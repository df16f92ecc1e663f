"""Full training-state checkpoints: params, SA λ, optimizer moments.

Counterpart of the JAX package's ``checkpoint.py``, single process, with
its crash-safety protocol and its meta file (``tdq_meta.json``, the same
keys):

* every save lands in a ``<path>.tmp`` sibling first, every payload file
  and the directory are fsynced, and the new generation swaps in by atomic
  renames;
* the previous generation is kept at ``<path>.old`` (two generations
  survive): rollback and corruption fallback both need one;
* the meta file carries a sha256 over every payload byte;
  :func:`restore_checkpoint` validates it and the template's shapes before
  it trusts a generation, raises :class:`TemplateMismatch` on a shape
  mismatch (a configuration error, never absorbed), falls back to
  ``<path>.old`` on a torn or corrupt generation and raises
  :class:`CheckpointCorrupted` only when no generation survives.

The payload is one ``.npz`` of NumPy arrays keyed by tree path, written and
read with ``allow_pickle=False``.  A state is a nest of dicts and
lists/tuples whose leaves are tensors, arrays or numbers; ``None`` holds no
leaf (a non-adaptive λ slot).  Leaves come back as NumPy arrays in the
template's structure.

Not ported yet (ROADMAP queue 1 item 6): the sharded, multi-process layout
(per-process shard files, ``cluster.json``, the peers' sync timeout);
``sharded=True`` raises :class:`~.utils.NotPortedError`.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import shutil
import sys
import zipfile
from typing import Any, Optional

import numpy as np
import torch

from .utils import not_ported

_META = "tdq_meta.json"
_STATE_FILE = "state.npz"

# the JAX package numbers its saves per process (its multi-process barrier's
# round id); the meta keeps the key
_save_seq = itertools.count()


class TemplateMismatch(ValueError):
    """The caller's template does not match what this checkpoint holds — a
    configuration error (other layer sizes, another λ setup), not
    corruption.  Never absorbed by the previous-generation fallback."""


class CheckpointCorrupted(RuntimeError):
    """No checkpoint generation under this path survived validation.
    ``failures`` maps each candidate directory to why it was rejected."""

    def __init__(self, path: str, failures: dict):
        self.path = path
        self.failures = dict(failures)
        detail = "; ".join(f"{d}: {why}" for d, why in failures.items())
        super().__init__(
            f"every checkpoint generation under {path} failed validation "
            f"({detail})")


def _leaves(tree: Any, prefix: str = "") -> list:
    """``[(path, leaf), ...]`` in tree order (dict keys sorted, as JAX
    flattens them); ``None`` holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree, key=str)
                for kv in _leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _leaves(v, f"{prefix}{i}/")]
    return [(prefix.rstrip("/"), tree)]


def _rebuild(template: Any, arrays: dict, prefix: str = "") -> Any:
    """``template``'s structure with each leaf replaced by
    ``arrays[path]``."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _rebuild(template[k], arrays, f"{prefix}{k}/")
                for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, arrays, f"{prefix}{i}/")
                              for i, v in enumerate(template))
    return arrays[prefix.rstrip("/")]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    arr = np.asarray(leaf)
    if arr.dtype.hasobject:
        raise TypeError(f"checkpoint leaves must be numeric arrays, got "
                        f"{type(leaf).__name__}")
    return arr


def write_npz(fh, arrays: dict) -> None:
    """``arrays`` (name -> array) as an uncompressed ``.npz`` into the open
    binary file ``fh``, pickling refused."""
    with zipfile.ZipFile(fh, "w", zipfile.ZIP_STORED) as zf:
        for name, arr in arrays.items():
            with zf.open(name + ".npy", "w", force_zip64=True) as member:
                # np.ascontiguousarray would make a 0-d array 1-d
                np.lib.format.write_array(member, np.array(arr, order="C"),
                                          allow_pickle=False)


def read_npz(source) -> dict:
    """Every array of an ``.npz`` (a path or a binary file), loaded with
    ``allow_pickle=False``."""
    with np.load(source, allow_pickle=False) as npz:
        return {k: npz[k] for k in npz.files}


def _payload_files(path: str) -> list:
    """Every file under ``path`` but the meta, as sorted relative paths."""
    out = []
    for root, _, files in os.walk(path):
        for f in files:
            if f != _META:
                out.append(os.path.relpath(os.path.join(root, f), path))
    return sorted(out)


def _digest_dir(path: str) -> dict:
    """sha256 over every payload byte, file names included (a missing or
    renamed file fails validation too)."""
    h = hashlib.sha256()
    files = _payload_files(path)
    for rel in files:
        h.update(rel.encode("utf-8"))
        h.update(b"\x00")
        with open(os.path.join(path, rel), "rb") as fh:
            for block in iter(lambda: fh.read(1 << 20), b""):
                h.update(block)
    return {"algo": "sha256", "digest": h.hexdigest(), "n_files": len(files)}


def _fsync_dir_tree(path: str) -> None:
    """fsync every file under ``path`` and the directories themselves: the
    rename-based swap is crash-atomic only once the bytes are on disk."""
    for root, _, files in os.walk(path):
        for f in files:
            with open(os.path.join(root, f), "rb") as fh:
                os.fsync(fh.fileno())
        try:
            fd = os.open(root, os.O_RDONLY)
        except OSError:  # a filesystem without directory handles
            continue
        try:
            os.fsync(fd)
        except OSError:
            pass
        finally:
            os.close(fd)


def checkpoint_exists(path: str) -> bool:
    """Is there a restorable generation (current or previous) under
    ``path``?"""
    path = os.path.abspath(path)
    return any(os.path.exists(os.path.join(c, _META))
               for c in (path, path + ".old"))


def save_checkpoint(path: str, state: dict, meta: Optional[dict] = None,
                    extra_files: Optional[dict] = None,
                    sharded: Optional[bool] = None) -> None:
    """Write ``state`` under the directory ``path``, crash-safe (module
    docstring).  ``meta`` is a JSON-serialisable dict stored beside it (the
    loss history, iteration counters, ...).  ``extra_files`` maps
    checkpoint-relative paths to raw bytes written beside the state before
    the checksum is taken, so they are fsynced, swapped and validated with
    it: a torn extra file fails the whole generation.  ``sharded=True``
    (the multi-process layout) is not ported."""
    if sharded:
        raise not_ported("save_checkpoint(sharded=True)",
                         "queue 1 item 6, topology-portable checkpoints")
    path = os.path.abspath(path)
    tmp, old = path + ".tmp", path + ".old"
    leaves = _leaves(state)
    arrays = {p: _to_numpy(leaf) for p, leaf in leaves}
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    with open(os.path.join(tmp, _STATE_FILE), "wb") as fh:
        write_npz(fh, arrays)
    for rel, blob in (extra_files or {}).items():
        rel = os.path.normpath(rel)
        if os.path.isabs(rel) or rel.startswith(".."):
            raise ValueError(f"extra file path {rel!r} escapes the "
                             "checkpoint directory")
        if os.path.basename(rel) in (_META, _STATE_FILE):
            raise ValueError(f"extra file {rel!r} would shadow the "
                             "checkpoint's own files")
        dest = os.path.join(tmp, rel)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        with open(dest, "wb") as fh:
            fh.write(bytes(blob))
    with open(os.path.join(tmp, _META), "w") as fh:
        json.dump({"backend": "npz", "meta": meta or {},
                   # restores hold the caller's template to these before
                   # loading, so a wrong configuration is a TemplateMismatch
                   "leaf_shapes": [list(a.shape) for a in arrays.values()],
                   "save_id": next(_save_seq),
                   "checksum": _digest_dir(tmp)}, fh)
        fh.flush()
        os.fsync(fh.fileno())
    _fsync_dir_tree(tmp)
    # park the current generation and promote the new one; only clear a
    # stale .old when there is a current one to park in its place (after a
    # save killed mid-swap, .old is the only restorable generation)
    if os.path.exists(path):
        shutil.rmtree(old, ignore_errors=True)
        os.rename(path, old)
    os.rename(tmp, path)


def resolve_checkpoint_dir(path: str) -> str:
    """The directory a restore reads first: ``path``, or ``<path>.old`` when
    a killed save left only that."""
    path = os.path.abspath(path)
    if not os.path.exists(os.path.join(path, _META)) \
            and os.path.exists(os.path.join(path + ".old", _META)):
        return path + ".old"
    return path


def verify_checkpoint(path: str) -> None:
    """Validate one generation's content checksum against its meta.  Raises
    ``ValueError`` on a mismatch and ``OSError`` for missing files; a
    generation without a recorded checksum passes."""
    with open(os.path.join(path, _META)) as fh:
        info = json.load(fh)
    want = info.get("checksum")
    if want is None:
        return
    got = _digest_dir(path)
    if got["digest"] != want.get("digest"):
        raise ValueError(
            f"content checksum mismatch ({got['n_files']} files, "
            f"{got['digest'][:12]}… != recorded "
            f"{str(want.get('digest'))[:12]}…) — torn or corrupted write")


def _template_shape_check(saved_shapes, template) -> None:
    t_shapes = [tuple(np.shape(leaf)) for _, leaf in _leaves(template)]
    saved = [tuple(s) for s in saved_shapes]
    if len(saved) != len(t_shapes):
        raise TemplateMismatch(
            f"checkpoint has {len(saved)} array leaves but the template "
            f"has {len(t_shapes)}; was this checkpoint saved for a "
            "different configuration?")
    for t, s in zip(t_shapes, saved):
        if t != s:
            raise TemplateMismatch(
                f"checkpoint leaf shape {s} does not match the template's "
                f"{t}; was this checkpoint saved for a different "
                "configuration?")


def _restore_one(path: str, template: dict) -> tuple[dict, dict]:
    """Load and validate one generation (no fallback)."""
    verify_checkpoint(path)
    with open(os.path.join(path, _META)) as fh:
        info = json.load(fh)
    if info.get("backend") != "npz":
        raise ValueError(f"backend {info.get('backend')!r} is not this "
                         "package's format (a JAX package checkpoint?)")
    _template_shape_check(info["leaf_shapes"], template)
    arrays = read_npz(os.path.join(path, _STATE_FILE))
    paths = [p for p, _ in _leaves(template)]
    missing = [p for p in paths if p not in arrays]
    if missing:
        raise TemplateMismatch(
            f"checkpoint lacks the template's leaves {missing[:3]}; was it "
            "saved for a different configuration?")
    _template_shape_check([arrays[p].shape for p in paths], template)
    return _rebuild(template, arrays), info["meta"]


def restore_checkpoint(path: str, template: dict) -> tuple[dict, dict]:
    """Load the state saved under ``path`` into ``template``'s structure.
    Returns ``(state, meta)`` with NumPy leaves.

    Restore order: the current generation, then the previous one
    (``<path>.old``).  A generation whose checksum fails, whose files are
    missing or whose payload does not load is skipped with a warning on
    stderr; only when none survives does :class:`CheckpointCorrupted`
    raise.  A :class:`TemplateMismatch` propagates: falling back would
    resume an older run of another configuration."""
    path = os.path.abspath(path)
    candidates = [c for c in (path, path + ".old")
                  if os.path.exists(os.path.join(c, _META))]
    if not candidates:
        raise FileNotFoundError(
            f"no checkpoint meta under {path} (or its .old sibling)")
    failures: dict = {}
    for i, cand in enumerate(candidates):
        try:
            state, meta = _restore_one(cand, template)
        except TemplateMismatch:
            raise
        except (OSError, ValueError, KeyError, zipfile.BadZipFile,
                EOFError) as e:
            failures[cand] = f"{type(e).__name__}: {e}"
        else:
            if i > 0 or failures:
                print(f"[checkpoint] restored the previous generation "
                      f"{cand} (newer one rejected: "
                      f"{'; '.join(failures.values()) or 'missing'})",
                      file=sys.stderr, flush=True)
            return state, meta
    raise CheckpointCorrupted(path, failures)
