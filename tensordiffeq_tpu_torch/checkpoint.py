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

The sharded layout (``sharded=True``, the default under data parallelism
with more than one rank) is the JAX package's topology-portable one: a
leaf that is a :class:`RowBlock` (a rank's rows of a global array: the
collocation set, per-point λ and their Adam moments) is written by its own
process into ``shards/proc{r}.npz`` with an index ``shards/proc{r}.json``
(the segments' global row bounds; written last, by an atomic rename: the
"this process is done" marker), and the meta records each such leaf's
global shape (the manifest).  The coordinator (rank 0) opens the staging
directory with ``cluster.json`` (the round's id), writes the replicated
leaves, waits for every process's index (at most :data:`SYNC_TIMEOUT_S`,
from ``TDQ_CKPT_SYNC_TIMEOUT_S``: a dead peer costs a bounded wait, never
a hang), then writes the meta and its checksum over every payload byte
(the shards included) and promotes the generation, as single writer.  A
restore assembles each global array from the shard files and validates
its coverage: a generation that lost a process's index fails it and the
restore falls back to ``<path>.old``, as it does on a torn shard file
(the checksum).  The caller re-trims and re-splits the global arrays for
its own world size: an 8-rank checkpoint resumes on 4 ranks and back.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import shutil
import time
import zipfile
from typing import Any, Optional

import numpy as np
import torch

from .telemetry import log_event

_META = "tdq_meta.json"
_STATE_FILE = "state.npz"
_SHARD_DIR = "shards"
_CLUSTER_FILE = "cluster.json"

#: How long a multi-process save waits on its peers' shard files before it
#: goes on without them (the incomplete generation then fails coverage at
#: restore, and the previous complete one is used).
SYNC_TIMEOUT_S = float(os.environ.get("TDQ_CKPT_SYNC_TIMEOUT_S", "120"))

# the JAX package numbers its saves per process (its multi-process barrier's
# round id); the meta keeps the key
_save_seq = itertools.count()
# sharded saves, numbered apart: every process of a group makes them in
# lockstep, so the count is the file barrier's round id
_sharded_seq = itertools.count()


class RowBlock:
    """A checkpoint leaf that is the rows ``[start, start + len(data))`` of
    a global ``[n_rows, ...]`` array split across processes (the module
    docstring's sharded layout).  Its :attr:`shape` is the global one."""

    def __init__(self, data, start: int, n_rows: int):
        self.data = data
        self.start = int(start)
        self.n_rows = int(n_rows)

    @classmethod
    def of_rank(cls, t, mesh):
        """``t``, this rank's block of a set split into equal rank blocks
        (the collocation points, their per-point λ and moments, a
        discovery model's observations), as a checkpoint leaf; ``t`` itself
        with no ``mesh`` or no ``t``."""
        if mesh is None or t is None:
            return t
        n = int(t.shape[0])
        return cls(t, mesh.rank * n, n * mesh.size)

    @property
    def shape(self) -> tuple:
        return (self.n_rows,) + tuple(self.data.shape[1:])

    def __array__(self, dtype=None, copy=None):
        """The whole array, when this block is all of it."""
        if self.start != 0 or int(self.data.shape[0]) != self.n_rows:
            raise ValueError("a RowBlock that is part of its array has no "
                             "single-process value: save it sharded")
        a = _to_numpy(self.data)
        return a if dtype is None else a.astype(dtype)


class TemplateMismatch(ValueError):
    """The caller's template does not match what this checkpoint holds — a
    configuration error (other layer sizes, another λ setup), not
    corruption.  Never absorbed by the previous-generation fallback."""

    trace_id = None


class CheckpointCorrupted(RuntimeError):
    """No checkpoint generation under this path survived validation.
    ``failures`` maps each candidate directory to why it was rejected."""

    trace_id = None

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


def global_placeholder(shape, dtype=np.float32) -> np.ndarray:
    """A zero-memory array of ``shape``: a template leaf whose values the
    restore replaces (a global row count the caller does not hold)."""
    return np.broadcast_to(np.zeros((), dtype), tuple(shape))


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
    if isinstance(leaf, RowBlock):
        return np.asarray(leaf)
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


def _wait_for(predicate, what: str, timeout_s: Optional[float] = None
              ) -> bool:
    """Poll ``predicate`` until it holds or the timeout passes: the file
    barrier a multi-process save coordinates through (no collective: a
    dead peer costs a bounded wait, never a hang)."""
    timeout_s = SYNC_TIMEOUT_S if timeout_s is None else timeout_s
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    log_event("checkpoint", f"timed out after {timeout_s:.0f}s waiting for "
              f"{what}; continuing without it", level="warning",
              verbose=False, what=what, timeout_s=timeout_s)
    return False


def _read_json(path: str) -> Optional[dict]:
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def _write_shards(tmp: str, blocks: dict, proc: int, save_id: int) -> None:
    """This process's rows of every :class:`RowBlock` leaf: one ``.npz``
    and one index JSON, the index written last by an atomic rename (the
    marker the coordinator waits on)."""
    sdir = os.path.join(tmp, _SHARD_DIR)
    os.makedirs(sdir, exist_ok=True)
    arrays, leaves_meta = {}, {}
    for i, (p, blk) in enumerate(sorted(blocks.items())):
        key = f"l{i}_s0"
        data = _to_numpy(blk.data)
        arrays[key] = data
        bounds = [[blk.start, blk.start + int(data.shape[0])]] + [
            [0, int(d)] for d in data.shape[1:]]
        leaves_meta[p] = {"global_shape": list(blk.shape),
                          "dtype": data.dtype.name,
                          "segments": [{"key": key, "bounds": bounds}]}
    npz_rel = os.path.join(_SHARD_DIR, f"proc{proc}.npz")
    with open(os.path.join(tmp, npz_rel), "wb") as fh:
        write_npz(fh, arrays)
        fh.flush()
        os.fsync(fh.fileno())
    idx = {"proc": proc, "save_id": int(save_id), "file": npz_rel,
           "leaves": leaves_meta}
    idx_path = os.path.join(sdir, f"proc{proc}.json")
    with open(idx_path + ".part", "w") as fh:
        json.dump(idx, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(idx_path + ".part", idx_path)


def _assemble_sharded(path: str, manifest: dict) -> dict:
    """Every manifest leaf as a whole host array, assembled from the shard
    files under ``path``.  Raises ``ValueError`` when a leaf's rows are not
    all covered (a process's shards are missing): the caller's fallback to
    the previous generation then applies."""
    sdir = os.path.join(path, _SHARD_DIR)
    want = manifest["leaves"]
    bufs = {p: np.zeros(m["global_shape"], np.dtype(m["dtype"]))
            for p, m in want.items()}
    filled = {p: 0 for p in want}
    indexes = sorted(f for f in os.listdir(sdir)
                     if f.startswith("proc") and f.endswith(".json")) \
        if os.path.isdir(sdir) else []
    for rel in indexes:
        idx = _read_json(os.path.join(sdir, rel))
        if idx is None:
            raise ValueError(f"unreadable shard index {rel}")
        arrays = read_npz(os.path.join(path, idx["file"]))
        for p, m in idx["leaves"].items():
            if p not in want:
                continue
            for seg in m["segments"]:
                sl = tuple(slice(a, b) for a, b in seg["bounds"])
                data = arrays[seg["key"]]
                bufs[p][sl] = data
                filled[p] += int(data.size)
    for p, m in want.items():
        total = int(np.prod(m["global_shape"]))
        if filled[p] < total:
            raise ValueError(
                f"shard coverage incomplete for leaf {p!r} ({filled[p]}/"
                f"{total} elements; a process's shards are missing, likely "
                "a save that lost a peer)")
    return bufs


def save_checkpoint(path: str, state: dict, meta: Optional[dict] = None,
                    extra_files: Optional[dict] = None,
                    sharded: Optional[bool] = None, mesh=None) -> None:
    """Write ``state`` under the directory ``path``, crash-safe (module
    docstring).  ``meta`` is a JSON-serialisable dict stored beside it (the
    loss history, iteration counters, ...).  ``extra_files`` maps
    checkpoint-relative paths to raw bytes written beside the state before
    the checksum is taken, so they are fsynced, swapped and validated with
    it: a torn extra file fails the whole generation.

    ``sharded``: the topology-portable layout of the module docstring.
    ``None`` chooses it when ``mesh`` (a :class:`~.parallel.DataMesh`) has
    more than one process; ``True`` forces it (a single process writes
    every row, the format tests exercise that way); ``False`` the plain
    layout, which needs every :class:`RowBlock` whole on this process.
    Under a multi-process ``mesh`` every process calls this in lockstep."""
    path = os.path.abspath(path)
    tmp, old = path + ".tmp", path + ".old"
    nproc = 1 if mesh is None else mesh.size
    proc = 0 if mesh is None else mesh.rank
    leaves = _leaves(state)
    blocks = {p: leaf for p, leaf in leaves if isinstance(leaf, RowBlock)}
    if sharded is None:
        sharded = nproc > 1
    if not sharded and nproc > 1:
        raise ValueError("save_checkpoint(sharded=False) under a "
                         f"{nproc}-process group: the plain layout needs "
                         "every row on one process; save sharded")
    manifest = None
    if sharded:
        save_id = next(_sharded_seq)

        def round_id():
            return (_read_json(os.path.join(tmp, _CLUSTER_FILE))
                    or {}).get("save_id")

        if proc != 0:
            # a follower: wait for the coordinator to open this round's
            # staging directory, add the shards, then wait for the promote
            # (or the next round: the coordinator went on without us)
            if _wait_for(lambda: round_id() == save_id,
                         f"save round {save_id} staging dir"):
                _write_shards(tmp, blocks, proc, save_id)
                _wait_for(lambda: round_id() != save_id,
                          f"save round {save_id} promote")
            return
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with open(os.path.join(tmp, _CLUSTER_FILE), "w") as fh:
            json.dump({"nproc": nproc, "save_id": save_id}, fh)
        _write_shards(tmp, blocks, proc, save_id)
        if nproc > 1:
            sdir = os.path.join(tmp, _SHARD_DIR)
            _wait_for(lambda: all(os.path.exists(os.path.join(
                sdir, f"proc{r}.json")) for r in range(nproc)),
                f"all {nproc} processes' shard files")
        manifest = {"nproc": nproc,
                    "leaves": {p: {"global_shape": list(blk.shape),
                                   "dtype": str(blk.data.dtype).replace(
                                       "torch.", "")}
                               for p, blk in blocks.items()}}
        arrays = {p: _to_numpy(leaf) for p, leaf in leaves
                  if p not in blocks}
    else:
        arrays = {p: _to_numpy(leaf) for p, leaf in leaves}
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    with open(os.path.join(tmp, _STATE_FILE), "wb") as fh:
        write_npz(fh, arrays)
    leaf_shapes = [list(blocks[p].shape) if p in blocks
                   else list(arrays[p].shape) for p, _ in leaves]
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
                   # loading, so a wrong configuration is a TemplateMismatch;
                   # a sharded save records the GLOBAL shapes, the contract
                   # another world size restores against
                   "leaf_shapes": leaf_shapes,
                   "save_id": next(_save_seq),
                   **({"sharded": manifest} if manifest is not None
                      else {}),
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
    # chaos's torn-write fault (no-op without an active plan): storage
    # corruption of the promoted generation, which the restore's checksum
    # and .old fallback must absorb
    from .resilience.chaos import active_chaos
    c = active_chaos()
    if c is not None:
        c.on_checkpoint_saved(path)


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
    if info.get("sharded") is not None:
        arrays.update(_assemble_sharded(path, info["sharded"]))
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
                log_event("checkpoint",
                          f"restored the previous generation {cand} "
                          f"(newer one rejected: "
                          f"{'; '.join(failures.values()) or 'missing'})",
                          level="warning", restored=cand, failures=failures)
            return state, meta
    raise CheckpointCorrupted(path, failures)
