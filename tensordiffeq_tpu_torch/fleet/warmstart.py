"""Warm start: move a fresh replica's first-touch costs to load time.

Counterpart of the JAX package's ``fleet/warmstart.py``, which serializes
one ``jax.export`` program per (kind, bucket) rung into the artifact and
keeps two promises with them: the first real query compiles nothing, and
a residual is served with no ``f_model`` attached (the exported program
embeds the computation).  The port keeps both with what it has:

* **artifact side** — :func:`export_fleet_artifact` writes the ladder
  spec (min/max bucket, the query kinds to prewarm) into the artifact's
  meta, and, for the ``residual`` kind, the surrogate's ``f_model``
  lowered to the pointwise tape that K3 runs
  (:mod:`~..ops.residual_tape`: integer op codes, an f32 constant pool)
  over the Taylor channels it reads: ``aot/residual_tape.json``, saved
  and checksummed with the checkpoint payload.  The block's ``backend``
  is ``torch-tape/<digest of the tape's op table>``: a replica whose op
  table differs treats the blob as a backend mismatch and never misreads
  the op codes.  An ``f_model`` that does not lower writes no tape (that
  kind is prewarmed through the engine's own program, as a failed
  ``jax.export`` is); exporting ``residual`` with no ``f_model`` raises.
* **replica side** — :func:`warm_start` builds the kernel library first
  (:func:`~..ops.cuda_taylor.build`: compiled once per source digest into
  ``_build/``, so a later process only loads it: the persistent-cache
  tier), installs the tape program on the residual rungs of a surrogate
  loaded with **no** ``f_model``, and drives one dummy query through
  every rung of the artifact's ladder, so every rung's CUDA graph is
  captured at load.  The first real query captures nothing (the engine's
  ``serving.engine.compiles`` counter, the JAX counter's name, counts the
  captures).  The tape program is K1's table at the rung (f32, 3xTF32;
  :func:`~..ops.cuda_taylor.build_cuda_table_fn` over the tape's
  channels) followed by :meth:`~..ops.residual_tape.ResidualTape.forward`
  over the table's columns and the coordinates, captured as the rung's
  graph: K1 once per replay.  It is the fused engine's arithmetic, within
  the JAX package's band of the generic program (rtol 5e-3,
  ``ops/fused.py::crosscheck_residuals``), not bit for bit.  A surrogate
  loaded WITH its ``f_model`` keeps the engine's generic residual program,
  so a fleet-served query is bit for bit a direct engine over the same
  artifact.

Every rung lands somewhere and the load never fails for a degradable
reason: a corrupt tape blob (chaos ``warmstart_fail_n``, or a torn file
caught by the artifact checksum) costs its rung the tape: with no
``f_model`` the rung fails its first touch and is quarantined (queries
reroute upward), with one it runs the engine's own program.  The counts
keep the JAX names: ``aot`` rungs run the artifact's tape, ``jit`` rungs
the engine's own program, each captured at load.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Optional, Sequence

import numpy as np

from ..ops.residual_tape import (OPS, MinimaxLoweringError, ResidualTape,
                                 lower_residual)
from ..resilience.chaos import active_chaos
from ..telemetry import default_registry, log_event

#: artifact-relative directory the tape blob lives in
AOT_SUBDIR = "aot"
#: version of the warm-start meta block (independent of the artifact
#: schema version: the block is optional and self-describing)
WARMSTART_FORMAT = 1
#: the residual tape's file, relative to the artifact
TAPE_FILE = os.path.join(AOT_SUBDIR, "residual_tape.json")

DEFAULT_KINDS = ("u", "residual")


def tape_backend() -> str:
    """The warm-start block's ``backend``: the tape format and a digest of
    its op table (op codes are positions in :data:`~..ops.residual_tape.
    OPS`)."""
    digest = hashlib.sha256(",".join(OPS).encode()).hexdigest()[:16]
    return f"torch-tape/{digest}"


def _lower(surrogate) -> dict:
    """The residual tape blob of ``surrogate`` (a JSON-able dict), or
    raises :class:`~..ops.residual_tape.MinimaxLoweringError` when its
    ``f_model`` does not lower (or its network is not the standard f32
    tanh MLP that K1 evaluates)."""
    from ..ops.fused import analyze_f_model, mlp_qualifies
    from ..ops.taylor import canonical, channel_order
    if mlp_qualifies(surrogate.net, surrogate.params) is None:
        raise MinimaxLoweringError(
            "the tape program runs K1, which takes the standard float32 "
            "tanh MLP only")
    requests, why = analyze_f_model(surrogate.point_residual,
                                    surrogate.varnames, surrogate.n_out,
                                    return_reason=True)
    if requests is None:
        raise MinimaxLoweringError(f"the residual is not analysable ({why})")
    requests = sorted({canonical(mi) for mi in requests},
                      key=lambda t: (len(t), t))
    channels = channel_order(set(requests))
    tape = lower_residual(surrogate.point_residual, surrogate.varnames,
                          surrogate.n_out, channels)
    return {"format": 1, "backend": tape_backend(),
            "requests": [list(r) for r in requests],
            "channels": [list(c) for c in channels],
            "n_out": int(surrogate.n_out),
            "varnames": list(surrogate.varnames),
            "tape": {"src": list(tape.src),
                     "ops": [list(op) for op in tape.ops],
                     "consts": list(tape.consts),
                     "outputs": list(tape.outputs),
                     "n_table": int(tape.n_table)}}


def export_fleet_artifact(surrogate, path: str, *, min_bucket: int = 256,
                          max_bucket: int = 4096,
                          kinds: Sequence[str] = DEFAULT_KINDS,
                          aot: bool = True) -> dict:
    """Save ``surrogate`` under ``path`` with a warm-start block: the
    ladder spec, and (with ``aot=True`` and ``"residual"`` among
    ``kinds``) its ``f_model`` lowered to the residual tape, which a
    replica serves with no ``f_model`` attached (module docstring).

    ``kinds`` are engine query-kind specs (``"u"``, ``"residual"``,
    ``"d:<var>[:<order>[:<component>]]"``).  A kind the surrogate cannot
    evaluate (``"residual"`` with no ``f_model``) raises.  An ``f_model``
    that does not lower is logged and exported without a tape; the save
    never fails over it.  Returns the warm-start meta block that was
    embedded."""
    # a throwaway engine supplies the kind parsing and the ladder the live
    # replica will run
    engine = surrogate.engine(min_bucket=min_bucket, max_bucket=max_bucket)
    specs = [engine.spec_for(engine.kind_key(k)) for k in kinds]
    engine.release()
    if "residual" in specs and surrogate.point_residual is None:
        raise ValueError(
            "cannot export a residual warm start: this surrogate has no "
            "f_model attached (drop 'residual' from kinds=, or export "
            "from a compiled solver)")
    block = {"format": WARMSTART_FORMAT, "min_bucket": int(min_bucket),
             "max_bucket": int(max_bucket), "kinds": specs,
             "backend": tape_backend(), "aot": {}}
    files: dict = {}
    if aot and "residual" in specs:
        try:
            blob = _lower(surrogate)
        except MinimaxLoweringError as e:
            log_event("warmstart",
                      f"residual tape export failed ({type(e).__name__}: "
                      f"{e}); the replica prewarms the residual rungs "
                      "through the engine's own program (it needs the "
                      "f_model attached)", level="warning", verbose=False,
                      kind_label="residual",
                      error=f"{type(e).__name__}: {e}")
        else:
            files[TAPE_FILE] = json.dumps(blob, indent=1).encode("utf-8")
            block["aot"]["residual"] = {str(b): TAPE_FILE
                                        for b in engine.bucket_sizes}
    surrogate.save(path, extra_meta={"warmstart": block},
                   extra_files=files)
    log_event("warmstart",
              f"exported fleet artifact {path}: "
              f"{sum(len(v) for v in block['aot'].values())} tape rung(s) "
              f"over kinds={specs}, buckets={list(engine.bucket_sizes)}",
              verbose=False, path=str(path),
              programs=sum(len(v) for v in block["aot"].values()),
              kinds=specs)
    return block


def _tape_program(sur, blob: dict):
    """The rung program factory of a tape blob: K1's table at the rung
    (f32, 3xTF32 on the card; the plain flavor on the CPU), then the tape
    over its columns and the coordinates.  Raises ``ValueError`` for a
    blob that does not fit this surrogate."""
    from ..ops.cuda_taylor import build_cuda_table_fn
    from ..ops.taylor import canonical, channel_order

    if blob.get("backend") != tape_backend():
        raise ValueError(f"tape backend {blob.get('backend')!r} is not "
                         f"{tape_backend()!r}")
    if list(blob["varnames"]) != list(sur.varnames) \
            or int(blob["n_out"]) != sur.n_out:
        raise ValueError("the tape was lowered for other coordinates or "
                         "outputs than this surrogate's")
    requests = {canonical(tuple(r)) for r in blob["requests"]}
    channels = [tuple(c) for c in blob["channels"]]
    if channel_order(requests) != channels:
        raise ValueError("the tape's channel order is not this build's")
    t = blob["tape"]
    tape = ResidualTape(src=tuple(int(s) for s in t["src"]),
                        ops=tuple(tuple(int(v) for v in op)
                                  for op in t["ops"]),
                        consts=tuple(float(c) for c in t["consts"]),
                        outputs=tuple(int(o) for o in t["outputs"]),
                        n_table=int(t["n_table"]))
    n_out = sur.n_out
    if tape.n_table != len(channels) * n_out \
            or any(op[0] >= len(OPS) for op in tape.ops):
        raise ValueError("the tape's tables do not fit its channels")
    shapes = [tuple(W.shape) for W, _ in sur.net.param_tree(sur.params)]
    table_fn = build_cuda_table_fn(requests, shapes, device=sur.device,
                                   precision="highest")
    ndim = sur.ndim

    def program(params, X):
        table = table_fn(list(params), X)
        columns = [table[mi][:, o] if mi in table else None
                   for mi in channels for o in range(n_out)]
        coords = [X[:, i] for i in range(ndim)]
        regs = tape.forward(columns, coords)
        outs = [regs[r] for r in tape.outputs]
        return outs[0] if len(outs) == 1 else tuple(outs)

    return lambda: program


def warm_start(engine, *, kinds: Optional[Sequence[str]] = None,
               tenant: Optional[str] = None, registry=None,
               max_drive_bucket: Optional[int] = None) -> dict:
    """Prewarm ``engine`` so its first real query captures nothing.

    Builds the kernel library (on the card), reads the warm-start block
    from the engine's surrogate artifact meta, installs the residual tape
    on the residual rungs when the surrogate has no ``f_model``, then
    drives one dummy query through every ladder rung up to the artifact's
    ``max_bucket`` (quarantined rungs skipped), so each rung is captured
    now.  Without a block (a pre-fleet v1 artifact, or an ``aot=False``
    export) the same drive runs over ``kinds`` (default: ``u``, plus
    ``residual`` when evaluable) up to the rung ``max_drive_bucket``
    routes to.

    Never raises for a degradable reason: a corrupt blob, a backend
    mismatch, or a rung that fails to capture costs that rung its tier,
    and the load continues.  Returns ``{"aot": n, "jit": n, "failed": n,
    "skipped": [...], "compile_cache_dir": dir, "wall_s": s}``: ``aot``
    rungs run the artifact's tape, ``jit`` rungs the engine's own
    program."""
    registry = registry if registry is not None else default_registry()
    sur = engine.surrogate
    block = (sur.artifact_meta or {}).get("warmstart")
    t0 = time.monotonic()

    # the persistent tier: the kernel library, built once per source digest
    cache_dir = None
    if sur.device.type == "cuda":
        from ..ops import cuda_taylor as ct
        ct.build()
        cache_dir = ct.BUILD_DIR

    # the artifact block's own kinds win when present: an explicit kinds=
    # that dropped a block kind would skip the tape a no-f_model replica
    # depends on
    if block:
        kinds = block["kinds"]
    elif kinds is None:
        kinds = list(DEFAULT_KINDS)

    # drive ladder cap: the artifact's ladder, not the policy engine's
    # (rungs past it capture lazily on first demand)
    cap = engine.bucket_sizes[-1]
    if block:
        cap = min(cap, int(block["max_bucket"]))
    elif max_drive_bucket is not None:
        cap = min(cap, engine.bucket_for(int(max_drive_bucket)))
    aot_index = (block or {}).get("aot", {})
    backend_ok = (block or {}).get("backend") == tape_backend()
    if block and block.get("aot") and not backend_ok:
        log_event("warmstart",
                  f"the residual tape was exported for backend "
                  f"{block.get('backend')!r} but this replica runs "
                  f"{tape_backend()!r}; prewarming the engine's own "
                  "programs instead", level="warning", verbose=False,
                  tenant=tenant)

    n_aot = n_jit = n_failed = 0
    skipped: list = []
    for spec in kinds:
        key = engine.kind_key(spec)
        spec = engine.spec_for(key)
        # only a surrogate with no f_model serves from the tape: with one
        # the engine's own program keeps the fleet bit for bit a direct
        # engine
        blobs = (aot_index.get(spec, {})
                 if backend_ok and spec == "residual"
                 and sur.point_residual is None else {})
        installed = set()
        parsed: dict = {}
        for bucket in engine.bucket_sizes:
            if bucket > cap:
                continue
            rel = blobs.get(str(bucket))
            if rel is None or sur.artifact_dir is None:
                continue
            try:
                chaos = active_chaos()
                if chaos is not None:
                    chaos.on_warmstart(spec, bucket)
                if rel not in parsed:
                    with open(os.path.join(sur.artifact_dir, rel)) as fh:
                        parsed[rel] = _tape_program(sur, json.load(fh))
                engine.install_program(spec, bucket, parsed[rel])
                installed.add(bucket)
            except Exception as e:  # ChaosFault included: degrade, don't die
                n_failed += 1
                registry.counter("fleet.warmstart.aot_failed",
                                 **({"tenant": tenant} if tenant else {})
                                 ).inc()
                log_event("warmstart",
                          f"residual tape kind={spec} bucket={bucket} "
                          f"unusable ({type(e).__name__}: {e}); the rung "
                          "runs without it", level="warning",
                          verbose=False, tenant=tenant, kind_label=spec,
                          bucket=bucket, error=f"{type(e).__name__}: {e}")
        if spec == "residual" and sur.point_residual is None \
                and not installed:
            skipped.append(spec)  # nothing can evaluate it on this replica
            continue
        op = engine.op_for(spec)
        dead = set(engine.quarantine_snapshot())
        for bucket in engine.bucket_sizes:
            if bucket > cap:
                continue
            if (spec, bucket) in dead:
                continue  # eviction memory: never resurrect a dead rung
            try:
                op(np.zeros((bucket, sur.ndim), np.float32))
            except Exception as e:
                n_failed += 1
                log_event("warmstart",
                          f"prewarm drive failed for kind={spec} "
                          f"bucket={bucket} ({type(e).__name__}: {e})",
                          level="warning", verbose=False, tenant=tenant,
                          kind_label=spec, bucket=bucket,
                          error=f"{type(e).__name__}: {e}")
                continue
            if (spec, bucket) in set(engine.quarantine_snapshot()):
                # the rung failed its first touch and the drive was served
                # by a larger one: this rung is dead, not warm
                n_failed += 1
            elif bucket in installed:
                n_aot += 1
            else:
                n_jit += 1
    wall = time.monotonic() - t0
    labels = {"tenant": tenant} if tenant else {}
    registry.counter("fleet.warmstart.programs", mode="aot",
                     **labels).inc(n_aot)
    registry.counter("fleet.warmstart.programs", mode="jit",
                     **labels).inc(n_jit)
    registry.histogram("fleet.warmstart.wall_s", **labels).observe(wall)
    out = {"aot": n_aot, "jit": n_jit, "failed": n_failed,
           "skipped": skipped, "compile_cache_dir": cache_dir,
           "wall_s": wall}
    log_event("warmstart",
              f"warm start{f' tenant={tenant}' if tenant else ''}: "
              f"{n_aot} AOT + {n_jit} jit program(s) in {wall:.3f}s"
              + (f", {n_failed} degraded" if n_failed else ""),
              verbose=False, tenant=tenant, **{k: v for k, v in out.items()
                                               if k != "skipped"})
    return out
