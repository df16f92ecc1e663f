"""Batched query engine over a :class:`Surrogate`: one CUDA graph per
(kind, bucket).

Counterpart of the JAX package's ``serving/engine.py``.  A serving workload
sends queries of every size; a program per exact size would mean unbounded
captures and unbounded tail latency.  The engine pads each query to a rung
of a **power-of-two bucket ladder** between ``min_bucket`` and
``max_bucket`` (larger queries are split into ``max_bucket`` chunks), so
the programs it ever builds are the ladder: ``log2(max_bucket /
min_bucket) + 1`` per query kind, whatever the query sizes.

Each (kind, bucket) rung owns a static input buffer of ``[bucket, ndim]``
on the surrogate's device (the counterpart of the JAX engine's donated
buffer): a chunk's rows are copied in and the tail zeroed.  On the card the
rung's program is a CUDA graph (:class:`~..training.graphs.StepGraph`):
warmed up and captured at the rung's first touch and replayed for every
chunk after, its output copied to the host before the query returns.  The
rungs of one engine never run at the same time, so their graphs share one
memory pool.  A graph is keyed on the storage of the surrogate's parameters
and of its input buffer: assigning new parameter tensors to
``surrogate.params`` drops it, and the next chunk captures it again.  On
the CPU the same programs run eagerly.

The programs are the JAX engine's generic ones: ``u`` is the MLP forward,
``d:<var>:<order>:<comp>`` the per-point derivative chain of
:func:`~..ops.derivatives.d` vmapped over the rows, ``residual``
:func:`~..ops.derivatives.vmap_residual` of the surrogate's ``f_model`` —
the referee every training engine is cross-checked against.  They run at
the network's matmul precision (IEEE float32 unless its ``precision`` is
``None``/``"default"``, then TF32 on the card; as ``solver.predict``)
without autograd.  A ``precision=None`` standard tanh MLP serves its
derivative kinds within the Taylor propagation's reach from the table of
K1's single-pass TF32 flavor (:func:`~..ops.cuda_taylor.k1_forward_tf32`,
one launch per replay on the card; the plain flavor on the CPU), as the
training solver's fused engine at that precision does.

Every kind is pointwise along the rows, so padding is sound and a row's
answer does not depend on the other rows of its rung.  The contracts:
a rung's graph equals its program run eagerly at the same padded shape bit
for bit; within a rung a row's answer does not depend on the other rows or
on the padding; across rungs (and against ``solver.predict``) the answers
agree within float32 rounding, since a library matmul may choose another
algorithm for another row count.

``compute_dtype="bfloat16"`` serves the JAX engine's mixed-precision
programs: ``u``, each derivative kind within the Taylor propagation's
reach (:func:`~..ops.taylor.supported`) and ``residual`` (when the
``f_model`` is analysable) come from the bf16-operand flavor of the Taylor
table: on the card one launch of K1-bf16
(:func:`~..ops.cuda_taylor.k1_forward_bf16`) inside the rung's graph, the
residual the fused engine over that table; on the CPU the plain bf16
flavor.  A kind outside the propagation's reach keeps the f32 program,
bit-equal to the f32 engine's.  Results carry bf16 rounding (about three
significant digits).

A first-touch failure (the warm-up, the capture or the first replay)
quarantines that rung for its kind; the chunk reroutes to the next larger
rung, which is a graph too.  A rung is never run eagerly in place of its
graph.  :class:`EngineDegraded` is raised when no usable rung is left.

Not ported yet: ``shard=True`` (multi-GPU, queue 1 item 6), which raises
:class:`~tensordiffeq_tpu_torch.utils.NotPortedError`, the cost gauges
``serving.engine.{flops,bytes}_per_point`` and the chaos and tracing hooks
(queue 1 item 7).
"""

from __future__ import annotations

from typing import Callable, Union

import numpy as np
import torch
from torch.func import vmap

from ..ops.derivatives import d, make_ufn, vmap_residual
from ..telemetry import default_registry, log_event
from ..training.graphs import CudaGraph, SharedPool, StepGraph
from ..utils import (matmul_precision, not_ported, param_leaves,
                     resolve_compute_dtype)
from .surrogate import Surrogate


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def _label(kind) -> str:
    return kind if isinstance(kind, str) else ":".join(map(str, kind))


def _tree_map(fn: Callable, out):
    if isinstance(out, (tuple, list)):
        return type(out)(fn(o) for o in out)
    return fn(out)


class EngineDegraded(RuntimeError):
    """Every bucket a query could route to is quarantined for this query
    kind — the engine cannot serve it (other kinds keep serving)."""

    def __init__(self, kind, buckets):
        self.kind = kind
        self.buckets = tuple(buckets)
        super().__init__(
            f"all usable buckets {self.buckets} are quarantined for query "
            f"kind {kind!r} (first-touch failures); engine degraded for "
            "this kind")


class _Rung:
    """One (kind, bucket) rung: the static input buffer, the program's
    output and the graph that replays it."""

    def __init__(self, engine: "InferenceEngine", kind, bucket: int,
                 program: Callable):
        self.surrogate = engine.surrogate
        self.program = program
        self.X = torch.zeros(bucket, self.surrogate.ndim,
                             dtype=torch.float32,
                             device=self.surrogate.device)
        self.out = None
        self.graph = StepGraph(self._step, self._keyed, self.X.device,
                               f"serve {_label(kind)} b={bucket}",
                               make_graph=engine._make_graph)

    def _step(self):
        with matmul_precision(self.surrogate.net.precision), torch.no_grad():
            self.out = self.program(self.surrogate.params, self.X)

    def _keyed(self) -> list:
        return param_leaves(self.surrogate.params) + [self.X]

    def run(self, X: np.ndarray):
        """The program's answer on the rows ``X`` (at most ``bucket``):
        the rows copied into the buffer, the tail zeroed, one replay (or
        one eager run), the first ``len(X)`` rows back on the host."""
        n = X.shape[0]
        self.X[:n].copy_(torch.from_numpy(X))
        self.X[n:].zero_()
        self.graph.check()
        self.graph.prime()
        self.graph()
        return _tree_map(lambda a: a[:n].cpu().numpy(), self.out)


class InferenceEngine:
    """Batched ``u`` / derivative / residual queries over a bounded ladder
    of programs (module docstring).

    Args:
      surrogate: the :class:`Surrogate` to serve; the engine runs on its
        parameters' device.
      min_bucket / max_bucket: powers of two bounding the pad-to-bucket
        ladder.  Every chunk runs at one of the ladder sizes, so the engine
        holds at most :attr:`n_buckets` programs per query kind (``u``,
        each distinct derivative, ``residual``).
      shard: not ported (multi-GPU); ``True`` raises.
      donate: the JAX engine donates the padded buffer to its program; a
        rung's static buffer is reused by every replay here either way.
      registry: :class:`~tensordiffeq_tpu_torch.telemetry.MetricsRegistry`
        receiving the engine's health metrics — first-touch counts per
        (kind, bucket) (``serving.engine.compiles``: the warm-up and
        capture on the card, the first eager run on the CPU), installed
        programs loaded or failed (``serving.engine.aot_loads``,
        ``.aot_failed``), quarantines (``serving.engine.quarantined``),
        points served (``serving.engine.points``) and the padded fraction
        of each bucket (``serving.engine.pad_waste``).  Defaults to the
        process-wide registry.
      compute_dtype: ``None``, or ``"bfloat16"``/``torch.bfloat16``: the
        mixed-precision programs (module docstring).  Requires the
        standard float32 tanh MLP (raises :class:`ValueError` at
        construction otherwise).
    """

    def __init__(self, surrogate: Surrogate, min_bucket: int = 256,
                 max_bucket: int = 1 << 20, shard: bool = False,
                 donate: bool = True, registry=None, compute_dtype=None):
        if shard:
            raise not_ported("InferenceEngine(shard=True)",
                             "queue 1 item 6, multi-GPU")
        if _next_pow2(min_bucket) != min_bucket \
                or _next_pow2(max_bucket) != max_bucket:
            raise ValueError("min_bucket and max_bucket must be powers of "
                             f"two, got {min_bucket}/{max_bucket}")
        if min_bucket > max_bucket:
            raise ValueError(f"min_bucket {min_bucket} > max_bucket "
                             f"{max_bucket}")
        self.surrogate = surrogate
        self._compute_dtype = resolve_compute_dtype(compute_dtype)
        self._mixed: dict = {}  # kind -> the table program factory, or None
        from ..ops.fused import mlp_qualifies
        qualifies = mlp_qualifies(surrogate.net, surrogate.params) is not None
        if self._compute_dtype is not None and not qualifies:
            raise ValueError(
                "compute_dtype requires the standard float32 tanh MLP "
                "(the reduced-precision programs run the fused Taylor "
                "propagation, which cannot differentiate this network)")
        # a precision=None standard MLP: its derivative kinds from K1-TF32
        self._tf32 = (self._compute_dtype is None and qualifies
                      and surrogate.net.precision == "default")
        self._buckets = tuple(min_bucket << i for i in range(
            (max_bucket // min_bucket).bit_length()))
        self._rungs: dict = {}        # (kind, bucket) -> _Rung
        self._cache_keys: set = set()  # (kind, bucket) ever first-touched
        self._quarantined: set = set()  # (kind, bucket) that failed then
        self._aot: dict = {}  # (kind, bucket) -> installed program
        self._metrics = registry if registry is not None \
            else default_registry()
        # how a rung's graph is made: None runs the programs eagerly (the
        # CPU); on the card a CUDA graph in the engine's one pool, held in
        # a list so that a failure can replace it (_attempt)
        self._make_graph = None
        self._pool: list = []
        if surrogate.device.type == "cuda":
            pool = self._pool
            pool.append(SharedPool(surrogate.device))
            self._make_graph = lambda stream: CudaGraph(stream, pool[0].id)

    # ------------------------------------------------------------------ #
    @property
    def bucket_sizes(self) -> tuple:
        return self._buckets

    @property
    def n_buckets(self) -> int:
        return len(self._buckets)

    @property
    def compile_cache_size(self) -> int:
        """Distinct (query kind, bucket) programs built so far — bounded by
        ``kinds_used * n_buckets`` whatever the query sizes."""
        return len(self._cache_keys)

    def bucket_for(self, n: int) -> int:
        """The bucket a chunk of ``n`` rows pads to on a healthy engine;
        quarantined rungs reroute upward (:meth:`quarantined_buckets`)."""
        return min(max(_next_pow2(n), self._buckets[0]), self._buckets[-1])

    def quarantined_buckets(self) -> dict:
        """``{kind_label: [bucket, ...]}`` of rungs quarantined by
        first-touch failures (empty when the engine is healthy)."""
        out: dict = {}
        for kind, bucket in sorted(self._quarantined, key=lambda kb: kb[1]):
            out.setdefault(_label(kind), []).append(bucket)
        return out

    def quarantine_snapshot(self) -> list:
        """JSON-able ``[(kind_spec, bucket), ...]`` of quarantined rungs:
        an engine rebuilt from the same artifact re-applies it with
        :meth:`restore_quarantine`, so a dead rung is not served again as
        healthy."""
        return sorted((self.spec_for(kind), int(b))
                      for kind, b in self._quarantined)

    def restore_quarantine(self, items) -> None:
        """Re-apply a :meth:`quarantine_snapshot`."""
        for spec, bucket in items:
            self._quarantined.add((self.kind_key(spec), int(bucket)))

    # ------------------------------------------------------------------ #
    # query-kind specs: "u", "residual", "d:<var>:<order>:<component>"
    # ------------------------------------------------------------------ #
    def kind_key(self, spec: str):
        """Internal kind key for a query-kind spec string: ``"u"``,
        ``"residual"``, or ``"d:<var>:<order>:<component>"`` (var by name
        or index; order/component default to 1/0)."""
        if spec in ("u", "residual"):
            return spec
        if isinstance(spec, str) and spec.startswith("d:"):
            parts = spec.split(":")
            var = parts[1]
            idx = (int(var) if var.lstrip("-").isdigit()
                   else self.surrogate.varnames.index(var))
            if not 0 <= idx < self.surrogate.ndim:
                raise ValueError(f"derivative spec {spec!r}: coordinate "
                                 f"index {idx} out of range")
            order = int(parts[2]) if len(parts) > 2 else 1
            comp = int(parts[3]) if len(parts) > 3 else 0
            return ("d", idx, order, comp)
        raise ValueError(
            f"unknown query-kind spec {spec!r} (expected 'u', 'residual', "
            "or 'd:<var>[:<order>[:<component>]]')")

    def spec_for(self, key) -> str:
        """Inverse of :meth:`kind_key`."""
        if isinstance(key, str):
            return key
        _, idx, order, comp = key
        return f"d:{idx}:{order}:{comp}"

    def op_for(self, spec: str):
        """The batched query callable ``X -> result`` for a kind spec —
        what a per-kind :class:`~tensordiffeq_tpu_torch.serving.
        RequestBatcher` wraps."""
        key = self.kind_key(spec)
        if key == "u":
            return self.u
        if key == "residual":
            return self.residual
        _, idx, order, comp = key
        return lambda X: self.derivative(X, idx, order=order,
                                         component=comp)

    def make_batched(self, spec: str):
        """The program factory for a kind spec: ``make()`` returns the
        ``(params, X) -> out`` program that every rung of the kind runs
        (eagerly, at the rung's padded shape, it is the graph's referee)."""
        return self._make_fn(self.kind_key(spec))

    def _make_fn(self, key):
        sur = self.surrogate
        if key == "residual" and sur.point_residual is None:
            raise ValueError(
                "this surrogate has no f_model attached; pass f_model= "
                "to Surrogate.load (or export from a compiled solver) "
                "to enable residual queries")
        if not isinstance(key, str) and not 0 <= key[3] < sur.n_out:
            # the scalar-output path below never consults UFn.__getitem__,
            # which would otherwise catch this
            raise ValueError(f"component {key[3]} out of range for an "
                             f"n_out={sur.n_out} surrogate")
        if self._compute_dtype is not None or (
                self._tf32 and not isinstance(key, str)):
            if key not in self._mixed:
                self._mixed[key] = self._make_fn_mixed(key)
            if self._mixed[key] is not None:
                return self._mixed[key]
        if key == "u":
            apply_fn = sur.apply_fn
            return lambda: apply_fn
        if key == "residual":
            point_res = sur.point_residual

            def make_res():
                def batched(params, Xb):
                    u = make_ufn(sur.apply_fn, params, sur.varnames,
                                 sur.n_out)
                    return vmap_residual(point_res, u, sur.ndim)(Xb)
                return batched

            return make_res
        _, idx, order, component = key

        def make_d():
            def batched(params, Xb):
                u = make_ufn(sur.apply_fn, params, sur.varnames, sur.n_out)
                dfn = d(u if sur.n_out == 1 else u[component], idx, order)
                return vmap(
                    lambda pt: dfn(*(pt[i] for i in range(sur.ndim))))(Xb)
            return batched

        return make_d

    def _make_fn_mixed(self, key):
        """The Taylor-table program factory of one kind (module docstring:
        the bf16 flavor, or the TF32 flavor of a ``precision=None`` net's
        derivative kinds), or ``None`` when the kind is outside the Taylor
        propagation's reach (a derivative order it does not serve, an
        ``f_model`` it cannot analyse): that kind keeps its f32 program."""
        from ..ops.cuda_taylor import build_cuda_table_fn
        from ..ops.fused import analyze_f_model, make_fused_residual
        from ..ops.taylor import supported

        sur = self.surrogate
        shapes = [tuple(W.shape) for W, _ in sur.net.param_tree(sur.params)]

        def table_fn(requests):
            return build_cuda_table_fn(requests, shapes, device=sur.device,
                                       compute_dtype=self._compute_dtype,
                                       precision=sur.net.precision)

        if key == "u":
            tab = table_fn({()})
            return lambda: lambda params, Xb: tab(params, Xb)[()]
        if key == "residual":
            reqs = analyze_f_model(sur.point_residual, sur.varnames,
                                   sur.n_out)
            if reqs is None:
                return None
            fused = make_fused_residual(sur.point_residual, sur.varnames,
                                        sur.n_out, reqs,
                                        table_producer=table_fn(reqs))
            return lambda: fused
        _, idx, order, component = key
        mi = (idx,) * int(order)
        if not supported(mi):
            return None
        tab = table_fn({mi})
        return lambda: lambda params, Xb: tab(params, Xb)[mi][:, component]

    # ------------------------------------------------------------------ #
    def install_aot(self, spec: str, bucket: int, fn) -> None:
        """Install a ready-made program ``(params, X) -> out`` for one
        (kind, bucket) rung.  The rung then runs it on a fresh padded
        device copy of each chunk instead of its own graph; a program that
        fails on first use is dropped and the rung falls back to its own
        program (a degraded warm start, never a dead rung)."""
        bucket = int(bucket)
        if bucket not in self._buckets:
            raise ValueError(f"bucket {bucket} is not on this engine's "
                             f"ladder {self._buckets}")
        self._aot[(self.kind_key(spec), bucket)] = fn

    def has_aot(self, spec: str, bucket: int) -> bool:
        """Is an installed program still live for this rung?  (False after
        a first-use failure dropped it.)"""
        return (self.kind_key(spec), int(bucket)) in self._aot

    # ------------------------------------------------------------------ #
    def _rung_for(self, kind, bucket: int, make_fn: Callable) -> _Rung:
        rung = self._rungs.get((kind, bucket))
        if rung is None:
            rung = self._rungs[(kind, bucket)] = _Rung(self, kind, bucket,
                                                        make_fn())
        return rung

    def _bucket_for_routing(self, kind, n: int) -> int:
        """The bucket a chunk routes to: the :meth:`bucket_for` rung, or
        the next larger healthy rung when that one is quarantined.  Raises
        :class:`EngineDegraded` when no usable rung remains for this
        kind."""
        base = self.bucket_for(n)
        for cand in self._buckets:
            if cand >= base and (kind, cand) not in self._quarantined:
                return cand
        raise EngineDegraded(kind, [b for b in self._buckets if b >= base])

    def _quarantine(self, kind, bucket: int, exc: Exception):
        """First-touch failure of a (kind, bucket) program: quarantine THE
        RUNG, not the engine — later chunks reroute to the next rung (more
        padding, the same math) and every other kind keeps serving."""
        self._quarantined.add((kind, bucket))
        self._rungs.pop((kind, bucket), None)
        klabel = _label(kind)
        self._metrics.counter("serving.engine.quarantined",
                              kind=klabel, bucket=bucket).inc()
        log_event("serving",
                  f"quarantined kind={klabel} bucket={bucket} after a "
                  f"first-touch failure ({type(exc).__name__}: {exc}); "
                  "rerouting to the next bucket", level="warning",
                  verbose=False, kind_label=klabel, bucket=bucket,
                  error=f"{type(exc).__name__}: {exc}")

    def _run(self, kind, make_fn: Callable, X: np.ndarray):
        """Pad one ``<= max_bucket`` chunk to its rung, run, trim.  A
        first-touch failure quarantines that rung and retries on the next
        larger one; a failure on a proven rung is a runtime fault and
        propagates (the batcher's retry and breaker own those)."""
        n = X.shape[0]
        bucket, out, first_touch, used_aot, key = self._attempt(
            kind, make_fn, X, n)
        if first_touch:
            self._cache_keys.add(key)
            klabel = _label(kind)
            self._metrics.counter(
                "serving.engine.aot_loads" if used_aot
                else "serving.engine.compiles",
                kind=klabel, bucket=bucket).inc()
            log_event("serving",
                      f"{'loaded installed program' if used_aot else 'built'}"
                      f" kind={klabel} bucket={bucket} "
                      f"({len(self._cache_keys)} programs cached)",
                      verbose=False, kind_label=klabel, bucket=bucket,
                      aot=used_aot, programs=len(self._cache_keys))
        self._metrics.counter("serving.engine.points").inc(int(n))
        self._metrics.histogram("serving.engine.pad_waste").observe(
            (bucket - n) / bucket)
        return out

    def _run_aot(self, aot: Callable, X: np.ndarray, bucket: int):
        n = X.shape[0]
        Xd = torch.zeros(bucket, X.shape[1], dtype=torch.float32,
                         device=self.surrogate.device)
        Xd[:n].copy_(torch.from_numpy(X))
        with matmul_precision(self.surrogate.net.precision), \
                torch.no_grad():
            out = aot(self.surrogate.params, Xd)
        return _tree_map(lambda a: a[:n].cpu().numpy(), out)

    def _attempt(self, kind, make_fn: Callable, X: np.ndarray, n: int):
        while True:
            bucket = self._bucket_for_routing(kind, n)
            key = (kind, bucket)
            first_touch = key not in self._cache_keys
            used_aot = False
            try:
                aot = self._aot.get(key)
                if aot is not None:
                    try:
                        out = self._run_aot(aot, X, bucket)
                        used_aot = True
                    except Exception as e:
                        # a bad installed program degrades to the rung's
                        # own program on the SAME rung
                        del self._aot[key]
                        klabel = _label(kind)
                        self._metrics.counter("serving.engine.aot_failed",
                                              kind=klabel,
                                              bucket=bucket).inc()
                        log_event("serving",
                                  f"installed program kind={klabel} "
                                  f"bucket={bucket} failed "
                                  f"({type(e).__name__}: {e}); falling "
                                  "back to the rung's own program",
                                  level="warning", verbose=False,
                                  kind_label=klabel, bucket=bucket,
                                  error=f"{type(e).__name__}: {e}")
                        out = self._rung_for(kind, bucket, make_fn).run(X)
                        if not first_touch:
                            # a proven rung built its program at request
                            # time: the compile counter must see it
                            self._metrics.counter(
                                "serving.engine.compiles",
                                kind=klabel, bucket=bucket).inc()
                else:
                    out = self._rung_for(kind, bucket, make_fn).run(X)
            except Exception as e:
                if self._pool:
                    # a capture that failed inside the CUDA runtime leaves
                    # the allocator recording into its pool, which then
                    # refuses every later capture: the rungs to come take
                    # a new pool (those captured keep theirs)
                    self._pool[0] = SharedPool(self.surrogate.device)
                if not first_touch:
                    raise
                self._quarantine(kind, bucket, e)
                continue
            return bucket, out, first_touch, used_aot, key

    def _query(self, kind, make_fn: Callable, X):
        X = np.asarray(X, np.float32)
        ndim = self.surrogate.ndim
        if (X.ndim >= 2 and X.shape[-1] != ndim) \
                or (X.ndim == 1 and X.size != ndim):
            # a silent reshape would pair coordinates across row
            # boundaries: reject mis-shaped matrices and flat multi-point
            # arrays, keep the single-point [ndim] convenience
            raise ValueError(
                f"query has {X.shape[-1]} coordinate columns but this "
                f"surrogate has {ndim} ({', '.join(self.surrogate.varnames)})")
        X = np.ascontiguousarray(X.reshape(-1, ndim))
        top = self._buckets[-1]
        chunks = [self._run(kind, make_fn, X[i:i + top])
                  for i in range(0, max(X.shape[0], 1), top)]
        if len(chunks) == 1:
            return chunks[0]
        if isinstance(chunks[0], (tuple, list)):
            return type(chunks[0])(np.concatenate(parts)
                                   for parts in zip(*chunks))
        return np.concatenate(chunks)

    # ------------------------------------------------------------------ #
    def u(self, X) -> np.ndarray:
        """Network evaluation ``u(X) -> [N, n_out]``."""
        return self._query("u", self._make_fn("u"), X)

    def derivative(self, X, var: Union[str, int], order: int = 1,
                   component: int = 0) -> np.ndarray:
        """``order``-th derivative of output ``component`` along coordinate
        ``var`` (name or index), batched: ``u_x = derivative(X, "x")``,
        ``u_xx = derivative(X, "x", 2)``.  Returns ``[N]``."""
        sur = self.surrogate
        idx = var if isinstance(var, int) else sur.varnames.index(var)
        key = ("d", idx, int(order), int(component))
        return self._query(key, self._make_fn(key), X)

    def residual(self, X):
        """PDE residual ``f(X) -> [N]`` (tuple of ``[N]`` for systems)
        through the generic per-point engine.  With installed residual
        programs the query also works with no ``f_model`` attached: rungs
        they cover serve, and a rung without one fails its first touch and
        is quarantined."""
        if self.surrogate.point_residual is not None:
            return self._query("residual", self._make_fn("residual"), X)
        if any(k == "residual" for (k, _b) in self._aot):
            def make_unavailable():
                def batched(params, Xb):
                    raise ValueError(
                        "residual rung has no installed program and this "
                        "surrogate has no f_model attached")
                return batched
            return self._query("residual", make_unavailable, X)
        raise ValueError(
            "this surrogate has no f_model attached; pass f_model= to "
            "Surrogate.load (or export from a compiled solver) to "
            "enable residual queries")

    def predict(self, X):
        """``(u, f)`` as ``CollocationSolverND.predict`` returns them
        (``f`` is ``None`` without an attached ``f_model``)."""
        u = self.u(X)
        if self.surrogate.point_residual is None:
            return u, None
        f = self.residual(X)
        if isinstance(f, tuple) and len(f) == 1:
            f = f[0]
        return u, f
