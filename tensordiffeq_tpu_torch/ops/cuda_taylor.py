"""Hand-written CUDA Taylor-table kernels (K1 forward, K2 backward) for the
fused residual engine.

Counterpart of the JAX package's ``ops/pallas_taylor.py::
build_pallas_table_fn``: :func:`build_cuda_table_fn` returns
``table_fn(layers, X) -> {mi: [N, n_out]}``, a drop-in ``table_producer``
for :func:`~.fused.make_fused_residual`.  The kernels live in
``csrc/taylor_table.cu`` (its header note says what bounds them on the H100
and how the design answers it) over the device code in
``csrc/taylor_common.cuh``, which the fused minimax step K3
(``csrc/minimax_step.cu``, :mod:`.cuda_minimax`) shares.  :func:`build`
compiles every source under ``csrc/`` with ``nvcc`` for ``sm_90a`` into
one plain C-ABI shared library at first use and loads it with ``ctypes``.

Dispatch is by the tensors' device, never by a fallback:

* CPU tensors take the plain flavor (:func:`~.taylor.taylor_derivatives`
  with ``flat_matmul=True``), and no kernel launch is counted.
* CUDA tensors launch K1 (and K2 in the backward pass, through a
  ``torch.autograd.Function``), or raise.

Each kernel wrapper counts its launches in an integer attribute
(``k1_forward.launches``, ``k2_backward.launches``), so a run can show that
its main path went through the kernels.

Both kernels have a second flavor, the mixed precision of the JAX package's
``compute_dtype=jnp.bfloat16`` (``csrc/taylor_common.cuh``: every layer's
product on operands rounded to bf16 with f32 sums, the stack's cotangent and
``dW`` rounded to bf16 where the reference's jaxpr rounds them), launched by
:func:`k1_forward_bf16` and :func:`k2_backward_bf16`, which count their own
launches; ``build_cuda_table_fn(compute_dtype=torch.bfloat16)`` takes them,
and its CPU flavor is ``taylor_derivatives(compute_dtype=torch.bfloat16)``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Sequence

import torch

from ..utils import resolve_compute_dtype, resolve_device
from .taylor import canonical, channel_order, taylor_derivatives

MAX_LAYERS = 16    # MAXL in csrc/taylor_common.cuh
MAX_CHANNELS = 16  # MAXC in csrc/taylor_common.cuh
# the residual tape K3 interprets (csrc/minimax_step.cu, ops/residual_tape.py)
MAX_TAPE_INPUTS = 48  # MAXTIN: table columns and coordinates the tape reads
MAX_TAPE_OPS = 96     # MAXTOPS
MAX_TAPE_CONSTS = 32  # MAXTCONST
MAX_EQUATIONS = 8     # MAXEQ: residual equations E
BLOCK_ROWS = 128  # BLK_M: rows of a product's block tile, the tile's cap
NARROW_N = 16     # NARROW_N: products this narrow stay SIMT loops

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

_lib = None
build_seconds = None  # wall time of the nvcc build this process ran


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused the kernel source."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error (refused configuration,
    too much shared memory, or a fault reported by the runtime)."""


def find_nvcc() -> str:
    """``nvcc`` on ``PATH``, else under ``$CUDA_HOME/bin`` or
    ``/usr/local/cuda/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise KernelBuildError(
        "nvcc not found on PATH, under $CUDA_HOME/bin or /usr/local/cuda/bin")


def sources() -> list:
    """Every file under ``csrc/`` (the ``.cu`` translation units and the
    headers they share), sorted by name."""
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def source_digest() -> str:
    """Digest over the names and contents of every file under ``csrc/``: an
    edited header changes it as an edited kernel does."""
    h = hashlib.sha256()
    for path in sources():
        h.update(os.path.basename(path).encode() + b"\0")
        with open(path, "rb") as fh:
            h.update(fh.read())
        h.update(b"\0")
    return h.hexdigest()[:12]


def _nvcc_build(so: str):
    """Compile each ``.cu`` under ``csrc/`` with its own ``nvcc`` (all
    started together), link the objects into one shared library, and move
    it into place under ``so``."""
    nvcc = find_nvcc()
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC"]
    tmpdir = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        units = [p for p in sources() if p.endswith(".cu")]
        objs = [os.path.join(tmpdir, os.path.basename(p) + ".o")
                for p in units]
        procs = [subprocess.Popen([nvcc] + flags + ["-c", src, "-o", obj],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for src, obj in zip(units, objs)]
        errors = []
        for src, proc in zip(units, procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{os.path.basename(src)} "
                              f"({proc.returncode}):\n{err[-4000:]}")
        if errors:
            raise KernelBuildError("nvcc failed: " + "\n".join(errors))
        tmp = os.path.join(tmpdir, "lib.so")
        res = subprocess.run([nvcc] + flags + ["-shared", "-o", tmp] + objs,
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise KernelBuildError(
                f"nvcc link failed ({res.returncode}):\n{res.stderr[-4000:]}")
        # rename into place: a concurrent process never loads a half-written
        # library
        os.replace(tmp, so)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def build() -> ctypes.CDLL:
    """Compile every source under ``csrc/`` into one shared library (once
    per version of the sources, into the git-ignored ``_build/``) and load
    it.  Idempotent."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    so = os.path.join(BUILD_DIR, f"libtdq_kernels_{source_digest()}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.perf_counter()
        _nvcc_build(so)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(so)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # the int before the stream: 1 launches the bf16-operand flavor
    lib.tdq_taylor_fwd.argtypes = [ptr, ptr, ptr, i32, i32, ptr, ptr, i32,
                                   ptr]
    lib.tdq_taylor_bwd.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32,
                                   i32, i32, ptr, ptr, i32, ptr]
    lib.tdq_minimax_step.argtypes = [ptr] * 8 + [i32, i32, i32] + \
        [ptr] * 4 + [i32, ptr]
    lib.tdq_device_info.argtypes = [i32, ptr]
    lib.tdq_limits.argtypes = [ptr]
    lib.tdq_minimax_limits.argtypes = [ptr]
    for fn in (lib.tdq_taylor_fwd, lib.tdq_taylor_bwd, lib.tdq_minimax_step,
               lib.tdq_device_info, lib.tdq_limits, lib.tdq_minimax_limits):
        fn.restype = i32
    limits = (ctypes.c_int * 5)()
    lib.tdq_limits(limits)
    tape = (ctypes.c_int * 4)()
    lib.tdq_minimax_limits(tape)
    got = (limits[0], limits[1], limits[3], limits[4], *tape)
    want = (MAX_LAYERS, MAX_CHANNELS, NARROW_N, BLOCK_ROWS, MAX_TAPE_INPUTS,
            MAX_TAPE_OPS, MAX_TAPE_CONSTS, MAX_EQUATIONS)
    if got != want:
        raise KernelBuildError(
            f"kernel limits {got} disagree with the wrapper's {want}")
    # the shared memory a block needs besides its wavefront buffers
    lib.stage_bytes = int(limits[2])
    _lib = lib
    return lib


def slot_stride(n: int) -> int:
    """Floats between the per-block partial slots of ``n`` values: a
    multiple of 4, so each slot starts 16-byte aligned (``slot_stride`` in
    ``csrc/taylor_common.cuh``)."""
    return -(-n // 4) * 4


def _check(err: int, what: str):
    if err != 0:
        raise KernelLaunchError(f"{what}: CUDA error {err}")


# ------------------------------------------------------------------ #
# host-side plan: the channel schedule and the packed network layout
# ------------------------------------------------------------------ #
def channel_schedule(requests: set) -> tuple[list, list]:
    """Compile the Faà di Bruno recurrence for ``requests`` into the
    kernel's integer schedule.  Returns ``(channels, rows)``: the wavefront
    channels in :func:`~.taylor.channel_order`, and per channel
    ``(order, idx)`` where ``idx`` lists the channels its recurrence reads —
    order 1: ``(direction,)``; 2: firsts ``(i, j)``; 3: firsts ``(i, j,
    k)`` then seconds ``(ij, ik, jk)``; 4 (unmixed along k): ``(k, kk,
    kkk)``."""
    channels = channel_order(requests)
    pos = {mi: c for c, mi in enumerate(channels)}
    rows = []
    for mi in channels:
        o = len(mi)
        if o == 0:
            idx = ()
        elif o == 1:
            idx = (mi[0],)
        elif o == 2:
            idx = (pos[(mi[0],)], pos[(mi[1],)])
        elif o == 3:
            i, j, k = mi
            idx = (pos[(i,)], pos[(j,)], pos[(k,)],
                   pos[canonical((i, j))], pos[canonical((i, k))],
                   pos[canonical((j, k))])
        else:
            k = mi[0]
            idx = (pos[(k,)], pos[(k, k)], pos[(k, k, k)])
        rows.append((o, idx))
    return channels, rows


class _Plan:
    """Everything a launch needs that depends only on the request set and
    the layer shapes: the schedule and net descriptors as C int arrays, and
    the tile sizes (fixed at first launch from the card's limits)."""

    def __init__(self, requests: set, layer_shapes: Sequence[tuple]):
        self.layer_shapes = [(int(a), int(b)) for a, b in layer_shapes]
        L = len(self.layer_shapes)
        if not 2 <= L <= MAX_LAYERS:
            raise ValueError(
                f"the Taylor-table kernels take 2..{MAX_LAYERS} layers, got {L}")
        for (_, fo), (fi, _) in zip(self.layer_shapes[:-1],
                                    self.layer_shapes[1:]):
            if fo != fi:
                raise ValueError(f"layer shapes do not chain: {layer_shapes}")
        self.d = self.layer_shapes[0][0]
        self.n_out = self.layer_shapes[-1][1]
        self.channels, rows = channel_schedule(requests)
        self.C = len(self.channels)
        if self.C > MAX_CHANNELS:
            raise ValueError(
                f"request set needs {self.C} wavefront channels; the kernels "
                f"hold at most {MAX_CHANNELS}")
        self.pos = {mi: c for c, mi in enumerate(self.channels)}
        self.mis = sorted({canonical(m) for m in requests} | {()},
                          key=lambda t: (len(t), t))
        # the wavefront row stride in floats: every width padded to 16 fits
        # in a row, and ld = 8 (mod 32) keeps the tensor-core fragment loads
        # free of bank conflicts (csrc/taylor_common.cuh)
        self.width = max(max(s) for s in self.layer_shapes)
        self.ld = 32 * -(-self.width // 32) + 8
        offs, o = [], 0
        for fi, fo in self.layer_shapes:
            offs.append((o, o + fi * fo))
            o += fi * fo + fo
        self.offsets = offs
        self.P_total = o

        net = [L, self.d, self.n_out, self.ld, self.P_total]
        pad = [0] * (MAX_LAYERS - L)
        net += [fi for fi, _ in self.layer_shapes] + pad
        net += [fo for _, fo in self.layer_shapes] + pad
        net += [w for w, _ in offs] + pad
        net += [b for _, b in offs] + pad
        self.net_h = (ctypes.c_int * len(net))(*net)
        sched = [self.C] + [o for o, _ in rows] + [0] * (MAX_CHANNELS - self.C)
        for _, idx in rows:
            sched += list(idx) + [0] * (6 - len(idx))
        sched += [0] * (6 * (MAX_CHANNELS - self.C))
        self.sched_h = (ctypes.c_int * len(sched))(*sched)
        self.tiles = None  # (TP_fwd, TP_bwd, n_sm) after the first launch

    def tile_sizes(self, device: torch.device) -> tuple[int, int, int]:
        """Points per block for K1 (2 wavefront buffers) and K2/K3 (3): the
        most whose rows, padded to the tensor cores' 16, fit the card's
        opt-in shared memory beside the weight stage, at most one block tile
        of rows."""
        if self.tiles is None:
            lib = build()
            info = (ctypes.c_int * 2)()
            index = (device.index if device.index is not None
                     else torch.cuda.current_device())
            _check(lib.tdq_device_info(index, info), "cudaDeviceGetAttribute")
            smem, n_sm = int(info[0]), int(info[1])
            row_bytes = 4 * self.ld
            tps = []
            for n_buf in (2, 3):
                rows = min((smem - lib.stage_bytes) // (n_buf * row_bytes),
                           BLOCK_ROWS) // 16 * 16
                if rows < self.C:
                    raise KernelLaunchError(
                        f"width {self.width} x {self.C} channels does not "
                        f"fit 16 rows in {smem} B of shared memory")
                tps.append(rows // self.C)
            self.tiles = (tps[0], tps[1], n_sm)
        return self.tiles

    def pack(self, flat_layers) -> torch.Tensor:
        """The parameters as one contiguous vector (W_0, b_0, W_1, ...)."""
        return torch.cat([t.reshape(-1) for t in flat_layers])

    def unpack(self, flat: torch.Tensor) -> list:
        out = []
        for (fi, fo), (ow, ob) in zip(self.layer_shapes, self.offsets):
            out += [flat[ow:ow + fi * fo].view(fi, fo), flat[ob:ob + fo]]
        return out


def _check_cuda_inputs(plan: _Plan, X: torch.Tensor, flat: torch.Tensor):
    if X.device.type != "cuda" or flat.device != X.device:
        raise ValueError("the CUDA Taylor-table kernels need X and every "
                         "layer on one CUDA device")
    if X.dtype != torch.float32 or flat.dtype != torch.float32:
        raise TypeError("the CUDA Taylor-table kernels take float32 only")
    if X.ndim != 2 or X.shape[1] != plan.d or X.shape[0] == 0:
        raise ValueError(f"X must be [N>0, {plan.d}], got {tuple(X.shape)}")
    if not X.is_contiguous():
        raise ValueError("X must be contiguous")
    if flat.numel() != plan.P_total:
        raise ValueError(f"layers hold {flat.numel()} values, the plan "
                         f"expects {plan.P_total}")


def _k1(plan: _Plan, X: torch.Tensor, flat: torch.Tensor,
        bf16: int) -> torch.Tensor:
    _check_cuda_inputs(plan, X, flat)
    lib = build()
    tp, _, _ = plan.tile_sizes(X.device)
    N = X.shape[0]
    table = torch.empty((plan.C, N, plan.n_out), device=X.device,
                        dtype=torch.float32)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    _check(lib.tdq_taylor_fwd(X.data_ptr(), flat.data_ptr(), table.data_ptr(),
                              N, tp, plan.net_h, plan.sched_h, bf16, stream),
           "taylor_table K1 launch")
    return table


def k1_forward(plan: _Plan, X: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """Launch K1: the ``[C, N, n_out]`` channel table at points ``X``."""
    table = _k1(plan, X, flat, 0)
    k1_forward.launches += 1
    return table


def k1_forward_bf16(plan: _Plan, X: torch.Tensor,
                    flat: torch.Tensor) -> torch.Tensor:
    """Launch K1's bf16-operand flavor (the module docstring): the table of
    ``taylor_derivatives(compute_dtype=torch.bfloat16)``."""
    table = _k1(plan, X, flat, 1)
    k1_forward_bf16.launches += 1
    return table


k1_forward.launches = 0
k1_forward_bf16.launches = 0


def _k2(plan: _Plan, X: torch.Tensor, flat: torch.Tensor, g: torch.Tensor,
        bf16: int) -> tuple[torch.Tensor, torch.Tensor]:
    _check_cuda_inputs(plan, X, flat)
    N = X.shape[0]
    if tuple(g.shape) != (plan.C, N, plan.n_out) or g.dtype != torch.float32 \
            or g.device != X.device or not g.is_contiguous():
        raise ValueError(f"cotangent must be a contiguous float32 "
                         f"[{plan.C}, {N}, {plan.n_out}] on {X.device}")
    lib = build()
    _, tp, n_sm = plan.tile_sizes(X.device)
    n_tiles = -(-N // tp)
    G = min(n_tiles, n_sm)
    R = tp * plan.C
    L = len(plan.layer_shapes)
    opts = dict(device=X.device, dtype=torch.float32)
    dX = torch.empty((N, plan.d), **opts)
    part = torch.empty((G, slot_stride(plan.P_total)), **opts)
    ws = torch.empty((G * (2 * L - 3) * R * plan.ld,), **opts)
    dflat = torch.empty((plan.P_total,), **opts)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    _check(lib.tdq_taylor_bwd(X.data_ptr(), flat.data_ptr(), g.data_ptr(),
                              dX.data_ptr(), part.data_ptr(), ws.data_ptr(),
                              dflat.data_ptr(), N, tp, G, plan.net_h,
                              plan.sched_h, bf16, stream),
           "taylor_table K2 launch")
    return dX, dflat


def k2_backward(plan: _Plan, X: torch.Tensor, flat: torch.Tensor,
                g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K2 (and its deterministic cross-block reduction): returns
    ``(dX [N, d], dflat [P_total])`` for table cotangents ``g [C, N,
    n_out]``."""
    out = _k2(plan, X, flat, g, 0)
    k2_backward.launches += 1
    return out


def k2_backward_bf16(plan: _Plan, X: torch.Tensor, flat: torch.Tensor,
                     g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K2's bf16-operand flavor: the cotangents of
    :func:`k1_forward_bf16`'s table, ``dX`` and ``dW`` rounded to bf16 as
    the reference's jaxpr rounds them (``db`` not)."""
    out = _k2(plan, X, flat, g, 1)
    k2_backward_bf16.launches += 1
    return out


k2_backward.launches = 0
k2_backward_bf16.launches = 0

# (K1, K2) of each flavor
FLAVORS = {None: (k1_forward, k2_backward),
           torch.bfloat16: (k1_forward_bf16, k2_backward_bf16)}

# every kernel wrapper of the package, K3's included once its module is
# imported; reset_launch_counts() zeroes them all
COUNTED = [k1_forward, k2_backward, k1_forward_bf16, k2_backward_bf16]


def reset_launch_counts():
    for fn in COUNTED:
        fn.launches = 0


class _TaylorTable(torch.autograd.Function):
    """K1 forward, K2 backward: the ``jax.custom_vjp`` pair of the Pallas
    version as one autograd node over ``(X, W_0, b_0, W_1, ...)``."""

    @staticmethod
    def forward(ctx, plan, kernels, X, *flat_layers):
        flat = plan.pack(flat_layers)
        ctx.plan, ctx.k2 = plan, kernels[1]
        ctx.save_for_backward(X, flat)
        return kernels[0](plan, X, flat)

    @staticmethod
    def backward(ctx, g):
        X, flat = ctx.saved_tensors
        dX, dflat = ctx.k2(ctx.plan, X, flat, g.contiguous())
        return (None, None, dX if ctx.needs_input_grad[2] else None,
                *ctx.plan.unpack(dflat))


def build_cuda_table_fn(requests: set, layer_shapes: Sequence[tuple],
                        device="cuda", compute_dtype=None):
    """Build ``table_fn(layers, X) -> {mi: [N, n_out]}`` backed by the CUDA
    kernels (the primal ``()`` is implied).

    Args:
      requests: canonical multi-indices (mixed 3rd and unmixed 4th order
        included, as :func:`~.taylor.supported`).
      layer_shapes: ``[(in, out), ...]`` static layer dims.
      device: where the caller means to run; ``"cuda"`` (the default)
        raises :class:`~..utils.CudaUnavailableError` without a card.  The
        returned function dispatches on each call's tensors: CPU tensors
        take the plain flavor, CUDA tensors launch the kernels.
      compute_dtype: ``None`` (K1/K2) or ``"bfloat16"``/``torch.bfloat16``
        (their bf16-operand flavor, and the plain bf16 flavor on the CPU).
    """
    resolve_device(device)
    dtype = resolve_compute_dtype(compute_dtype)
    plan = _Plan(set(map(canonical, requests)), layer_shapes)

    def table_fn(layers, X):
        if X.device.type == "cpu":
            table = taylor_derivatives(layers, X, set(plan.mis),
                                       flat_matmul=True, compute_dtype=dtype)
            return {mi: table[mi] for mi in plan.mis}
        flat_layers = [t for pair in layers for t in pair]
        table = _TaylorTable.apply(plan, FLAVORS[dtype], X.contiguous(),
                                   *flat_layers)
        return {mi: table[plan.pos[mi]] for mi in plan.mis}

    table_fn.plan = plan
    table_fn.compute_dtype = dtype
    return table_fn


# ------------------------------------------------------------------ #
# work counts, for the bound the measurements are held against
# ------------------------------------------------------------------ #
# float operations counted from csrc/taylor_table.cu, common subexpressions
# shared: deriving z (tanh counted as one), d1, ..., d5 of the tanh chain
# from the lower ones; one channel's Faa di Bruno line and its transpose,
# per order
_CHAIN_FLOPS = (1, 2, 2, 4, 6, 5)
_ACT_FLOPS = {1: 1, 2: 4, 3: 12, 4: 19}
_VJP_FLOPS = {1: 4, 2: 13, 3: 39, 4: 40}


def _tensor_products(plan: _Plan) -> list:
    """Per layer, the flops per point of its channel product when it runs
    on the tensor cores (past layer 0, wider than ``NARROW_N``), else 0."""
    return [0] + [2 * plan.C * fi * fo if fo > NARROW_N else 0
                  for fi, fo in plan.layer_shapes[1:]]


def _mean_passes(plan: _Plan, fwd_passes: int, back_passes: int) -> dict:
    """Passes per tensor-core product of each kernel, averaged over its
    ``flop_count`` ``tensor`` share, ``fwd_passes`` for a forward product
    and ``back_passes`` for a dW or dH product."""
    tc = _tensor_products(plan)
    fwd, back = sum(tc[:-1]), 2 * sum(tc)
    return {"k1": float(fwd_passes),
            "k2": ((fwd * fwd_passes + back * back_passes) / (fwd + back)
                   if fwd + back else float(back_passes))}


def tensor_passes(plan: _Plan, compute_dtype=None) -> dict:
    """TF32 passes per tensor-core product of each kernel, averaged over
    its ``flop_count`` ``tensor`` share: 3 in the f32 flavor (3xTF32); in
    the bf16 flavor 1 for a forward product (two rounded operands) and 2
    for a dW or dH product (the f32 cotangent split in two).  The route
    the kernel takes, not the least the card could take for the work:
    :func:`bf16_bound_passes`."""
    if resolve_compute_dtype(compute_dtype) is None:
        return {"k1": 3.0, "k2": 3.0}
    return _mean_passes(plan, 1, 2)


def bf16_bound_passes(plan: _Plan) -> dict:
    """Dense-bf16 passes per tensor-core product of the bf16 flavor's work
    on the card's fastest route for its types, averaged as
    :func:`tensor_passes` averages: 1 for a forward product (two bf16
    operands), 3 for a dW or dH product (the f32 cotangent's 24 significand
    bits in three bf16 pieces against an exact bf16 operand; three passes
    at the bf16 peak take less time than two at the TF32 peak).  The bound
    prices them at the dense bf16 peak."""
    return _mean_passes(plan, 1, 3)


def flop_count(plan: _Plan, n_points: int) -> dict:
    """Float operations the function of each kernel needs for ``n_points``
    points, not what the kernel happens to do, split by the route the kernel
    takes them on: ``{"k1": {"tensor": ..., "simt": ...}, "k2": ...}``.

    ``tensor``: the channel products of the layers past layer 0 that are
    wider than ``NARROW_N`` (the hidden layers' products, on the tensor
    cores; counted once, as the products they stand for, whatever the
    passes of the route: :func:`tensor_passes`).
    ``simt``: the rest, on the CUDA cores.  K1: the channel matmuls (2 per
    multiply-add; layer 0 is a product only in the primal channel, its
    seeds are copies) and, per hidden unit, the tanh chain up to the
    highest order in the plan plus one Faa di Bruno line per channel.  K2:
    the forward through the hidden layers once (the kernel re-derives each
    layer's input a second time; its choice, not counted), the weight- and
    input-cotangent products, per hidden unit the chain's next order and
    the transposed lines closed onto the primal cotangent, and the sums of
    db and of the seeds' share of dW_0."""
    orders = [len(mi) for mi in plan.channels if mi]
    top = max(orders, default=0)
    shapes = plan.layer_shapes
    w0 = shapes[0][1]
    hidden = sum(fo for _, fo in shapes[:-1])
    mm = [2 * plan.d * w0] + [2 * plan.C * fi * fo for fi, fo in shapes[1:]]
    tc = _tensor_products(plan)
    act = hidden * (sum(_CHAIN_FLOPS[:top + 1])
                    + sum(_ACT_FLOPS[o] for o in orders))
    # d_{top+1}, then gz*d1 + sum_k gd_k*d_{k+1} added to the primal's
    vjp = hidden * (_CHAIN_FLOPS[top + 1] + 2 * (top + 1)
                    + sum(_VJP_FLOPS[o] for o in orders))
    sums = sum(fo for _, fo in shapes) + w0 * orders.count(1)
    k1_tc = sum(tc)
    k2_tc = sum(tc[:-1]) + 2 * sum(tc)
    return {"k1": {"tensor": n_points * k1_tc,
                   "simt": n_points * (sum(mm) - k1_tc + act)},
            "k2": {"tensor": n_points * k2_tc,
                   "simt": n_points * (sum(mm[:-1]) + act + 2 * sum(mm) + vjp
                                       + sums - k2_tc)}}


def byte_count(plan: _Plan, n_points: int) -> dict:
    """Bytes each kernel must move at least: every input read once, every
    output written once (K2's partials and workspace are its own choice and
    not counted)."""
    params = 4 * plan.P_total
    x = 4 * n_points * plan.d
    table = 4 * plan.C * n_points * plan.n_out
    return {"k1": x + params + table,
            "k2": x + params + table + x + params}
