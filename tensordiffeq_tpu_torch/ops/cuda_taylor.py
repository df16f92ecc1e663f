"""Hand-written CUDA Taylor-table kernels (K1 forward, K2 backward) for the
fused residual engine.

Counterpart of the JAX package's ``ops/pallas_taylor.py::
build_pallas_table_fn``: :func:`build_cuda_table_fn` returns
``table_fn(layers, X) -> {mi: [N, n_out]}``, a drop-in ``table_producer``
for :func:`~.fused.make_fused_residual`.  K2 lives in
``csrc/taylor_table.cu`` (its header note says what bounds it on the H100
and how the design answers it) over the device code in
``csrc/taylor_common.cuh``, which the fused minimax step K3
(``csrc/minimax_step.cu``, :mod:`.cuda_minimax`) shares.  K1 has two
routes, chosen by shape (:meth:`_Plan.k1_route`): a persistent kernel on
Hopper's warpgroup products for hidden widths up to 128 and up to 8
channels (``csrc/taylor_fwd_wg.cuh``, :func:`wg_plan`), and the kernel
beside K2 for the other shapes.  :func:`build`
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

A third flavor is the single-pass TF32 product of precision ``"default"``
(the network's ``precision=None``; :func:`~..utils.resolve_flavor`):
every product on its operands' TF32 hi parts (``cvt.rna``) in one
tensor-core pass, f32 sums, in the float32 flavor's layout; K1's wgmma
route streams the hi weight plane alone.  :func:`k1_forward_tf32` and
:func:`k2_backward_tf32` launch it and count their own launches; its
referee is ``taylor_derivatives(emulate_tf32=True)``.  ``"high"`` and
``"highest"`` keep the 3xTF32 float32 flavor, f32-grade and the nearest to
a TPU's bf16x3.  A ``compute_dtype=bfloat16`` request overrides the
precision.  The flavors are keyed ``None``, ``torch.bfloat16`` and
:data:`~..utils.TF32`; the C interface takes them as 0, 1 and 2.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import NamedTuple, Sequence

import torch

from ..utils import TF32, resolve_compute_dtype, resolve_device, resolve_flavor
from .taylor import canonical, channel_order, rna_tf32, taylor_derivatives

MAX_LAYERS = 16    # MAXL in csrc/taylor_common.cuh
MAX_CHANNELS = 16  # MAXC in csrc/taylor_common.cuh
# the residual tape K3 interprets (csrc/minimax_step.cu, ops/residual_tape.py)
MAX_TAPE_INPUTS = 48  # MAXTIN: table columns and coordinates the tape reads
MAX_TAPE_OPS = 96     # MAXTOPS
MAX_TAPE_CONSTS = 32  # MAXTCONST
MAX_EQUATIONS = 8     # MAXEQ: residual equations E
BLOCK_ROWS = 128  # BLK_M: rows of a product's block tile, the tile's cap
NARROW_N = 16     # NARROW_N: products this narrow stay SIMT loops
# the wavefront arrays a block holds, in slots of rows x ld bf16 (an f32
# buffer is two): K1 two f32 buffers in both flavors; K2/K3 three f32
# buffers, or the bf16 flavor's five slots (csrc/taylor_common.cuh:
# reverse_sweep_bf)
K1_SLOTS = 4
BWD_SLOTS = {None: 6, torch.bfloat16: 5}

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
    # the int before the stream: the flavor (FLAVOR_CODE)
    lib.tdq_taylor_fwd.argtypes = [ptr, ptr, ptr, i32, i32, ptr, ptr, i32,
                                   ptr]
    lib.tdq_taylor_bwd.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32,
                                   i32, i32, ptr, ptr, i32, ptr]
    lib.tdq_minimax_step.argtypes = [ptr] * 8 + [i32, i32, i32] + \
        [ptr] * 4 + [i32, ptr]
    lib.tdq_device_info.argtypes = [i32, ptr]
    lib.tdq_limits.argtypes = [ptr]
    lib.tdq_minimax_limits.argtypes = [ptr]
    lib.tdq_workspace_floats.argtypes = [ptr, i32, i32, i32]
    lib.tdq_workspace_floats.restype = ctypes.c_longlong
    # K1's wgmma route: its plan (net, sched, flavor, the card's shared
    # memory and SMs, N, out), and its launch (X, prm, weight chunks, table,
    # N, net, sched, flavor, plan, stream)
    lib.tdq_k1wg_plan.argtypes = [ptr, ptr, i32, i32, i32, i32, ptr]
    lib.tdq_taylor_fwd_wg.argtypes = [ptr, ptr, ptr, ptr, i32, ptr, ptr,
                                      i32, ptr, ptr]
    for fn in (lib.tdq_taylor_fwd, lib.tdq_taylor_bwd, lib.tdq_minimax_step,
               lib.tdq_device_info, lib.tdq_limits, lib.tdq_minimax_limits,
               lib.tdq_k1wg_plan, lib.tdq_taylor_fwd_wg):
        fn.restype = i32
    limits = (ctypes.c_int * 6)()
    lib.tdq_limits(limits)
    tape = (ctypes.c_int * 4)()
    lib.tdq_minimax_limits(tape)
    got = (limits[0], limits[1], limits[3], limits[4], *tape)
    want = (MAX_LAYERS, MAX_CHANNELS, NARROW_N, BLOCK_ROWS, MAX_TAPE_INPUTS,
            MAX_TAPE_OPS, MAX_TAPE_CONSTS, MAX_EQUATIONS)
    if got != want:
        raise KernelBuildError(
            f"kernel limits {got} disagree with the wrapper's {want}")
    # the shared memory a block needs besides its wavefront arrays: the
    # f32 weight stage (K1 in both flavors, K2/K3 in f32) and the bf16 one
    lib.stage_bytes = (int(limits[2]), int(limits[5]))
    _lib = lib
    return lib


def flavor_of(flavor):
    """The flavor key (``None``, ``torch.bfloat16`` or :data:`TF32`) of a
    ``flavor``/``compute_dtype`` argument: those, ``"bfloat16"``, or
    ``"tf32"``."""
    if isinstance(flavor, str) and flavor == TF32:
        return TF32
    return resolve_compute_dtype(flavor)


def _layout(flavor):
    """The buffer layout a flavor's kernels use: the bf16 flavor's own, or
    the float32 one (``None``), which the TF32 flavor shares."""
    return torch.bfloat16 if flavor_of(flavor) is torch.bfloat16 else None


# the C interface's flavor argument (FL_F32, FL_BF16, FL_TF32 in
# csrc/taylor_common.cuh), and back
FLAVOR_CODE = {None: 0, torch.bfloat16: 1, TF32: 2}
FLAVOR_OF = {code: key for key, code in FLAVOR_CODE.items()}


def slot_stride(n: int) -> int:
    """Floats between the per-block partial slots of ``n`` values: a
    multiple of 4, so each slot starts 16-byte aligned (``slot_stride`` in
    ``csrc/taylor_common.cuh``)."""
    return -(-n // 4) * 4


def tile_points(smem: int, stage_bytes: tuple, ld: int, C: int,
                flavor=None) -> tuple[int, int]:
    """Points per block tile ``(K1, K2/K3)`` for a card with ``smem``
    bytes of opt-in shared memory, weight stages of ``stage_bytes = (f32,
    bf16)`` bytes, wavefront rows of ``ld`` floats and ``C`` channels: the
    most rows, a multiple of the tensor cores' 16 and at most one block
    tile (``BLOCK_ROWS``), whose wavefront arrays fit beside the stage, over
    ``C``.  K1 keeps the f32 flavor's tile in every flavor (its bf16 body
    needs less); K2/K3 take the flavor's own layout (``BWD_SLOTS``) and
    stage, so the bf16 flavor's tile is taller (the TF32 flavor's is the
    f32 one's).  Raises :class:`KernelLaunchError` when 16 rows do not
    fit."""
    dtype = _layout(flavor)
    slot_row = 2 * ld  # bytes of one row of a bf16 slot
    tps = []
    for slots, stage in ((K1_SLOTS, stage_bytes[0]),
                         (BWD_SLOTS[dtype],
                          stage_bytes[0 if dtype is None else 1])):
        rows = min((smem - stage) // (slots * slot_row), BLOCK_ROWS)
        rows = rows // 16 * 16
        if rows < C:
            raise KernelLaunchError(
                f"rows of {ld} floats x {C} channels do not fit 16 rows in "
                f"{smem} B of shared memory")
        tps.append(rows // C)
    return tps[0], tps[1]


def ws_floats(L: int, R: int, ld: int, flavor=None) -> int:
    """Floats of one block's K2/K3 workspace slice for tiles of ``R`` rows
    (``ws_slices`` and ``ws_floats_bf`` in ``csrc/taylor_common.cuh``): the
    f32 flavor stages 2L-3 layers of R x ld floats; the bf16 flavor the L-1
    pre-activation layers so and the L-2 layer inputs as bf16, pad16(R) x
    ld each.  The TF32 flavor's is the f32 one's."""
    if _layout(flavor) is None:
        return (2 * L - 3) * R * ld
    return (L - 1) * R * ld + (L - 2) * (-(-R // 16) * 16) * ld // 2


def workspace_floats(layer_shapes: Sequence[tuple], R: int, ld: int, G: int,
                     flavor=None) -> int:
    """Floats of a K2/K3 launch's workspace: ``G`` blocks' slices
    (:func:`ws_floats`) and, in the bf16 flavor, the weights' bf16 copy
    after them (``round_weights`` in ``csrc/taylor_common.cuh``: the W of
    layers 1 .. L-1 as rows padded to 8 bf16, in a multiple of 4
    floats)."""
    L = len(layer_shapes)
    floats = G * ws_floats(L, R, ld, flavor)
    if _layout(flavor) is not None:
        copy = sum(fi * -(-fo // 8) * 8 for fi, fo in layer_shapes[1:])
        floats += -(-copy // 8) * 4
    return floats


# ------------------------------------------------------------------ #
# K1's persistent wgmma route (csrc/taylor_fwd_wg.cuh): its plan and the
# plain mirror of its weight preparation
# ------------------------------------------------------------------ #
# wg_tile: rows of a block's tile, 64 per consumer warpgroup (two in the
# f32 and TF32 flavors, three in the bf16 one); keyed by "is bf16"
WG_TILE_ROWS = {False: 128, True: 192}
WG_MAX_STAGES = 8   # WG_MAXS: weight stages in shared memory
WG_MAX_D = 16       # WG_MAXD: inputs
WG_MAX_OUT = 16     # WG_MAXOUT: the head's columns
WG_MAX_C = 8        # WG_MAXC: a point's channels in one 8-row half of a tile
WG_MAX_WIDTH = 128  # hidden widths, padded to 64 or 128


class WgPlan(NamedTuple):
    """The wgmma route's launch for one plan, flavor and N (``wg_plan`` in
    ``csrc/taylor_fwd_wg.cuh``, in the same order)."""
    NP: int           # hidden width padded to 64 or 128
    CP: int           # channels padded to a power of two
    KC: int           # k rows of a weight chunk
    S: int            # weight stages in shared memory
    P: int            # chunks per tile: all hidden products
    resident: int     # P <= S: each chunk is copied once per block
    stage_bytes: int
    n_tiles: int      # tiles of WG_TILE_ROWS[bf16] rows
    grid: int         # persistent blocks: one per SM, at most one per tile
    smem: int         # dynamic shared memory bytes


def _wg_code(flavor) -> int:
    """The route's flavor code from a flavor key or a bool (``True``: the
    bf16 flavor, ``False``: the f32 one), or the code itself."""
    if isinstance(flavor, bool):
        return int(flavor)
    if isinstance(flavor, int):
        return flavor
    return FLAVOR_CODE[flavor_of(flavor)]


def wg_plan(layer_shapes: Sequence[tuple], orders: Sequence[int], flavor,
            smem_optin: int, n_sm: int, N: int):
    """The wgmma route's :class:`WgPlan` for these shapes in a flavor (a
    key, a code, or a bool for bf16), or ``None`` where the shape is the
    other route's: more than ``WG_MAX_C`` channels, a hidden width over
    ``WG_MAX_WIDTH``, more than ``WG_MAX_D`` inputs or ``WG_MAX_OUT``
    outputs, or a ring of fewer than two stages.  The TF32 flavor's chunks
    are the f32 flavor's with the hi plane alone."""
    code = _wg_code(flavor)
    bf16 = code == 1
    L = len(layer_shapes)
    d, n_out = layer_shapes[0][0], layer_shapes[-1][1]
    C = len(orders)
    width = max(fo for _, fo in layer_shapes[:-1])
    if C > WG_MAX_C or width > WG_MAX_WIDTH or d > WG_MAX_D \
            or n_out > WG_MAX_OUT:
        return None
    CP = 1
    while CP < C:
        CP *= 2
    NP = 64 if width <= 64 else 128
    KC = NP if bf16 else 64
    P = (L - 2) * (NP // KC)
    stage_bytes = NP * KC * (2 if bf16 else (4 if code == 2 else 8))
    misc = -(-4 * (NP * (d + L - 1 + n_out) + WG_MAX_OUT) // 16) * 16
    bars = 2 * WG_MAX_STAGES * 8
    if P == 0:
        S = 0
    else:
        S = min(P, (smem_optin - misc - bars) // stage_bytes, WG_MAX_STAGES)
        if S < P and S < 2:
            return None
    n_tiles = -(-N * CP // WG_TILE_ROWS[bool(bf16)])
    return WgPlan(NP, CP, KC, S, P, int(P <= S), stage_bytes, n_tiles,
                  min(n_tiles, n_sm), S * stage_bytes + misc + bars)


def wg_kslots(KC: int, bf16: bool) -> list:
    """The input column each k slot of a chunk holds (``wg_kslot`` in
    ``csrc/wgmma.cuh``): the natural order for bf16; for tf32, within each
    8 slots, slot t takes column 2t and slot t + 4 column 2t + 1."""
    if bf16:
        return list(range(KC))
    return [8 * (q // 8) + (2 * (q % 8) if q % 8 < 4 else 2 * (q % 8 - 4) + 1)
            for q in range(KC)]


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``split_tf32`` of ``csrc/taylor_common.cuh`` on float32 ``x``: ``hi``
    rounded to TF32 (to nearest, ties away from zero: the bits plus 2^12,
    the low 13 cleared; :func:`~.taylor.rna_tf32`), ``lo = x - hi``
    (exact)."""
    hi = rna_tf32(x)
    return hi, x - hi


def wg_prepare(flat_layers, wp: WgPlan, flavor) -> torch.Tensor:
    """The plain mirror of ``prep_wg_weights``: the bytes of the hidden
    layers' weights as the route's chunks lay them out, ``P`` chunks of
    ``stage_bytes``.  Chunk ``q`` holds layer ``1 + q // (NP // KC)``'s k
    rows ``(q % (NP // KC)) * KC ..`` as W^T (N = NP rows, K = KC columns,
    zero past the layer's shape), in :func:`wg_kslots` order, laid out in
    core matrices (``wg_cm_offset``): one plane of bf16 rounded to nearest
    even (``flavor`` the bf16 one, or ``True``), the two float32 planes of
    :func:`split_tf32`, ``hi`` then ``lo`` (the f32 flavor, or ``False``),
    or the ``hi`` plane alone (the TF32 flavor)."""
    code = _wg_code(flavor)
    bf16, tf32 = code == 1, code == 2
    NP, KC = wp.NP, wp.KC
    epc = 8 if bf16 else 4
    n = torch.arange(NP).view(NP, 1)
    kq = torch.arange(KC).view(1, KC)
    off = (((n // 8) * (KC // epc) + kq // epc) * (8 * epc) + (n % 8) * epc
           + kq % epc).reshape(-1)
    slots = torch.tensor(wg_kslots(KC, bf16))
    chunks = []
    for q in range(wp.P):
        W = flat_layers[2 * (1 + q // (NP // KC))].detach().float().cpu()
        fi, fo = W.shape
        pad = torch.zeros(NP, NP)
        pad[:fo, :fi] = W.t()
        plane = pad[:, (q % (NP // KC)) * KC + slots].reshape(-1)
        if bf16:
            out = torch.empty(NP * KC, dtype=torch.bfloat16)
            out[off] = plane.to(torch.bfloat16)
            chunks.append(out.view(torch.uint8))
        elif tf32:
            out = torch.empty(NP * KC)
            out[off] = rna_tf32(plane)
            chunks.append(out.view(torch.uint8))
        else:
            hi, lo = split_tf32(plane)
            out = torch.empty(2, NP * KC)
            out[0, off], out[1, off] = hi, lo
            chunks.append(out.reshape(-1).view(torch.uint8))
    return torch.cat(chunks) if chunks else torch.empty(0, dtype=torch.uint8)


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


# device index -> (opt-in shared memory a block, SMs)
_CARDS = {}


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
        self.orders = [o for o, _ in rows]
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
        self.tiles = {}  # flavor -> (TP_fwd, TP_bwd, n_sm), at first launch
        self.k1_checked = set()  # flavors whose K1 route was cross-checked
        self.k1_routes = {}  # flavor -> the route its last K1 launch took

    def card(self, device: torch.device) -> tuple[int, int]:
        """The card's opt-in shared memory a block and its SM count."""
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        if index not in _CARDS:
            info = (ctypes.c_int * 2)()
            _check(build().tdq_device_info(index, info),
                   "cudaDeviceGetAttribute")
            _CARDS[index] = (int(info[0]), int(info[1]))
        return _CARDS[index]

    def k1_route(self, device: torch.device, compute_dtype, N: int):
        """K1's route for ``N`` points in a flavor: the wgmma route's
        :class:`WgPlan` (``csrc/taylor_fwd_wg.cuh``), or ``None`` for the
        kernel beside K2 (``csrc/taylor_table.cu``), chosen by shape
        (:func:`wg_plan`).  Before a flavor's first launch the kernels' own
        plan (``tdq_k1wg_plan``) is held to this one: a drift raises
        :class:`KernelBuildError`."""
        dtype = flavor_of(compute_dtype)
        smem, n_sm = self.card(device)
        wp = wg_plan(self.layer_shapes, self.orders, FLAVOR_CODE[dtype], smem,
                     n_sm, N)
        if dtype not in self.k1_checked:
            out = (ctypes.c_int * len(WgPlan._fields))()
            took = build().tdq_k1wg_plan(self.net_h, self.sched_h,
                                         FLAVOR_CODE[dtype], smem, n_sm,
                                         N, out)
            got = WgPlan(*out) if took else None
            if got != wp:
                raise KernelBuildError(
                    f"the kernels' K1 route is {got}, the wrapper's {wp}")
            self.k1_checked.add(dtype)
        self.k1_routes[dtype] = "wide" if wp is None else "wgmma"
        return wp

    def tile_sizes(self, device: torch.device,
                   compute_dtype=None) -> tuple[int, int, int]:
        """Points per block for K1 and K2/K3 in a flavor
        (:func:`tile_points` over the card's opt-in shared memory), and the
        card's SM count."""
        dtype = flavor_of(compute_dtype)
        if dtype not in self.tiles:
            lib = build()
            smem, n_sm = self.card(device)
            tiles = (*tile_points(smem, lib.stage_bytes, self.ld, self.C,
                                  dtype), n_sm)
            # the workspace the wrappers allocate is the one the kernels
            # index: a drift between the two sizes would under-allocate it
            for G in (1, 2):
                want = workspace_floats(self.layer_shapes, tiles[1] * self.C,
                                        self.ld, G, dtype)
                got = lib.tdq_workspace_floats(
                    self.net_h, tiles[1] * self.C, G, FLAVOR_CODE[dtype])
                if got != want:
                    raise KernelBuildError(
                        f"the kernels' workspace is {got} floats for {G} "
                        f"block(s), the wrapper's {want}")
            self.tiles[dtype] = tiles
        return self.tiles[dtype]

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
    N = X.shape[0]
    table = torch.empty((plan.C, N, plan.n_out), device=X.device,
                        dtype=torch.float32)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    wp = plan.k1_route(X.device, FLAVOR_OF[bf16], N)
    if wp is not None:
        # the weights' chunks, prepared by the launch itself
        chunks = torch.empty((max(wp.P * wp.stage_bytes // 4, 1),),
                             device=X.device, dtype=torch.float32)
        _check(lib.tdq_taylor_fwd_wg(X.data_ptr(), flat.data_ptr(),
                                     chunks.data_ptr(), table.data_ptr(), N,
                                     plan.net_h, plan.sched_h, bf16,
                                     (ctypes.c_int * len(wp))(*wp), stream),
               "taylor_fwd_wg K1 launch")
        return table
    tp, _, _ = plan.tile_sizes(X.device, FLAVOR_OF[bf16])
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


def k1_forward_tf32(plan: _Plan, X: torch.Tensor,
                    flat: torch.Tensor) -> torch.Tensor:
    """Launch K1's single-pass TF32 flavor (precision ``"default"``): the
    table of ``taylor_derivatives(emulate_tf32=True)``."""
    table = _k1(plan, X, flat, 2)
    k1_forward_tf32.launches += 1
    return table


k1_forward.launches = 0
k1_forward_bf16.launches = 0
k1_forward_tf32.launches = 0


def _k2(plan: _Plan, X: torch.Tensor, flat: torch.Tensor, g: torch.Tensor,
        bf16: int) -> tuple[torch.Tensor, torch.Tensor]:
    _check_cuda_inputs(plan, X, flat)
    N = X.shape[0]
    if tuple(g.shape) != (plan.C, N, plan.n_out) or g.dtype != torch.float32 \
            or g.device != X.device or not g.is_contiguous():
        raise ValueError(f"cotangent must be a contiguous float32 "
                         f"[{plan.C}, {N}, {plan.n_out}] on {X.device}")
    lib = build()
    _, tp, n_sm = plan.tile_sizes(X.device, FLAVOR_OF[bf16])
    n_tiles = -(-N // tp)
    G = min(n_tiles, n_sm)
    opts = dict(device=X.device, dtype=torch.float32)
    dX = torch.empty((N, plan.d), **opts)
    part = torch.empty((G, slot_stride(plan.P_total)), **opts)
    ws = torch.empty((workspace_floats(plan.layer_shapes, tp * plan.C,
                                       plan.ld, G, FLAVOR_OF[bf16]),), **opts)
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


def k2_backward_tf32(plan: _Plan, X: torch.Tensor, flat: torch.Tensor,
                     g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K2's single-pass TF32 flavor: the cotangents of
    :func:`k1_forward_tf32`'s table, each product on TF32-rounded
    operands (the cotangent's included)."""
    out = _k2(plan, X, flat, g, 2)
    k2_backward_tf32.launches += 1
    return out


k2_backward.launches = 0
k2_backward_bf16.launches = 0
k2_backward_tf32.launches = 0

# (K1, K2) of each flavor
FLAVORS = {None: (k1_forward, k2_backward),
           torch.bfloat16: (k1_forward_bf16, k2_backward_bf16),
           TF32: (k1_forward_tf32, k2_backward_tf32)}

# every kernel wrapper of the package, K3's included once its module is
# imported; reset_launch_counts() zeroes them all
COUNTED = [k1_forward, k2_backward, k1_forward_bf16, k2_backward_bf16,
           k1_forward_tf32, k2_backward_tf32]


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
                        device="cuda", compute_dtype=None,
                        precision="highest"):
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
      precision: the network's (:func:`~..utils.resolve_precision`):
        ``"default"`` (``None``) takes the single-pass TF32 flavor,
        ``"high"``/``"highest"`` the 3xTF32 one; a bf16 ``compute_dtype``
        overrides it.  On the CPU every precision computes IEEE float32.
    """
    resolve_device(device)
    dtype = resolve_compute_dtype(compute_dtype)
    flavor = resolve_flavor(dtype, precision)
    plan = _Plan(set(map(canonical, requests)), layer_shapes)

    def table_fn(layers, X):
        if X.device.type == "cpu":
            table = taylor_derivatives(layers, X, set(plan.mis),
                                       flat_matmul=True, compute_dtype=dtype)
            return {mi: table[mi] for mi in plan.mis}
        flat_layers = [t for pair in layers for t in pair]
        table = _TaylorTable.apply(plan, FLAVORS[flavor], X.contiguous(),
                                   *flat_layers)
        return {mi: table[plan.pos[mi]] for mi in plan.mis}

    table_fn.plan = plan
    table_fn.compute_dtype = dtype
    table_fn.flavor = flavor
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
    """Tensor-core passes per product of each kernel, averaged over its
    ``flop_count`` ``tensor`` share: 3 TF32 passes in the f32 flavor
    (3xTF32, priced at the TF32 peak), 1 in the TF32 flavor; in the bf16
    flavor bf16 passes
    (priced at the dense bf16 peak), 1 for a forward product (two bf16
    operands) and 3 for a dW or dH product (the f32 cotangent's 24
    significand bits in three bf16 pieces against the bf16 operand): the
    passes its kernels take, and the fewest the card's fastest route for
    these types takes (``wgmma`` would take as many)."""
    flavor = flavor_of(compute_dtype)
    if flavor is None:
        return {"k1": 3.0, "k2": 3.0}
    if flavor == TF32:
        return {"k1": 1.0, "k2": 1.0}
    return _mean_passes(plan, 1, 3)


def flop_count(plan: _Plan, n_points: int) -> dict:
    """Float operations the function of each kernel needs for ``n_points``
    points, not what the kernel happens to do, split by the route the kernel
    takes them on: ``{"k1": {"tensor": ..., "simt": ...}, "k2": ...}``.

    ``tensor``: the channel products of the layers past layer 0 that are
    wider than ``NARROW_N`` (the hidden layers' products, on the tensor
    cores; counted once, as the products they stand for, whatever the
    passes of the route: :func:`tensor_passes`; the bf16 flavor's head
    cotangent products, SIMT at any width, are counted so too).
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
