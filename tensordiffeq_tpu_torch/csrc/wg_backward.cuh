// K2 and K3 on Hopper's warpgroup products, in three flavors: FL_F32 (the
// 3xTF32 products of precision HIGHEST, the default), FL_TF32 (one TF32
// pass, precision DEFAULT) and FL_BF16 (the mixed precision of
// compute_dtype=bfloat16).  The route for hidden widths up to 128, up to 8
// channels and up to 16 inputs and outputs (K1's wgmma route's shapes,
// wg_plan in taylor_fwd_wg.cuh), the device code; taylor_bwd_wg.cu and
// minimax_wg.cu hold the C interfaces, taylor_bwd_wg_{f32,tf32,bf16}_{64,
// 128}.cu and minimax_wg_{f32,tf32,bf16}_{64,128}.cu the instances.  The
// f32 and TF32 flavors' hidden widths 129-256 have a design of their own
// (wg_backward_wide.cuh, NP = 256), which wb_plan below also plans.
//
// Replaces, for those shapes, the JAX package's ops/pallas_taylor.py::
// bwd_kernel (pallas_call at :171) as taylor_table.cu's taylor_bwd_kernel
// does, and ops/pallas_minimax.py::build_minimax_sq_fn's kernel
// (pallas_call at :259) as minimax_step.cu's minimax_step_kernel does;
// those stay the route for every other shape (the host chooses by shape,
// ops/cuda_taylor.py::wb_plan and wb_plan below, which agree before a
// flavor's first launch).  It computes what they compute: K2 dW/db and dX
// from the table cotangents; K3 the value sum_e sum_p w f_e^2, dW/db, gw =
// f^2 and gX through the residual tape.  The interfaces, the packed
// layouts and the partial slots are theirs, so reduce_partials sums the
// slots after it as after them.  K3 also runs over a member axis (a
// surrogate factory's members, whose tapes share their ops): one launch,
// each member keeping the single launch's partition and slot order, so
// its outputs are that launch's bit for bit (wb_body_k3; M = 1 is the
// single launch).
//
// What bounds it.  Operations: the nine 128-wide products of a tile on the
// AC slice (three forward, three dH, three dW; 58.98 GFLOP at N = 50,000,
// C = 4), 0.357 ms at three TF32 passes (f32) and 0.119 ms at one (TF32)
// over 495 TFLOP/s; the tanh chains, the Faa di Bruno lines and their
// transposes on the CUDA cores are the rest.  The mma.sync route
// (taylor_table.cu's K2 note) lost its time to its SIMT passes over a
// wavefront in shared memory, to dW's read-modify-write of the partial
// slot from the SMs, to mma.sync's instruction stream and to tiles of 96
// rows.  So this route:
//   * runs persistent blocks, one per SM, each two warpgroups of 64 tile
//     rows (a tile is 128 rows: points x CP channels, C padded to a power
//     of two, as K1's route lays them), the weights streaming through a
//     ring of stages (cp.async.bulk onto "full" mbarriers; each warp
//     releases a stage on its "empty" one, and thread 0 refills it with
//     the chunk S ahead).  No producer warp: ptxas gives a block of 9 warps
//     the registers of 12 (168 a thread, and the NP = 128 instances spilled
//     up to 4.4 KB), a block of 8 warps up to 255.
//   * keeps the wavefront in registers, in the accumulator layout of K1's
//     route: layer 0, the activation pass (wb_act, k1w_act's butterfly),
//     the forward products chained through the accumulator; the reverse
//     sweep's pass (wb_act_vjp) is the transpose of the activation pass on
//     the same butterfly, in place on the cotangent registers.
//   * runs every hidden product on wgmma: the forward H W and dH = dP W^T
//     with A the registers (wgmma.cuh's chaining) and B a weight chunk,
//     prepared once per launch by prep_wb_weights in core-matrix, k-slot
//     order (the forward plane W^T, K = in, and the backward plane W, K =
//     out); dW = H^T dP with both operands in shared memory, where wgmma
//     reads tf32 only K-major: the producer of each operand writes it so
//     (wb_put_kmajor: feature rows, tile rows along K), H_l recomputed from
//     the staged Q_{l-1} (no second staged slice), dP_l from the
//     registers.  No transpose pass runs.
//     FL_TF32: one pass, operands rounded by cvt.rna as the referee rounds
//     them (taylor_derivatives(emulate_tf32=True); the tensor cores would
//     truncate), chunks of KC = 64 k rows (the hi plane: 32 KB at NP =
//     128).
//     FL_F32: the forward and dH products take K1's three passes a k step,
//     A_lo B_hi + A_hi B_lo + A_hi B_hi, A split in registers (split_tf32,
//     a k step at a time), B the chunk's hi and lo planes of split_tf32
//     (KC = 32: the same 32 KB a stage); a chunk's small passes go first
//     (wb_chunk3).  The tensor cores round each pass's sum into the
//     accumulator toward zero, so 48 passes into one accumulator shrink a
//     128-deep product by several ulps: every hidden activation drifts
//     the same way, and a sum over points that cancels (the head bias's
//     gradient in K3) sat ten times further from the IEEE flavor than the
//     mma.sync kernels', which add each k step on the CUDA cores.  So the
//     forward sums each chunk in an accumulator of its own and adds the
//     chunks rounded to nearest (scripts/torch_tc_accumulation_witness.py
//     emulates the orders).  dH and dW keep one accumulator each (dH with
//     the small passes first): K2's leaves (its cotangents come in, not
//     from sums over the forward) stayed within 6e-6 of the plain flavor
//     over 16 input seeds on the card (PERF.md), and a second accumulator
//     costs 64 registers where the sweep has none.
//     dW's operands hold the f32 values, which the tensor cores read as
//     their truncated hi parts (tf32_trunc); its lo parts x - tf32_trunc(x)
//     (exact) are made in place between passes (wb_dw3): hi hi, then
//     dP^T's lo parts (the warpgroup's own half), hi lo, then H^T's lo
//     parts and dP^T written again from the registers, lo hi.  This split
//     truncates where split_tf32 rounds: |lo| < 2^-10 |x| against 2^-11, so
//     a dW term is within about 2^-19 of the f32 product (the dropped lo lo
//     and lo's own truncation 2^-20 each) against about 2^-21 for the
//     forward's and dH's split; both far inside the 1e-4 band the kernels
//     are held to against the IEEE plain flavor.  Everything outside the
//     hidden products (layer 0, the head and its cotangent products, the
//     tape, the bias sums) is IEEE f32 on the CUDA cores, reading the f32
//     values of H^T and dP^T, as in the mma.sync f32 kernels.
//     FL_BF16: the rounding points of taylor_common.cuh's bf16 flavor (the
//     mma.sync kernels', which stay its referee with the JAX package's
//     taylor_derivatives(compute_dtype=bfloat16)) on bf16 wgmma
//     (m64nNk16).  The forward: one pass a k16 step, A the layer's input
//     rounded to nearest even as it is packed from the registers
//     (wg_chunk<FL_BF16>, K1-bf16's chain), B W^T in bf16 chunks of KC =
//     64 k rows (16 KB at NP = 128; wb_kc).  dH = dP W^T: A the f32
//     cotangent cut in the registers into split_pieces' three bf16 pieces
//     (hi = rn(x), mid = rn(x - hi), lo = rn(x - hi - mid): their sum is x),
//     three passes a k16 step, smallest first (wb_chunk_pieces, two k steps
//     of pieces at a time: 24 registers), B W in bf16; dH then rounded to
//     bf16 per element, as the reference's bf16 plane holds it.  dW = H^T
//     dP: both operands in shared memory, H_l as one bf16 plane and dP_l's
//     three pieces as planes (wb_put_pieces; each warpgroup's half of the
//     columns of all three together, so that its dW block's staging for the
//     bulk adds lies over its own pieces), three passes (lo, mid, hi:
//     wb_dw_pieces).  H (32 KB at NP = 128) and the pieces (96 KB) take the
//     bytes of the f32 flavor's H^T and dP^T, so the ring's 16 KB stages
//     get the rest (five at the AC slice) and nothing is made in place.
//     wgmma reads 16-bit operands from shared memory MN-major too (the
//     instruction's transpose bits), so these planes are written MN-major
//     (wb_mn_offset): a lane's two neighbouring columns are one 4-byte
//     store, a warp's stores of a register pair one 128-byte line.  Against
//     K-major writes (2-byte stores, tf32's layout) in turns on the H100
//     (scripts/torch_tf32_time.py --flavor bf16 on both): K3-bf16 1.554-
//     1.582 against 1.600-1.605 ms and K2-bf16 1.353-1.372 against
//     1.428-1.434, and at CP = 4 no spill (K-major: 20-32 B of spill
//     stores).  Layer 0, the head and its cotangent products, the tape
//     and the bias sums are f32 on the CUDA cores, their operands rounded as
//     the reference rounds them (X, W_0, the head's input and W; not the
//     cotangents); dX's network share and dH at the head rounded to bf16;
//     each dW rounded once, after reduce_partials<true>'s slot-ordered sum;
//     db not.
//   * stages in the workspace only Q_0 .. Q_{L-2}, each hidden layer's
//     pre-activation channels with the primal's tanh in place of the
//     primal, as the activation pass holds them between its butterflies:
//     each thread its own registers, 16 bytes at a time, streaming; (L-1) x
//     64 KB a block on the AC net, 33.8 MB for 132 blocks (the mma.sync
//     route's 48.3).  The reverse sweep's recompute of a layer's input and
//     its VJP start from Q with no butterfly and no tanh.
//   * is short: the kernel's code runs once per tile, so its length, not
//     its arithmetic, set the pace at first (a phase of a few hundred
//     straight-line instructions took ~40 cycles each, the instruction
//     cache missing).  Each pass is one loop body (a batch of groups, the
//     registers rotated between batches), layer 0 runs in the forward only
//     and the reverse sweep's layers, layer 0's included, are one loop.
//     The batches are small (4 groups in the activation pass, 2 in the
//     VJP) for the same reason: larger ones ran slower at the AC slice
//     (PERF.md, scripts/torch_tf32_time.py on copies with them).
//   * adds dW into the block's own partial slot by bulk reduce-adds
//     (cp.reduce.async.bulk .add.f32) from a staging copy in shared memory,
//     one slot row per thread, each after the same thread's add to that
//     row one tile before completed (and nothing else: the other layers'
//     adds stay in flight); the block's first tile stores by bulk copies
//     instead.  The slot's rows are then summed in the tiles' order: no
//     float atomics across blocks, bit-identical run to run.  Where a
//     layer's slot rows are not 16-byte pieces (a width or offset not a
//     multiple of 4) the warpgroup's threads add the staged values from the
//     SMs instead.
//   * keeps the tile's rows of X in shared memory for layer 0 (forward and
//     backward) and the tape.
//   * the head's narrow product (n_out <= 16 columns) and its cotangent
//     products, layer 0 and the bias sums stay SIMT, as in the mma.sync
//     route; K3's epilogue interprets the tape one thread per point
//     (minimax_tape.cuh), rows past N predicated.
// Shared memory at the AC slice (NP = 128, C = 4, d = 2, n_out = 1), the
// f32 and TF32 flavors: a ring of two 32 KB weight chunks (65,536), the
// operands H^T
// and dP^T (65,536 each), the table rows (the bias partials in the reverse
// sweep, 4,096), X's rows (1,024), the small operands (3,648), the value's
// warp sums (32), K3's work item state (64), the mbarriers (128): 205,600
// bytes of the H100's 232,448.  The f32 flavor's sum, were its operands'
// lo planes resident: the hi and lo weight planes at KC = 64 would take 64
// KB a stage (two stages and the fixed 140,064: 271,136), and dW's lo
// planes of H^T and dP^T another 131,072 (at KC = 32: 336,672); so KC =
// 32, and dW's lo planes are made in place over H^T and dP^T (three
// passes, two more block barriers and two warpgroup barriers a hidden
// layer).  The bf16 flavor: five 16 KB stages (81,920) and the same fixed
// 140,064: 221,984.
// Registers (nvcc -Xptxas -v, CUDA 12.8): TF32 NP = 128 180-255 (255 at
// CP = 4, no spills; 8 B of spill stores at CP = 8), NP = 64 114-207, no
// spills; f32: PERF.md section 6; bf16 NP = 128 247-255, no spill at CP <=
// 4 (40-96 B of spill stores at CP = 8).  A TF32 kernel is 7-25 thousand
// SASS instructions (14,112 for K3 and 12,184 for K2 at NP = 128, CP = 4).
// The products of a tile are summed in the tensor cores' order and its
// sums over rows in fixed orders, so a point's contribution is the same
// bit for bit run to run, but not the same sum as the mma.sync route's.

#pragma once

#include "minimax_tape.cuh"
#include "taylor_fwd_wg.cuh"

#define WB_ROWS 128       // rows of a tile: two warpgroups of 64
#define WB_THREADS 256    // the block: the two warpgroups
#define WB_ITEM_FLOATS 16 // K3's work item state (WbItem), 64 bytes

// k rows of a weight chunk: 64 in the TF32 flavor (the hi plane alone), 32
// in the f32 flavor (the hi and lo planes: the same bytes a stage), 64 in
// the bf16 flavor (16 KB a stage at NP = 128: dH's three pieces a k step
// take their A registers a batch of k steps at a time, wb_chunk_pieces)
static __host__ __device__ constexpr int wb_kc(int flavor) {
  return flavor == FL_F32 ? 32 : 64;
}

// A launch of the route (ops/cuda_taylor.py::WbPlan, in the same order).
// P: chunks per tile (each hidden layer's forward plane, then the backward
// planes in the sweep's order); bulk: dW's slot rows take bulk adds;
// ws_floats: the launch's workspace (the blocks' slices, then the planes).
struct WbPlan {
  int NP, CP, KC, S, P, stage_bytes, n_tiles, grid, smem, bulk, ws_floats;
};
#define WB_PLAN_INTS 11

// The C interface's plan: WbPlan's fields in order.
static inline WbPlan unpack_wb(const int* h) {
  return WbPlan{h[0], h[1], h[2], h[3], h[4], h[5],
                h[6], h[7], h[8], h[9], h[10]};
}

static __host__ __device__ __forceinline__ int pad4(int n) {
  return (n + 3) & ~3;
}

// Floats of the small operands (K1's route's: W0, the biases of layers 0 ..
// L-2 as NP-wide rows, the head's W and bias), a multiple of 4.
static __host__ __device__ __forceinline__ int wb_misc_floats(const Net& net,
                                                              int NP) {
  return pad4(NP * (net.d + net.L - 1 + net.n_out) + WG_MAXOUT);
}

// Floats of the table rows (128 x n_out) and, in the same place, the bias
// partials of the reverse sweep (8 warps x NP): the table's cotangents are
// spent by then.
static __host__ __device__ __forceinline__ int wb_rows_floats(const Net& net,
                                                              int NP) {
  return pad4(imax(WB_ROWS * net.n_out, 8 * NP));
}

// Dynamic shared memory besides the ring: H^T and dP^T (NP x 128 floats
// each), the table rows (or the bias partials), the tile's rows of X (128 x
// d at most), the small operands, the value's 8 warp sums, K3's work item
// state (WbItem), the 2 x WG_MAXS mbarriers.
static __host__ __device__ __forceinline__ int wb_fixed_bytes(const Net& net,
                                                              int NP) {
  return 4 * (2 * NP * WB_ROWS + wb_rows_floats(net, NP) +
              pad4(WB_ROWS * net.d) + wb_misc_floats(net, NP) + 8 +
              WB_ITEM_FLOATS) +
         2 * WG_MAXS * 8;
}

// The f32 and TF32 flavors' design for hidden widths 129 .. 256 (NP =
// 256, wg_backward_wide.cuh): tiles of 64 rows, each warpgroup 128 columns.
#define WBW_ROWS 64    // rows of a tile: both warpgroups' 64 rows
#define WBW_H 128      // columns a warpgroup holds
#define WBW_HALF 8192  // floats of a warpgroup's half of a 64-row operand
#define WBW_LDS 132    // floats of a row of dW's staging

// k rows of a weight chunk at NP = 256: 16 in the f32 flavor (the hi and
// lo planes), 32 in the TF32 flavor (the hi plane alone): 32 KB a stage
static __host__ __device__ constexpr int wbw_kc(int flavor) {
  return flavor == FL_F32 ? 16 : 32;
}

// Stages of the ring at NP = 256: the TF32 flavor leaves the ring's fourth
// 32 KB to warpgroup 1's parked running sum (WBW_KEEP1, wbw_product)
static __host__ __device__ constexpr int wbw_maxs(int flavor) {
  return flavor == FL_TF32 ? 3 : WG_MAXS;
}
// the parked sums' byte offsets: warpgroup 0's in the exchange buffer's
// second 32 KB (the f32 flavor's lo plane), warpgroup 1's past the ring's
// stages
#define WBW_KEEP0 32768
#define WBW_KEEP1 (65536 + wbw_maxs(FL_TF32) * 256 * wbw_kc(FL_TF32) * 4)

// The region the ring shares with dW's operands: the exchange buffer and
// H^T (64 KB), then dP^T (64 KB) and dW's staging (two warpgroups' 64 rows
// of WBW_LDS floats), or the ring's stages.
static __host__ __device__ __forceinline__ int wbw_region_bytes(int S,
                                                                int stage) {
  return 65536 + imax(65536 + 2 * WBW_ROWS * WBW_LDS * 4, S * stage);
}

// Floats of the rows area: the head's table rows (64 x n_out) and the two
// warpgroups' row sums, or the reverse sweep's bias partials (8 warps x
// 128 columns).
static __host__ __device__ __forceinline__ int wbw_rows_floats(
    const Net& net) {
  return pad4(imax(3 * WBW_ROWS * net.n_out, 8 * WBW_H));
}

// Dynamic shared memory besides the region: the rows area, X's rows, the
// small operands at NP = 256, the value's warp sums, the work item, the
// mbarriers.
static __host__ __device__ __forceinline__ int wbw_fixed_bytes(
    const Net& net) {
  return 4 * (wbw_rows_floats(net) + pad4(WBW_ROWS * net.d) +
              wb_misc_floats(net, 256) + 8 + WB_ITEM_FLOATS) +
         2 * WG_MAXS * 8;
}

// The route's plan for a net, schedule, flavor (FL_F32, FL_TF32 or
// FL_BF16) and N on a card with smem_optin bytes of shared memory a block
// and n_sm SMs; 0 where the shape is the mma.sync route's: K1's route's
// conditions (wg_plan) and a ring of at least two stages; past 128 wide,
// the f32 and TF32 flavors up to 256 (NP = 256: wg_backward_wide.cuh's
// layout, 64-row tiles, chunks of wbw_kc k rows) where its region and the
// rest fit.
static inline int wb_plan(const Net& net, const Sched& s, int flavor,
                          int smem_optin, int n_sm, int N, WbPlan* p) {
  const int L = net.L, C = s.C;
  if (flavor != FL_F32 && flavor != FL_TF32 && flavor != FL_BF16) return 0;
  int width = 0;
  for (int l = 0; l + 1 < L; ++l) width = imax(width, net.w_out[l]);
  if (C > WG_MAXC || width > (flavor == FL_BF16 ? 128 : 256) ||
      net.d > WG_MAXD || net.n_out > WG_MAXOUT)
    return 0;
  int CP = 1;
  while (CP < C) CP *= 2;
  if (width > 128) {
    const int KC = wbw_kc(flavor), P = 2 * (L - 2) * (256 / KC);
    const int stage = 256 * KC * (flavor == FL_F32 ? 8 : 4);
    const int fixed = wbw_fixed_bytes(net);
    int S = 0;
    if (P > 0) {
      S = imin(imin(P, (smem_optin - fixed - 65536) / stage),
               wbw_maxs(flavor));
      if (S < 2) return 0;
    }
    const int smem = wbw_region_bytes(S, stage) + fixed;
    if (smem > smem_optin) return 0;
    int bulk = 1;
    for (int l = 1; l + 1 < L; ++l)
      if (net.offW[l] % 4 != 0 || net.w_out[l] % 4 != 0) bulk = 0;
    const int n_tiles = (int)(((long long)N * CP + WBW_ROWS - 1) / WBW_ROWS);
    const int grid = imin(n_tiles, n_sm);
    *p = WbPlan{256, CP, KC, S, P, stage, n_tiles, grid, smem, bulk,
                grid * (L - 1) * WBW_ROWS * 256 + P * (stage / 4)};
    return 1;
  }
  const int NP = width <= 64 ? 64 : 128;
  const int KC = wb_kc(flavor);
  const int P = 2 * (L - 2) * (NP / KC);
  const int stage =
      NP * KC * (flavor == FL_F32 ? 8 : (flavor == FL_TF32 ? 4 : 2));
  const int fixed = wb_fixed_bytes(net, NP);
  int S = 0;
  if (P > 0) {
    S = imin(imin(P, (smem_optin - fixed) / stage), WG_MAXS);
    if (S < 2) return 0;
  }
  int bulk = 1;
  for (int l = 1; l + 1 < L; ++l)
    if (net.offW[l] % 4 != 0 || net.w_out[l] % 4 != 0) bulk = 0;
  const int n_tiles = (int)(((long long)N * CP + WB_ROWS - 1) / WB_ROWS);
  const int grid = imin(n_tiles, n_sm);
  *p = WbPlan{NP, CP, KC, S, P, stage, n_tiles, grid, S * stage + fixed,
              bulk, grid * (L - 1) * WB_ROWS * NP + P * (stage / 4)};
  return 1;
}

// The weights' planes of one launch (the plain mirror is
// ops/cuda_taylor.py::wb_prepare), chunks of KC k rows, NP rows each, in
// core-matrix order (wg_cm_offset) and the tf32 k-slot order (wg_kslot):
// first the forward planes of layers 1 .. L-2 (row n, k the input: W^T,
// K1's chunks of the flavor), then the backward planes of layers L-2 .. 1
// (row i, k the output: W as it lies), zero past each layer's shape.  FL_TF32:
// W rounded to TF32 (cvt.rna); FL_F32: the hi plane, then the lo plane, of
// split_tf32 (K1's f32 chunks); FL_BF16: W rounded to bf16 (to nearest
// even), 8 to a core-matrix row and the k rows in their natural order
// (K1-bf16's chunks).
template <int FL>
static __device__ __forceinline__ void wb_prep(const float* __restrict__ prm,
                                               float* __restrict__ out,
                                               const Net& net,
                                               const WbPlan& wp) {
  const int NP = wp.NP, KC = wp.KC, per = NP * KC, nch = NP / KC;
  const int half = wp.P / 2, total = wp.P * per;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += gridDim.x * blockDim.x) {
    const int q = e / per, r = e % per, n = r / KC, kq = r % KC;
    const int k = FL == FL_BF16 ? kq : 8 * (kq / 8) + wg_kslot(kq % 8);
    float v;
    if (q < half) {
      const int l = 1 + q / nch, kk = (q % nch) * KC + k;
      v = (kk < net.w_in[l] && n < net.w_out[l])
              ? prm[net.offW[l] + kk * net.w_out[l] + n]
              : 0.f;
    } else {
      const int qb = q - half, l = net.L - 2 - qb / nch;
      const int kk = (qb % nch) * KC + k;
      v = (n < net.w_in[l] && kk < net.w_out[l])
              ? prm[net.offW[l] + n * net.w_out[l] + kk]
              : 0.f;
    }
    if constexpr (FL == FL_F32) {
      unsigned hi, lo;
      split_tf32(v, hi, lo);
      float* chunk = out + (size_t)q * 2 * per;
      chunk[wg_cm_offset(n, kq, KC, 4)] = __uint_as_float(hi);
      chunk[per + wg_cm_offset(n, kq, KC, 4)] = __uint_as_float(lo);
    } else if constexpr (FL == FL_BF16) {
      bf16* chunk = reinterpret_cast<bf16*>(out) + (size_t)q * per;
      chunk[wg_cm_offset(n, kq, KC, 8)] = __float2bfloat16_rn(v);
    } else {
      out[(size_t)q * per + wg_cm_offset(n, kq, KC, 4)] = tf32r(v);
    }
  }
}

template <int FL>
static __global__ void prep_wb_weights(const float* __restrict__ prm,
                                       float* __restrict__ out, Net net,
                                       WbPlan wp) {
  wb_prep<FL>(prm, out, net, wp);
}

// K3's planes for a member axis: member blockIdx.y's parameters (prm rows
// of P_total) into its planes, P * stage_bytes after the previous member's.
template <int FL>
static __global__ void prep_wb_weights_m(const float* __restrict__ prm,
                                         float* __restrict__ out, Net net,
                                         WbPlan wp) {
  wb_prep<FL>(prm + (size_t)blockIdx.y * net.P_total,
              out + (size_t)blockIdx.y * wp.P * (wp.stage_bytes / 4), net,
              wp);
}

// reduce_partials over a member axis: member blockIdx.y's G slots (the
// slots of members before it first) summed in slot order into its row of
// out (P values a member), as reduce_partials sums a single launch's.
template <bool BF>
static __global__ void reduce_member_partials(const float* __restrict__ part,
                                              float* __restrict__ out, int G,
                                              int P, Net net) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= P) return;
  const size_t stride = slot_stride(P);
  const float* mine = part + (size_t)blockIdx.y * G * stride;
  float acc = 0.f;
  for (int g = 0; g < G; ++g) acc += mine[g * stride + e];
  if (BF && is_weight(net, e)) acc = bf16r(acc);
  out[(size_t)blockIdx.y * P + e] = acc;
}

// x's TF32 part as the tensor cores read an f32 operand: its low 13 bits
// dropped (truncation)
static __device__ __forceinline__ float tf32_trunc(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xFFFFE000u);
}

// n floats at p (16-byte aligned, n a multiple of 4) replaced by their lo
// parts x - tf32_trunc(x) (exact), threads id, id + nt, ... 16 bytes at a
// time: the f32 flavor's dW operands, which hold x, become the lo operand
// of a pass.
static __device__ __forceinline__ void wb_lo_in_place(float* p, int n, int id,
                                                      int nt) {
  float4* q = reinterpret_cast<float4*>(p);
  for (int i = id; i < n / 4; i += nt) {
    float4 v = q[i];
    v.x -= tf32_trunc(v.x);
    v.y -= tf32_trunc(v.y);
    v.z -= tf32_trunc(v.z);
    v.w -= tf32_trunc(v.w);
    q[i] = v;
  }
}

// The two warpgroups together, and one warpgroup alone (named barriers).
static __device__ __forceinline__ void wb_sync_all() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

static __device__ __forceinline__ void wb_sync_wg(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(2 + wg) : "memory");
}

// bytes from shared src to global dst (16-byte aligned, a multiple of 16),
// in the thread's bulk group
static __device__ __forceinline__ void bulk_store(float* dst, const float* src,
                                                  unsigned bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      :: "l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
}

static __device__ __forceinline__ void slot_rmw(float* p, float v,
                                                bool first) {
  *p = first ? v : *p + v;
}

// Wait until at most n of the thread's latest bulk groups are pending (n
// above 7 waits as for 7, which waits for more).
static __device__ __forceinline__ void bulk_wait_pending(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.bulk.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.bulk.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.bulk.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.bulk.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.bulk.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.bulk.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.bulk.wait_group 7;\n" ::: "memory");
  }
}

// A column index n < 256 for thread ctid that alternates the warpgroups
// (even columns to the first, odd to the second), so a pass over fewer
// columns than threads keeps both busy.
static __device__ __forceinline__ int wb_spread(int ctid) {
  return 2 * (ctid & 127) + (ctid >> 7);
}

// A thread's share of a staged layer (wb_act's Q) back into its registers:
// register r at slice[((r / 4) * 256 + ctid) * 4 + r % 4], 16 bytes at a
// time, consecutive threads on consecutive 16 bytes.
template <int NP>
static __device__ __forceinline__ void wb_load_p(float (&a)[NP / 2],
                                                 const float* slice,
                                                 int ctid) {
  const float4* p = reinterpret_cast<const float4*>(slice) + ctid;
#pragma unroll
  for (int q = 0; q < NP / 8; ++q) {
    const float4 v = __ldcg(p + q * WB_THREADS);
    a[4 * q] = v.x;
    a[4 * q + 1] = v.y;
    a[4 * q + 2] = v.z;
    a[4 * q + 3] = v.w;
  }
}

// Element (n, r) of a bf16 tile operand (NP features x the tile's 128 rows,
// the rows the product's K) laid out MN-major for wgmma (no swizzle): core
// matrices of 8 rows r by 8 features n (16 bytes a row, the features
// contiguous), LBO = 128 bytes along r, SBO = 2048 along n; the bf16
// flavor's dW operands and the head's input.
static __device__ __forceinline__ int wb_mn_offset(int n, int r) {
  return (n >> 3) * (WB_ROWS / 8) * 64 + (r >> 3) * 64 + (r & 7) * 8 + (n & 7);
}

// The lane's two tile rows (row0, row0 + 8) of a (rows x NP) operand, the
// accumulator layout, into buf transposed and K-major: feature n's 128 tile
// rows r at wg_cm_offset(n, r, 128, 4), the operand of a product over the
// tile's rows: rounded to TF32 (FL_TF32), or as it is (FL_F32: the
// tensor cores read its truncated hi part, wb_dw3 its lo part); FL_BF16:
// rounded to bf16 into a bf16 plane, MN-major (wb_mn_offset), a register
// pair (columns 2t, 2t + 1) a store.
template <int FL, int NP>
static __device__ __forceinline__ void wb_put_kmajor(const float (&a)[NP / 2],
                                                     float* buf, int row0,
                                                     int t) {
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) {
    const int r = row0 + ((i & 2) ? 8 : 0);
    if constexpr (FL == FL_BF16) {
      if ((i & 1) == 0)
        *reinterpret_cast<__nv_bfloat162*>(
            reinterpret_cast<bf16*>(buf) + wb_mn_offset(acc_col(i, t), r)) =
            __floats2bfloat162_rn(a[i], a[i + 1]);
    } else {
      buf[wg_cm_offset(acc_col(i, t), r, WB_ROWS, 4)] = opnd<FL>(a[i]);
    }
  }
}

// split_pieces' three bf16 pieces of the pair (x0, x1): p[2] = hi = rn(x),
// p[1] = mid = rn(x - hi), p[0] = lo = rn(x - hi - mid) (the subtractions
// are exact, the three sum to x).
static __device__ __forceinline__ void wb_pieces2(float x0, float x1,
                                                  __nv_bfloat162 (&p)[3]) {
  p[2] = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(p[2]);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  p[1] = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(p[1]);
  p[0] = __floats2bfloat162_rn(r0 - mf.x, r1 - mf.y);
}

// The bf16 flavor's dW operand dP_l: the lane's two tile rows of the f32
// cotangent cut into split_pieces' three bf16 pieces (wb_pieces2), each
// MN-major as wb_put_kmajor<FL_BF16> writes, in planes of NP/2 columns: the
// columns of warpgroup half h (wb_dw_pieces' B) at pc + (3 h + p) NP/2 x
// 128, piece p = 0 lo, 1 mid, 2 hi, so a warpgroup's three planes lie
// together.
template <int NP>
static __device__ __forceinline__ void wb_put_pieces(const float (&a)[NP / 2],
                                                     bf16* pc, int row0,
                                                     int t) {
  constexpr int H2 = NP / 2, PL = H2 * WB_ROWS;
#pragma unroll
  for (int i = 0; i < NP / 2; i += 2) {
    const int r = row0 + ((i & 2) ? 8 : 0), n = acc_col(i, t);
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(
        pc + (n / H2) * 3 * PL + wb_mn_offset(n % H2, r));
    __nv_bfloat162 v[3];
    wb_pieces2(a[i], a[i + 1], v);
    p[0] = v[0];
    p[PL / 2] = v[1];
    p[PL] = v[2];
  }
}

// Element (i, r) of the head operand Ht as the flavor holds it: f32,
// K-major (rounded to TF32 in the TF32 flavor), or the bf16 flavor's bf16
// plane, MN-major.
template <int FL>
static __device__ __forceinline__ float wb_ht(const float* Ht, int i, int r) {
  if constexpr (FL == FL_BF16)
    return __bfloat162float(
        reinterpret_cast<const bf16*>(Ht)[wb_mn_offset(i, r)]);
  else
    return Ht[wg_cm_offset(i, r, WB_ROWS, 4)];
}

// y[k] += v for a channel index k that is the same in every lane (selects,
// not a register array indexed at run time).
template <int CP>
static __device__ __forceinline__ void wb_add_at(float* y, int k, float v) {
#pragma unroll
  for (int q = 0; q < CP; ++q) y[q] = q == k ? y[q] + v : y[q];
}

// Rotate a register array left by R: the passes below take their groups
// R registers at a time from the front, in a loop that is not unrolled, so
// their code is one batch long (the kernel's code, executed once per tile,
// is what bounds it from the instruction cache); NB rotations of R bring
// the array back.
template <int N, int R>
static __device__ __forceinline__ void wb_rotate(float (&a)[N]) {
  if constexpr (R < N) {
    float tmp[R];
#pragma unroll
    for (int i = 0; i < R; ++i) tmp[i] = a[i];
#pragma unroll
    for (int i = 0; i < N - R; ++i) a[i] = a[i + R];
#pragma unroll
    for (int i = 0; i < R; ++i) a[N - R + i] = tmp[i];
  }
}

// The transpose of the activation pass in place.  gr holds the cotangents
// dH of a layer's post-activation channels (the accumulator layout) and
// becomes the cotangents dG of its pre-activation channels P; q holds the
// layer's staged Q (wb_act's lane-transposed layout: the primal's tanh z
// in place of P's primal), so neither P's transpose nor the tanh is
// redone.  Each group of CP registers of gr is transposed (k1w_transpose)
// so that a lane holds all CP channels of one item; then, GB groups at a
// time, taylor_common.cuh's act_vjp_items on them: the chain z, d1 .. d5,
// then the channels in ascending order, each line's transpose (the same
// expressions, the same order).  In place is safe in that order: channel
// c's own cotangent is read before any line writes it (a line writes only
// lower channels, and channel 0 never: its cotangent closes the chain
// last).  Pad channels get zero.  q is spent (rotated).
template <int NP, int CP, int GB = 2>
static __device__ __forceinline__ void wb_act_vjp(float (&q)[NP / 2],
                                                  float (&gr)[NP / 2], int c,
                                                  const Sched& s) {
  constexpr int G = NP / 2 / CP, B = G < GB ? G : GB, R = B * CP;
#pragma unroll 1
  for (int it = 0; it < G / B; ++it) {
    float* pa = q;
    float* ga = gr;
#pragma unroll
    for (int j = 0; j < B; ++j) {
      float y[CP];
#pragma unroll
      for (int k = 0; k < CP; ++k) y[k] = ga[j * CP + k];
      k1w_transpose<CP>(y, c);
#pragma unroll
      for (int k = 0; k < CP; ++k) ga[j * CP + k] = y[k];
    }
    float d1[B], d2[B], d3[B], d4[B], d5[B];
    float gz[B], g1[B], g2[B], g3[B], g4[B];
#pragma unroll
    for (int j = 0; j < B; ++j) {
      const float z = pa[j * CP];
      d1[j] = 1.f - z * z;
      d2[j] = -2.f * z * d1[j];
      d3[j] = -2.f * d1[j] * (1.f - 3.f * z * z);
      d4[j] = -2.f * d2[j] * (1.f - 3.f * z * z) + 12.f * z * d1[j] * d1[j];
      const float z2 = z * z;
      d5[j] = d1[j] * (16.f - z2 * (120.f - 120.f * z2));
      gz[j] = ga[j * CP];
      g1[j] = g2[j] = g3[j] = g4[j] = 0.f;
    }
#pragma unroll
    for (int ch = 1; ch < CP; ++ch) {
      const int o = ch < s.C ? s.order[ch] : 0;
      const int* ix = s.idx[ch];
      if (o == 1) {
#pragma unroll
        for (int j = 0; j < B; ++j) {
          const float g = ga[j * CP + ch];
          g1[j] += g * pa[j * CP + ch];
          ga[j * CP + ch] = g * d1[j];
        }
      } else if (o == 2) {
#pragma unroll
        for (int j = 0; j < B; ++j) {
          const float* y = pa + j * CP;
          float* gc = ga + j * CP;
          const float g = gc[ch];
          g1[j] += g * y[ch];
          gc[ch] = g * d1[j];
          const float a = k1w_pick<CP>(y, ix[0]), bb = k1w_pick<CP>(y, ix[1]);
          g2[j] += g * a * bb;
          wb_add_at<CP>(gc, ix[0], g * d2[j] * bb);
          wb_add_at<CP>(gc, ix[1], g * d2[j] * a);
        }
      } else if (o == 3) {
#pragma unroll
        for (int j = 0; j < B; ++j) {
          const float* y = pa + j * CP;
          float* gc = ga + j * CP;
          const float g = gc[ch];
          g1[j] += g * y[ch];
          gc[ch] = g * d1[j];
          const float qi = k1w_pick<CP>(y, ix[0]), qj = k1w_pick<CP>(y, ix[1]),
                      qk = k1w_pick<CP>(y, ix[2]),
                      rij = k1w_pick<CP>(y, ix[3]),
                      rik = k1w_pick<CP>(y, ix[4]),
                      rjk = k1w_pick<CP>(y, ix[5]);
          g3[j] += g * qi * qj * qk;
          g2[j] += g * (rij * qk + rik * qj + rjk * qi);
          wb_add_at<CP>(gc, ix[0], g * (d3[j] * qj * qk + d2[j] * rjk));
          wb_add_at<CP>(gc, ix[1], g * (d3[j] * qi * qk + d2[j] * rik));
          wb_add_at<CP>(gc, ix[2], g * (d3[j] * qi * qj + d2[j] * rij));
          wb_add_at<CP>(gc, ix[3], g * d2[j] * qk);
          wb_add_at<CP>(gc, ix[4], g * d2[j] * qj);
          wb_add_at<CP>(gc, ix[5], g * d2[j] * qi);
        }
      } else if (o == 4) {
#pragma unroll
        for (int j = 0; j < B; ++j) {
          const float* y = pa + j * CP;
          float* gc = ga + j * CP;
          const float g = gc[ch];
          g1[j] += g * y[ch];
          gc[ch] = g * d1[j];
          const float q = k1w_pick<CP>(y, ix[0]), r = k1w_pick<CP>(y, ix[1]),
                      v = k1w_pick<CP>(y, ix[2]);
          g2[j] += g * (4.f * v * q + 3.f * r * r);
          g3[j] += g * 6.f * r * q * q;
          g4[j] += g * q * q * q * q;
          wb_add_at<CP>(gc, ix[0], g * (4.f * d2[j] * v + 12.f * d3[j] * r * q
                                        + 4.f * d4[j] * q * q * q));
          wb_add_at<CP>(gc, ix[1], g * (6.f * d2[j] * r + 6.f * d3[j] * q * q));
          wb_add_at<CP>(gc, ix[2], g * 4.f * d2[j] * q);
        }
      } else {  // a pad channel
#pragma unroll
        for (int j = 0; j < B; ++j) ga[j * CP + ch] = 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < B; ++j) {
      ga[j * CP] = gz[j] * d1[j] + g1[j] * d2[j] + g2[j] * d3[j]
                   + g3[j] * d4[j] + g4[j] * d5[j];
      float y[CP];
#pragma unroll
      for (int k = 0; k < CP; ++k) y[k] = ga[j * CP + k];
      k1w_transpose<CP>(y, c);
#pragma unroll
      for (int k = 0; k < CP; ++k) ga[j * CP + k] = y[k];
    }
    wb_rotate<NP / 2, R>(q);
    wb_rotate<NP / 2, R>(gr);
  }
}

// The activation pass in place, K1's route's k1w_act (kept apart, so K1's
// code stays as it is) with the layer's Q staged or taken back.  From P
// (FROM_Q false: the pre-activations in the accumulator layout): each
// group of CP registers is transposed
// (k1w_transpose) so that a lane holds all CP channels of one item, the
// primal's chain z = tanh, d1, d2 derived, and Q, those groups with z in
// place of P's primal, written to the workspace slice (16 bytes a group of
// four registers, streaming): the reverse sweep's recompute and VJP start
// from it with no butterfly and no tanh.  From Q (a staged slice, loaded by
// wb_load_p): no transpose in, no tanh.  Then the lines, from the highest
// channel down (a line reads only lower channels), in place; pad channels
// zero; the transpose back.  GB groups at a time, in a loop that is not
// unrolled (wb_rotate).
template <int NP, int CP, bool FROM_Q, int GB = 4>
static __device__ __forceinline__ void wb_act(float (&acc)[NP / 2], int c,
                                              const Sched& s,
                                              float* __restrict__ slice,
                                              int ctid) {
  constexpr int G = NP / 2 / CP, B = G < GB ? G : GB, R = B * CP;
#pragma unroll 1
  for (int it = 0; it < G / B; ++it) {
    float* a = acc;
    if constexpr (!FROM_Q) {
#pragma unroll
      for (int j = 0; j < B; ++j) {
        float x[CP];
#pragma unroll
        for (int q = 0; q < CP; ++q) x[q] = a[j * CP + q];
        k1w_transpose<CP>(x, c);
#pragma unroll
        for (int q = 0; q < CP; ++q) a[j * CP + q] = x[q];
      }
    }
    float z[B], d1[B], d2[B];
#pragma unroll
    for (int j = 0; j < B; ++j) {
      z[j] = FROM_Q ? a[j * CP] : tanhf(a[j * CP]);
      d1[j] = 1.f - z[j] * z[j];
      d2[j] = -2.f * z[j] * d1[j];
    }
    if constexpr (!FROM_Q) {
      // register r of the thread at slice[((r / 4) * 256 + ctid) * 4 + r % 4]
#pragma unroll
      for (int j = 0; j < B; ++j) {
        float v[CP];
        v[0] = z[j];
#pragma unroll
        for (int q = 1; q < CP; ++q) v[q] = a[j * CP + q];
        const int r0 = (it * B + j) * CP;
        if constexpr (CP % 4 == 0) {
#pragma unroll
          for (int q = 0; q < CP; q += 4)
            __stcs(reinterpret_cast<float4*>(slice) +
                       (size_t)((r0 + q) / 4) * WB_THREADS + ctid,
                   make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]));
        } else {
#pragma unroll
          for (int q = 0; q < CP; ++q) {
            const int r = r0 + q;
            __stcs(slice + ((size_t)(r / 4) * WB_THREADS + ctid) * 4 + r % 4,
                   v[q]);
          }
        }
      }
    }
#pragma unroll
    for (int ch = CP - 1; ch >= 1; --ch) {
      const int o = ch < s.C ? s.order[ch] : 0;
      const int* ix = s.idx[ch];
      if (o == 1) {
#pragma unroll
        for (int j = 0; j < B; ++j) a[j * CP + ch] = d1[j] * a[j * CP + ch];
      } else if (o == 2) {
#pragma unroll
        for (int j = 0; j < B; ++j) {
          const float* y = a + j * CP;
          a[j * CP + ch] = d1[j] * y[ch] + d2[j] * k1w_pick<CP>(y, ix[0])
                                               * k1w_pick<CP>(y, ix[1]);
        }
      } else if (o == 3) {
#pragma unroll
        for (int j = 0; j < B; ++j) {
          const float* y = a + j * CP;
          const float d3 = -2.f * d1[j] * (1.f - 3.f * z[j] * z[j]);
          const float qi = k1w_pick<CP>(y, ix[0]),
                      qj = k1w_pick<CP>(y, ix[1]),
                      qk = k1w_pick<CP>(y, ix[2]),
                      rij = k1w_pick<CP>(y, ix[3]),
                      rik = k1w_pick<CP>(y, ix[4]),
                      rjk = k1w_pick<CP>(y, ix[5]);
          a[j * CP + ch] = d3 * qi * qj * qk
                           + d2[j] * (rij * qk + rik * qj + rjk * qi)
                           + d1[j] * y[ch];
        }
      } else if (o == 4) {
#pragma unroll
        for (int j = 0; j < B; ++j) {
          const float* y = a + j * CP;
          const float e = 1.f - 3.f * z[j] * z[j];
          const float d3 = -2.f * d1[j] * e;
          const float d4 = -2.f * d2[j] * e + 12.f * z[j] * d1[j] * d1[j];
          const float q = k1w_pick<CP>(y, ix[0]), r = k1w_pick<CP>(y, ix[1]),
                      w = k1w_pick<CP>(y, ix[2]);
          a[j * CP + ch] = d1[j] * y[ch] + 4.f * d2[j] * w * q
                           + 3.f * d2[j] * r * r + 6.f * d3 * r * q * q
                           + d4 * q * q * q * q;
        }
      } else {  // a pad channel
#pragma unroll
        for (int j = 0; j < B; ++j) a[j * CP + ch] = 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < B; ++j) {
      float x[CP];
      x[0] = z[j];
#pragma unroll
      for (int q = 1; q < CP; ++q) x[q] = a[j * CP + q];
      k1w_transpose<CP>(x, c);
#pragma unroll
      for (int q = 0; q < CP; ++q) a[j * CP + q] = x[q];
    }
    wb_rotate<NP / 2, R>(acc);
  }
}

// The bias cotangent's share of a warp: each column's sum over the warp's
// primal rows (the bias sees only the primal channel) into sDb[warp][col].
// A lane's two rows are one channel (g % CP); the lanes of one channel and
// column differ in the bits of g at and above CP, which the shuffles sum.
template <int NP, int CP>
static __device__ __forceinline__ void wb_bias_partial(
    const float (&a)[NP / 2], float* sDb, int warp, int g, int t, int c) {
#pragma unroll
  for (int j = 0; j < NP / 8; ++j)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      float v = c == 0 ? a[4 * j + b] + a[4 * j + 2 + b] : 0.f;
      if (CP < 8) v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (CP < 4) v += __shfl_xor_sync(0xffffffffu, v, 8);
      if (CP < 2) v += __shfl_xor_sync(0xffffffffu, v, 4);
      if (g == 0) sDb[warp * NP + 8 * j + 2 * t + b] = v;
    }
}

// db of a layer of w <= 128 columns: the 8 warps' partials summed in warp
// order, into the slot (assigned on the block's first tile), a column a
// thread (wb_spread).
static __device__ __forceinline__ void wb_bias(const float* sDb, int NP,
                                               int w, float* __restrict__ slot,
                                               bool first, int ctid) {
  const int n = wb_spread(ctid);
  if (n >= w) return;
  float v = sDb[n];
  for (int k = 1; k < 8; ++k) v += sDb[k * NP + n];
  slot_rmw(slot + n, v, first);
}

// The weight ring: S stages of stage_bytes, each with a "full" mbarrier
// (the chunk's bytes landed) and an "empty" one (the 8 warps released it);
// the block's chunks are the planes' P in order, once per tile, total in
// all.  Thread 0 fills it: the first S chunks before the tiles, then chunk
// i + S into chunk i's stage as soon as every warp released chunk i.
struct WbRing {
  char* stages;
  const char* planes;
  uint64_t* full;
  uint64_t* empty;
  int S, P, stage_bytes;
  long long total;
};

static __device__ __forceinline__ void wb_fill(const WbRing& r, long long i) {
  const int st = (int)(i % r.S);
  mbar_expect(&r.full[st], (unsigned)r.stage_bytes);
  bulk_copy(r.stages + (size_t)st * r.stage_bytes,
            r.planes + (size_t)(i % r.P) * r.stage_bytes,
            (unsigned)r.stage_bytes, &r.full[st]);
}

// Wait for chunk i; returns its stage's shared address.
template <class R>
static __device__ __forceinline__ unsigned wb_acquire(const R& r,
                                                      long long i) {
  const int st = (int)(i % r.S);
  mbar_wait(&r.full[st], (unsigned)((i / r.S) & 1));
  return smem_addr(r.stages + (size_t)st * r.stage_bytes);
}

// The warp is done with chunk i (its products waited for); thread 0 then
// waits for the other warps and refills the stage with chunk i + S.
static __device__ __forceinline__ void wb_release(const WbRing& r,
                                                  long long i, int lane) {
  const int st = (int)(i % r.S);
  __syncwarp();
  if (lane == 0) mbar_arrive(&r.empty[st]);
  if (threadIdx.x == 0 && i + r.S < r.total) {
    mbar_wait(&r.empty[st], (unsigned)((i / r.S) & 1));
    wb_fill(r, i + r.S);
  }
}

// K3's work item over a member axis (wb_body_k3), in shared memory: thread
// 0 writes it at the item's start, before the block's barrier, and every
// thread reads it where it needs it (registers are the kernel's scarcest
// resource).  The ring's chunks run through the block's items in turn, each
// item's a whole number of tiles' P chunks (so i % P is still a chunk's
// plane): chunks before boundary come from planes (this item's member's),
// the rest, up to total (the end of the next item's), from next (the next
// item's member's), so thread 0 fills on across an item's end.
struct WbItem {
  const char* planes;
  const char* next;
  long long boundary, total;
  float* slot;  // its partial slot, m*G + b
  int j, m, b;  // the item, its member and virtual block
  int items;    // the launch's M*G
};
static_assert(sizeof(WbItem) <= 4 * WB_ITEM_FLOATS, "WbItem's bytes");

struct WbRingF {
  char* stages;
  uint64_t* full;
  uint64_t* empty;
  int S, P, stage_bytes;
  const WbItem* it;
};

static __device__ __forceinline__ void wb_fill(const WbRingF& r,
                                               long long i) {
  const int st = (int)(i % r.S);
  const char* planes = i < r.it->boundary ? r.it->planes : r.it->next;
  mbar_expect(&r.full[st], (unsigned)r.stage_bytes);
  bulk_copy(r.stages + (size_t)st * r.stage_bytes,
            planes + (size_t)(i % r.P) * r.stage_bytes,
            (unsigned)r.stage_bytes, &r.full[st]);
}

static __device__ __forceinline__ void wb_release(const WbRingF& r,
                                                  long long i, int lane) {
  const int st = (int)(i % r.S);
  __syncwarp();
  if (lane == 0) mbar_arrive(&r.empty[st]);
  if (threadIdx.x == 0 && i + r.S < r.it->total) {
    mbar_wait(&r.empty[st], (unsigned)((i / r.S) & 1));
    wb_fill(r, i + r.S);
  }
}

// One f32 (3xTF32) weight chunk's products into d (first: d afresh),
// issued and waited for: A (h's columns chunk*KC ..) split in registers as
// wg_chunk<FL_F32> splits it, then the small passes of every k step
// (A_lo B_hi, A_hi B_lo), then the A_hi B_hi passes.  The tensor cores
// round each sum into the accumulator toward zero, so a pass costs up to
// an ulp of what the accumulator holds: the small passes go in while it
// is small.
template <int NP, int KC>
static __device__ __forceinline__ void wb_chunk3(float (&d)[NP / 2],
                                                 const float (&h)[NP / 2],
                                                 int chunk, unsigned base,
                                                 bool first) {
  constexpr int S8 = KC / 8;
  unsigned ahi[S8][4], alo[S8][4];
#pragma unroll
  for (int s = 0; s < S8; ++s) {
    const int j = chunk * S8 + s;
    const float x[4] = {h[4 * j], h[4 * j + 2], h[4 * j + 1], h[4 * j + 3]};
#pragma unroll
    for (int q = 0; q < 4; ++q) split_tf32(x[q], ahi[s][q], alo[s][q]);
  }
  wg_fence();
  constexpr unsigned sbo = (KC / 4) * 128;
  const unsigned lo = base + NP * KC * 4;
#pragma unroll
  for (int s = 0; s < S8; ++s) {
    WgMma<false, NP>::run(d, alo[s], wg_desc(base + 256 * s, 128, sbo),
                          (first && s == 0) ? 0 : 1);
    WgMma<false, NP>::run(d, ahi[s], wg_desc(lo + 256 * s, 128, sbo), 1);
  }
#pragma unroll
  for (int s = 0; s < S8; ++s)
    WgMma<false, NP>::run(d, ahi[s], wg_desc(base + 256 * s, 128, sbo), 1);
  wg_commit();
  wg_wait_all();
#pragma unroll
  for (int s = 0; s < S8; ++s)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      wg_keep(ahi[s][q]);
      wg_keep(alo[s][q]);
    }
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) wg_keep(d[i]);
}

// One bf16 weight chunk's dH products into d (first: d afresh), issued
// and waited for: A the f32 cotangent h (its columns chunk*KC ..) cut in
// the registers into split_pieces' three bf16 pieces, a k16 step's pairs
// packed as wg_chunk<FL_BF16> packs them, then per k16 step the passes
// lo, mid, hi (the smallest first, as taylor_common.cuh's bmma_steps takes
// them) against the chunk's B.  SB k steps of pieces at a time (12
// registers a step), each batch waited for before the next is packed (SB =
// 4, one batch a chunk, ran no faster and spilled more).
template <int NP, int KC>
static __device__ __forceinline__ void wb_chunk_pieces(
    float (&d)[NP / 2], const float (&h)[NP / 2], int chunk, unsigned base,
    bool first) {
  constexpr int S16 = KC / 16, SB = 2;
  constexpr unsigned sbo = (KC / 8) * 128;
  static_assert(S16 % SB == 0, "whole batches of k steps");
#pragma unroll
  for (int b = 0; b < S16; b += SB) {
    unsigned a[SB][3][4];
#pragma unroll
    for (int s = 0; s < SB; ++s) {
      const int j = chunk * S16 + b + s;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        __nv_bfloat162 v[3];
        wb_pieces2(h[8 * j + 2 * q], h[8 * j + 2 * q + 1], v);
#pragma unroll
        for (int p = 0; p < 3; ++p)
          a[s][p][q] = *reinterpret_cast<const unsigned*>(&v[p]);
      }
    }
    wg_fence();
#pragma unroll
    for (int s = 0; s < SB; ++s) {
      const uint64_t bd = wg_desc(base + 256 * (b + s), 128, sbo);
#pragma unroll
      for (int p = 0; p < 3; ++p)
        WgMma<true, NP>::run(d, a[s][p], bd,
                             (first && b + s == 0 && p == 0) ? 0 : 1);
    }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int s = 0; s < SB; ++s)
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) wg_keep(a[s][p][q]);
  }
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) wg_keep(d[i]);
}

// Hidden layer l's forward product in place (K1's route's k1w_products on
// this ring): acc (the layer's input) becomes H W_l + b_l, the bias on
// primal rows.  FL_TF32: one pass a k step (wg_chunk).  FL_F32: three on
// the chunk's hi and lo planes (wb_chunk3), each chunk into an accumulator
// of its own, the chunks' sums added on the CUDA cores (rounded to
// nearest): the hidden activations, which every later sum over points
// reads, carry no drift toward zero from 48 truncating passes into one
// accumulator.
template <int FL, int NP, class R>
static __device__ __forceinline__ void wb_products(float (&acc)[NP / 2],
                                                   int l, int c, int t,
                                                   int lane, const float* sB,
                                                   const R& r,
                                                   long long& chunk) {
  constexpr int KC = wb_kc(FL);
  float nacc[NP / 2];
#pragma unroll
  for (int h = 0; h < NP / KC; ++h) {
    if constexpr (FL == FL_F32) {
      if (h == 0) {
        wb_chunk3<NP, KC>(nacc, acc, h, wb_acquire(r, chunk), true);
      } else {
        float part[NP / 2];
        wb_chunk3<NP, KC>(part, acc, h, wb_acquire(r, chunk), true);
#pragma unroll
        for (int i = 0; i < NP / 2; ++i) nacc[i] += part[i];
      }
    } else {
      wg_chunk<FL, NP, KC>(nacc, acc, h, wb_acquire(r, chunk), h == 0);
    }
    wb_release(r, chunk, lane);
    ++chunk;
  }
  const float* b = sB + l * NP;
#pragma unroll
  for (int i = 0; i < NP / 2; ++i)
    acc[i] = c == 0 ? nacc[i] + b[acc_col(i, t)] : nacc[i];
}

// dH_l = dP_l W_l^T into out: A the cotangent registers (rounded to TF32
// as they are packed, wg_chunk; or split into hi and lo in the f32 flavor,
// wb_chunk3, into the one accumulator; or cut into three bf16 pieces in
// the bf16 flavor, wb_chunk_pieces, and the sums rounded to bf16), B layer
// l's backward plane, chunk by chunk through the ring.
template <int FL, int NP, class R>
static __device__ __forceinline__ void wb_dh(float (&out)[NP / 2],
                                             const float (&in)[NP / 2],
                                             int lane, const R& r,
                                             long long& chunk) {
  constexpr int KC = wb_kc(FL);
#pragma unroll
  for (int h = 0; h < NP / KC; ++h) {
    if constexpr (FL == FL_F32)
      wb_chunk3<NP, KC>(out, in, h, wb_acquire(r, chunk), h == 0);
    else if constexpr (FL == FL_BF16)
      wb_chunk_pieces<NP, KC>(out, in, h, wb_acquire(r, chunk), h == 0);
    else
      wg_chunk<FL, NP, KC>(out, in, h, wb_acquire(r, chunk), h == 0);
    wb_release(r, chunk, lane);
    ++chunk;
  }
  if constexpr (FL == FL_BF16) {
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) out[i] = bf16r(out[i]);
  }
}

// dW_l = H_l^T dP_l over the tile's 128 rows into acc (ADD: added to it):
// warpgroup wg takes the columns wg*NP/2 .., all NP rows (NP/64 m64
// products per k step), A from Ht, B from its half of dPt, both K-major.
template <int NP, bool ADD = false>
static __device__ __forceinline__ void wb_dw_product(
    float (&acc)[NP / 64][NP / 4], const float* Ht, const float* dPt,
    int wg) {
  constexpr int H2 = NP / 2, MT = NP / 64, NR = NP / 4;
  constexpr unsigned SBO = (WB_ROWS / 4) * 128;  // an 8-row group's bytes
  if constexpr (!ADD) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < NR; ++i) acc[m][i] = 0.f;
  }
  const unsigned a0 = smem_addr(Ht);
  const unsigned b0 = smem_addr(dPt) + (unsigned)(wg * (H2 / 8)) * SBO;
  wg_fence();
#pragma unroll
  for (int s = 0; s < WB_ROWS / 8; ++s)
#pragma unroll
    for (int m = 0; m < MT; ++m)
      WgMmaSS<H2>::run(acc[m], wg_desc(a0 + m * 8 * SBO + 256 * s, 128, SBO),
                       wg_desc(b0 + 256 * s, 128, SBO),
                       (ADD || s > 0) ? 1 : 0);
  wg_commit();
  wg_wait_all();
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < NR; ++i) wg_keep(acc[m][i]);
}

// dW_l = H_l^T dP_l in the f32 flavor (3xTF32) into acc.  Ht and dPt hold
// the f32 values (wb_put_kmajor<FL_F32>), which the tensor cores read as
// their truncated TF32 hi parts; the lo parts are made in place
// (wb_lo_in_place), so the three passes run over the one pair of buffers:
// hi hi; then the warpgroup's half of dPt (which no other warpgroup reads)
// turned into its lo parts, hi lo; then Ht turned into its lo parts and
// dPt written again from the cotangent registers dp (the lane's rows of
// dP_l, as wb_put_kmajor wrote them), lo hi.  Every pass waits for its
// products, so the barriers order the rewrites after the reads.
template <int NP>
static __device__ __forceinline__ void wb_dw3(
    float (&acc)[NP / 64][NP / 4], float* Ht, float* dPt,
    const float (&dp)[NP / 2], int wg, int wt, int ctid, int row0, int t) {
  constexpr int H2 = NP / 2;
  wb_dw_product<NP>(acc, Ht, dPt, wg);
  wb_sync_wg(wg);
  wb_lo_in_place(dPt + wg * H2 * WB_ROWS, H2 * WB_ROWS, wt, 128);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  wb_sync_wg(wg);
  wb_dw_product<NP, true>(acc, Ht, dPt, wg);
  wb_sync_all();
  wb_lo_in_place(Ht, NP * WB_ROWS, ctid, WB_THREADS);
  wb_put_kmajor<FL_F32, NP>(dp, dPt, row0, t);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  wb_sync_all();
  wb_dw_product<NP, true>(acc, Ht, dPt, wg);
}

// d (+)= A B over one bf16 k16 step with both operands in shared memory
// (m64nNk16), both MN-major (the instruction's transpose bits 1,
// wb_mn_offset's layout): the bf16 flavor's dW.  N = 32 or 64.
template <int N>
struct WgMmaSSbf;

template <>
struct WgMmaSSbf<32> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgMmaSSbf<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// dW_l = H_l^T dP_l in the bf16 flavor over the tile's 128 rows into acc:
// warpgroup wg takes the columns wg*NP/2 .., all NP rows; A the bf16 plane
// Hb (wb_put_kmajor<FL_BF16>), B its three piece planes at pc
// (wb_put_pieces), both MN-major (a k16 step two core matrices along the
// rows, 256 bytes), three passes lo, mid, hi over every k16 step.  A bf16
// product is exact in f32, so the three are H^T dP up to the order of the
// sums.
template <int NP>
static __device__ __forceinline__ void wb_dw_pieces(
    float (&acc)[NP / 64][NP / 4], const bf16* Hb, const bf16* pc, int wg) {
  constexpr int H2 = NP / 2, MT = NP / 64, NR = NP / 4;
  constexpr unsigned SBO = (WB_ROWS / 8) * 128;  // an 8-row group's bytes
  constexpr unsigned PB = H2 * WB_ROWS * 2;      // a piece plane's bytes
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < NR; ++i) acc[m][i] = 0.f;
  const unsigned a0 = smem_addr(Hb);
  const unsigned b0 = smem_addr(pc) + (unsigned)wg * 3 * PB;
  wg_fence();
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int s = 0; s < WB_ROWS / 16; ++s)
#pragma unroll
      for (int m = 0; m < MT; ++m)
        WgMmaSSbf<H2>::run(acc[m],
                           wg_desc(a0 + m * 8 * SBO + 256 * s, 128, SBO),
                           wg_desc(b0 + p * PB + 256 * s, 128, SBO),
                           (p > 0 || s > 0) ? 1 : 0);
  wg_commit();
  wg_wait_all();
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < NR; ++i) wg_keep(acc[m][i]);
}

// The warpgroup's dW block (wb_dw_product) into the block's slot rows
// (slot: the layer's W in the slot, Ni x Nn): row-major [NP][NP/2] over the
// warpgroup's half of dPt (no other warpgroup reads it), then one slot row
// per thread by a bulk copy on the block's first tile, else a bulk
// reduce-add (bulk), or, where the rows are not 16-byte pieces, element by
// element.  A thread's add to a row waits for its add to the same row one
// tile before, which lies `behind` bulk groups back (its groups of a tile
// less one), so the row's sums are taken in the tiles' order; the staging
// is read before dPt is written again (bulk_wait_read before the block's
// next barrier).  PIECES (the bf16 flavor): dPt is the piece planes
// (wb_put_pieces), and the staging lies over the warpgroup's own three.
template <int NP, bool PIECES = false>
static __device__ __forceinline__ void wb_dw_update(
    const float (&acc)[NP / 64][NP / 4], float* dPt,
    float* __restrict__ slot, int Ni, int Nn, bool first, int bulk,
    int behind, int wg, int wt, int wq, int g, int t) {
  constexpr int H2 = NP / 2, MT = NP / 64;
  float* st = PIECES ? dPt + wg * (3 * H2 * WB_ROWS / 2)
                     : dPt + wg * H2 * WB_ROWS;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < H2 / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 64 * m + 16 * wq + g + 8 * h;
        *reinterpret_cast<float2*>(st + i * H2 + 8 * j + 2 * t) =
            make_float2(acc[m][4 * j + 2 * h], acc[m][4 * j + 2 * h + 1]);
      }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  wb_sync_wg(wg);
  const int n0 = wg * H2, len = imin(H2, Nn - n0);
  if (len <= 0) return;
  if (bulk) {
    if (wt < Ni) {
      bulk_wait_pending(behind);
      float* dst = slot + (size_t)wt * Nn + n0;
      if (first) bulk_store(dst, st + wt * H2, 4u * (unsigned)len);
      else bulk_reduce_add(dst, st + wt * H2, 4u * (unsigned)len);
      bulk_commit();
    }
  } else {
    for (int e = wt; e < NP * H2; e += 128) {
      const int i = e / H2, n = e % H2;
      if (i < Ni && n < len) slot_rmw(slot + (size_t)i * Nn + n0 + n, st[e],
                                      first);
    }
  }
}

// The head's table rows T[row][o] (K3): K1's route's head (k1w_head) into
// shared memory, every row (a pad channel's is zero).  FL_TF32 (FL_BF16):
// acc (the post-activations) is rounded to TF32 (bf16) in place.
template <int FL, int NP>
static __device__ __forceinline__ void wb_head(float (&acc)[NP / 2],
                                               float* T, int n_out, int c,
                                               int t, int row0,
                                               const float* sWh,
                                               const float* sBh) {
  if constexpr (FL == FL_TF32) {
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) acc[i] = tf32r(acc[i]);
  } else if constexpr (FL == FL_BF16) {
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) acc[i] = bf16r(acc[i]);
  }
  for (int o = 0; o < n_out; ++o) {
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < NP / 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float w0 = sWh[col * n_out + o], w1 = sWh[(col + 1) * n_out + o];
      s0 = fmaf(acc[4 * j], w0, s0);
      s0 = fmaf(acc[4 * j + 1], w1, s0);
      s1 = fmaf(acc[4 * j + 2], w0, s1);
      s1 = fmaf(acc[4 * j + 3], w1, s1);
    }
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    if (c == 0) {
      s0 += sBh[o];
      s1 += sBh[o];
    }
    if ((o & 3) == t) {
      T[row0 * n_out + o] = s0;
      T[(row0 + 8) * n_out + o] = s1;
    }
  }
}

// Layer 0's pre-activations of the lane's two rows (points pl0, pl1 of the
// tile; its channel of order ord, -1 a pad channel): K1's route's
// k1w_layer0 with X's rows from shared memory (sx: the tile's, zero past
// N), rounded as the flavor's operands (opnd: to TF32, or not at all).
template <int FL, int NP>
static __device__ __forceinline__ void wb_layer0(const float* sx, int d,
                                                 int pl0, int pl1, int ord,
                                                 int dir, int t,
                                                 const float* sW0,
                                                 const float* sB,
                                                 float (&acc)[NP / 2]) {
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) acc[i] = 0.f;
  for (int k = 0; k < d; ++k) {
    const float x0 = opnd<FL>(sx[pl0 * d + k]),
                x1 = opnd<FL>(sx[pl1 * d + k]);
    const float* w = sW0 + k * NP;
#pragma unroll
    for (int i = 0; i < NP / 2; ++i)
      acc[i] = fmaf((i & 2) ? x1 : x0, w[acc_col(i, t)], acc[i]);
  }
  const float* seed = sW0 + dir * NP;
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) {
    const int col = acc_col(i, t);
    acc[i] = ord == 0 ? acc[i] + sB[col] : (ord == 1 ? seed[col] : 0.f);
  }
}

// K3's epilogue of one tile of ROWS rows: one thread per point interprets the
// tape (tape_point, the point's coordinates from sx) on its rows of T,
// which become the table
// cotangents (a row past N gets zeros and runs no tape); the value's sum
// over the tile (a warp's by shuffles, the 8 warps' in order) into the
// slot's last element.  Ends with the block's barrier.
template <int CP, int ROWS = WB_ROWS>
static __device__ __forceinline__ void wb_epilogue(
    float* T, const float* sx, const float* __restrict__ w,
    float* __restrict__ gw, float* __restrict__ gX, int N, int p0, int C,
    int n_out, int d, const Tape& tp, const float* cst, float* sRed,
    float* vslot, bool first, int ctid, int lane, int warp) {
  constexpr int TP = ROWS / CP;
  float v = 0.f;
  if (ctid < TP) {
    const int gp = p0 + ctid;
    float* rows = T + ctid * CP * n_out;
    if (gp < N) {
      v = tape_point(rows, n_out, sx + ctid * d, w, gw, gX, gp, C, n_out, d,
                     tp, cst);
    } else {
      for (int cc = 0; cc < C; ++cc)
        for (int o = 0; o < n_out; ++o) rows[cc * n_out + o] = 0.f;
    }
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  if (lane == 0) sRed[warp] = v;
  wb_sync_all();
  if (ctid == 0) {
    float sum = sRed[0];
    for (int k = 1; k < 8; ++k) sum += sRed[k];
    slot_rmw(vslot, sum, first);
  }
  wb_sync_all();
}

// The head's cotangent products from T (its pre-activation cotangents,
// rows x n_out) and Ht (its input, the flavor's operand, K-major: wb_ht):
// db and dW into the slot, one output element a thread, summed over the
// tile's rows in order (taylor_common.cuh's narrow_dw, bias_accum); dH, the
// cotangent of the last hidden layer's post-activations, into the lane's
// registers (narrow_dh), W from sWh.  T rounded as the flavor's cotangent
// operands (gopnd: to TF32, or as it is in the f32 and bf16 flavors); the
// bf16 flavor's dH rounded to bf16, as narrow_dh<true> rounds it.
template <int FL, int NP, int CP>
static __device__ __forceinline__ void wb_head_bwd(
    float (&dh)[NP / 2], const float* T, const float* Ht, const float* sWh,
    int n_out, int wl, float* __restrict__ pW, float* __restrict__ pb,
    bool first, int ctid, int row0, int t) {
  constexpr int TP = WB_ROWS / CP;
  for (int o = ctid; o < n_out; o += WB_THREADS) {
    float v = 0.f;
    for (int p = 0; p < TP; ++p) v += T[p * CP * n_out + o];
    slot_rmw(pb + o, v, first);
  }
  for (int base = 0; base < wl * n_out; base += WB_THREADS) {
    const int e = base + wb_spread(ctid);
    if (e >= wl * n_out) break;
    const int i = e / n_out, o = e % n_out;
    float v = 0.f;
    for (int r = 0; r < WB_ROWS; ++r)
      v = fmaf(wb_ht<FL>(Ht, i, r), gopnd<FL>(T[r * n_out + o]), v);
    slot_rmw(pW + e, v, first);
  }
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) dh[i] = 0.f;
  for (int o = 0; o < n_out; ++o) {
    const float a0 = gopnd<FL>(T[row0 * n_out + o]);
    const float a1 = gopnd<FL>(T[(row0 + 8) * n_out + o]);
#pragma unroll
    for (int i = 0; i < NP / 2; ++i)
      dh[i] = fmaf((i & 2) ? a1 : a0, sWh[acc_col(i, t) * n_out + o], dh[i]);
  }
  if constexpr (FL == FL_BF16) {
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) dh[i] = bf16r(dh[i]);
  }
}

// Layer 0's weight and input cotangents from dP_0 (in dPt, the flavor's
// operand, K-major; f32 in the bf16 flavor) and the tile's rows of X (sx,
// rounded here as the flavor's operands): taylor_common.cuh's layer0_bwd,
// one output element a thread.  dX = the sum (K2), or += it (K3: the
// tape's direct adjoints are there); the bf16 flavor's sum rounded to bf16
// first.
template <int FL, int CP, bool K3>
static __device__ __forceinline__ void wb_layer0_bwd(
    const float* dPt, const float* sx, const float* sW0, int NP,
    float* __restrict__ dX, float* __restrict__ pW, int N, int p0, int d,
    int w0, const Sched& s, bool first, int ctid) {
  constexpr int TP = WB_ROWS / CP;
  for (int e = ctid; e < d * w0; e += WB_THREADS) {
    const int k = e / w0, j = e % w0;
    float v = 0.f;
    for (int p = 0; p < TP; ++p)
      v = fmaf(opnd<FL>(sx[p * d + k]),
               dPt[wg_cm_offset(j, p * CP, WB_ROWS, 4)], v);
    for (int cc = 1; cc < s.C; ++cc) {
      if (s.order[cc] != 1 || s.idx[cc][0] != k) continue;
      for (int p = 0; p < TP; ++p)
        v += dPt[wg_cm_offset(j, p * CP + cc, WB_ROWS, 4)];
    }
    slot_rmw(pW + e, v, first);
  }
  for (int e = ctid; e < TP * d; e += WB_THREADS) {
    const int p = e / d, k = e % d, gp = p0 + p;
    if (gp >= N) continue;
    float v = 0.f;
    for (int j = 0; j < w0; ++j)
      v = fmaf(dPt[wg_cm_offset(j, p * CP, WB_ROWS, 4)], sW0[k * NP + j], v);
    if constexpr (FL == FL_BF16) v = bf16r(v);
    float* dst = dX + (size_t)gp * d + k;
    *dst = K3 ? *dst + v : v;
  }
}

// K2's body on the route (the table cotangents gtab in, dX out), in flavor
// FL (FL_F32, FL_TF32 or FL_BF16).  The bf16 flavor's operands of dW take
// the bytes of H^T and dP^T as four bf16 planes: Hb, then the pieces
// (wb_put_pieces); layer 0's dP_0 goes to dPt in f32.  K3's body
// (wb_body_k3, over a member axis) runs the same tile; this one keeps its
// own copy so that K2's instructions stay as they were.
template <int FL, int NP, int CP>
static __device__ __forceinline__ void wb_body(
    const float* __restrict__ X, const float* __restrict__ prm,
    const float* __restrict__ gtab, float* __restrict__ dX,
    float* __restrict__ part, float* __restrict__ ws, int N, const Net& net,
    const Sched& s, const WbPlan& wp) {
  constexpr int H2 = NP / 2, TP = WB_ROWS / CP;
  extern __shared__ __align__(128) char smw[];
  const int d = net.d, L = net.L, n_out = net.n_out, C = s.C;
  char* stages = smw;
  float* Ht = reinterpret_cast<float*>(smw + (size_t)wp.S * wp.stage_bytes);
  float* dPt = Ht + NP * WB_ROWS;
  bf16* const Hb = reinterpret_cast<bf16*>(Ht);
  bf16* const pc = Hb + NP * WB_ROWS;
  float* T = dPt + NP * WB_ROWS;
  float* sDb = T;  // the reverse sweep's bias partials
  float* sx = T + wb_rows_floats(net, NP);
  float* sW0 = sx + pad4(WB_ROWS * d);
  float* sB = sW0 + d * NP;
  float* sWh = sB + (L - 1) * NP;
  float* sBh = sWh + NP * n_out;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smw + (wp.smem - 2 * WG_MAXS * 8));
  uint64_t* empty = full + WG_MAXS;
  if (threadIdx.x == 0) {
    for (int i = 0; i < wp.S; ++i) {
      mbar_init_n(&full[i], 1);
      mbar_init_n(&empty[i], 8);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  const int w0 = net.w_out[0], wl = net.w_in[L - 1];
  for (int e = threadIdx.x; e < d * NP; e += WB_THREADS) {
    const int k = e / NP, n = e % NP;
    sW0[e] = n < w0 ? opnd<FL>(prm[net.offW[0] + k * w0 + n]) : 0.f;
  }
  for (int e = threadIdx.x; e < (L - 1) * NP; e += WB_THREADS) {
    const int l = e / NP, n = e % NP;
    sB[e] = n < net.w_out[l] ? prm[net.offb[l] + n] : 0.f;
  }
  for (int e = threadIdx.x; e < NP * n_out; e += WB_THREADS)
    sWh[e] = e / n_out < wl ? opnd<FL>(prm[net.offW[L - 1] + e]) : 0.f;
  for (int o = threadIdx.x; o < n_out; o += WB_THREADS)
    sBh[o] = prm[net.offb[L - 1] + o];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t slice = (size_t)WB_ROWS * NP;
  const int mine = (wp.n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                   (int)gridDim.x;
  const WbRing ring{stages,
                    reinterpret_cast<const char*>(
                        ws + (size_t)wp.grid * (L - 1) * slice),
                    full, empty, wp.S, wp.P, wp.stage_bytes,
                    (long long)mine * wp.P};
  if (threadIdx.x == 0)
    for (long long i = 0; i < imin(wp.S, (int)ring.total); ++i)
      wb_fill(ring, i);
  const int ctid = threadIdx.x, wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, t = lane & 3, wt = ctid & 127;
  const int c = g % CP;
  const int ord = c < C ? s.order[c] : -1;
  const int dir = ord == 1 ? s.idx[c][0] : 0;
  const int row0 = 64 * wg + 16 * wq + g;
  const int pl0 = row0 / CP, pl1 = (row0 + 8) / CP;
  float* mypart = part + (size_t)blockIdx.x * slot_stride(net.P_total);
  float* myws = ws + (size_t)blockIdx.x * (L - 1) * slice;
  long long chunk = 0;
  // the bulk groups this thread issues a tile (wb_dw_update), less one
  int behind = -1;
  for (int l = 1; l + 1 < L; ++l)
    behind += wt < net.w_in[l] && wg * H2 < net.w_out[l];
  for (int tile = blockIdx.x; tile < wp.n_tiles; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;
    const int p0 = tile * TP;
    for (int e = ctid; e < TP * d; e += WB_THREADS)
      sx[e] = p0 + e / d < N ? X[(size_t)p0 * d + e] : 0.f;
    wb_sync_all();
    // the forward, staging Q_0 .. Q_{L-2}
    float acc[H2];
    wb_layer0<FL, NP>(sx, d, pl0, pl1, ord, dir, t, sW0, sB, acc);
    for (int l = 1; l < L; ++l) {
      wb_act<NP, CP, false>(acc, c, s, myws + (l - 1) * slice, ctid);
      if (l + 1 < L)
        wb_products<FL, NP>(acc, l, c, t, lane, sB, ring, chunk);
    }
    // the head: acc holds its input H_{L-1}
    wb_put_kmajor<FL, NP>(acc, Ht, row0, t);
    for (int e = ctid; e < WB_ROWS * n_out; e += WB_THREADS) {
      const int r = e / n_out, o = e % n_out, p = r / CP, cc = r % CP;
      const int gp = p0 + p;
      T[e] = (cc < C && gp < N) ? gtab[((size_t)cc * N + gp) * n_out + o]
                                : 0.f;
    }
    wb_sync_all();
    float dh[H2];
    wb_head_bwd<FL, NP, CP>(dh, T, Ht, sWh, n_out, wl,
                        mypart + net.offW[L - 1], mypart + net.offb[L - 1],
                        first, ctid, row0, t);
    // the reverse sweep, last hidden layer to layer 0
    for (int l = L - 2; l >= 0; --l) {
      bulk_wait_read();
      wb_sync_all();  // Ht, dPt (the staged dW read), sDb free
      float x[H2];
      if (l >= 1) {  // H_l, the layer's input, from Q_{l-1}
        wb_load_p<NP>(x, myws + (l - 1) * slice, ctid);
        wb_act<NP, CP, true>(x, c, s, nullptr, ctid);
        wb_put_kmajor<FL, NP>(x, Ht, row0, t);
      }
      wb_load_p<NP>(x, myws + l * slice, ctid);  // Q_l
      wb_act_vjp<NP, CP>(x, dh, c, s);          // dh = dP_l
      wb_bias_partial<NP, CP>(dh, sDb, warp, g, t, c);
      if constexpr (FL == FL_BF16) {
        if (l == 0) wb_put_kmajor<FL_F32, NP>(dh, dPt, row0, t);
        else wb_put_pieces<NP>(dh, pc, row0, t);
      } else {
        wb_put_kmajor<FL, NP>(dh, dPt, row0, t);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wb_sync_all();
      wb_bias(sDb, NP, net.w_out[l], mypart + net.offb[l], first, ctid);
      if (l == 0) {
        wb_layer0_bwd<FL, CP, false>(dPt, sx, sW0, NP, dX,
                                     mypart + net.offW[0], N, p0, d, w0, s,
                                     first, ctid);
        break;
      }
      float nh[H2];
      if constexpr (FL == FL_TF32) {
        wb_dh<FL, NP>(nh, dh, lane, ring, chunk);
        float dw[NP / 64][NP / 4];
        wb_dw_product<NP>(dw, Ht, dPt, wg);
        wb_dw_update<NP>(dw, dPt, mypart + net.offW[l], net.w_in[l],
                         net.w_out[l], first, wp.bulk, behind, wg, wt, wq, g,
                         t);
      } else if constexpr (FL == FL_BF16) {
        wb_dh<FL, NP>(nh, dh, lane, ring, chunk);
        float dw[NP / 64][NP / 4];
        wb_dw_pieces<NP>(dw, Hb, pc, wg);
        wb_dw_update<NP, true>(dw, reinterpret_cast<float*>(pc),
                               mypart + net.offW[l], net.w_in[l],
                               net.w_out[l], first, wp.bulk, behind, wg, wt,
                               wq, g, t);
      } else {  // dW first: its passes write dPt again from dh
        {
          float dw[NP / 64][NP / 4];
          wb_dw3<NP>(dw, Ht, dPt, dh, wg, wt, ctid, row0, t);
          wb_dw_update<NP>(dw, dPt, mypart + net.offW[l], net.w_in[l],
                           net.w_out[l], first, wp.bulk, behind, wg, wt, wq,
                           g, t);
        }
        wb_dh<FL, NP>(nh, dh, lane, ring, chunk);
      }
#pragma unroll
      for (int i = 0; i < H2; ++i) dh[i] = nh[i];
    }
    wb_sync_all();  // sx, sDb and dPt read before the next tile
  }
  bulk_wait();  // this thread's last bulk adds are in the slot
}

// K3's body on the route (the tape's epilogue on the head's rows; w in, gw
// and gX out), in flavor FL, over a member axis of M networks (a family's
// members, which share N, the architecture and the tape's ops tp; M = 1 is
// the single network): X, w, prm, gw and gX hold the members one after
// another, cst_tab their tape constants (MAXTCONST a member; nullptr:
// tp's own), and the members' weight planes follow the blocks' slices, one
// member's after another's.  Member m keeps the single launch's partition:
// G = wp.grid virtual blocks, b running its tiles b, b + G, ... into its
// slot m*G + b.  The launch's persistent blocks walk the M*G work items
// (m, b) in turn (block k the items k, k + gridDim.x, ...), so each slot
// gets the single launch's adds in its order and every member's outputs
// are that launch's bit for bit.  An item's state (WbItem) lives in shared
// memory, its small operands are loaded after the previous item's last
// barrier, and the ring fills on across items (WbRingF).  The tile is
// K2's (wb_body) with the head's table rows from the forward and the tape.
template <int FL, int NP, int CP>
static __device__ __forceinline__ void wb_body_k3(
    const float* __restrict__ X, const float* __restrict__ w,
    const float* __restrict__ prm, float* __restrict__ gw,
    float* __restrict__ gX, float* __restrict__ part,
    float* __restrict__ ws, int N, const Net& net, const Sched& s,
    const Tape& tp, const float* __restrict__ cst_tab, int M,
    const WbPlan& wp) {
  constexpr int H2 = NP / 2, TP = WB_ROWS / CP;
  extern __shared__ __align__(128) char smw[];
  const int d = net.d, L = net.L, n_out = net.n_out, C = s.C;
  char* stages = smw;
  float* Ht = reinterpret_cast<float*>(smw + (size_t)wp.S * wp.stage_bytes);
  float* dPt = Ht + NP * WB_ROWS;
  bf16* const Hb = reinterpret_cast<bf16*>(Ht);
  bf16* const pc = Hb + NP * WB_ROWS;
  float* T = dPt + NP * WB_ROWS;
  float* sDb = T;  // the reverse sweep's bias partials
  float* sx = T + wb_rows_floats(net, NP);
  float* sW0 = sx + pad4(WB_ROWS * d);
  float* sB = sW0 + d * NP;
  float* sWh = sB + (L - 1) * NP;
  float* sBh = sWh + NP * n_out;
  float* sRed = sW0 + wb_misc_floats(net, NP);
  WbItem* it = reinterpret_cast<WbItem*>(sRed + 8);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smw + (wp.smem - 2 * WG_MAXS * 8));
  uint64_t* empty = full + WG_MAXS;
  if (threadIdx.x == 0) {
    for (int i = 0; i < wp.S; ++i) {
      mbar_init_n(&full[i], 1);
      mbar_init_n(&empty[i], 8);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  const int w0 = net.w_out[0], wl = net.w_in[L - 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t slice = (size_t)WB_ROWS * NP;
  const WbRingF ring{stages, full, empty, wp.S, wp.P, wp.stage_bytes, it};
  const int ctid = threadIdx.x, wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, t = lane & 3, wt = ctid & 127;
  const int c = g % CP;
  const int ord = c < C ? s.order[c] : -1;
  const int dir = ord == 1 ? s.idx[c][0] : 0;
  const int row0 = 64 * wg + 16 * wq + g;
  const int pl0 = row0 / CP, pl1 = (row0 + 8) / CP;
  const int P_all = net.P_total + 1, E = tp.n_eq, G = wp.grid;
  float* myws = ws + (size_t)blockIdx.x * (L - 1) * slice;
  long long chunk = 0;
  // the bulk groups this thread issues a tile (wb_dw_update), less one
  int behind = -1;
  for (int l = 1; l + 1 < L; ++l)
    behind += wt < net.w_in[l] && wg * H2 < net.w_out[l];
  // the block's items j, j + gridDim.x, ... (j < M*G as grid <= M*G), their
  // tiles in one loop: tile < 0 starts item -1 - tile.  The item's values
  // are read from its state where they are needed, so the tiles hold no
  // more registers than the single launch's did
  int tile = -1 - (int)blockIdx.x;
  for (;;) {
    if (tile < 0) {
      const int j = -1 - tile, b = j % G;
      __syncthreads();  // every thread has read the previous item's state
      if (threadIdx.x == 0) {  // the item's state; its ring (WbItem)
        const char* planes0 = reinterpret_cast<const char*>(
            ws + (size_t)gridDim.x * (L - 1) * slice);
        const size_t bytes = (size_t)wp.P * wp.stage_bytes;  // a member's
        const int jn = j + gridDim.x;
        it->j = j;
        it->m = j / G;
        it->b = b;
        it->items = M * G;
        it->slot = part + (size_t)j * slot_stride(P_all);
        it->planes = planes0 + (size_t)(j / G) * bytes;
        it->next = jn < M * G ? planes0 + (size_t)(jn / G) * bytes
                              : it->planes;
        // the chunks of an item: its tiles' P each
        it->boundary =
            chunk + (long long)((wp.n_tiles - b + G - 1) / G) * wp.P;
        it->total = it->boundary +
                    (jn < M * G ? (long long)((wp.n_tiles - jn % G + G - 1) /
                                              G) * wp.P
                                : 0);
      }
      {  // the member's small operands
        const float* pm = prm + (size_t)(j / G) * net.P_total;
        for (int e = threadIdx.x; e < d * NP; e += WB_THREADS) {
          const int k = e / NP, n = e % NP;
          sW0[e] = n < w0 ? opnd<FL>(pm[net.offW[0] + k * w0 + n]) : 0.f;
        }
        for (int e = threadIdx.x; e < (L - 1) * NP; e += WB_THREADS) {
          const int l = e / NP, n = e % NP;
          sB[e] = n < net.w_out[l] ? pm[net.offb[l] + n] : 0.f;
        }
        for (int e = threadIdx.x; e < NP * n_out; e += WB_THREADS)
          sWh[e] = e / n_out < wl ? opnd<FL>(pm[net.offW[L - 1] + e]) : 0.f;
        for (int o = threadIdx.x; o < n_out; o += WB_THREADS)
          sBh[o] = pm[net.offb[L - 1] + o];
      }
      __syncthreads();
      if (j == (int)blockIdx.x && threadIdx.x == 0)
        for (long long i = 0; i < imin(wp.S, (int)it->total); ++i)
          wb_fill(ring, i);
      tile = b;
    }
    {
      const bool first = tile == it->b;
      const int p0 = tile * TP;
      const size_t x0 = (size_t)it->m * N;  // the member's first point
      for (int e = ctid; e < TP * d; e += WB_THREADS)
        sx[e] = p0 + e / d < N ? X[(x0 + p0) * d + e] : 0.f;
      wb_sync_all();
      // the forward, staging Q_0 .. Q_{L-2}
      float acc[H2];
      wb_layer0<FL, NP>(sx, d, pl0, pl1, ord, dir, t, sW0, sB, acc);
      for (int l = 1; l < L; ++l) {
        wb_act<NP, CP, false>(acc, c, s, myws + (l - 1) * slice, ctid);
        if (l + 1 < L)
          wb_products<FL, NP>(acc, l, c, t, lane, sB, ring, chunk);
      }
      // the head: acc holds its input H_{L-1}
      wb_put_kmajor<FL, NP>(acc, Ht, row0, t);
      wb_head<FL, NP>(acc, T, n_out, c, t, row0, sWh, sBh);
      wb_sync_all();
      {
        const size_t xm = (size_t)it->m * N;
        wb_epilogue<CP>(T, sx, w + xm * E, gw + xm * E, gX + xm * d, N, p0,
                        C, n_out, d, tp,
                        cst_tab != nullptr
                            ? cst_tab + (size_t)it->m * MAXTCONST
                            : tp.cst,
                        sRed, it->slot + net.P_total, first, ctid, lane,
                        warp);
      }
      float dh[H2];
      wb_head_bwd<FL, NP, CP>(dh, T, Ht, sWh, n_out, wl,
                              it->slot + net.offW[L - 1],
                              it->slot + net.offb[L - 1], first, ctid, row0,
                              t);
      // the reverse sweep, last hidden layer to layer 0
      for (int l = L - 2; l >= 0; --l) {
        bulk_wait_read();
        wb_sync_all();  // Ht, dPt (the staged dW read), sDb free
        float x[H2];
        if (l >= 1) {  // H_l, the layer's input, from Q_{l-1}
          wb_load_p<NP>(x, myws + (l - 1) * slice, ctid);
          wb_act<NP, CP, true>(x, c, s, nullptr, ctid);
          wb_put_kmajor<FL, NP>(x, Ht, row0, t);
        }
        wb_load_p<NP>(x, myws + l * slice, ctid);  // Q_l
        wb_act_vjp<NP, CP>(x, dh, c, s);          // dh = dP_l
        wb_bias_partial<NP, CP>(dh, sDb, warp, g, t, c);
        if constexpr (FL == FL_BF16) {
          if (l == 0) wb_put_kmajor<FL_F32, NP>(dh, dPt, row0, t);
          else wb_put_pieces<NP>(dh, pc, row0, t);
        } else {
          wb_put_kmajor<FL, NP>(dh, dPt, row0, t);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        wb_sync_all();
        wb_bias(sDb, NP, net.w_out[l], it->slot + net.offb[l], first,
                ctid);
        if (l == 0) {
          wb_layer0_bwd<FL, CP, true>(dPt, sx, sW0, NP,
                                      gX + (size_t)it->m * N * d,
                                      it->slot + net.offW[0], N, p0, d, w0,
                                      s, first, ctid);
          break;
        }
        float nh[H2];
        if constexpr (FL == FL_TF32) {
          wb_dh<FL, NP>(nh, dh, lane, ring, chunk);
          float dw[NP / 64][NP / 4];
          wb_dw_product<NP>(dw, Ht, dPt, wg);
          wb_dw_update<NP>(dw, dPt, it->slot + net.offW[l], net.w_in[l],
                           net.w_out[l], first, wp.bulk, behind, wg, wt, wq,
                           g, t);
        } else if constexpr (FL == FL_BF16) {
          wb_dh<FL, NP>(nh, dh, lane, ring, chunk);
          float dw[NP / 64][NP / 4];
          wb_dw_pieces<NP>(dw, Hb, pc, wg);
          wb_dw_update<NP, true>(dw, reinterpret_cast<float*>(pc),
                                 it->slot + net.offW[l], net.w_in[l],
                                 net.w_out[l], first, wp.bulk, behind, wg,
                                 wt, wq, g, t);
        } else {  // dW first: its passes write dPt again from dh
          {
            float dw[NP / 64][NP / 4];
            wb_dw3<NP>(dw, Ht, dPt, dh, wg, wt, ctid, row0, t);
            wb_dw_update<NP>(dw, dPt, it->slot + net.offW[l], net.w_in[l],
                             net.w_out[l], first, wp.bulk, behind, wg, wt,
                             wq, g, t);
          }
          wb_dh<FL, NP>(nh, dh, lane, ring, chunk);
        }
#pragma unroll
        for (int i = 0; i < H2; ++i) dh[i] = nh[i];
      }
      wb_sync_all();  // sx, sDb and dPt read before the next tile
    }
    tile += G;
    if (tile >= wp.n_tiles) {  // the item's last tile: the next item
      const int jn = it->j + gridDim.x;
      if (jn >= it->items) break;
      tile = -1 - jn;
    }
  }
  bulk_wait();  // this thread's last bulk adds are in the slots
}

template <int FL, int NP, int CP>
__global__ void __launch_bounds__(WB_THREADS, 1)
taylor_bwd_wg_kernel(const float* __restrict__ X,
                     const float* __restrict__ prm,
                     const float* __restrict__ gtab, float* __restrict__ dX,
                     float* __restrict__ part, float* __restrict__ ws, int N,
                     Net net, Sched s, WbPlan wp) {
  wb_body<FL, NP, CP>(X, prm, gtab, dX, part, ws, N, net, s, wp);
}

template <int FL, int NP, int CP>
__global__ void __launch_bounds__(WB_THREADS, 1)
minimax_wg_kernel(const float* __restrict__ X, const float* __restrict__ w,
                  const float* __restrict__ prm, float* __restrict__ gw,
                  float* __restrict__ gX, float* __restrict__ part,
                  float* __restrict__ ws, int N, Net net, Sched s,
                  const __grid_constant__ Tape tp,
                  const float* __restrict__ cst, int M, WbPlan wp) {
  wb_body_k3<FL, NP, CP>(X, w, prm, gw, gX, part, ws, N, net, s, tp, cst, M,
                         wp);
}
// K2 on the route: the planes, the kernel (dW/db into the G = grid slots,
// dX), the slots' sum into out.
template <int FL, int NP, int CP>
static int launch_k2wb(const float* X, const float* prm, const float* gtab,
                       float* dX, float* part, float* ws, float* out, int N,
                       const Net& net, const Sched& s, const WbPlan& wp,
                       cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      taylor_bwd_wg_kernel<FL, NP, CP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, wp.smem);
  if (e != cudaSuccess) return (int)e;
  if (wp.P > 0) {
    prep_wb_weights<FL><<<64, 256, 0, st>>>(
        prm, ws + (size_t)wp.grid * (net.L - 1) * WB_ROWS * NP, net, wp);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  taylor_bwd_wg_kernel<FL, NP, CP><<<wp.grid, WB_THREADS, wp.smem, st>>>(
      X, prm, gtab, dX, part, ws, N, net, s, wp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_partials<FL == FL_BF16><<<(net.P_total + 255) / 256, 256, 0, st>>>(
      part, out, wp.grid, net.P_total, net);
  return (int)cudaGetLastError();
}

// K3 on the route over M members (M = 1: the single network) on grid
// persistent blocks: the members' planes, the kernel (value, dW/db into
// the M*G slots; gw, gX), the members' slot sums into out [M, P_total + 1].
template <int FL, int NP, int CP>
static int launch_k3wb(const float* X, const float* w, const float* prm,
                       float* gw, float* gX, float* part, float* ws,
                       float* out, int N, const Net& net, const Sched& s,
                       const Tape& tp, const float* cst, int M, int grid,
                       const WbPlan& wp, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      minimax_wg_kernel<FL, NP, CP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, wp.smem);
  if (e != cudaSuccess) return (int)e;
  if (wp.P > 0) {
    prep_wb_weights_m<FL><<<dim3(64, M), 256, 0, st>>>(
        prm, ws + (size_t)grid * (net.L - 1) * WB_ROWS * NP, net, wp);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  minimax_wg_kernel<FL, NP, CP><<<grid, WB_THREADS, wp.smem, st>>>(
      X, w, prm, gw, gX, part, ws, N, net, s, tp, cst, M, wp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int P = net.P_total + 1;
  reduce_member_partials<FL == FL_BF16>
      <<<dim3((P + 255) / 256, M), 256, 0, st>>>(part, out, wp.grid, P, net);
  return (int)cudaGetLastError();
}

// One kernel's launches in one flavor at one NP, at the plan's CP
// (taylor_bwd_wg_{f32,tf32,bf16}_*.cu and minimax_wg_{f32,tf32,bf16}_*.cu
// define them, so nvcc builds the twelve side by side;
// cudaErrorInvalidValue for a channel count the route has no instance of).
// K2 takes gtab and dX = its input cotangent; K3 w, gw, dX = gX, tp, cst
// (the members' constants, or nullptr), M members on grid blocks.
#define WB_ARGS                                                              \
  const float *X, const float *w, const float *prm, const float *gtab,      \
      float *gw, float *dX, float *part, float *ws, float *out, int N,      \
      const Net &net, const Sched &s, const Tape *tp, const float *cst,     \
      int M, int grid, const WbPlan &wp, cudaStream_t st
template <int FL, int NP, int CP, bool K3>
static int launch_wb(WB_ARGS) {
  if constexpr (K3)
    return launch_k3wb<FL, NP, CP>(X, w, prm, gw, dX, part, ws, out, N, net,
                                   s, *tp, cst, M, grid, wp, st);
  else
    return launch_k2wb<FL, NP, CP>(X, prm, gtab, dX, part, ws, out, N, net,
                                   s, wp, st);
}
#define WB_CALL(FL, NP, CP, K3)                                              \
  launch_wb<FL, NP, CP, K3>(X, w, prm, gtab, gw, dX, part, ws, out, N, net, \
                            s, tp, cst, M, grid, wp, st)
#define WB_INSTANCES(name, FL, NP, K3)                                       \
  int name(WB_ARGS) {                                                        \
    switch (wp.CP) {                                                         \
      case 1: return WB_CALL(FL, NP, 1, K3);                                 \
      case 2: return WB_CALL(FL, NP, 2, K3);                                 \
      case 4: return WB_CALL(FL, NP, 4, K3);                                 \
      case 8: return WB_CALL(FL, NP, 8, K3);                                 \
      default: return (int)cudaErrorInvalidValue;                            \
    }                                                                        \
  }
int k2wb_f32_64(WB_ARGS);
int k2wb_f32_128(WB_ARGS);
int k3wb_f32_64(WB_ARGS);
int k3wb_f32_128(WB_ARGS);
int k2wb_tf32_64(WB_ARGS);
int k2wb_tf32_128(WB_ARGS);
int k3wb_tf32_64(WB_ARGS);
int k3wb_tf32_128(WB_ARGS);
int k2wb_bf16_64(WB_ARGS);
int k2wb_bf16_128(WB_ARGS);
int k3wb_bf16_64(WB_ARGS);
int k3wb_bf16_128(WB_ARGS);
int k2wb_f32_256(WB_ARGS);  // wg_backward_wide.cuh's design
int k3wb_f32_256(WB_ARGS);
int k2wb_tf32_256(WB_ARGS);
int k3wb_tf32_256(WB_ARGS);
