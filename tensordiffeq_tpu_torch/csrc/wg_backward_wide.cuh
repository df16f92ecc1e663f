// The f32 (3xTF32) and TF32 (one pass) K2 and K3 of the wgmma route for
// hidden widths 129 .. 256 (NP = 256): the device code.
// {taylor_bwd,minimax}_wg_{f32,tf32}_256.cu build the instances;
// taylor_bwd_wg.cu and minimax_wg.cu hold the C interfaces, wb_plan
// (wg_backward.cuh) the plan, and the route chooses this design by shape
// there, as it chooses wg_backward.cuh's NP = 64 and 128 instances.  It
// computes what those compute (K2 dW/db and dX from the table cotangents;
// K3 the value, dW/db, gw and gX through the residual tape, over a member
// axis), into the same partial slots, which reduce_partials and
// reduce_member_partials sum in slot order after it.  The bf16 flavor past
// 128, widths over 256, C > 8 and d or n_out > 16 stay on the mma.sync
// kernels.
//
// Replaces, at these shapes, the JAX package's ops/pallas_taylor.py::
// bwd_kernel (pallas_call at :171) and ops/pallas_minimax.py::
// build_minimax_sq_fn's kernel (pallas_call at :259), as taylor_table.cu's
// taylor_bwd_kernel and minimax_step.cu's minimax_step_kernel do.
//
// Why NP = 256 is a design of its own.  The NP = 128 route keeps a tile's
// 128 rows x NP columns in the registers of two warpgroups (64 rows each)
// and H^T and dP^T whole in shared memory.  At NP = 256 an m64n256
// accumulator is 128 registers a thread before the layer's input, the
// forward's second accumulator and the A fragments, and H^T and dP^T are
// 256 KB.  So the features are split:
//   * a tile is 64 rows (points x CP channels); both warpgroups hold all
//     64 rows, warpgroup wg the columns 128 wg .. 128 wg + 127, in the
//     accumulator layout of an m64n128 product: 64 registers a thread, the
//     NP = 128 route's footprint, so its activation pass, its VJP and the
//     staging of Q (wb_act, wb_act_vjp, wb_load_p at NP = 128) run
//     unchanged.
//   * a next-layer product (H W, and dH = dP W^T) takes its K = 256 in two
//     halves (wbw_product): the warpgroup's own half is chained from its
//     registers (wgmma.cuh's chaining, split_tf32 in registers), the other
//     half is read from shared memory (WgMmaSS<128>), written K-major by
//     the warpgroup that owns it with its hi and lo parts (wbw_put_rows:
//     rows along M, the k slots of wg_kslot, so that the chunk's B planes
//     serve both).  Both warpgroups take the same weight chunk at once
//     (the ring's chunk is 256 n rows; each reads its 128), so one
//     exchange buffer of 64 rows x 128 columns (hi and lo: 64 KB) holds
//     warpgroup 0's half for the first eight chunks, then warpgroup 1's.
//   * dW_l = H_l^T dP_l over the tile's 64 rows: warpgroup wg takes the
//     columns 128 wg .. (its own dP half, exclusive), four m64n128 blocks
//     of 64 rows (wbw_dw).  A (H^T's 64 features of the block) comes from
//     registers: loaded from H^T (written transposed, wbw_ht_offset) and
//     split in registers (split_tf32), so H^T needs no lo plane.  B is the
//     warpgroup's dP^T half, K-major (wgmma reads tf32 only so), as its f32
//     values (read as their truncated hi parts) or made into its lo parts
//     in place (wb_lo_in_place, x - tf32_trunc(x)) for the hi-lo pass, and
//     written again from the registers for the next block; the blocks
//     alternate the order of their passes (even: hh, lh, then hl; odd: hl,
//     then hh, lh), so dP^T changes form four times a layer, not eight.
//     The lh passes sit behind that run-time parity, so ptxas serializes
//     dW's wgmma instructions (its C7520 note); a template per parity, or
//     every block in one order with eight changes, took more registers
//     and spilled more, and both ran slower (PERF.md section 6).
//     The split is the NP = 128 route's for dP (its lo truncated, within
//     about 2^-19 a term) and split_tf32's for H (2^-21).
//   * dW's m64n128 block goes to a staging copy (64 rows of 132 floats a
//     warpgroup: wbw_dw_stage) and
//     into the block's own partial slot by bulk reduce-adds, a slot row
//     per thread, each after the same thread's add to that row one tile
//     before completed (the NP = 128 route's rule, wb_dw_update); the
//     block's first tile stores.  Sums in the tiles' order, bit for bit
//     run to run; rows that are not 16-byte pieces are added from the SMs.
//   * the forward sums each 32 k rows (two chunks of KC = 16) in an
//     accumulator of its own and adds them rounded to nearest (the NP =
//     128 route's rule, where a chunk is 32 k rows); dH keeps one
//     accumulator, the small passes first in each chunk.
//   * the weights stream through a ring of 32 KB stages (chunks of KC = 16
//     k rows x 256 n rows, hi and lo planes; prep_wb_weights at NP = 256).
//     The stages lie over dP^T and dW's staging, which only dW uses: a
//     backward run of chunks (layer l's dH) is filled only after layer l's
//     dW is done (wbw_open); the forward chunks, and those of a layer's
//     dH once opened, refill as the NP = 128 ring does (wbw_release).
//     Layer 0's dP^T goes where H^T lies, so the next tile's forward
//     chunks stream in during its backward.
//   * the head's narrow product, its cotangent products, layer 0, the bias
//     sums and K3's tape epilogue stay SIMT, as at NP = 128; the head's
//     row sums take each warpgroup's half and add the two in order.
// The TF32 flavor (FL_TF32, the network's precision=None: one TF32 pass a
// product) keeps this layout and changes what the f32 flavor splits:
//   * every operand that reaches wgmma is rounded to nearest (cvt.rna, as
//     taylor_derivatives(emulate_tf32=True) rounds it; the tensor cores
//     would truncate) where it is written or packed: the own half's A
//     fragments in registers (tf32_bits), the exchange buffer, H^T, dP^T
//     and the weight planes; so are the SIMT products' operands, as the
//     NP = 128 TF32 flavor rounds them (X, W_0, the head's input and W,
//     the head's cotangents; dP_0 read from its rounded dP^T).
//   * the exchange buffer holds the hi plane alone (32 KB), a chunk is 32
//     k rows of the hi plane (32 KB a stage), and a product takes each
//     chunk's four k steps in one batch (wbw_chunk1).
//   * every product sums each chunk (32 k rows) in the accumulator afresh
//     and adds the chunks on the CUDA cores, rounded to nearest
//     (wbw_chunk_sum), as the mma.sync kernels add each k step: 32 k steps
//     into one accumulator, each rounded into it toward zero, put K3's gX
//     outside phase 16's max band on a card test (and each half of K
//     apart did not bring it back; PERF.md).  The running sum is parked
//     in shared memory: warpgroup 0's in the exchange buffer's unused 32
//     KB, warpgroup 1's past the ring's three stages (wbw_maxs).
//   * dW is one pass a block with A loaded from H^T as its bits and B the
//     rounded dP^T half (wbw_dw_pass1), all eight k steps in one batch:
//     no lo parts, so dP^T keeps one form and no pass parity is run.
// Shared memory at 2-256x4-1, C = 4, n_out = 1 (wb_plan):
//   U, 198,656 bytes: [0, 64K) the exchange buffer (forward and dH), H^T
//   (dW, the head), layer 0's dP^T; [64K, 128K) dP^T, then dW's staging
//   (2 x 64 rows of 132 floats); the ring's S = 4 stages of 32,768 at
//   [64K, 192K);
//   then the rows (the head's table rows and the two halves' sums, or the
//   bias partials: 4,096), X's rows (512), the small operands (7,232), the
//   value's warp sums (32), the work item (64), the mbarriers (128):
//   210,720 bytes of the H100's 232,448.
// Registers: the f32 forward holds the input, its sum, a 32-row
// accumulator and a chunk's A fragments (64 + 64 + 64 + 16); dW the
// cotangent, the block's accumulator and four k steps' A fragments (64 +
// 64 + 32).  The TF32 flavor: the forward 64 + 64 + 16, dW 64 + 64 + 32
// (eight k steps of one plane).  ptxas's counts are in PERF.md
// (scripts/torch_ptxas_report.py).  In TF32 the same shared memory: the
// ring's three stages of 32 KB (chunks of KC = 32) at [64K, 160K) and
// warpgroup 1's parked sum at [160K, 192K), both over dP^T and dW's
// staging.

#pragma once

#include "wg_backward.cuh"

// The wide route's work item as the ring and the slot adds read it
// (WbItem's fields), and the end of the backward run the ring may fill
// (wbw_open; thread 0's).
struct WbwItem {
  const char* planes;
  const char* next;
  long long boundary, total;
  float* slot;
  int j, m, b;  // the item, its member and virtual block
  int items;    // the launch's M*G
  long long open_end;
};
static_assert(sizeof(WbwItem) <= 4 * WB_ITEM_FLOATS, "WbwItem's bytes");

// The ring: chunk i in stage i % S; a tile's P chunks are its F forward
// ones, then its layers' dH runs of 256 / wbw_kc chunks, the last layer
// first.
struct WbwRing {
  char* stages;
  uint64_t* full;
  uint64_t* empty;
  int S, P, stage_bytes, F;
  WbwItem* it;
};

static __device__ __forceinline__ void wbw_fill(const WbwRing& r,
                                                long long i) {
  const int st = (int)(i % r.S);
  const char* planes = i < r.it->boundary ? r.it->planes : r.it->next;
  mbar_expect(&r.full[st], (unsigned)r.stage_bytes);
  bulk_copy(r.stages + (size_t)st * r.stage_bytes,
            planes + (size_t)(i % r.P) * r.stage_bytes,
            (unsigned)r.stage_bytes, &r.full[st]);
}

// The warp is done with chunk i; thread 0 then refills its stage with
// chunk i + S, if that is a forward chunk or one of the open dH run (a
// later run waits for wbw_open: its stages lie over dW's operands).
static __device__ __forceinline__ void wbw_release(const WbwRing& r,
                                                   long long i, int lane) {
  const int st = (int)(i % r.S);
  __syncwarp();
  if (lane == 0) mbar_arrive(&r.empty[st]);
  if (threadIdx.x == 0) {
    const long long j = i + r.S;
    if (j < r.it->total && (j % r.P < r.F || j < r.it->open_end)) {
      mbar_wait(&r.empty[st], (unsigned)((i / r.S) & 1));
      wbw_fill(r, j);
    }
  }
}

// Thread 0, after the block's barrier that ends dW: open the dH run that
// starts at chunk rs, filling its first S chunks (every chunk before it
// is released).
template <int FL>
static __device__ __forceinline__ void wbw_open(const WbwRing& r,
                                                long long rs) {
  r.it->open_end = rs + 256 / wbw_kc(FL);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  for (long long j = rs; j < rs + r.S && j < r.it->total; ++j) {
    const long long i = j - r.S;
    mbar_wait(&r.empty[i % r.S], (unsigned)((i / r.S) & 1));
    wbw_fill(r, j);
  }
}

static __device__ __forceinline__ void wbw_fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The lane's two tile rows of its warpgroup's half (the accumulator
// layout) into the exchange buffer xb as the A operand of the other
// warpgroup's products: K-major (row along M, column along K, 128 of
// them), each k8 step's columns in wg_kslot's order (slot t column 2t,
// slot t + 4 column 2t + 1, as the weight planes' k rows lie), split_tf32's
// hi plane at xb, its lo plane WBW_HALF floats after it (FL_F32), or the
// value rounded to TF32 alone (FL_TF32).
template <int FL>
static __device__ __forceinline__ void wbw_put_rows(const float (&a)[64],
                                                    float* xb, int row0,
                                                    int t) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = row0 + ((i & 2) ? 8 : 0);
    const int k = 8 * (i >> 2) + ((i & 1) ? t + 4 : t);
    const int o = wg_cm_offset(r, k, WBW_H, 4);
    if constexpr (FL == FL_TF32) {
      xb[o] = tf32r(a[i]);
    } else {
      unsigned hi, lo;
      split_tf32(a[i], hi, lo);
      xb[o] = __uint_as_float(hi);
      xb[WBW_HALF + o] = __uint_as_float(lo);
    }
  }
}

// One weight chunk's three passes (3xTF32) into d (first: d afresh), issued
// and waited for: the small passes of both k steps (A_lo B_hi, A_hi B_lo),
// then A_hi B_hi.  B: the warpgroup's 128 rows of the chunk's hi plane at
// bh and lo plane 16 KB after.  A: XS false, the k steps j0, j0 + 1 of the
// warpgroup's own half h, split in registers (wb_chunk3's order); XS true,
// the k steps j0, j0 + 1 of the exchange buffer at xa (wbw_put_rows).
template <bool XS>
static __device__ __forceinline__ void wbw_chunk3(float (&d)[64],
                                                  const float (&h)[64],
                                                  int j0, unsigned xa,
                                                  unsigned bh, bool first) {
  constexpr int KC = wbw_kc(FL_F32);
  constexpr unsigned bsbo = (KC / 4) * 128, asbo = (WBW_H / 4) * 128;
  const unsigned bl = bh + 256 * KC * 4;
  if constexpr (XS) {
    const unsigned al = xa + WBW_HALF * 4;
    wg_fence();
#pragma unroll
    for (int s = 0; s < KC / 8; ++s) {
      const unsigned ko = 256 * (j0 + s);
      WgMmaSS<128>::run(d, wg_desc(al + ko, 128, asbo),
                        wg_desc(bh + 256 * s, 128, bsbo),
                        (first && s == 0) ? 0 : 1);
      WgMmaSS<128>::run(d, wg_desc(xa + ko, 128, asbo),
                        wg_desc(bl + 256 * s, 128, bsbo), 1);
    }
#pragma unroll
    for (int s = 0; s < KC / 8; ++s)
      WgMmaSS<128>::run(d, wg_desc(xa + 256 * (j0 + s), 128, asbo),
                        wg_desc(bh + 256 * s, 128, bsbo), 1);
    wg_commit();
    wg_wait_all();
  } else {
    constexpr int S8 = KC / 8;
    unsigned ahi[S8][4], alo[S8][4];
#pragma unroll
    for (int s = 0; s < S8; ++s) {
      const int j = j0 + s;
      const float x[4] = {h[4 * j], h[4 * j + 2], h[4 * j + 1], h[4 * j + 3]};
#pragma unroll
      for (int q = 0; q < 4; ++q) split_tf32(x[q], ahi[s][q], alo[s][q]);
    }
    wg_fence();
#pragma unroll
    for (int s = 0; s < S8; ++s) {
      WgMma<false, 128>::run(d, alo[s], wg_desc(bh + 256 * s, 128, bsbo),
                             (first && s == 0) ? 0 : 1);
      WgMma<false, 128>::run(d, ahi[s], wg_desc(bl + 256 * s, 128, bsbo), 1);
    }
#pragma unroll
    for (int s = 0; s < S8; ++s)
      WgMma<false, 128>::run(d, ahi[s], wg_desc(bh + 256 * s, 128, bsbo), 1);
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int s = 0; s < S8; ++s)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        wg_keep(ahi[s][q]);
        wg_keep(alo[s][q]);
      }
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) wg_keep(d[i]);
}

// One TF32 weight chunk's products into d afresh, issued and waited for:
// one pass a k step, its KC / 8 k steps in one batch.  B: the
// warpgroup's 128 rows of the chunk's hi plane at bh.  A: XS false, the k
// steps j0 .. of the warpgroup's own half h, rounded to TF32 as they are
// packed (wg_chunk<FL_TF32>'s order); XS true, the k steps j0 .. of the
// exchange buffer at xa (wbw_put_rows<FL_TF32>).
template <bool XS>
static __device__ __forceinline__ void wbw_chunk1(float (&d)[64],
                                                  const float (&h)[64],
                                                  int j0, unsigned xa,
                                                  unsigned bh) {
  constexpr int KC = wbw_kc(FL_TF32), S8 = KC / 8;
  constexpr unsigned bsbo = (KC / 4) * 128, asbo = (WBW_H / 4) * 128;
  if constexpr (XS) {
    wg_fence();
#pragma unroll
    for (int s = 0; s < S8; ++s)
      WgMmaSS<128>::run(d, wg_desc(xa + 256 * (j0 + s), 128, asbo),
                        wg_desc(bh + 256 * s, 128, bsbo), s == 0 ? 0 : 1);
    wg_commit();
    wg_wait_all();
  } else {
    unsigned a[S8][4];
#pragma unroll
    for (int s = 0; s < S8; ++s) {
      const int j = j0 + s;
      a[s][0] = tf32_bits(h[4 * j]);
      a[s][1] = tf32_bits(h[4 * j + 2]);
      a[s][2] = tf32_bits(h[4 * j + 1]);
      a[s][3] = tf32_bits(h[4 * j + 3]);
    }
    wg_fence();
#pragma unroll
    for (int s = 0; s < S8; ++s)
      WgMma<false, 128>::run(d, a[s], wg_desc(bh + 256 * s, 128, bsbo),
                             s == 0 ? 0 : 1);
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int s = 0; s < S8; ++s)
#pragma unroll
      for (int q = 0; q < 4; ++q) wg_keep(a[s][q]);
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) wg_keep(d[i]);
}

// The TF32 flavor's running sum of a product's chunks (wbw_product) in
// shared memory (keep: the thread's 64 values, 128 floats apart): chunk
// c's sum d stored (c = 0) or added to it on the CUDA cores, rounded to
// nearest.
static __device__ __forceinline__ void wbw_chunk_sum(const float (&d)[64],
                                                     float* keep, int c) {
  if (c == 0) {
#pragma unroll
    for (int i = 0; i < 64; ++i) keep[128 * i] = d[i];
  } else {
#pragma unroll
    for (int i = 0; i < 64; ++i) keep[128 * i] += d[i];
  }
}

// A product over K = 256 through the ring's next 256 / wbw_kc(FL) chunks:
// out = in_full W, the warpgroup's 128 output columns.  in is the
// warpgroup's half of the input (the accumulator layout); the chunks' k
// rows 0 .. 127 are warpgroup 0's half, 128 .. 255 warpgroup 1's.
// Warpgroup 0 writes its half to the exchange buffer xb first; for the
// first half of the chunks it takes A from its registers and warpgroup 1
// from xb; then warpgroup 1 writes its half over it, and the roles turn.
// The f32 flavor's FWD: each two chunks (32 k rows) into an accumulator of
// its own, the sums added into out rounded to nearest (out starts at
// zero); its dH one accumulator.  The TF32 flavor: each chunk (32 k rows,
// four k steps) into the accumulator afresh and the chunks' sums added in
// order on the CUDA cores (wbw_chunk_sum, the running sum parked in shared
// memory at WBW_KEEP0 / WBW_KEEP1, read back into out at the end): the
// tensor cores round each k step's sum into
// the accumulator toward zero, and 32 steps into one accumulator drifted
// the products, and the operands rounded after them, away from the
// referee's (PERF.md).
template <int FL, bool FWD>
static __device__ __forceinline__ void wbw_product(float (&out)[64],
                                                   const float (&in)[64],
                                                   int wg, int row0, int t,
                                                   int lane, float* xb,
                                                   const WbwRing& r,
                                                   long long& chunk) {
  constexpr int KC = wbw_kc(FL), NH = 128 / KC;  // chunks of a half
  constexpr bool SPLIT = FWD && FL == FL_F32;
  constexpr unsigned wgb = (WBW_H / 8) * (KC / 4) * 128;  // a half's rows
  const unsigned xa = smem_addr(xb);
  float part[SPLIT ? 64 : 1];
  float* keep = nullptr;  // TF32: this thread's running sum
  if constexpr (FL == FL_TF32)
    keep = reinterpret_cast<float*>(reinterpret_cast<char*>(xb) +
                                    (wg == 0 ? WBW_KEEP0 : WBW_KEEP1)) +
           (threadIdx.x & 127);
  if constexpr (SPLIT) {
#pragma unroll
    for (int i = 0; i < 64; ++i) out[i] = 0.f;
  }
  if (wg == 0) {
    wbw_put_rows<FL>(in, xb, row0, t);
    wbw_fence_async();
  }
  wb_sync_all();
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    if (half == 1) {
      if (wg == 1) {
        wb_sync_wg(1);  // its reads of warpgroup 0's half are done
        wbw_put_rows<FL>(in, xb, row0, t);
        wbw_fence_async();
      }
      wb_sync_all();
    }
    if (half == wg) {
#pragma unroll
      for (int hl = 0; hl < NH; ++hl) {
        const unsigned bh = wb_acquire(r, chunk) + wg * wgb;
        if constexpr (SPLIT) {
          wbw_chunk3<false>(part, in, 2 * hl, 0, bh, (hl & 1) == 0);
          if (hl & 1) {
#pragma unroll
            for (int i = 0; i < 64; ++i) out[i] += part[i];
          }
        } else if constexpr (FL == FL_F32) {
          wbw_chunk3<false>(out, in, 2 * hl, 0, bh, half == 0 && hl == 0);
        } else {
          wbw_chunk1<false>(out, in, (KC / 8) * hl, 0, bh);
          wbw_chunk_sum(out, keep, half * NH + hl);
        }
        wbw_release(r, chunk, lane);
        ++chunk;
      }
    } else {
#pragma unroll 1
      for (int hl = 0; hl < NH; ++hl) {
        const unsigned bh = wb_acquire(r, chunk) + wg * wgb;
        if constexpr (SPLIT) {
          wbw_chunk3<true>(part, in, 2 * hl, xa, bh, (hl & 1) == 0);
          if (hl & 1) {
#pragma unroll
            for (int i = 0; i < 64; ++i) out[i] += part[i];
          }
        } else if constexpr (FL == FL_F32) {
          wbw_chunk3<true>(out, in, 2 * hl, xa, bh, half == 0 && hl == 0);
        } else {
          wbw_chunk1<true>(out, in, (KC / 8) * hl, xa, bh);
          wbw_chunk_sum(out, keep, half * NH + hl);
        }
        wbw_release(r, chunk, lane);
        ++chunk;
      }
    }
  }
  if constexpr (FL == FL_TF32) {
#pragma unroll
    for (int i = 0; i < 64; ++i) out[i] = keep[128 * i];
  }
}

// Hidden layer l's forward product in place: acc (the warpgroup's half of
// the layer's input) becomes its half of H W_l + b_l (the bias on primal
// rows; sB's rows 256 wide).
template <int FL>
static __device__ __forceinline__ void wbw_products(
    float (&acc)[64], const float* sB, int l, int c, int wg, int row0,
    int t, int lane, float* xb, const WbwRing& r, long long& chunk) {
  float nacc[64];
  wbw_product<FL, true>(nacc, acc, wg, row0, t, lane, xb, r, chunk);
  const float* b = sB + l * 256 + WBW_H * wg;
#pragma unroll
  for (int i = 0; i < 64; ++i)
    acc[i] = c == 0 ? nacc[i] + b[acc_col(i, t)] : nacc[i];
}

// dH_l = dP_l W_l^T: dh (the warpgroup's half of dP_l) becomes its half of
// the next cotangent.
template <int FL>
static __device__ __forceinline__ void wbw_dh(float (&dh)[64], int wg,
                                              int row0, int t, int lane,
                                              float* xb, const WbwRing& r,
                                              long long& chunk) {
  float nh[64];
  wbw_product<FL, false>(nh, dh, wg, row0, t, lane, xb, r, chunk);
#pragma unroll
  for (int i = 0; i < 64; ++i) dh[i] = nh[i];
}

// Element (f, r) of H^T (feature f < 256, tile row r < 64) as dW's A
// loads read it: feature f's 64 rows, each 16 rows' float4 q (4 t + v:
// rows t, t + 4, t + 8, t + 12 of the 16, the lane's two k steps' A
// fragment halves) swizzled by f so that a quarter warp's float4 loads
// (features f and f + 1) and a warp's stores (features 2 t apart) spread
// over the banks.
static __device__ __forceinline__ int wbw_ht_offset(int f, int r) {
  const int q = 4 * (r >> 4) + (r & 3);
  const int sw = 4 * ((f ^ (f >> 1)) & 1);
  return f * WBW_ROWS + 4 * (q ^ sw) + ((r >> 2) & 3);
}

// The lane's two tile rows of its warpgroup's features (the accumulator
// layout) into H^T (wbw_ht_offset), as the flavor's operands (opnd: f32,
// or rounded to TF32).
template <int FL>
static __device__ __forceinline__ void wbw_put_ht(const float (&a)[64],
                                                  float* ht, int wg,
                                                  int row0, int t) {
#pragma unroll
  for (int i = 0; i < 64; ++i)
    ht[wbw_ht_offset(WBW_H * wg + acc_col(i, t), row0 + ((i & 2) ? 8 : 0))] =
        opnd<FL>(a[i]);
}

// The lane's two tile rows of its warpgroup's columns into its half of
// dP^T, K-major for wgmma's B (feature n's 64 rows at wg_cm_offset(n, r,
// 64, 4)), as f32 values (FL_F32) or rounded to TF32 (FL_TF32).
template <int FL>
static __device__ __forceinline__ void wbw_put_pt(const float (&a)[64],
                                                  float* pt, int row0,
                                                  int t) {
#pragma unroll
  for (int i = 0; i < 64; ++i)
    pt[wg_cm_offset(acc_col(i, t), row0 + ((i & 2) ? 8 : 0), WBW_ROWS, 4)] =
        opnd<FL>(a[i]);
}

// H^T's values of dW's A fragments for two k8 steps of one 64-feature
// block: the lane's features fa and fb = fa + 8 at the tile rows r, r +
// 4, r + 8, r + 12 (two float4 loads); x[v] is k step v's fragment (rows
// r (slot t), r + 4 (slot t + 4); step 1: + 8).
static __device__ __forceinline__ void wbw_a_pair(float (&x)[2][4],
                                                  const float* ht, int fa,
                                                  int fb, int r) {
  const float4 va =
      *reinterpret_cast<const float4*>(ht + (wbw_ht_offset(fa, r) & ~3));
  const float4 vb =
      *reinterpret_cast<const float4*>(ht + (wbw_ht_offset(fb, r) & ~3));
  x[0][0] = va.x;
  x[0][1] = vb.x;
  x[0][2] = va.y;
  x[0][3] = vb.y;
  x[1][0] = va.z;
  x[1][1] = vb.z;
  x[1][2] = va.w;
  x[1][3] = vb.w;
}

// dW's A fragments of one 64-feature block (features f0 ..), k8 steps 4 b
// .. 4 b + 3 (the tile's rows 32 b ..): the lane's features f0 + 16 wq + g
// and + 8, split_tf32 in registers (hi, lo).
static __device__ __forceinline__ void wbw_load_a(unsigned (&ahi)[4][4],
                                                  unsigned (&alo)[4][4],
                                                  const float* ht, int f0,
                                                  int b, int wq, int g,
                                                  int t) {
  const int fa = f0 + 16 * wq + g, fb = fa + 8;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    float x[2][4];
    wbw_a_pair(x, ht, fa, fb, 16 * (2 * b + u) + t);
#pragma unroll
    for (int v = 0; v < 2; ++v)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        split_tf32(x[v][q], ahi[2 * u + v][q], alo[2 * u + v][q]);
  }
}

// One block of dW in the TF32 flavor (64 features f0 .., the tile's eight
// k8 steps) into d afresh: one pass, A H^T's rounded values as their bits
// (all eight k steps' fragments loaded at once), B the warpgroup's rounded
// dP^T half at pb; issued and waited for.
static __device__ __forceinline__ void wbw_dw_pass1(float (&d)[64],
                                                    const float* ht, int f0,
                                                    int wq, int g, int t,
                                                    unsigned pb) {
  constexpr unsigned sbo = (WBW_ROWS / 4) * 128;
  const int fa = f0 + 16 * wq + g, fb = fa + 8;
  unsigned a[8][4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    float x[2][4];
    wbw_a_pair(x, ht, fa, fb, 16 * u + t);
#pragma unroll
    for (int v = 0; v < 2; ++v)
#pragma unroll
      for (int q = 0; q < 4; ++q) a[2 * u + v][q] = __float_as_uint(x[v][q]);
  }
  wg_fence();
#pragma unroll
  for (int s = 0; s < 8; ++s)
    WgMma<false, 128>::run(d, a[s], wg_desc(pb + 256 * s, 128, sbo),
                           s == 0 ? 0 : 1);
  wg_commit();
  wg_wait_all();
#pragma unroll
  for (int s = 0; s < 8; ++s)
#pragma unroll
    for (int q = 0; q < 4; ++q) wg_keep(a[s][q]);
#pragma unroll
  for (int i = 0; i < 64; ++i) wg_keep(d[i]);
}

// One block's passes (64 features f0 .., the tile's eight k8 steps) into
// d before (FIRST) or after the change of dP^T's form (wbw_dw): an even
// block hh, lh on dP^T's f32 values, then hl on their lo parts; an odd
// block hl on the lo parts, then hh, lh on the values written again.  A
// four k8 steps at a time (wbw_load_a), each batch issued and waited for;
// B the warpgroup's dP^T half at pb.
template <bool FIRST>
static __device__ __forceinline__ void wbw_dw_passes(float (&d)[64],
                                                     const float* ht, int f0,
                                                     int wq, int g, int t,
                                                     unsigned pb, bool even) {
  constexpr unsigned sbo = (WBW_ROWS / 4) * 128;
  const bool both = FIRST == even;  // hh and lh; else hl alone
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    unsigned ahi[4][4], alo[4][4];
    wbw_load_a(ahi, alo, ht, f0, b, wq, g, t);
    wg_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
      WgMma<false, 128>::run(d, ahi[s],
                             wg_desc(pb + 256 * (4 * b + s), 128, sbo),
                             (FIRST && b == 0 && s == 0) ? 0 : 1);
    if (both) {
#pragma unroll
      for (int s = 0; s < 4; ++s)
        WgMma<false, 128>::run(d, alo[s],
                               wg_desc(pb + 256 * (4 * b + s), 128, sbo), 1);
    }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        wg_keep(ahi[s][q]);
        wg_keep(alo[s][q]);
      }
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) wg_keep(d[i]);
}

// A block of dW (64 features x the warpgroup's 128 columns) into the
// warpgroup's staging (stg: rows of WBW_LDS floats, 4 past 128 so that a
// warp's stores of its rows g spread over the banks) and the slot (the layer's W in it,
// Ni x Nn) by bulk reduce-adds, one slot row a thread (wt < 64), or from
// the SMs where rows are not 16-byte pieces.  The staging is free once
// this warpgroup's adds of the block before have read it.
static __device__ __forceinline__ void wbw_dw_stage(
    const float (&d)[64], float* stg, float* __restrict__ slot, int m,
    int Ni, int Nn, bool first, int bulk, int behind, int wg, int wt, int wq,
    int g, int t) {
  bulk_wait_read();
  wb_sync_wg(wg);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 16 * wq + g + 8 * h;
      *reinterpret_cast<float2*>(stg + i * WBW_LDS + 8 * j + 2 * t) =
          make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
    }
  wbw_fence_async();
  wb_sync_wg(wg);
  const int n0 = wg * WBW_H, len = imin(WBW_H, Nn - n0);
  if (len <= 0) return;
  const int i = 64 * m + wt;  // the slot row of this thread
  if (bulk) {
    if (wt < 64 && i < Ni) {
      bulk_wait_pending(behind);
      float* dst = slot + (size_t)i * Nn + n0;
      if (first) bulk_store(dst, stg + wt * WBW_LDS, 4u * (unsigned)len);
      else bulk_reduce_add(dst, stg + wt * WBW_LDS, 4u * (unsigned)len);
      bulk_commit();
    }
  } else {
    for (int e = wt; e < 64 * WBW_H; e += 128) {
      const int ii = e / WBW_H, n = e % WBW_H;
      if (64 * m + ii < Ni && n < len)
        slot_rmw(slot + (size_t)(64 * m + ii) * Nn + n0 + n,
                 stg[ii * WBW_LDS + n], first);
    }
  }
}

// dW_l = H_l^T dP_l over the tile's 64 rows, the warpgroup's 128 columns,
// in four blocks of 64 features (the header's note), up to the layer's Ni
// rows, each staged and added into the slot (wbw_dw_stage).  pt: the
// warpgroup's dP^T half, which holds dP_l's f32 values on entry (the f32
// flavor changes their form; nothing reads it after), or their TF32
// roundings (the TF32 flavor's one pass); dp: the lane's rows of dP_l.
template <int FL>
static __device__ __forceinline__ void wbw_dw(
    const float* ht, float* pt, float* stg, const float (&dp)[64],
    float* __restrict__ slot, int Ni, int Nn, bool first, int bulk,
    int behind, int wg, int wt, int wq, int g, int t, int row0) {
  const unsigned pb = smem_addr(pt);
#pragma unroll 1
  for (int m = 0; m < 4; ++m) {
    if (64 * m >= Ni) break;  // the block's features are all past the layer
    float d[64];
    if constexpr (FL == FL_TF32) {
      wbw_dw_pass1(d, ht, 64 * m, wq, g, t, pb);
    } else {
      const bool even = (m & 1) == 0;
      wbw_dw_passes<true>(d, ht, 64 * m, wq, g, t, pb, even);
      wb_sync_wg(wg);
      if (even) wb_lo_in_place(pt, WBW_HALF, wt, 128);
      else wbw_put_pt<FL>(dp, pt, row0, t);
      wbw_fence_async();
      wb_sync_wg(wg);
      wbw_dw_passes<false>(d, ht, 64 * m, wq, g, t, pb, even);
    }
    wbw_dw_stage(d, stg, slot, m, Ni, Nn, first, bulk, behind, wg, wt, wq,
                 g, t);
  }
}

// The bulk groups thread (wg, wt) issues a tile (wbw_dw), less one.
static __device__ __forceinline__ int wbw_behind(const Net& net, int wg,
                                                 int wt) {
  int n = -1;
  for (int l = 1; l + 1 < net.L; ++l)
    for (int m = 0; m < 4; ++m)
      n += wt < 64 && 64 * m + wt < net.w_in[l] && wg * WBW_H < net.w_out[l];
  return n;
}

// db of a layer of w <= 256 columns: column n's four warps' partials (its
// warpgroup's, wb_bias_partial at NP = 128) summed in warp order, into the
// slot (assigned on the block's first tile), a column a thread.
static __device__ __forceinline__ void wbw_bias(const float* sDb, int w,
                                                float* __restrict__ slot,
                                                bool first, int ctid) {
  const int n = ctid;
  if (n >= w) return;
  const float* p = sDb + (n >> 7) * 4 * WBW_H + (n & 127);
  float v = p[0];
  for (int k = 1; k < 4; ++k) v += p[k * WBW_H];
  slot_rmw(slot + n, v, first);
}

// Layer 0's pre-activations of the lane's two rows (wb_layer0) for the
// warpgroup's columns: sW0 and sB rows are 256 wide; X's rows rounded as
// the flavor's operands (opnd).
template <int FL>
static __device__ __forceinline__ void wbw_layer0(const float* sx, int d,
                                                  int pl0, int pl1, int ord,
                                                  int dir, int t, int wg,
                                                  const float* sW0,
                                                  const float* sB,
                                                  float (&acc)[64]) {
  const int c0 = WBW_H * wg;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int k = 0; k < d; ++k) {
    const float x0 = opnd<FL>(sx[pl0 * d + k]),
                x1 = opnd<FL>(sx[pl1 * d + k]);
    const float* w = sW0 + k * 256 + c0;
#pragma unroll
    for (int i = 0; i < 64; ++i)
      acc[i] = fmaf((i & 2) ? x1 : x0, w[acc_col(i, t)], acc[i]);
  }
  const float* seed = sW0 + dir * 256 + c0;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int col = acc_col(i, t);
    acc[i] = ord == 0 ? acc[i] + sB[c0 + col] : (ord == 1 ? seed[col] : 0.f);
  }
}

// The head's table rows T[row][o] (K3): each warpgroup's dot products over
// its 128 columns (k1w_head's order; its input acc rounded as the flavor's
// operands) into Tp[wg], then, after the block's barrier, T = Tp[0] +
// Tp[1] (+ the bias on primal rows), a row element a thread.
template <int FL, int CP>
static __device__ __forceinline__ void wbw_head(const float (&acc)[64],
                                                float* T, int n_out, int t,
                                                int wg, int row0, int ctid,
                                                const float* sWh,
                                                const float* sBh) {
  float* Tp = T + WBW_ROWS * n_out;
  for (int o = 0; o < n_out; ++o) {
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = WBW_H * wg + 8 * j + 2 * t;
      const float w0 = sWh[col * n_out + o], w1 = sWh[(col + 1) * n_out + o];
      s0 = fmaf(opnd<FL>(acc[4 * j]), w0, s0);
      s0 = fmaf(opnd<FL>(acc[4 * j + 1]), w1, s0);
      s1 = fmaf(opnd<FL>(acc[4 * j + 2]), w0, s1);
      s1 = fmaf(opnd<FL>(acc[4 * j + 3]), w1, s1);
    }
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    if ((o & 3) == t) {
      float* tp = Tp + wg * WBW_ROWS * n_out;
      tp[row0 * n_out + o] = s0;
      tp[(row0 + 8) * n_out + o] = s1;
    }
  }
  wb_sync_all();
  for (int e = ctid; e < WBW_ROWS * n_out; e += WB_THREADS) {
    const int r = e / n_out, o = e % n_out;
    const float v = Tp[e] + Tp[WBW_ROWS * n_out + e];
    T[e] = r % CP == 0 ? v + sBh[o] : v;
  }
}

// The head's cotangent products from T (its pre-activation cotangents, 64
// rows x n_out; rounded as the flavor's cotangent operands, gopnd) and H^T
// (its input, wbw_ht_offset): db and dW into the slot, one output element
// a thread, summed over the tile's rows in order; dH, the cotangent of the
// last hidden layer's post-activations, into the lane's registers for the
// warpgroup's columns.
template <int FL, int CP>
static __device__ __forceinline__ void wbw_head_bwd(
    float (&dh)[64], const float* T, const float* ht, const float* sWh,
    int n_out, int wl, float* __restrict__ pW, float* __restrict__ pb,
    bool first, int ctid, int wg, int row0, int t) {
  constexpr int TP = WBW_ROWS / CP;
  for (int o = ctid; o < n_out; o += WB_THREADS) {
    float v = 0.f;
    for (int p = 0; p < TP; ++p) v += T[p * CP * n_out + o];
    slot_rmw(pb + o, v, first);
  }
  for (int e = ctid; e < wl * n_out; e += WB_THREADS) {
    const int i = e / n_out, o = e % n_out;
    float v = 0.f;
    for (int r = 0; r < WBW_ROWS; ++r)
      v = fmaf(ht[wbw_ht_offset(i, r)], gopnd<FL>(T[r * n_out + o]), v);
    slot_rmw(pW + e, v, first);
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) dh[i] = 0.f;
  for (int o = 0; o < n_out; ++o) {
    const float a0 = gopnd<FL>(T[row0 * n_out + o]);
    const float a1 = gopnd<FL>(T[(row0 + 8) * n_out + o]);
#pragma unroll
    for (int i = 0; i < 64; ++i)
      dh[i] = fmaf((i & 2) ? a1 : a0,
                   sWh[(WBW_H * wg + acc_col(i, t)) * n_out + o], dh[i]);
  }
}

// Element (j, r) of layer 0's dP^T (wbw_put_pt's halves at p0)
static __device__ __forceinline__ float wbw_p0(const float* p0, int j,
                                               int r) {
  return p0[(j >> 7) * WBW_HALF + wg_cm_offset(j & 127, r, WBW_ROWS, 4)];
}

// Layer 0's weight and input cotangents from dP_0 (p0, wbw_put_pt's
// halves, the flavor's operands) and the tile's rows of X (rounded here as
// the flavor's operands): wb_layer0_bwd's sums, one output element a
// thread.  dX = the sum (K2), or += it (K3).
template <int FL, int CP, bool K3>
static __device__ __forceinline__ void wbw_layer0_bwd(
    const float* p0, const float* sx, const float* sW0,
    float* __restrict__ dX, float* __restrict__ pW, int N, int pt0, int d,
    int w0, const Sched& s, bool first, int ctid) {
  constexpr int TP = WBW_ROWS / CP;
  for (int e = ctid; e < d * w0; e += WB_THREADS) {
    const int k = e / w0, j = e % w0;
    float v = 0.f;
    for (int p = 0; p < TP; ++p)
      v = fmaf(opnd<FL>(sx[p * d + k]), wbw_p0(p0, j, p * CP), v);
    for (int cc = 1; cc < s.C; ++cc) {
      if (s.order[cc] != 1 || s.idx[cc][0] != k) continue;
      for (int p = 0; p < TP; ++p) v += wbw_p0(p0, j, p * CP + cc);
    }
    slot_rmw(pW + e, v, first);
  }
  for (int e = ctid; e < TP * d; e += WB_THREADS) {
    const int p = e / d, k = e % d, gp = pt0 + p;
    if (gp >= N) continue;
    float v = 0.f;
    for (int j = 0; j < w0; ++j)
      v = fmaf(wbw_p0(p0, j, p * CP), sW0[k * 256 + j], v);
    float* dst = dX + (size_t)gp * d + k;
    *dst = K3 ? *dst + v : v;
  }
}

// The wide route's body in flavor FL (FL_F32 or FL_TF32), K2 (the table
// cotangents gtab in, dX out) or K3 (the tape's epilogue on the head's
// rows; w in, gw and gX = dX out) over a member axis of M networks (K2: M
// = 1), with wb_body_k3's walk of the work items (m, b): block k the items
// k, k + gridDim.x, ..., item (m, b) member m's tiles b, b + G, ... into
// its slot m*G + b.
template <int FL, bool K3, int CP>
static __device__ __forceinline__ void wbw_body(
    const float* __restrict__ X, const float* __restrict__ w,
    const float* __restrict__ prm, const float* __restrict__ gtab,
    float* __restrict__ gw, float* __restrict__ dX, float* __restrict__ part,
    float* __restrict__ ws, int N, const Net& net, const Sched& s,
    const Tape* tp, const float* __restrict__ cst_tab, int M,
    const WbPlan& wp) {
  constexpr int TP = WBW_ROWS / CP;
  extern __shared__ __align__(128) char smw[];
  const int d = net.d, L = net.L, n_out = net.n_out, C = s.C;
  const int ubytes = wbw_region_bytes(wp.S, wp.stage_bytes);
  float* const xb = reinterpret_cast<float*>(smw);  // also H^T, dP_0^T
  float* const ht = xb;
  float* const pt = reinterpret_cast<float*>(smw + 65536);
  float* const stg = reinterpret_cast<float*>(smw + 131072);
  char* const stages = smw + 65536;
  float* T = reinterpret_cast<float*>(smw + ubytes);
  float* sDb = T;  // the reverse sweep's bias partials
  float* sx = T + wbw_rows_floats(net);
  float* sW0 = sx + pad4(WBW_ROWS * d);
  float* sB = sW0 + d * 256;
  float* sWh = sB + (L - 1) * 256;
  float* sBh = sWh + 256 * n_out;
  float* sRed = sW0 + wb_misc_floats(net, 256);
  WbwItem* it = reinterpret_cast<WbwItem*>(sRed + 8);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smw + (wp.smem - 2 * WG_MAXS * 8));
  uint64_t* empty = full + WG_MAXS;
  if (threadIdx.x == 0) {
    for (int i = 0; i < wp.S; ++i) {
      mbar_init_n(&full[i], 1);
      mbar_init_n(&empty[i], 8);
    }
    it->open_end = 0;
    wbw_fence_async();
  }
  const int w0 = net.w_out[0], wl = net.w_in[L - 1];
  // the warp's index from lane 0: warp-uniform as the compiler sees it, so
  // the products' choice by warpgroup (wbw_product) is no divergent path
  // that would serialize its wgmma instructions
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;
  const size_t slice = (size_t)WBW_ROWS * 256;
  const WbwRing ring{stages, full, empty, wp.S, wp.P, wp.stage_bytes,
                     (L - 2) * (256 / wbw_kc(FL)), it};
  const int ctid = threadIdx.x, wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, t = lane & 3, wt = ctid & 127;
  const int c = g % CP;
  const int ord = c < C ? s.order[c] : -1;
  const int dir = ord == 1 ? s.idx[c][0] : 0;
  const int row0 = 16 * wq + g;
  const int pl0 = row0 / CP, pl1 = (row0 + 8) / CP;
  const int P_all = K3 ? net.P_total + 1 : net.P_total, G = wp.grid;
  const int E = K3 ? tp->n_eq : 0;
  float* myws = ws + (size_t)blockIdx.x * (L - 1) * slice;
  long long chunk = 0;
  const int behind = wbw_behind(net, wg, wt);
  // the block's items j, j + gridDim.x, ... (j < M*G as grid <= M*G), their
  // tiles in one loop: tile < 0 starts item -1 - tile (wb_body_k3's walk;
  // the item's values are read from its state where they are needed)
  int tile = -1 - (int)blockIdx.x;
  for (;;) {
    if (tile < 0) {
      const int j = -1 - tile, b = j % G;
      __syncthreads();  // every thread has read the previous item's state
      if (threadIdx.x == 0) {
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
        it->boundary =
            chunk + (long long)((wp.n_tiles - b + G - 1) / G) * wp.P;
        it->total = it->boundary +
                    (jn < M * G ? (long long)((wp.n_tiles - jn % G + G - 1) /
                                              G) * wp.P
                                : 0);
      }
      {  // the member's small operands, 256-wide rows (the weights
         // rounded as the flavor's operands)
        const float* pm = prm + (size_t)(j / G) * net.P_total;
        for (int e = threadIdx.x; e < d * 256; e += WB_THREADS) {
          const int k = e / 256, n = e % 256;
          sW0[e] = n < w0 ? opnd<FL>(pm[net.offW[0] + k * w0 + n]) : 0.f;
        }
        for (int e = threadIdx.x; e < (L - 1) * 256; e += WB_THREADS) {
          const int l = e / 256, n = e % 256;
          sB[e] = n < net.w_out[l] ? pm[net.offb[l] + n] : 0.f;
        }
        for (int e = threadIdx.x; e < 256 * n_out; e += WB_THREADS)
          sWh[e] = e / n_out < wl ? opnd<FL>(pm[net.offW[L - 1] + e]) : 0.f;
        for (int o = threadIdx.x; o < n_out; o += WB_THREADS)
          sBh[o] = pm[net.offb[L - 1] + o];
      }
      __syncthreads();
      if (j == (int)blockIdx.x && threadIdx.x == 0)
        for (long long i = 0; i < imin(wp.S, (int)it->total); ++i)
          wbw_fill(ring, i);
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
      float acc[64];
      wbw_layer0<FL>(sx, d, pl0, pl1, ord, dir, t, wg, sW0, sB, acc);
      for (int l = 1; l < L; ++l) {
        wb_act<128, CP, false>(acc, c, s, myws + (l - 1) * slice, ctid);
        if (l + 1 < L)
          wbw_products<FL>(acc, sB, l, c, wg, row0, t, lane, xb, ring,
                           chunk);
      }
      // the head: acc holds its input H_{L-1}
      wb_sync_all();  // the exchange buffer read
      wbw_put_ht<FL>(acc, ht, wg, row0, t);
      float* const slot = it->slot;
      if constexpr (K3) {
        wbw_head<FL, CP>(acc, T, n_out, t, wg, row0, ctid, sWh, sBh);
        wb_sync_all();
        const size_t xm = (size_t)it->m * N;
        wb_epilogue<CP, WBW_ROWS>(
            T, sx, w + xm * E, gw + xm * E, dX + xm * d, N, p0, C, n_out, d,
            *tp,
            cst_tab != nullptr ? cst_tab + (size_t)it->m * MAXTCONST
                               : tp->cst,
            sRed, slot + net.P_total, first, ctid, lane, warp);
      } else {
        for (int e = ctid; e < WBW_ROWS * n_out; e += WB_THREADS) {
          const int r = e / n_out, o = e % n_out, p = r / CP, cc = r % CP;
          const int gp = p0 + p;
          T[e] = (cc < C && gp < N) ? gtab[((size_t)cc * N + gp) * n_out + o]
                                    : 0.f;
        }
        wb_sync_all();
      }
      float dh[64];
      wbw_head_bwd<FL, CP>(dh, T, ht, sWh, n_out, wl,
                           slot + net.offW[L - 1], slot + net.offb[L - 1],
                           first, ctid, wg, row0, t);
      // the reverse sweep, last hidden layer to layer 0
      for (int l = L - 2; l >= 0; --l) {
        bulk_wait_read();
        wb_sync_all();  // H^T, dP^T, the staging, sDb free
        float x[64];
        if (l >= 1) {  // H_l, the layer's input, from Q_{l-1}
          wb_load_p<128>(x, myws + (l - 1) * slice, ctid);
          wb_act<128, CP, true>(x, c, s, nullptr, ctid);
          wbw_put_ht<FL>(x, ht, wg, row0, t);
        }
        wb_load_p<128>(x, myws + l * slice, ctid);  // Q_l
        wb_act_vjp<128, CP>(x, dh, c, s);          // dh = dP_l
        wb_bias_partial<128, CP>(dh, sDb, warp, g, t, c);
        // dP_l^T: layer 0's where H^T lies (the ring's stages are the
        // next tile's), the others' over the ring's (its dH run not open)
        float* const mypt = (l == 0 ? xb : pt) + wg * WBW_HALF;
        wbw_put_pt<FL>(dh, mypt, row0, t);
        wbw_fence_async();
        wb_sync_all();
        wbw_bias(sDb, net.w_out[l], slot + net.offb[l], first, ctid);
        if (l == 0) {
          wbw_layer0_bwd<FL, CP, K3>(
              xb, sx, sW0, K3 ? dX + (size_t)it->m * N * d : dX,
              slot + net.offW[0], N, p0, d, w0, s, first, ctid);
          break;
        }
        wbw_dw<FL>(ht, mypt, stg + wg * WBW_ROWS * WBW_LDS, dh,
                   slot + net.offW[l], net.w_in[l], net.w_out[l], first,
                   wp.bulk, behind, wg, wt, wq, g, t, row0);
        bulk_wait_read();
        wb_sync_all();  // dW's operands and staging read: the ring's
        if (threadIdx.x == 0) wbw_open<FL>(ring, chunk);
        wbw_dh<FL>(dh, wg, row0, t, lane, xb, ring, chunk);
      }
      wb_sync_all();  // sx, sDb and layer 0's dP^T read before the next tile
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

template <int FL, int CP>
__global__ void __launch_bounds__(WB_THREADS, 1)
taylor_bwd_wbw_kernel(const float* __restrict__ X,
                      const float* __restrict__ prm,
                      const float* __restrict__ gtab, float* __restrict__ dX,
                      float* __restrict__ part, float* __restrict__ ws,
                      int N, Net net, Sched s, WbPlan wp) {
  wbw_body<FL, false, CP>(X, nullptr, prm, gtab, nullptr, dX, part, ws, N,
                          net, s, nullptr, nullptr, 1, wp);
}

template <int FL, int CP>
__global__ void __launch_bounds__(WB_THREADS, 1)
minimax_wbw_kernel(const float* __restrict__ X, const float* __restrict__ w,
                   const float* __restrict__ prm, float* __restrict__ gw,
                   float* __restrict__ gX, float* __restrict__ part,
                   float* __restrict__ ws, int N, Net net, Sched s,
                   const __grid_constant__ Tape tp,
                   const float* __restrict__ cst, int M, WbPlan wp) {
  wbw_body<FL, true, CP>(X, w, prm, nullptr, gw, gX, part, ws, N, net, s,
                         &tp, cst, M, wp);
}

// K2 or K3 on the wide route in flavor FL: the (members') planes after the
// blocks' slices, the kernel on grid persistent blocks, the slots' sums
// (launch_k2wb's and launch_k3wb's steps).
template <int FL, int CP, bool K3>
static int launch_wbw(WB_ARGS) {
  const size_t planes = (size_t)grid * (net.L - 1) * WBW_ROWS * 256;
  cudaError_t e;
  if constexpr (K3)
    e = cudaFuncSetAttribute(minimax_wbw_kernel<FL, CP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             wp.smem);
  else
    e = cudaFuncSetAttribute(taylor_bwd_wbw_kernel<FL, CP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             wp.smem);
  if (e != cudaSuccess) return (int)e;
  if (wp.P > 0) {
    prep_wb_weights_m<FL><<<dim3(64, M), 256, 0, st>>>(prm, ws + planes,
                                                       net, wp);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if constexpr (K3)
    minimax_wbw_kernel<FL, CP><<<grid, WB_THREADS, wp.smem, st>>>(
        X, w, prm, gw, dX, part, ws, N, net, s, *tp, cst, M, wp);
  else
    taylor_bwd_wbw_kernel<FL, CP><<<grid, WB_THREADS, wp.smem, st>>>(
        X, prm, gtab, dX, part, ws, N, net, s, wp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if constexpr (K3) {
    const int P = net.P_total + 1;
    reduce_member_partials<false>
        <<<dim3((P + 255) / 256, M), 256, 0, st>>>(part, out, wp.grid, P,
                                                   net);
  } else {
    reduce_partials<false><<<(net.P_total + 255) / 256, 256, 0, st>>>(
        part, out, wp.grid, net.P_total, net);
  }
  return (int)cudaGetLastError();
}

#define WBW_CALL(FL, CP, K3)                                                 \
  launch_wbw<FL, CP, K3>(X, w, prm, gtab, gw, dX, part, ws, out, N, net, s, \
                         tp, cst, M, grid, wp, st)
#define WBW_INSTANCES(name, FL, K3)                                          \
  int name(WB_ARGS) {                                                        \
    switch (wp.CP) {                                                         \
      case 1: return WBW_CALL(FL, 1, K3);                                    \
      case 2: return WBW_CALL(FL, 2, K3);                                    \
      case 4: return WBW_CALL(FL, 4, K3);                                    \
      case 8: return WBW_CALL(FL, 8, K3);                                    \
      default: return (int)cudaErrorInvalidValue;                            \
    }                                                                        \
  }
