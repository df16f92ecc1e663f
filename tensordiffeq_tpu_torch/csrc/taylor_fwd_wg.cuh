// K1, the Taylor-table forward, on Hopper's warpgroup products: the route
// for hidden widths up to 128 and up to 8 channels (the device code; see
// below for the translation units that build it).
//
// Replaces the JAX package's ops/pallas_taylor.py::fwd_kernel (pallas_call
// at :154), as taylor_table.cu's taylor_fwd_kernel does for the shapes this
// route does not take (taylor_table.cu's header note says what the table
// is).  The three flavors FL of taylor_common.cuh: FL_F32 (3xTF32),
// FL_BF16 (the bf16 operands of compute_dtype=bfloat16) and FL_TF32 (one
// TF32 pass on the operands' cvt.rna hi parts: the hi weight plane alone,
// half the f32 flavor's weight bytes), each rounding where
// taylor_common.cuh says.
//
// What bounds it.  The channel products of the hidden layers: on the AC
// slice (N = 50,000, 2-128x4-1, C = 4) 19.7 GFLOP, 0.119 ms at the TF32
// peak for the f32 flavor's three passes and 0.020 ms at the bf16 peak for
// the bf16 flavor's one; the tanh chain and the Faa di Bruno lines on the
// CUDA cores are the rest.  X and the table are 1.2 MB.  So the design
// keeps the tensor cores fed and hides the pointwise pass behind them:
//   * persistent blocks, one per SM (grid = min(SMs, tiles)), each walking
//     tiles blockIdx.x, + gridDim.x, ...  A block is two consumer
//     warpgroups (three in the bf16 flavor) and one producer warpgroup,
//     whose registers go to the consumers (setmaxnreg, wg_consumers).  A
//     tile is 64 rows (points x channels, C padded to CP, a power of two up
//     to 8) per consumer warpgroup, one m64 product tile each.
//   * the wavefront never leaves the registers: layer 0 (d inputs, SIMT)
//     writes its pre-activations straight into the accumulator layout; the
//     activation pass works on the accumulator in place.  A point's CP
//     channels sit in lanes 4 apart (rows 16w + g and 16w + g + 8 of a
//     warp hold channel g % CP of two points), so every register holds the
//     same (point, column) item in the CP lanes of its point: a butterfly of
//     __shfl_xor_sync over each group of CP registers gives lane c all CP
//     channels of the group's item c, whose tanh chain and Faa di Bruno
//     lines it derives once, and the same butterfly brings them back;
//     the next layer's A fragments are the accumulator registers
//     (wgmma.cuh); the head's n_out columns are dot products reduced over
//     the 4 lanes of a row, stored from registers.  Shared memory holds
//     only the weights and the barriers.
//   * the hidden products are wgmma.mma_async (m64nNPk8 tf32 three times
//     per k step, A_lo B_hi + A_hi B_lo + A_hi B_hi, A split in registers
//     once per element; m64nNPk16 bf16 once), N = the widest hidden layer
//     padded to NP = 64 or 128 by zero weight columns, B from shared memory.
//   * the weights are prepared once per launch by prep_wg_weights (same
//     stream): each hidden layer's W^T in chunks of KC k rows (f32: the
//     TF32 hi and lo planes of split_tf32, KC = 64; bf16: rounded once,
//     KC = NP), in the descriptors' core-matrix order and the tf32 k-slot
//     order (wgmma.cuh), so the producer brings a chunk in with one plain
//     cp.async.bulk onto a "full" mbarrier of a ring of S stages; the
//     consumers' warps release a stage on its "empty" mbarrier.  Where all
//     P chunks of a tile fit (P <= S), each is copied once per block and
//     stays resident.
//   * the pointwise pass keeps tanhf (no tanh.approx) and the generic
//     channel schedule (Sched): every lane runs every channel's line of
//     its item, so a line's order and reads are the same in every lane
//     (no divergence), read from the kernel's parameters.
// The figures at the AC slice on an H100 (227 KB of shared memory a block):
//   f32:  NP = 128, chunks of 64 KB (hi + lo), P = 6 per tile, a ring of
//         S = 3 stages: 200,384 bytes of shared memory.  A tile's pass over
//         the weights is 384 KB shared by its 128 rows: 1,563 tiles take
//         600 MB per launch from L2.
//   bf16: NP = 128, chunks of 32 KB (one layer), P = 3, resident: 102,080
//         bytes; 132 blocks x 96 KB = 12.7 MB per launch from L2; tiles
//         of 192 rows.
// The device code is here; taylor_fwd_wg.cu has the C interface, and
// taylor_fwd_wg_{f32,bf16}_{64,128}.cu build the instances of each flavor
// and NP (CP = 1, 2, 4, 8 each), so nvcc compiles them side by side.
// The routes (the host chooses by shape, ops/cuda_taylor.py::_Plan and
// wg_plan below, which agree before a plan's first launch): this one for
// C <= 8 channels, hidden widths <= 128, d <= 16 inputs, n_out <= 16
// outputs and a ring of at least two stages (or all chunks resident);
// taylor_table.cu's taylor_fwd_kernel for every other shape (a wider hidden
// layer, more channels).  A point's row of the table depends only on its
// own inputs (the products sum each row alone, in a fixed order), so it is
// the same bit for bit whatever N is and wherever the point sits in X.

#pragma once

#include "taylor_common.cuh"
#include "wgmma.cuh"

#define WG_MAXS 8     // weight stages
#define WG_MAXD 16    // inputs
#define WG_MAXOUT 16  // the head's columns
#define WG_MAXC 8     // channels

// Consumer warpgroups per block: two in the f32 flavor, whose products
// hold the layer's input, its output and the A fragments of a chunk at
// once (about 200 registers a thread), three in the bf16 flavor (under
// 160), for more warps to hide the pointwise pass's latency.  The producer
// warpgroup gives its registers to them (setmaxnreg): 2 x 128 x 232 + 128
// x 40, or 3 x 128 x 160 + 128 x 24, within the SM's 65,536.
static __host__ __device__ constexpr int wg_consumers(bool bf16) {
  return bf16 ? 3 : 2;
}
static __host__ __device__ constexpr int wg_threads(bool bf16) {
  return (wg_consumers(bf16) + 1) * 128;
}
static __host__ __device__ constexpr int wg_tile(bool bf16) {  // rows
  return wg_consumers(bf16) * 64;
}
static __host__ __device__ constexpr int wg_regs_consumer(bool bf16) {
  return bf16 ? 160 : 232;
}
static __host__ __device__ constexpr int wg_regs_producer(bool bf16) {
  return bf16 ? 24 : 40;
}

// A launch of the route (ops/cuda_taylor.py::WgPlan, in the same order).
struct WgPlan {
  int NP, CP, KC, S, P, resident, stage_bytes, n_tiles, grid, smem;
};
#define WG_PLAN_INTS 10

static __host__ __device__ __forceinline__ int imin(int a, int b) {
  return a < b ? a : b;
}

static __host__ __device__ __forceinline__ int imax(int a, int b) {
  return a > b ? a : b;
}

// The route's plan for a net, schedule, flavor and N on a card with
// smem_optin bytes of shared memory a block and n_sm SMs; 0 where the shape
// is the other route's.  The TF32 flavor takes the f32 flavor's tiles and
// chunks with the hi plane only.  Shared memory: the S stages, then the small operands
// (W0 and the biases of layers 0 .. L-2 as NP-wide rows, the head's W and
// bias), then the full and empty mbarriers.
static inline int wg_plan(const Net& net, const Sched& s, int flavor,
                          int smem_optin, int n_sm, int N, WgPlan* p) {
  const bool bf16 = flavor == FL_BF16;
  const int L = net.L, d = net.d, n_out = net.n_out, C = s.C;
  int width = 0;
  for (int l = 0; l + 1 < L; ++l) width = imax(width, net.w_out[l]);
  if (C > WG_MAXC || width > 128 || d > WG_MAXD || n_out > WG_MAXOUT)
    return 0;
  int CP = 1;
  while (CP < C) CP *= 2;
  const int NP = width <= 64 ? 64 : 128;
  const int KC = bf16 ? NP : 64;
  const int P = (L - 2) * (NP / KC);
  const int stage = NP * KC * (bf16 ? 2 : (flavor == FL_TF32 ? 4 : 8));
  const int misc =
      (4 * (NP * (d + L - 1 + n_out) + WG_MAXOUT) + 15) / 16 * 16;
  const int bars = 2 * WG_MAXS * 8;
  int S = 0;
  if (P > 0) {
    S = imin(imin(P, (smem_optin - misc - bars) / stage), WG_MAXS);
    if (S < P && S < 2) return 0;
  }
  const int tile = wg_tile(bf16);
  const int n_tiles = (int)(((long long)N * CP + tile - 1) / tile);
  *p = WgPlan{NP, CP, KC, S, P, P <= S ? 1 : 0, stage, n_tiles,
              imin(n_tiles, n_sm), S * stage + misc + bars};
  return 1;
}

static __device__ __forceinline__ void mbar_init_n(uint64_t* bar, int n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(n) : "memory");
}

static __device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// The column of accumulator register i of lane t (wgmma.cuh): n8 block
// i / 4, columns 2t and 2t + 1; registers i with bit 1 set are the lane's
// second row.
static __device__ __forceinline__ int acc_col(int i, int t) {
  return 8 * (i >> 2) + 2 * t + (i & 1);
}

// Layer 0's pre-activations of the lane's two rows (points gp0 and gp1,
// its channel of order ord; -1 a pad channel): the primal X W0 + b0 (the k
// terms in order, as taylor_common.cuh's layer0_fwd), a first-order
// channel's seed row W0[dir], zero for higher orders and pad channels.
// FL: X and W0 rounded as the flavor's operands (sW0 holds them so), b0
// not.
template <int FL, int NP>
static __device__ __forceinline__ void k1w_layer0(
    const float* __restrict__ X, int N, int d, int gp0, int gp1, int ord,
    int dir, int t, const float* sW0, const float* sB, float (&acc)[NP / 2]) {
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) acc[i] = 0.f;
  for (int k = 0; k < d; ++k) {
    const float x0 = gp0 < N ? opnd<FL>(X[(size_t)gp0 * d + k]) : 0.f;
    const float x1 = gp1 < N ? opnd<FL>(X[(size_t)gp1 * d + k]) : 0.f;
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

// The CP lanes of a point (lane ^ 4, ^ 8, ^ 16) exchange a group of CP
// registers: lane c held channel c of the group's items 0 .. CP-1, and
// holds after it channels 0 .. CP-1 of item c.  A butterfly of shuffles,
// its own inverse.
template <int CP>
static __device__ __forceinline__ void k1w_transpose(float (&x)[CP], int c) {
#pragma unroll
  for (int m = 1; m < CP; m <<= 1) {
    const bool up = (c & m) != 0;
#pragma unroll
    for (int i = 0; i < CP; ++i) {
      if (i & m) continue;
      const float recv =
          __shfl_xor_sync(0xffffffffu, up ? x[i] : x[i | m], 4 * m);
      x[i] = up ? recv : x[i];
      x[i | m] = up ? x[i | m] : recv;
    }
  }
}

// y[k] for a channel index k that is the same in every lane (the
// schedule's): selects, not a register array indexed at run time.
template <int CP>
static __device__ __forceinline__ float k1w_pick(const float* y, int k) {
  float r = y[0];
#pragma unroll
  for (int q = 1; q < CP; ++q) r = k == q ? y[q] : r;
  return r;
}

// The activation pass in place on the accumulator.  Each group of CP
// registers is transposed (k1w_transpose) so that each lane holds all CP
// channels of one item; then, a batch of groups at a time, every group's
// tanh chain (z, d1, d2 of the primal; d3 and d4 derived where a line
// needs them, by tanh_chain's expressions); then channel by channel, from
// the highest down (a line reads only lower channels, so in place is
// safe), every group's Faa di Bruno line (taylor_common.cuh's fdb_line:
// the same lines, the same operand order); channels past C zero; then the
// primal's z, and the transpose back.  A channel's order is the same in
// every lane, so the branch on it is taken once per channel, outside the
// loops over groups, and the groups' work interleaves freely.
template <int FL, int NP, int CP>
static __device__ __forceinline__ void k1w_act(float (&acc)[NP / 2], int c,
                                               const Sched& s) {
  constexpr bool BF = FL == FL_BF16;
  // groups of CP registers, taken GB at a time: GB items per lane in
  // flight, their chains held in 3 * GB registers (16 at most in the f32
  // flavor's 232-register consumers, 8 in the bf16 flavor's 160)
  constexpr int GBMAX = BF ? 8 : 16;
  constexpr int G = NP / 2 / CP, GB = G < GBMAX ? G : GBMAX;
#pragma unroll
  for (int b = 0; b < G; b += GB) {
    float* a = acc + b * CP;
#pragma unroll
    for (int j = 0; j < GB; ++j) {
      float x[CP];
#pragma unroll
      for (int q = 0; q < CP; ++q) x[q] = a[j * CP + q];
      k1w_transpose<CP>(x, c);
#pragma unroll
      for (int q = 0; q < CP; ++q) a[j * CP + q] = x[q];
    }
    float z[GB], d1[GB], d2[GB];
#pragma unroll
    for (int j = 0; j < GB; ++j) {
      z[j] = tanhf(a[j * CP]);
      d1[j] = 1.f - z[j] * z[j];
      d2[j] = -2.f * z[j] * d1[j];
    }
#pragma unroll
    for (int ch = CP - 1; ch >= 1; --ch) {
      const int o = ch < s.C ? s.order[ch] : 0;
      const int* ix = s.idx[ch];
      if (o == 1) {
#pragma unroll
        for (int j = 0; j < GB; ++j) a[j * CP + ch] = d1[j] * a[j * CP + ch];
      } else if (o == 2) {
#pragma unroll
        for (int j = 0; j < GB; ++j) {
          const float* y = a + j * CP;
          a[j * CP + ch] = d1[j] * y[ch] + d2[j] * k1w_pick<CP>(y, ix[0])
                                               * k1w_pick<CP>(y, ix[1]);
        }
      } else if (o == 3) {
#pragma unroll
        for (int j = 0; j < GB; ++j) {
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
        for (int j = 0; j < GB; ++j) {
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
        for (int j = 0; j < GB; ++j) a[j * CP + ch] = 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < GB; ++j) {
      float x[CP];
      x[0] = z[j];
#pragma unroll
      for (int q = 1; q < CP; ++q) x[q] = a[j * CP + q];
      k1w_transpose<CP>(x, c);
#pragma unroll
      for (int q = 0; q < CP; ++q) a[j * CP + q] = x[q];
    }
  }
}

// Hidden layer l's product in place: acc (the layer's input, in the
// accumulator layout) becomes H W_l + b_l (the bias on primal rows), chunk
// by chunk through the stages.  chunk counts the block's chunks taken, the
// ring's position.
template <int FL, int NP>
static __device__ __forceinline__ void k1w_products(
    float (&acc)[NP / 2], int l, int c, int t, int lane, const float* sB,
    char* stages, uint64_t* full, uint64_t* empty, int resident, int S,
    int stage_bytes, long long& chunk) {
  constexpr int KC = FL == FL_BF16 ? NP : 64, NCH = NP / KC;
  float nacc[NP / 2];
#pragma unroll
  for (int h = 0; h < NCH; ++h) {
    int st = (l - 1) * NCH + h;
    unsigned parity = 0;
    if (!resident) {
      st = (int)(chunk % S);
      parity = (unsigned)((chunk / S) & 1);
    }
    mbar_wait(&full[st], parity);
    wg_chunk<FL, NP, KC>(nacc, acc, h,
                         smem_addr(stages + (size_t)st * stage_bytes),
                         h == 0);
    if (!resident) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    ++chunk;
  }
  const float* b = sB + l * NP;
#pragma unroll
  for (int i = 0; i < NP / 2; ++i)
    acc[i] = c == 0 ? nacc[i] + b[acc_col(i, t)] : nacc[i];
}

// The head: each of the n_out columns a dot product over the lane's
// columns, summed over the row's 4 lanes (every lane then holds the same
// sum), plus the bias on primal rows; lane o % 4 stores column o of its
// two rows into table[c][point][o].  FL_BF16 / FL_TF32: the
// post-activations rounded to the flavor's operand first (sWh is rounded),
// sums in f32.
template <int FL, int NP>
static __device__ __forceinline__ void k1w_head(
    float (&acc)[NP / 2], float* __restrict__ table, int N, int n_out, int C,
    int c, int t, int gp0, int gp1, const float* sWh, const float* sBh) {
  if constexpr (FL != FL_F32) {
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) acc[i] = opnd<FL>(acc[i]);
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
    if ((o & 3) == t && c < C) {
      if (gp0 < N) table[((size_t)c * N + gp0) * n_out + o] = s0;
      if (gp1 < N) table[((size_t)c * N + gp1) * n_out + o] = s1;
    }
  }
}

// The route's kernel: the consumer warpgroups first, then the producer
// warpgroup (its first thread issues the copies).
template <int FL, int NP, int CP>
__global__ void __launch_bounds__(wg_threads(FL == FL_BF16), 1)
taylor_fwd_wg_kernel(const float* __restrict__ X,
                     const float* __restrict__ prm,
                     const char* __restrict__ wprep,
                     float* __restrict__ table, int N, Net net, Sched s,
                     WgPlan wp) {
  constexpr bool BF = FL == FL_BF16;
  extern __shared__ __align__(128) char smw[];
  constexpr int NC = wg_consumers(BF), NT = wg_threads(BF);
  const int d = net.d, L = net.L, n_out = net.n_out;
  char* stages = smw;
  float* sW0 = reinterpret_cast<float*>(smw + (size_t)wp.S * wp.stage_bytes);
  float* sB = sW0 + d * NP;
  float* sWh = sB + (L - 1) * NP;
  float* sBh = sWh + NP * n_out;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smw + (wp.smem - 2 * WG_MAXS * 8));
  uint64_t* empty = full + WG_MAXS;
  if (threadIdx.x == 0) {
    for (int i = 0; i < wp.S; ++i) {
      mbar_init_n(&full[i], 1);
      mbar_init_n(&empty[i], 4 * NC);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  // the small operands, NP-wide rows zero past each layer's width
  const int w0 = net.w_out[0], wl = net.w_in[L - 1];
  for (int e = threadIdx.x; e < d * NP; e += NT) {
    const int k = e / NP, n = e % NP;
    sW0[e] = n < w0 ? opnd<FL>(prm[net.offW[0] + k * w0 + n]) : 0.f;
  }
  for (int e = threadIdx.x; e < (L - 1) * NP; e += NT) {
    const int l = e / NP, n = e % NP;
    sB[e] = n < net.w_out[l] ? prm[net.offb[l] + n] : 0.f;
  }
  for (int e = threadIdx.x; e < NP * n_out; e += NT)
    sWh[e] = e / n_out < wl ? opnd<FL>(prm[net.offW[L - 1] + e]) : 0.f;
  for (int o = threadIdx.x; o < n_out; o += NT)
    sBh[o] = prm[net.offb[L - 1] + o];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= 4 * NC) {
    // the producer: the block's chunks in the consumers' order, each into
    // the next stage once every consumer warp has released it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(wg_regs_producer(BF)));
    if (threadIdx.x == 128 * NC && wp.P > 0) {
      const int mine = (wp.n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                       (int)gridDim.x;
      const long long total =
          wp.resident ? wp.P : (long long)mine * wp.P;
      for (long long i = 0; i < total; ++i) {
        const int st = (int)(i % wp.S);
        if (!wp.resident)
          mbar_wait(&empty[st], (unsigned)((i / wp.S) & 1) ^ 1u);
        mbar_expect(&full[st], (unsigned)wp.stage_bytes);
        bulk_copy(stages + (size_t)st * wp.stage_bytes,
                  wprep + (size_t)(i % wp.P) * wp.stage_bytes,
                  (unsigned)wp.stage_bytes, &full[st]);
      }
    }
  } else {
    // a consumer: rows 64 * wg + 16 * wq + g and + 8 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(wg_regs_consumer(BF)));
    const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
    const int C = s.C;
    const int c = g % CP;
    const int ord = c < C ? s.order[c] : -1;
    const int dir = ord == 1 ? s.idx[c][0] : 0;
    const int ppt = wg_tile(BF) / CP;
    const int row = 64 * wg + 16 * wq + g;
    const int pl0 = row / CP, pl1 = (row + 8) / CP;
    long long chunk = 0;
    for (int tile = blockIdx.x; tile < wp.n_tiles; tile += gridDim.x) {
      const int gp0 = tile * ppt + pl0, gp1 = tile * ppt + pl1;
      float acc[NP / 2];
      k1w_layer0<FL, NP>(X, N, d, gp0, gp1, ord, dir, t, sW0, sB, acc);
      for (int l = 1; l < L; ++l) {
        k1w_act<FL, NP, CP>(acc, c, s);
        if (l + 1 < L)
          k1w_products<FL, NP>(acc, l, c, t, lane, sB, stages, full, empty,
                               wp.resident, wp.S, wp.stage_bytes, chunk);
        else
          k1w_head<FL, NP>(acc, table, N, n_out, C, c, t, gp0, gp1, sWh,
                           sBh);
      }
    }
  }
}

// The hidden layers' weights in the route's chunks (the plain mirror is
// ops/cuda_taylor.py::wg_prepare): chunk q holds layer 1 + q / (NP/KC)'s k
// rows (q % (NP/KC)) * KC .. as W^T, zero past the layer's shape, in
// core-matrix order (wg_cm_offset) and, for tf32, the k-slot order
// (wg_kslot); f32: the hi plane then the lo plane of split_tf32; tf32: the
// hi plane alone; bf16: W rounded to nearest even.
template <int FL>
static __global__ void prep_wg_weights(const float* __restrict__ prm,
                                       char* __restrict__ out, Net net,
                                       WgPlan wp) {
  const int NP = wp.NP, KC = wp.KC, per = NP * KC, nch = NP / KC;
  const int total = wp.P * per;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += gridDim.x * blockDim.x) {
    const int q = e / per, r = e % per, n = r / KC, kq = r % KC;
    const int l = 1 + q / nch;
    const int k = (q % nch) * KC +
                  (FL == FL_BF16 ? kq : 8 * (kq / 8) + wg_kslot(kq % 8));
    const float w = (k < net.w_in[l] && n < net.w_out[l])
                        ? prm[net.offW[l] + k * net.w_out[l] + n]
                        : 0.f;
    char* chunk = out + (size_t)q * wp.stage_bytes;
    if constexpr (FL == FL_BF16) {
      reinterpret_cast<bf16*>(chunk)[wg_cm_offset(n, kq, KC, 8)] =
          __float2bfloat16_rn(w);
    } else if constexpr (FL == FL_TF32) {
      reinterpret_cast<float*>(chunk)[wg_cm_offset(n, kq, KC, 4)] = tf32r(w);
    } else {
      unsigned hi, lo;
      split_tf32(w, hi, lo);
      float* f = reinterpret_cast<float*>(chunk);
      const int o = wg_cm_offset(n, kq, KC, 4);
      f[o] = __uint_as_float(hi);
      f[per + o] = __uint_as_float(lo);
    }
  }
}

template <int FL, int NP, int CP>
static int launch_wg(const float* X, const float* prm, char* wprep,
                     float* table, int N, const Net& net, const Sched& s,
                     const WgPlan& wp, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      taylor_fwd_wg_kernel<FL, NP, CP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, wp.smem);
  if (e != cudaSuccess) return (int)e;
  if (wp.P > 0) {
    prep_wg_weights<FL><<<64, 256, 0, st>>>(prm, wprep, net, wp);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  taylor_fwd_wg_kernel<FL, NP, CP>
      <<<wp.grid, wg_threads(FL == FL_BF16), wp.smem, st>>>(
      X, prm, wprep, table, N, net, s, wp);
  return (int)cudaGetLastError();
}

// One flavor's launch at one NP, at its plan's CP (taylor_fwd_wg_*.cu
// define the four; cudaErrorInvalidValue for a channel count the route has
// no instance of).
#define K1WG_INSTANCES(name, FL, NP)                                        \
  int name(const float* X, const float* prm, char* w, float* table, int N, \
           const Net& net, const Sched& s, const WgPlan& wp,                \
           cudaStream_t st) {                                               \
    switch (wp.CP) {                                                        \
      case 1: return launch_wg<FL, NP, 1>(X, prm, w, table, N, net, s, wp, st); \
      case 2: return launch_wg<FL, NP, 2>(X, prm, w, table, N, net, s, wp, st); \
      case 4: return launch_wg<FL, NP, 4>(X, prm, w, table, N, net, s, wp, st); \
      case 8: return launch_wg<FL, NP, 8>(X, prm, w, table, N, net, s, wp, st); \
      default: return (int)cudaErrorInvalidValue;                           \
    }                                                                       \
  }

#define K1WG_DECLARE(name)                                                  \
  int name(const float* X, const float* prm, char* w, float* table, int N, \
           const Net& net, const Sched& s, const WgPlan& wp, cudaStream_t st);
K1WG_DECLARE(k1wg_f32_64)
K1WG_DECLARE(k1wg_f32_128)
K1WG_DECLARE(k1wg_bf16_64)
K1WG_DECLARE(k1wg_bf16_128)
K1WG_DECLARE(k1wg_tf32_64)
K1WG_DECLARE(k1wg_tf32_128)
