// What the tensor-core products of the port's K2/K3 reach on one NVIDIA
// GPU, apart from the rest of the kernels: independent mma.sync tf32
// m16n8k8 and bf16 m16n8k16 (the instructions' rates), and the kernels'
// own product routines (csrc/taylor_common.cuh, with the weight stage
// filled from global memory as the kernels fill it) run in the order one
// K2/K3 tile runs them, for `tiles` tiles per block on one block per SM,
// on three routes: the f32 flavor's 3xTF32 (product_fwd, product_dh,
// product_dw on wavefront buffers of R rows); the bf16 flavor's earlier
// route, TF32 passes over operands rounded at each fragment load (the
// kernels no longer take it: a copy here, tf32r_w and tf32r_dw, 1 pass
// forward, 2 for dH and dW, the same f32 buffers and stage); and the bf16 flavor's own route (bmma_w_rows,
// bmma_w_cols, bmma_dw on bf16 slots of 128 rows: ldmatrix into
// mma.m16n8k16 bf16, 1 pass forward, 3 for dH and dW over the
// cotangent's pieces, which split_pieces cuts once per layer; dW added
// into the block's slot by bulk reduce-adds past the first tile, staged in
// slots 2-3 as the kernels stage it).  wgmma is
// not tried.  Last, a 256-wide layer's forward product three ways: the
// kernels' product_fwd (128-row weight chunks, each loaded and waited
// for), and 64-row chunks either through a two-slot cp.async ring (chunk
// q+1 in flight while chunk q is in the MMAs, one barrier per chunk) or
// each waited for: what such a ring buys.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o torch_mma_bench scripts/torch_mma_bench.cu && ./torch_mma_bench
//
// Prints, per route and product kind, ms per launch, the blocks' cycles
// per tile (clock64, so independent of the SM clock), and cycles per mma
// per SM sub-partition (each pass counted; an m16n8k16 is twice the work
// of an m16n8k8).
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "../tensordiffeq_tpu_torch/csrc/taylor_common.cuh"

#define LD 136      // the wavefront stride of a 128-wide net
#define WIDE 256    // the wide layer's width
#define WIDE_LD (WIDE + 8)

static void check(const char* what) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) {
    printf("FAILED %s: %s\n", what, cudaGetErrorString(e));
    exit(1);
  }
}

template <int NACC>
__global__ void peak_tf32(float* out, int iters) {
  float acc[NACC][4];
  for (int i = 0; i < NACC; ++i) for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
  unsigned a[4], b[2];
  for (int q = 0; q < 4; ++q)
    a[q] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + q);
  for (int q = 0; q < 2; ++q) b[q] = __float_as_uint(0.5f + q);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) mma_tf32(acc[i], a, b);
  }
  float s = 0.f;
  for (int i = 0; i < NACC; ++i) for (int q = 0; q < 4; ++q) s += acc[i][q];
  if (s == 12345.f) out[threadIdx.x] = s;
}

__global__ void peak_bf16(float* out, int iters) {
  float acc[8][4];
  for (int i = 0; i < 8; ++i) for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
  unsigned a[4], b[2];
  for (int q = 0; q < 4; ++q) a[q] = 0x3f803f80u + threadIdx.x + q;
  for (int q = 0; q < 2; ++q) b[q] = 0x3f003f00u + q;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) mma_bf16(acc[i], a, b);
  }
  float s = 0.f;
  for (int i = 0; i < 8; ++i) for (int q = 0; q < 4; ++q) s += acc[i][q];
  if (s == 12345.f) out[threadIdx.x] = s;
}

// Fill n_buf wavefront buffers of Rp x ld: rows < R small values, pad rows
// zero.
static __device__ void fill_buffers(float* sm, int n_buf, int R, int ld) {
  const int Rp = pad16(R);
  for (int e = threadIdx.x; e < n_buf * Rp * ld; e += NTHREADS) {
    const int r = (e / ld) % Rp;
    sm[e] = r < R ? 1e-2f * ((e % 97) - 48) : 0.f;
  }
  __syncthreads();
}

// ------------------------------------------------------------------------
// The bf16 flavor's earlier route, for the comparison only: TF32 passes over
// operands rounded to bf16 at each fragment load.  A rounded value has 8
// significant bits, so its f32 pattern is exact in TF32 and the product of
// two is exact in f32: one pass over two rounded operands; a rounded
// operand against an f32 one (a cotangent) takes two, the f32 side split as
// split_tf32 splits it, lo*b + hi*b.  RA, RB: A, B rounded (true) or split
// (one of them at least).
// Trimmed to this bench's tiles: K = Nn = Ni = 128 (one weight chunk, one
// column tile) and 96 or 128 rows.

template <int NFM, bool RA, bool RB, class Op>
static __device__ __forceinline__ void tf32r_steps(float (&acc)[WFM][WFN][4],
                                                   const Op& op, int steps) {
  float x[NFM][4], y[WFN][2];
  frag_load<NFM, true>(op, 0, NFM, WFN, x, y);
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    unsigned ah[NFM][4], al[NFM][4], bh[WFN][2], bl[WFN][2];
#pragma unroll
    for (int mf = 0; mf < NFM; ++mf)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if constexpr (RA) ah[mf][q] = __float_as_uint(bf16r(x[mf][q]));
        else split_tf32(x[mf][q], ah[mf][q], al[mf][q]);
      }
#pragma unroll
    for (int nf = 0; nf < WFN; ++nf)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if constexpr (RB) bh[nf][q] = __float_as_uint(bf16r(y[nf][q]));
        else split_tf32(y[nf][q], bh[nf][q], bl[nf][q]);
      }
    if (s + 1 < steps) frag_load<NFM, true>(op, 8 * (s + 1), NFM, WFN, x, y);
    float st[NFM][WFN][4];
#pragma unroll
    for (int mf = 0; mf < NFM; ++mf)
#pragma unroll
      for (int nf = 0; nf < WFN; ++nf) {
        if constexpr (!RA) mma_tf32_first(st[mf][nf], al[mf], bh[nf]);
        else if constexpr (!RB) mma_tf32_first(st[mf][nf], ah[mf], bl[nf]);
      }
#pragma unroll
    for (int mf = 0; mf < NFM; ++mf)
#pragma unroll
      for (int nf = 0; nf < WFN; ++nf) {
        if constexpr (RA && RB) mma_tf32_first(st[mf][nf], ah[mf], bh[nf]);
        else mma_tf32(st[mf][nf], ah[mf], bh[nf]);
      }
#pragma unroll
    for (int mf = 0; mf < NFM; ++mf)
#pragma unroll
      for (int nf = 0; nf < WFN; ++nf)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mf][nf][q] += st[mf][nf][q];
  }
}

// mma_w on this route: the forward takes both operands rounded; dH (COLS)
// takes W rounded against the f32 dP and is rounded as it is stored.
template <bool COLS>
static __device__ void tf32r_w(float* A, int ld, int R,
                               const float* __restrict__ W,
                               const float* __restrict__ bias, int C,
                               float* out, float* wst, bool issued) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mtot = pad16(R) / 16, mhalf = (mtot + 1) / 2;
  const int wm0 = (warp & 1) ? mhalf * 16 : 0;
  const int nfm = (warp & 1) ? mtot - mhalf : mhalf;
  const int wn0 = (warp >> 1) * (WFN * 8);
  if (!issued) {
    stage_load<COLS>(W, 128, 128, 0, 0, wst);
    cp_async_commit();
  }
  cp_async_wait_all();
  __syncthreads();
  float acc[WFM][WFN][4];
  zero_acc(acc);
  const float* Ap = A + (wm0 + g) * ld + 2 * t;
  if constexpr (COLS) {
    const OpDh op(Ap, ld, wst + (wn0 + g) * LDB_COLS + 2 * t);
    if (nfm == 4) tf32r_steps<4, false, true>(acc, op, 16);
    else tf32r_steps<3, false, true>(acc, op, 16);
  } else {
    const OpFwd op(Ap, ld, wst + 2 * t * LDB_ROWS + wn0 + g);
    if (nfm == 4) tf32r_steps<4, true, true>(acc, op, 16);
    else tf32r_steps<3, true, true>(acc, op, 16);
  }
#pragma unroll
  for (int mf = 0; mf < WFM; ++mf) {
    if (mf >= nfm) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm0 + mf * 16 + g + 8 * h;
      if (r >= R) continue;
      const bool prim = bias != nullptr && r % C == 0;
#pragma unroll
      for (int nf = 0; nf < WFN; ++nf) {
        const int n = wn0 + nf * 8 + 2 * t;
        float v0 = acc[mf][nf][2 * h], v1 = acc[mf][nf][2 * h + 1];
        if (COLS) { v0 = bf16r(v0); v1 = bf16r(v1); }
        if (prim) { v0 += bias[n]; v1 += bias[n + 1]; }
        *reinterpret_cast<float2*>(out + r * ld + n) = make_float2(v0, v1);
      }
    }
  }
  __syncthreads();
}

// mma_dw on this route: H rounded against the f32 E.
static __device__ void tf32r_dw(const float* H, const float* E, int ld,
                                int R, float* __restrict__ part, bool first) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp & 1) * (WFM * 16), wn0 = (warp >> 1) * (WFN * 8);
  if (!first) slot_prefetch(part, wm0, wn0, 128, 128, lane);
  float acc[WFM][WFN][4];
  zero_acc(acc);
  tf32r_steps<WFM, true, false>(
      acc, OpDw{H + t * ld + wm0 + g, E + t * ld + wn0 + g, ld},
      pad16(R) / 8);
  slot_update(acc, part, wm0, wn0, 128, 128, WFM, WFN, true, first, g, t);
  __syncthreads();
}

// which: 1 forward (3 layers, each W's chunks issued ahead, + bias), 2 dH
// (3 layers), 4 dW (3 layers into the block's slot); the kernels' order is
// 1 then (2, 4) per layer.  8: the forward's three stage fills alone, each
// waited for; 16: the forward's three products on a stage filled once (no
// fill); 32: the forward's k8 steps alone, no barrier and no epilogue.
// W: 3 layers of 128 x 128 then 128 biases each.  TF32R: the products as the
// bf16 flavor took them before its own route (which 1, 2, 4 only).
template <bool TF32R>
__global__ void __launch_bounds__(NTHREADS)
tile_products(const float* __restrict__ prm, float* __restrict__ part,
              long long* __restrict__ cycles, int tiles, int R, int which) {
  extern __shared__ __align__(16) float sm[];
  const int ld = LD, Rp = pad16(R);
  float* b0 = sm;
  float* b1 = sm + Rp * ld;
  float* b2 = sm + 2 * Rp * ld;
  float* wst = stage_of(sm, 3, R, ld);
  fill_buffers(sm, 3, R, ld);
  // "filled, nothing in flight": the products then wait on no copy
  if (which & 16) {
    prefetch_fwd(prm, 128, 128, wst);
    cp_async_wait_all();
    __syncthreads();
  }
  float* mypart = part + (size_t)blockIdx.x * 3 * 128 * 128;
  float sink = 0.f;
  const long long t0 = clock64();
  for (int tile = 0; tile < tiles; ++tile) {
    const bool first = tile == 0;
    for (int l = 0; l < 3 && (which & 25); ++l) {
      const float* W = prm + l * (128 * 128 + 128);
      float* in = (l & 1) ? b1 : b0;
      float* out = (l & 1) ? b0 : b1;
      if (which & 16) {
        product_fwd(in, ld, R, 128, W, 128, W + 128 * 128, 4, out, wst, true);
        continue;
      }
      const bool how = prefetch_fwd(W, 128, 128, wst);
      __syncthreads();  // the kernels' activation pass ends in one
      if (which & 1) {
        if (TF32R)
          tf32r_w<false>(in, ld, R, W, W + 128 * 128, 4, out, wst, how);
        else
          product_fwd(in, ld, R, 128, W, 128, W + 128 * 128, 4, out, wst, how);
      } else {
        cp_async_wait_all();
        __syncthreads();
      }
    }
    for (int l = 2; l >= 0 && (which & 6); --l) {
      const float* W = prm + l * (128 * 128 + 128);
      if (which & 4) {
        if (TF32R)
          tf32r_dw(b0, b2, ld, R, mypart + l * 128 * 128, first);
        else
          product_dw(b0, b2, ld, R, 128, 128, mypart + l * 128 * 128, first);
      }
      if (which & 2) {
        const bool how = prefetch_dh(W, 128, 128, wst);
        __syncthreads();
        if (TF32R)
          tf32r_w<true>(b2, ld, R, W, nullptr, 1, b1, wst, how);
        else
          product_dh(b2, ld, R, 128, W, 128, b1, wst, how);
      }
    }
    if (which & 32) {
      const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
      const int g = lane >> 2, t = lane & 3;
      const int mhalf = (Rp / 16 + 1) / 2;
      const int wm0 = (warp & 1) ? mhalf * 16 : 0;
      const int nfm = (warp & 1) ? Rp / 16 - mhalf : mhalf;
      const int wn0 = (warp >> 1) * (WFN * 8);
      for (int l = 0; l < 3; ++l) {
        float acc[WFM][WFN][4];
        zero_acc(acc);
        mma_run(acc, OpFwd(b0 + (wm0 + g) * ld + 2 * t, ld,
                           wst + 2 * t * LDB_ROWS + wn0 + g),
                16, nfm, WFN);
        for (int mf = 0; mf < WFM; ++mf)
          for (int nf = 0; nf < WFN; ++nf)
            for (int q = 0; q < 4; ++q) sink += acc[mf][nf][q];
      }
    }
  }
  if (threadIdx.x == 0) cycles[blockIdx.x] = clock64() - t0;
  if (sink == 12345.f) part[threadIdx.x] = sink;
}

// The bf16 flavor's own route on five bf16 slots of R rows (the K2/K3 bf16
// layout, taylor_common.cuh: reverse_sweep_bf): which 1 forward (3 layers,
// Hb in slot 2 into F in slots 0-1), 2 dH (3 layers from the pieces in
// slots 0, 1, 4 into slot 2), 4 dW (3 layers, H in slot 3, staged for
// the bulk adds in slots 2-3), 8 the
// cotangent's split (3 layers, G in slots 2-3 into the pieces); 15 all of
// a tile's, in the kernels' order (per layer: split, dW, dH).  Each weight
// window comes from the bf16 copy wbf, issued ahead before a barrier, as
// K2/K3 issue it; 16: the forward with K1-bf16's fill instead, rounded
// from the f32 W as it lands.
__global__ void __launch_bounds__(NTHREADS)
tile_products_bf(const float* __restrict__ prm, const bf16* __restrict__ wbf,
                 float* __restrict__ part, long long* __restrict__ cycles,
                 int tiles, int R, int which) {
  extern __shared__ __align__(16) float sm[];
  const int ld = LD, Rp = pad16(R);
  bf16* wst = stage_of_bf(sm, 5, R, ld);
  for (int e = threadIdx.x; e < 5 * Rp * ld; e += NTHREADS) {
    const int r = (e / ld) % Rp;
    reinterpret_cast<bf16*>(sm)[e] =
        __float2bfloat16_rn(r < R ? 1e-2f * ((e % 97) - 48) : 0.f);
  }
  __syncthreads();
  float* F = sm;
  float* G = reinterpret_cast<float*>(slot_of(sm, 2, Rp, ld));
  bf16 *s0 = slot_of(sm, 0, Rp, ld), *s1 = slot_of(sm, 1, Rp, ld);
  bf16 *s2 = slot_of(sm, 2, Rp, ld), *s3 = slot_of(sm, 3, Rp, ld);
  bf16* s4 = slot_of(sm, 4, Rp, ld);
  float* mypart = part + (size_t)blockIdx.x * 3 * 128 * 128;
  const long long t0 = clock64();
  for (int tile = 0; tile < tiles; ++tile) {
    const bool first = tile == 0;
    for (int l = 0; l < 3 && (which & 17); ++l) {
      const float* W = prm + l * (128 * 128 + 128);
      const bf16* Wb = (which & 16) ? nullptr : wbf + l * 128 * 128;
      const bool issued = bprefetch(Wb, 128, 128, true, wst);
      __syncthreads();  // the kernels' activation pass ends in one
      if (Wb)
        bmma_w_rows<true>(s2, ld, R, 128, W, Wb, 128, W + 128 * 128, 4, F,
                          wst, issued);
      else
        bmma_w_rows<false>(s2, ld, R, 128, W, Wb, 128, W + 128 * 128, 4, F,
                           wst, issued);
    }
    for (int l = 2; l >= 0 && (which & 14); --l) {
      const bf16* Wb = wbf + l * 128 * 128;
      const bool issued = (which & 2) && bprefetch(Wb, 128, 128, true, wst);
      if (which & 8) split_pieces(G, ld, R, 128, s1, s0, s4);
      if (which & 4)
        bmma_dw(s3, s4, s0, s1, ld, R, 128, 128, mypart + l * 128 * 128,
                first, G);
      if (which & 2) {
        __syncthreads();
        bmma_w_cols(s4, s0, s1, ld, R, 128, Wb, 128, s2, wst, issued);
      }
    }
  }
  bulk_wait();
  if (threadIdx.x == 0) cycles[blockIdx.x] = clock64() - t0;
}

#define CH 64  // rows of a weight chunk of the ring variants

// Issue chunk q of the wide W [WIDE][WIDE] (CH rows of k, within column
// tile q / (WIDE / CH) of BLK_N) into the stage slot at dst, one group.
static __device__ void chunk_load(const float* __restrict__ W, int q,
                                  float* dst) {
  const int k0 = (q % (WIDE / CH)) * CH, n0 = (q / (WIDE / CH)) * BLK_N;
  for (int e = threadIdx.x; e < CH * BLK_N / 4; e += NTHREADS) {
    const int kk = e / (BLK_N / 4), nn = 4 * (e % (BLK_N / 4));
    cp_async16(dst + kk * LDB_ROWS + nn,
               W + (size_t)(k0 + kk) * WIDE + n0 + nn);
  }
  cp_async_commit();
}

static __device__ __forceinline__ void wait_groups(int pending) {
  if (pending) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The wide forward product in CH-row chunks, ring or each chunk loaded into
// slot 0 and waited for (two barriers per chunk); the accumulators go to a
// sink, not to a buffer.
static __device__ float wide_chunks(const float* A, int ld, int R,
                                    const float* __restrict__ W, float* wst,
                                    bool ring) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mtot = pad16(R) / 16, mhalf = (mtot + 1) / 2;
  const int wm0 = (warp & 1) ? mhalf * 16 : 0;
  const int nfm = (warp & 1) ? mtot - mhalf : mhalf;
  const int wn0 = (warp >> 1) * (WFN * 8);
  const int nK = WIDE / CH, total = nK * (WIDE / BLK_N);
  if (ring) {
    chunk_load(W, 0, wst);
    chunk_load(W, 1, wst + CH * LDB_ROWS);
  }
  float sink = 0.f;
  int q = 0;
  for (int n0 = 0; n0 < WIDE; n0 += BLK_N) {
    float acc[WFM][WFN][4];
    zero_acc(acc);
    for (int c = 0; c < nK; ++c, ++q) {
      const float* B = wst + (ring ? (q & 1) : 0) * CH * LDB_ROWS;
      if (ring) {
        wait_groups(q == 0);
        __syncthreads();  // chunk q is in; every warp is done with q-1's slot
        if (q >= 1 && q + 1 < total)
          chunk_load(W, q + 1, wst + ((q + 1) & 1) * CH * LDB_ROWS);
      } else {
        chunk_load(W, q, wst);
        wait_groups(0);
        __syncthreads();
      }
      if (nfm > 0)
        mma_run(acc, OpFwd(A + (wm0 + g) * ld + c * CH + 2 * t, ld,
                           B + 2 * t * LDB_ROWS + wn0 + g),
                CH / 8, nfm, WFN);
      if (!ring) __syncthreads();
    }
    for (int mf = 0; mf < WFM; ++mf)
      for (int nf = 0; nf < WFN; ++nf)
        for (int e = 0; e < 4; ++e) sink += acc[mf][nf][e];
  }
  return sink;
}

// how: 0 the kernels' product_fwd (its first chunk issued ahead as the
// kernels issue it); 1 the CH-row ring; 2 CH-row chunks each waited for.
__global__ void __launch_bounds__(NTHREADS)
wide_forward(const float* __restrict__ W, float* __restrict__ out_g,
             long long* __restrict__ cycles, int tiles, int R, int how) {
  extern __shared__ __align__(16) float sm[];
  const int ld = WIDE_LD, Rp = pad16(R);
  float* in = sm;
  float* out = sm + Rp * ld;
  float* wst = stage_of(sm, 2, R, ld);
  fill_buffers(sm, 2, R, ld);
  float sink = 0.f;
  const long long t0 = clock64();
  for (int tile = 0; tile < tiles; ++tile) {
    if (how == 0) {
      const bool issued = prefetch_fwd(W, WIDE, WIDE, wst);
      __syncthreads();
      product_fwd(in, ld, R, WIDE, W, WIDE, nullptr, 1, out, wst, issued);
    } else {
      sink += wide_chunks(in, ld, R, W, wst, how == 1);
    }
  }
  if (threadIdx.x == 0) cycles[blockIdx.x] = clock64() - t0;
  if (sink == 12345.f || out[threadIdx.x] == 12345.f)
    out_g[threadIdx.x] = sink;
}

static double mean_cycles(const long long* cyc, int n) {
  std::vector<long long> c(n);
  cudaMemcpy(c.data(), cyc, n * sizeof(long long), cudaMemcpyDeviceToHost);
  double mean = 0;
  for (long long v : c) mean += (double)v / n;
  return mean;
}

int main() {
  int dev_sm = 0, clk = 0;
  cudaDeviceGetAttribute(&dev_sm, cudaDevAttrMultiProcessorCount, 0);
  cudaDeviceGetAttribute(&clk, cudaDevAttrClockRate, 0);
  float* out;
  cudaMalloc(&out, 1 << 20);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  {
    const int it = 20000;
    peak_tf32<8><<<dev_sm, 256>>>(out, it);
    cudaEventRecord(a);
    peak_tf32<8><<<dev_sm, 256>>>(out, it);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    check("peak_tf32");
    float ms;
    cudaEventElapsedTime(&ms, a, b);
    const double mmas = (double)dev_sm * 8 * it * 8;
    printf("[bench] tf32 m16n8k8, 8 independent chains per warp, 8 warps/SM: "
           "%.1f TFLOP/s, %.2f cycles per mma per SMSP at %.3f GHz\n",
           mmas * 2048 / ms / 1e9,
           ms * 1e-3 * clk * 1e3 / (mmas / dev_sm / 4), clk / 1e6);
  }
  {
    const int it = 20000;
    peak_bf16<<<dev_sm, 256>>>(out, it);
    cudaEventRecord(a);
    peak_bf16<<<dev_sm, 256>>>(out, it);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    check("peak_bf16");
    float ms;
    cudaEventElapsedTime(&ms, a, b);
    const double mmas = (double)dev_sm * 8 * it * 8;
    printf("[bench] bf16 m16n8k16, 8 independent chains per warp, 8 warps/SM: "
           "%.1f TFLOP/s, %.2f cycles per mma per SMSP at %.3f GHz\n",
           mmas * 4096 / ms / 1e9,
           ms * 1e-3 * clk * 1e3 / (mmas / dev_sm / 4), clk / 1e6);
  }
  const int P = 3 * (128 * 128 + 128);
  std::vector<float> h(WIDE * WIDE > P ? WIDE * WIDE : P);
  for (size_t i = 0; i < h.size(); ++i)
    h[i] = 1e-2f * ((i * 7919) % 201 - 100) / 100.f;
  float *prm, *part, *wide;
  long long* cyc;
  cudaMalloc(&prm, P * sizeof(float));
  cudaMemcpy(prm, h.data(), P * sizeof(float), cudaMemcpyHostToDevice);
  cudaMalloc(&wide, WIDE * WIDE * sizeof(float));
  cudaMemcpy(wide, h.data(), WIDE * WIDE * sizeof(float),
             cudaMemcpyHostToDevice);
  cudaMalloc(&part, (size_t)dev_sm * 3 * 128 * 128 * sizeof(float));
  // the three layers' W rounded to bf16, as round_weights lays them out
  std::vector<bf16> hb(3 * 128 * 128);
  for (int l = 0; l < 3; ++l)
    for (int i = 0; i < 128 * 128; ++i)
      hb[l * 128 * 128 + i] = __float2bfloat16_rn(h[l * (128 * 128 + 128) + i]);
  bf16* wbf;
  cudaMalloc(&wbf, hb.size() * sizeof(bf16));
  cudaMemcpy(wbf, hb.data(), hb.size() * sizeof(bf16), cudaMemcpyHostToDevice);
  cudaMalloc(&cyc, dev_sm * sizeof(long long));
  const int tiles = 16;
  // route 0: the f32 flavor (3xTF32); 1: the bf16 flavor's earlier route
  // (TF32 passes on rounded operands); both on three f32 buffers, so 96
  // rows (128 do not fit)
  for (int route = 0; route < 2; ++route) {
    const int R = 96;
    const size_t smem = smem_bytes(3, R, LD);
    auto kern = route ? tile_products<true> : tile_products<false>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    for (int which : {1, 2, 4, 7, 8, 16, 32}) {
      if (route == 1 && (which & 56)) continue;
      const char* name = which == 1 ? "forward" : which == 2 ? "dH"
                       : which == 4 ? "dW" : which == 7 ? "all nine"
                       : which == 8 ? "fills" : which == 16 ? "fwd, no fill"
                       : "k8 steps";
      kern<<<dev_sm, NTHREADS, smem>>>(prm, part, cyc, tiles, R, which);
      cudaEventRecord(a);
      kern<<<dev_sm, NTHREADS, smem>>>(prm, part, cyc, tiles, R, which);
      cudaEventRecord(b);
      cudaEventSynchronize(b);
      check("tile_products");
      float ms;
      cudaEventElapsedTime(&ms, a, b);
      const double mean = mean_cycles(cyc, dev_sm);
      const int kinds = which == 7 ? 9 : 3;
      // mma per block per product: m16 fragments x n8 fragments x k8 steps
      // x passes (dW: 128 x 128 out, Rp deep); TF32-pass route: 1 forward, 2 dH/dW
      const double frags = (double)(((R + 15) & ~15) / 16) * 16 * 16;
      const double mma = route == 0 ? frags * 3 * kinds
                       : frags * (which == 1 ? 3 : which == 7 ? 15 : 6);
      const char* rname = route ? "bf16 TF32-pass route" : "f32 (3xtf32)";
      if (which == 8) {
        printf("[bench %s ld=%d R=%d] %-12s x3 per tile: %.3f ms, %.0f cycles "
               "per 64 KB fill\n", rname, LD, R, name, ms, mean / tiles / 3);
        continue;
      }
      printf("[bench %s ld=%d R=%d] %-12s x%d per tile: %.3f ms, %.0f cycles "
             "per tile, %.2f cycles per mma per SMSP, %.1f TFLOP/s of passes"
             "\n", rname, LD, R, name, kinds, ms, mean / tiles,
             mean / tiles / (mma / 4),
             (double)dev_sm * tiles * mma * 2048 / ms / 1e9);
    }
  }
  // route 2: the bf16 flavor's own, on its five slots of 128 rows
  {
    const int R = 128;
    const size_t smem = smem_bytes_bf(5, R, LD);
    cudaFuncSetAttribute(tile_products_bf,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    for (int which : {1, 2, 4, 8, 15, 16}) {
      const char* name = which == 1 ? "forward" : which == 2 ? "dH"
                       : which == 4 ? "dW" : which == 8 ? "split"
                       : which == 15 ? "all nine" : "fwd, K1 fill";
      tile_products_bf<<<dev_sm, NTHREADS, smem>>>(prm, wbf, part, cyc, tiles,
                                                   R, which);
      cudaEventRecord(a);
      tile_products_bf<<<dev_sm, NTHREADS, smem>>>(prm, wbf, part, cyc, tiles,
                                                   R, which);
      cudaEventRecord(b);
      cudaEventSynchronize(b);
      check("tile_products_bf");
      float ms;
      cudaEventElapsedTime(&ms, a, b);
      const double mean = mean_cycles(cyc, dev_sm);
      // m16n8k16 per block per product: m16 x n8 fragments x k16 steps,
      // times 1 pass (forward) or 3 (dH, dW)
      const double frags = (double)(R / 16) * 16 * 8;
      const double mma = which == 1 || which == 16 ? 3 * frags
                         : which == 2 || which == 4 ? 9 * frags
                         : which == 8 ? 0 : 21 * frags;
      if (which == 8) {
        printf("[bench bf16 native ld=%d R=%d] %-12s x3 per tile: %.3f ms, "
               "%.0f cycles per tile\n", LD, R, name, ms, mean / tiles);
        continue;
      }
      printf("[bench bf16 native ld=%d R=%d] %-12s per tile: %.3f ms, %.0f "
             "cycles per tile, %.2f cycles per m16n8k16 per SMSP, %.1f "
             "TFLOP/s of passes\n", LD, R, name, ms, mean / tiles,
             mean / tiles / (mma / 4),
             (double)dev_sm * tiles * mma * 4096 / ms / 1e9);
    }
  }
  {
    const int R = 48;
    const size_t smem = smem_bytes(2, R, WIDE_LD);
    cudaFuncSetAttribute(wide_forward,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    // m16 fragments x n8 fragments x k8 steps x 3 passes
    const double mma = (double)(R / 16) * (WIDE / 8) * (WIDE / 8) * 3;
    for (int how : {0, 1, 2}) {
      wide_forward<<<dev_sm, NTHREADS, smem>>>(wide, out, cyc, tiles, R, how);
      cudaEventRecord(a);
      wide_forward<<<dev_sm, NTHREADS, smem>>>(wide, out, cyc, tiles, R, how);
      cudaEventRecord(b);
      cudaEventSynchronize(b);
      check("wide_forward");
      float ms;
      cudaEventElapsedTime(&ms, a, b);
      const double mean = mean_cycles(cyc, dev_sm);
      printf("[bench ld=%d R=%d] %dx%d forward, %s: %.3f ms, %.0f cycles "
             "per product, %.2f cycles per mma per SMSP\n", WIDE_LD, R, WIDE,
             WIDE, how == 0 ? "product_fwd, 128-row chunks waited for"
                   : how == 1 ? "ring of two 64-row slots"
                   : "64-row chunks waited for",
             ms, mean / tiles, mean / tiles / (mma / 4));
    }
  }
  return 0;
}
