// What the tensor-core products of the port's K2/K3 reach on one NVIDIA
// GPU, apart from the rest of the kernels: independent mma.sync tf32
// m16n8k8 (the instruction's rate), and the kernels' own product routines
// (csrc/taylor_common.cuh: product_fwd, product_dh, product_dw, with the
// weight stage filled from global memory as the kernels fill it) run in
// the order one K2/K3 tile runs them, on wavefront buffers of R rows, for
// `tiles` tiles per block on one block per SM.  Last, a 256-wide layer's
// forward product three ways: the kernels' product_fwd (128-row weight
// chunks, each loaded and waited for), and 64-row chunks either through a
// two-slot cp.async ring (chunk q+1 in flight while chunk q is in the
// MMAs, one barrier per chunk) or each waited for: what such a ring buys.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o torch_mma_bench scripts/torch_mma_bench.cu && ./torch_mma_bench
//
// Prints, per product kind, ms per launch, the blocks' cycles per tile
// (clock64, so independent of the SM clock), and cycles per mma per SM
// sub-partition (each of the three passes counted).
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

// which: 1 forward (3 layers, each W's chunks issued ahead, + bias), 2 dH
// (3 layers), 4 dW (3 layers into the block's slot); the kernels' order is
// 1 then (2, 4) per layer.  8: the forward's three stage fills alone, each
// waited for; 16: the forward's three products on a stage filled once (no
// fill); 32: the forward's k8 steps alone, no barrier and no epilogue.
// W: 3 layers of 128 x 128 then 128 biases each.
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
        product_fwd<false>(in, ld, R, 128, W, 128, W + 128 * 128, 4, out, wst, true);
        continue;
      }
      const bool how = prefetch_fwd(W, 128, 128, wst);
      __syncthreads();  // the kernels' activation pass ends in one
      if (which & 1) {
        product_fwd<false>(in, ld, R, 128, W, 128, W + 128 * 128, 4, out, wst, how);
      } else {
        cp_async_wait_all();
        __syncthreads();
      }
    }
    for (int l = 2; l >= 0 && (which & 6); --l) {
      const float* W = prm + l * (128 * 128 + 128);
      if (which & 4)
        product_dw<false>(b0, b2, ld, R, 128, 128, mypart + l * 128 * 128, first);
      if (which & 2) {
        const bool how = prefetch_dh(W, 128, 128, wst);
        __syncthreads();
        product_dh<false>(b2, ld, R, 128, W, 128, b1, wst, how);
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
        mma_run<false, false>(acc, OpFwd(b0 + (wm0 + g) * ld + 2 * t, ld,
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
        mma_run<false, false>(acc, OpFwd(A + (wm0 + g) * ld + c * CH + 2 * t, ld,
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
      product_fwd<false>(in, ld, R, WIDE, W, WIDE, nullptr, 1, out, wst, issued);
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
  cudaMalloc(&cyc, dev_sm * sizeof(long long));
  const int tiles = 16;
  for (int R : {96, 128}) {
    const size_t smem = smem_bytes(3, R, LD);
    if (smem > 232448) continue;  // three buffers of 128 rows do not fit
    cudaFuncSetAttribute(tile_products,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    for (int which : {1, 2, 4, 7, 8, 16, 32}) {
      const char* name = which == 1 ? "forward" : which == 2 ? "dH"
                       : which == 4 ? "dW" : which == 7 ? "all nine"
                       : which == 8 ? "fills" : which == 16 ? "fwd, no fill"
                       : "k8 steps";
      tile_products<<<dev_sm, NTHREADS, smem>>>(prm, part, cyc, tiles, R,
                                                which);
      cudaEventRecord(a);
      tile_products<<<dev_sm, NTHREADS, smem>>>(prm, part, cyc, tiles, R,
                                                which);
      cudaEventRecord(b);
      cudaEventSynchronize(b);
      check("tile_products");
      float ms;
      cudaEventElapsedTime(&ms, a, b);
      const double mean = mean_cycles(cyc, dev_sm);
      const int kinds = which == 7 ? 9 : 3;
      // mma per block per product: m16 fragments x n8 fragments x k8 steps
      // x 3 passes (dW: 128 x 128 out, Rp deep)
      const double mma = (double)(((R + 15) & ~15) / 16) * 16 * 16 * 3;
      if (which == 8) {
        printf("[bench ld=%d R=%d] %-12s x3 per tile: %.3f ms, %.0f cycles "
               "per 64 KB fill\n", LD, R, name, ms, mean / tiles / 3);
        continue;
      }
      printf("[bench ld=%d R=%d] %-12s x%d per tile: %.3f ms, %.0f cycles per "
             "tile, %.2f cycles per mma per SMSP, %.1f TFLOP/s of passes\n",
             LD, R, name, kinds, ms, mean / tiles,
             mean / tiles / (kinds * mma / 4),
             (double)dev_sm * tiles * kinds * mma * 2048 / ms / 1e9);
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
