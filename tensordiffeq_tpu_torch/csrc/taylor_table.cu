// Taylor-table kernels for tanh MLPs: K1 (forward) and K2 (backward).
//
// Replaces the JAX package's Pallas pair in ops/pallas_taylor.py::
// build_pallas_table_fn: `fwd_kernel` (pallas_call at :154) and `bwd_kernel`
// (pallas_call at :171), tied there by jax.custom_vjp and here by a
// torch.autograd.Function (ops/cuda_taylor.py).
//
// What it computes.  One wavefront of C channels per point (the primal and
// every derivative channel of ops/taylor.py::closure, in channel_order) goes
// through the MLP.  Per layer every channel shares one matmul; the tanh
// chain (d1..d4) combines channels by Faa di Bruno.  K1 writes the head's
// channels as table[C][N][n_out].  K2 takes the table cotangents g[C][N][n_out]
// and returns dX[N][d] and the parameter gradient in the packed layout the
// wrapper uses (W_0, b_0, W_1, b_1, ...).
//
// Which channel reads which: the f_model decides (closure of its requests),
// so the host compiles the recurrence into a small integer schedule (per
// channel: its order and the indices of the channels it reads) and ONE
// generic kernel interprets it.  No per-f_model build.
//
// What bounds it on the H100.  Work is dominated by the channel-stacked
// matmuls: 2*C*sum(w_in*w_out) flops per point (0.40 MFLOP/point for the
// Allen-Cahn net 2-128x4-1 at C=4), against ~12 B/point in and C*n_out*4
// B/point out.  So both kernels are bound by FP32 operations, not bytes.
// The design follows from that:
//   * f32 is IEEE f32: plain FP32 FMA on the CUDA cores, no TF32 tensor
//     cores, matching the JAX package's precision=HIGHEST.
//   * the whole wavefront of a point tile (TP points x C channels x width)
//     stays in shared memory across all layers, so device memory sees only
//     X in and the table out (K1) — the Pallas kernel's VMEM residency.
//   * each layer's matmul is a register-tiled SIMT GEMM (16x16 threads,
//     8x8 outputs each) with the weights streamed through a small
//     shared-memory chunk; weights are ~200 KB and stay L2-resident.  The
//     head's product (n_out columns, at most NARROW_N) is a dot-product
//     loop, one thread per output, since the tile would be almost all
//     masked columns.
//   * the pointwise tanh chain runs in place in shared memory, channels in
//     descending order (a channel only reads lower-order channels and the
//     primal, so in-place is safe).
// This first version is simple and right; wgmma/TMA and a persistent K1 are
// later work (its measured times are in PERF.md).  The device code is in
// taylor_common.cuh, which the fused minimax step (minimax_step.cu, K3)
// shares.
//
// K2 differences from the Pallas kernel:
//   * Pallas summed dW/db across a sequential grid (pl.when(i == 0) then
//     +=).  CUDA blocks run in parallel and in no order, so each block owns
//     a partial slot, loops over tiles blockIdx.x, +gridDim.x, ... in a fixed
//     order, and a second kernel reduces the slots in slot order: the result
//     is bit-identical run to run (no atomics).
//   * Pallas got the VJP from jax.vjp inside the kernel.  Here it is written
//     out: the transpose of each Faa di Bruno line needs the tanh chain one
//     order higher (d(d_k)/du = d_{k+1}, so d5 when fourth-order channels
//     are present).
//   * The reverse sweep needs every hidden layer's pre-activation channels.
//     K2 recomputes the tile's forward once and stages them in a global
//     workspace slice private to the block (L-1 layers x TP*C rows), reused
//     for each tile the block takes: 35 MB for 132 blocks on the AC net,
//     so it stays L2-resident, where recomputing per layer would cost
//     O(L^2) matmuls.
//   * The bias enters only the primal channel, so db sums the primal
//     channel's cotangents; first-order seeds are constant one-hots, so dX
//     flows only through the primal channel of layer 0: dX = dP0 @ W0^T.
//   * The ragged tail is masked in the kernel: rows past N read X = 0 and
//     g = 0, so they contribute exactly zero to dW/db and are never written.

#include "taylor_common.cuh"

// ------------------------------------------------------------------------
// K1: one block per tile of TP points.
__global__ void __launch_bounds__(NTHREADS)
taylor_fwd_kernel(const float* __restrict__ X, const float* __restrict__ prm,
                  float* __restrict__ table, int N, int TP, Net net,
                  Sched s) {
  extern __shared__ float sm[];
  const int C = s.C, R = TP * C, ld = net.ld;
  float* cur = sm;
  float* nxt = sm + R * ld;
  float* Bs = sm + 2 * R * ld;
  const int p0 = blockIdx.x * TP;

  layer0_fwd(X, prm, N, p0, TP, net, s, cur);
  for (int l = 0; l < net.L; ++l) {
    if (l > 0) {
      mm_smem(cur, ld, R, net.w_in[l], prm + net.offW[l], net.w_out[l], 1,
              net.w_out[l], prm + net.offb[l], C, nxt, ld, Bs);
      float* t = cur; cur = nxt; nxt = t;
    }
    if (l < net.L - 1) act_fwd(cur, ld, TP, net.w_out[l], s);
  }
  const int n_out = net.n_out;
  for (int e = threadIdx.x; e < R * n_out; e += NTHREADS) {
    int r = e / n_out, o = e % n_out, p = r / C, c = r % C, gp = p0 + p;
    if (gp < N) table[((size_t)c * N + gp) * n_out + o] = cur[r * ld + o];
  }
}

// K2: each block owns partial slot blockIdx.x and a workspace slice, and
// walks tiles blockIdx.x, blockIdx.x + gridDim.x, ...
__global__ void __launch_bounds__(NTHREADS)
taylor_bwd_kernel(const float* __restrict__ X, const float* __restrict__ prm,
                  const float* __restrict__ gtab, float* __restrict__ dX,
                  float* __restrict__ part, float* __restrict__ ws, int N,
                  int TP, int n_tiles, Net net, Sched s) {
  extern __shared__ float sm[];
  const int C = s.C, R = TP * C, ld = net.ld, L = net.L, n_out = net.n_out;
  float* buf0 = sm;
  float* buf1 = sm + R * ld;
  float* buf2 = sm + 2 * R * ld;
  float* Bs = sm + 3 * R * ld;
  float* mypart = part + (size_t)blockIdx.x * net.P_total;
  float* myws = ws + (size_t)blockIdx.x * (L - 1) * R * ld;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const bool first = (tile == blockIdx.x);
    const int p0 = tile * TP;
    float* cur = stage_forward(X, prm, N, p0, TP, net, s, myws, buf0, buf1,
                               Bs);
    float* oth = (cur == buf0) ? buf1 : buf0;
    // head: the table cotangents are its pre-activation cotangents
    float* dP = buf2;
    for (int e = threadIdx.x; e < R * n_out; e += NTHREADS) {
      int r = e / n_out, o = e % n_out, p = r / C, c = r % C, gp = p0 + p;
      dP[r * ld + o] = (gp < N) ? gtab[((size_t)c * N + gp) * n_out + o] : 0.f;
    }
    __syncthreads();
    reverse_sweep(X, prm, dX, false, mypart, myws, N, p0, TP, first, net, s,
                  cur, oth, dP, Bs);
  }
}

// ------------------------------------------------------------------------
// C interface (loaded with ctypes; the descriptor layouts are in
// taylor_common.cuh).  Each entry point returns cudaGetLastError().

extern "C" int tdq_limits(int* out) {
  out[0] = MAXL;
  out[1] = MAXC;
  out[2] = KT * BS_LD * (int)sizeof(float);
  return 0;
}

extern "C" int tdq_device_info(int device, int* out) {
  cudaError_t e = cudaDeviceGetAttribute(
      &out[0], cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceGetAttribute(&out[1], cudaDevAttrMultiProcessorCount,
                                     device);
}

extern "C" int tdq_taylor_fwd(const float* X, const float* prm, float* table,
                              int N, int TP, const int* net_h,
                              const int* sched_h, void* stream) {
  const Net net = unpack_net(net_h);
  const Sched s = unpack_sched(sched_h);
  const size_t smem = smem_bytes(2, TP * s.C, net.ld);
  cudaError_t e = cudaFuncSetAttribute(
      taylor_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = (N + TP - 1) / TP;
  taylor_fwd_kernel<<<n_tiles, NTHREADS, smem, (cudaStream_t)stream>>>(
      X, prm, table, N, TP, net, s);
  return (int)cudaGetLastError();
}

extern "C" int tdq_taylor_bwd(const float* X, const float* prm,
                              const float* gtab, float* dX, float* part,
                              float* ws, float* grad, int N, int TP, int G,
                              const int* net_h, const int* sched_h,
                              void* stream) {
  const Net net = unpack_net(net_h);
  const Sched s = unpack_sched(sched_h);
  const size_t smem = smem_bytes(3, TP * s.C, net.ld);
  cudaError_t e = cudaFuncSetAttribute(
      taylor_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = (N + TP - 1) / TP;
  cudaStream_t st = (cudaStream_t)stream;
  taylor_bwd_kernel<<<G, NTHREADS, smem, st>>>(X, prm, gtab, dX, part, ws, N,
                                               TP, n_tiles, net, s);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_partials<<<(net.P_total + 255) / 256, 256, 0, st>>>(
      part, grad, G, net.P_total);
  return (int)cudaGetLastError();
}
