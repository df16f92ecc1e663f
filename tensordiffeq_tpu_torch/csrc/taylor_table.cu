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
// B/point out.  So both kernels are bound by operations, not bytes, and
// nearly all of them are the hidden layers' 128-wide products.  The design
// follows from that:
//   * the hidden-layer products run on the tensor cores as 3xTF32
//     (mma.sync.m16n8k8: each operand split into a TF32 high part and the
//     rest, three products per k8 step summed in f32): at worst about
//     2^-20 relative error per product, the counterpart of the JAX
//     package's precision=HIGHEST, at a bound of 3 x products / 495
//     TFLOP/s instead of products / 67 TFLOP/s on the CUDA cores
//     (taylor_common.cuh: mma_steps, mma_w, mma_dw).  What bounds them now
//     is the instruction stream around each mma.sync (the split and the
//     f32 sums, about five instructions per mma) and its latency at eight
//     warps per SM: about 11 cycles per mma per SM sub-partition, against
//     6.8 for independent mma.sync (scripts/torch_mma_bench.cu).
//   * the whole wavefront of a point tile (TP points x C channels x width)
//     stays in shared memory across all layers, so device memory sees only
//     X in and the table out (K1) — the Pallas kernel's VMEM residency.
//     Fragments load straight from it: the row stride ld = 8 (mod 32)
//     words and the k order of each k8 step keep every fragment load free
//     of bank conflicts.
//   * each product's weights (a 128 x 128 layer, 64 KB; ~200 KB in all,
//     L2-resident) come into one shared-memory stage by cp.async, issued
//     before the activation pass that precedes the product, so the warps
//     find them there: no copy waits inside a product and two barriers.
//     A layer wider than 128 streams in 128-row chunks, each loaded and
//     waited for.  A two-slot ring of 64-row chunks (the next in flight
//     while one is in the MMAs, one barrier per chunk) ran 2-4 % slower on
//     the AC net, whose fills land before their products start; what it
//     would buy a wider net is in PERF.md.
//   * narrow products (the head's n_out columns, at most NARROW_N) and
//     layer 0 (d inputs) stay SIMT loops, one thread per output, their
//     weights (and layer 0's rows of X) first copied into the free stage.
//   * the pointwise tanh chain runs in place in shared memory, channels in
//     descending order (a channel only reads lower-order channels and the
//     primal, so in-place is safe), four items per thread at a time.
// This K1 is the route for the shapes the persistent wgmma route
// (taylor_fwd_wg.cuh) does not take: a hidden layer wider than 128, more
// than 8 channels, more than 16 inputs or outputs.  It keeps one block per
// tile and a non-persistent grid.  The device code is in
// taylor_common.cuh, which the fused minimax step (minimax_step.cu, K3)
// shares.
//
// The bf16-operand flavor (template parameter BF = true; the Pallas pair
// under compute_dtype=bfloat16) rounds every product's operands to bf16 as
// taylor_common.cuh says, and dX and dW leave rounded to bf16.  It is
// built for the bf16 tensor cores: the stack is rounded once as act_fwd
// writes it, into a bf16 plane (and K2's workspace keeps the layer inputs
// as bf16), W as it lands in a bf16 stage of 32 KB, and K2's f32
// cotangent is cut once per layer into three bf16 pieces that carry all
// its 24 bits; fragments come by ldmatrix (.trans for dW's and the
// forward's transposed operands) into mma.m16n8k16 bf16, one pass per
// forward product and three per dW or dH, at most the passes the card's
// fastest route for the types takes.  The halved stage and bf16 planes
// give K2 tiles of 128 rows (five slots of 128 x ld bf16) where the f32
// flavor fits 96, so a block updates its partial slot a quarter less
// often, and past its first tile it adds a layer's dW into the slot by
// bulk reduce-adds from shared memory (bmma_dw), not by reading the slot
// into the SMs (PERF.md has the times and the split by phase).
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
//   * The reverse sweep needs every hidden layer's pre-activation channels
//     and every layer's input.  K2 recomputes the tile's forward once and
//     stages both in a global workspace slice private to the block (2L-3
//     slices of TP*C rows x ld: ws_slices), reused for each tile the block
//     takes, where recomputing per layer would cost O(L^2) matmuls.
//     act_fwd writes them as it reads and computes them (no extra pass,
//     streaming stores); the reverse sweep reads each slice back once with
//     one bulk copy (cp.async.bulk, one thread, an mbarrier) behind other
//     work.  The weight stage leaves room for three wavefront buffers of 96
//     rows (24 points at C = 4), so on the AC net the workspace is 48.3 MB
//     for 132 blocks and K2's partial slots 26.4 MB: 75 MB against the 50
//     MB L2.  The slots' read-modify-write per tile then reaches HBM: dW
//     takes about twice its time in the product bench (PERF.md).
//   * The bias enters only the primal channel, so db sums the primal
//     channel's cotangents; first-order seeds are constant one-hots, so dX
//     flows only through the primal channel of layer 0: dX = dP0 @ W0^T.
//   * The ragged tail is masked in the kernel: rows past N read X = 0 and
//     g = 0, so they contribute exactly zero to dW/db and are never written.

#include "taylor_common.cuh"

// ------------------------------------------------------------------------
// The head's channels of a tile's rows (buf, R x ld) into table[C][N][n_out]
// (the bf16 flavor's K1; the f32 one writes them inline).
static __device__ void table_rows(const float* buf, float* __restrict__ table,
                                  int N, int p0, int R, int C, int ld,
                                  int n_out) {
  for (int e = threadIdx.x; e < R * n_out; e += NTHREADS) {
    int r = e / n_out, o = e % n_out, p = r / C, c = r % C, gp = p0 + p;
    if (gp < N) table[((size_t)c * N + gp) * n_out + o] = buf[r * ld + o];
  }
}

// K1: one block per tile of TP points, in flavor FL (taylor_common.cuh:
// FL_F32, FL_BF16 or FL_TF32).
template <int FL>
__global__ void __launch_bounds__(NTHREADS)
taylor_fwd_kernel(const float* __restrict__ X, const float* __restrict__ prm,
                  float* __restrict__ table, int N, int TP, Net net,
                  Sched s) {
  extern __shared__ __align__(16) float sm[];
  const int C = s.C, R = TP * C, ld = net.ld;
  if constexpr (FL == FL_BF16) {
    // F (f32, slots 0-1) and the bf16 stack Hb (slot 2)
    const int Rp = pad16(R), p0 = blockIdx.x * TP;
    float* F = sm;
    bf16* Hb = slot_of(sm, 2, Rp, ld);
    bf16* wst = stage_of_bf(sm, 3, R, ld);
    zero_buffers(sm, 3 * Rp * ld / 2);
    layer0_fwd<true>(X, prm, N, p0, TP, net, s, F,
                     reinterpret_cast<float*>(wst));
    for (int l = 1; l < net.L; ++l) {
      act_fwd<true>(F, ld, TP, net.w_out[l - 1], s, nullptr, nullptr, Hb);
      bproduct_fwd<false>(Hb, ld, R, net.w_in[l], prm + net.offW[l], nullptr,
                          net.w_out[l], prm + net.offb[l], C, F, wst, false);
    }
    table_rows(F, table, N, p0, R, C, ld, net.n_out);
    return;
  }
  float* cur = sm;
  float* nxt = sm + pad16(R) * ld;
  float* wst = stage_of(sm, 2, R, ld);
  const int p0 = blockIdx.x * TP;

  zero_buffers(sm, 2 * pad16(R) * ld);
  layer0_fwd<FL>(X, prm, N, p0, TP, net, s, cur, wst);
  for (int l = 1; l < net.L; ++l) {
    const bool issued = prefetch_fwd(prm + net.offW[l], net.w_in[l],
                                     net.w_out[l], wst);
    act_fwd(cur, ld, TP, net.w_out[l - 1], s, nullptr, nullptr);
    product_fwd<FL>(cur, ld, R, net.w_in[l], prm + net.offW[l],
                net.w_out[l], prm + net.offb[l], C, nxt, wst, issued);
    float* t = cur; cur = nxt; nxt = t;
  }
  const int n_out = net.n_out;
  for (int e = threadIdx.x; e < R * n_out; e += NTHREADS) {
    int r = e / n_out, o = e % n_out, p = r / C, c = r % C, gp = p0 + p;
    if (gp < N) table[((size_t)c * N + gp) * n_out + o] = cur[r * ld + o];
  }
}

// K2: each block owns partial slot blockIdx.x and a workspace slice, and
// walks tiles blockIdx.x, blockIdx.x + gridDim.x, ...  FL: the flavor.
template <int FL>
__global__ void __launch_bounds__(NTHREADS)
taylor_bwd_kernel(const float* __restrict__ X, const float* __restrict__ prm,
                  const float* __restrict__ gtab, float* __restrict__ dX,
                  float* __restrict__ part, float* __restrict__ ws, int N,
                  int TP, int n_tiles, Net net, Sched s) {
  extern __shared__ __align__(16) float sm[];
  const int C = s.C, R = TP * C, ld = net.ld, L = net.L, n_out = net.n_out;
  const int Rp = pad16(R);
  if constexpr (FL == FL_BF16) {
    // five bf16 slots (taylor_common.cuh: reverse_sweep_bf)
    float* mypart = part + (size_t)blockIdx.x * slot_stride(net.P_total);
    bf16* wst = stage_of_bf(sm, 5, R, ld);
    uint64_t* mbar = mbar_of_bf(wst);
    float* myws = ws + (size_t)blockIdx.x * ws_floats_bf(L, R, ld);
    // the weights' bf16 copy, after every block's slice (round_weights)
    const bf16* wbf = reinterpret_cast<const bf16*>(
        ws + (size_t)gridDim.x * ws_floats_bf(L, R, ld));
    zero_buffers(sm, 5 * Rp * ld / 2);
    zero_ws_pads(myws, L, R, ld);
    mbar_init(mbar);
    unsigned phase = 0;
    float* F = sm;
    float* dP = reinterpret_cast<float*>(slot_of(sm, 3, Rp, ld));
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const bool first = (tile == blockIdx.x);
      const int p0 = tile * TP;
      stage_forward_bf(X, prm, wbf, N, p0, TP, net, s, myws, F,
                       slot_of(sm, 2, Rp, ld), wst);
      ws_load(F, ws_P(myws, L - 2, R, ld), R, ld, mbar);
      for (int e = threadIdx.x; e < R * n_out; e += NTHREADS) {
        int r = e / n_out, o = e % n_out, p = r / C, c = r % C, gp = p0 + p;
        dP[r * ld + o] =
            (gp < N) ? gtab[((size_t)c * N + gp) * n_out + o] : 0.f;
      }
      __syncthreads();
      reverse_sweep_bf(X, prm, wbf, dX, false, mypart, myws, N, p0, TP, first,
                       net, s, sm, wst, mbar, phase);
    }
    bulk_wait();  // dW's last bulk adds are in the slot
    return;
  }
  float* buf0 = sm;
  float* buf1 = sm + Rp * ld;
  float* buf2 = sm + 2 * Rp * ld;
  float* wst = stage_of(sm, 3, R, ld);
  uint64_t* mbar = mbar_of(wst);
  float* mypart = part + (size_t)blockIdx.x * slot_stride(net.P_total);
  float* myws = ws + (size_t)blockIdx.x * ws_slices(L) * R * ld;

  zero_buffers(sm, 3 * Rp * ld);
  mbar_init(mbar);
  unsigned phase = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const bool first = (tile == blockIdx.x);
    const int p0 = tile * TP;
    float* cur = stage_forward<FL>(X, prm, N, p0, TP, net, s, myws, buf0,
                                   buf1, wst, nullptr);
    float* oth = (cur == buf0) ? buf1 : buf0;
    ws_load(oth, myws + (size_t)(L - 2) * R * ld, R, ld, mbar);
    // head: the table cotangents are its pre-activation cotangents
    float* dP = buf2;
    for (int e = threadIdx.x; e < R * n_out; e += NTHREADS) {
      int r = e / n_out, o = e % n_out, p = r / C, c = r % C, gp = p0 + p;
      dP[r * ld + o] = (gp < N) ? gtab[((size_t)c * N + gp) * n_out + o] : 0.f;
    }
    __syncthreads();
    reverse_sweep<FL>(X, prm, dX, false, mypart, myws, N, p0, TP, first, net,
                      s, cur, oth, dP, wst, mbar, phase);
  }
}

// ------------------------------------------------------------------------
// C interface (loaded with ctypes; the descriptor layouts are in
// taylor_common.cuh).  Each entry point returns cudaGetLastError(); the
// flavor argument is FL_F32 (0), FL_BF16 (1) or FL_TF32 (2), and any other
// value returns cudaErrorInvalidValue.

extern "C" int tdq_limits(int* out) {
  out[0] = MAXL;
  out[1] = MAXC;
  out[2] = STAGE_BYTES;
  out[3] = NARROW_N;
  out[4] = BLK_M;
  out[5] = STAGE_BF_BYTES;
  return 0;
}

// Floats of a K2/K3 launch's workspace for tiles of R rows on G blocks:
// the blocks' slices and, in the bf16 flavor, the weights' bf16 copy after
// them (ops/cuda_taylor.py::workspace_floats allocates it, and checks its
// count against this one before a plan's first launch in a flavor).
extern "C" long long tdq_workspace_floats(const int* net_h, int R, int G,
                                          int flavor) {
  const Net net = unpack_net(net_h);
  if (flavor == FL_BF16)
    return (long long)G * (long long)ws_floats_bf(net.L, R, net.ld) +
           (long long)wbf_floats(net);
  return (long long)G * ws_slices(net.L) * R * net.ld;
}

extern "C" int tdq_device_info(int device, int* out) {
  cudaError_t e = cudaDeviceGetAttribute(
      &out[0], cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceGetAttribute(&out[1], cudaDevAttrMultiProcessorCount,
                                     device);
}

// Whether the SIMT loops' operands fit the weight stage they take as
// scratch, in a flavor's layout; false for an unknown flavor.
static inline bool fits(int flavor, const Net& net, int TP) {
  if (flavor == FL_BF16) return scratch_fits_bf(net, TP);
  if (flavor == FL_F32 || flavor == FL_TF32)
    return layer0_fits(net.d, net.w_out[0], TP);
  return false;
}

template <int FL>
static int taylor_fwd(const float* X, const float* prm, float* table, int N,
                      int TP, const Net& net, const Sched& s,
                      cudaStream_t st) {
  const size_t smem = FL == FL_BF16 ? smem_bytes_bf(3, TP * s.C, net.ld)
                                    : smem_bytes(2, TP * s.C, net.ld);
  cudaError_t e = cudaFuncSetAttribute(
      taylor_fwd_kernel<FL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = (N + TP - 1) / TP;
  taylor_fwd_kernel<FL><<<n_tiles, NTHREADS, smem, st>>>(X, prm, table, N,
                                                         TP, net, s);
  return (int)cudaGetLastError();
}

extern "C" int tdq_taylor_fwd(const float* X, const float* prm, float* table,
                              int N, int TP, const int* net_h,
                              const int* sched_h, int flavor, void* stream) {
  const Net net = unpack_net(net_h);
  const Sched s = unpack_sched(sched_h);
  // the SIMT loops take their operands into the weight stage
  if (!fits(flavor, net, TP)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (flavor == FL_BF16)
    return taylor_fwd<FL_BF16>(X, prm, table, N, TP, net, s, st);
  if (flavor == FL_TF32)
    return taylor_fwd<FL_TF32>(X, prm, table, N, TP, net, s, st);
  return taylor_fwd<FL_F32>(X, prm, table, N, TP, net, s, st);
}

template <int FL>
static int taylor_bwd(const float* X, const float* prm, const float* gtab,
                      float* dX, float* part, float* ws, float* grad, int N,
                      int TP, int G, const Net& net, const Sched& s,
                      cudaStream_t st) {
  constexpr bool BF = FL == FL_BF16;
  const size_t smem = BF ? smem_bytes_bf(5, TP * s.C, net.ld)
                         : smem_bytes(3, TP * s.C, net.ld);
  cudaError_t e = cudaFuncSetAttribute(
      taylor_bwd_kernel<FL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = (N + TP - 1) / TP;
  if (BF) {  // the weights' bf16 copy, after the blocks' workspace slices
    round_weights<<<64, 256, 0, st>>>(
        prm, reinterpret_cast<bf16*>(
                 ws + (size_t)G * ws_floats_bf(net.L, TP * s.C, net.ld)),
        net);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  taylor_bwd_kernel<FL><<<G, NTHREADS, smem, st>>>(X, prm, gtab, dX, part, ws,
                                                   N, TP, n_tiles, net, s);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_partials<BF><<<(net.P_total + 255) / 256, 256, 0, st>>>(
      part, grad, G, net.P_total, net);
  return (int)cudaGetLastError();
}

extern "C" int tdq_taylor_bwd(const float* X, const float* prm,
                              const float* gtab, float* dX, float* part,
                              float* ws, float* grad, int N, int TP, int G,
                              const int* net_h, const int* sched_h,
                              int flavor, void* stream) {
  const Net net = unpack_net(net_h);
  const Sched s = unpack_sched(sched_h);
  // the SIMT loops take their operands into the weight stage
  if (!fits(flavor, net, TP)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (flavor == FL_BF16)
    return taylor_bwd<FL_BF16>(X, prm, gtab, dX, part, ws, grad, N, TP, G,
                               net, s, st);
  if (flavor == FL_TF32)
    return taylor_bwd<FL_TF32>(X, prm, gtab, dX, part, ws, grad, N, TP, G,
                               net, s, st);
  return taylor_bwd<FL_F32>(X, prm, gtab, dX, part, ws, grad, N, TP, G, net,
                            s, st);
}
