// The fused minimax step (K3): one pass per point tile from the collocation
// points to the SA-lambda-weighted residual loss and every cotangent.
//
// Replaces the JAX package's Pallas kernel in ops/pallas_minimax.py::
// build_minimax_sq_fn (`kernel` :193-231, pallas_call at :259).  For a tanh
// MLP, a residual f_model of E single-column equations and per-point
// weights w[N][E] it computes, in one launch,
//
//   value      = sum_e sum_p w[p][e] * f_e(p)^2
//   dW, db     = d value / d params   (packed W_0, b_0, W_1, ... layout)
//   gw[p][e]   = d value / d w[p][e] = f_e(p)^2   (the SA-lambda ascent)
//   gX[p][k]   = d value / d X[p][k], summed over the equations
//
// and the wrapper's torch.autograd.Function (ops/minimax.py) only scales
// them by the incoming scalar, as the Pallas version's custom_vjp does.
//
// Per tile of TP points, each block runs K2's path with a new middle:
//   1. K2's forward through the hidden layers (stage_forward), staging the
//      pre-activation channels in the block's workspace slice;
//   2. the head's product into the table rows T[TP*C][n_out] in shared
//      memory (K1's last layer);
//   3. the epilogue: per point, interpret the residual tape forward to get
//      f_e, add w_e*f_e^2 into the block's value, write gw = f_e^2, and run
//      the tape in reverse from the seeds 2*w_e*f_e, which leaves the table
//      cotangents in place of T and the coordinates' direct adjoints in gX;
//   4. K2's reverse sweep unchanged from those table cotangents, which adds
//      the network's share of gX and accumulates dW/db.
// So the table never leaves shared memory: device memory sees X, w and the
// parameters in, and the value, parameter cotangents, gw and gX out.
//
// The residual tape.  Pallas traced the user's Python f_model into the
// kernel body; a kernel built once cannot.  The host lowers the batched
// f_model once, at compile, to a pointwise op tape (ops/residual_tape.py):
// inputs are table columns (channel c, output o) and coordinates, each op
// writes a new register, constants come from a small pool, and E registers
// are the equations.  One generic epilogue interprets it, as K1/K2 interpret
// the channel schedule: one build serves every f_model.  Registers live in a
// per-thread local array (MAXTIN + MAXTOPS floats, dynamically indexed, so
// in local memory backed by L1); the epilogue is a few dozen operations per
// point against the ~1 MFLOP per point of the matmuls, so that is not what
// bounds the kernel.
//
// What bounds it on the H100: operations, as for K2 (it is K2's work plus
// the head's product and the tape), nearly all of them the nine 128-wide
// hidden-layer products of a tile (three forward, three dW, three dH on
// the AC net).  They run on the tensor cores as 3xTF32 (taylor_common.cuh:
// at worst about 2^-20 relative error per product, the counterpart of
// precision=HIGHEST), so the bound is 3 x products / 495 TFLOP/s; each
// product's weights are staged in shared memory ahead of it, the staged
// layers come back by bulk copies behind other work.  taylor_table.cu's K2
// note has what holds the products back (mma.sync's instruction stream
// and latency at eight warps per SM) and the workspace's L2 footprint; K3's
// partial slots are 132 x 50,052 floats = 26.4 MB, so with the 48.3 MB
// workspace 75 MB meet the 50 MB L2 and dW's slot updates reach HBM.  The
// narrow head, layer 0 and the tape epilogue stay SIMT; the epilogue runs
// one thread per point.  wgmma with TMA, the tensor cores' full rate, is
// later work.
//
// The bf16-operand flavor (BF = true; the Pallas kernel under
// compute_dtype=bfloat16) rounds every product's operands to bf16 as
// taylor_common.cuh says, the epilogue staying f32, and the network's share
// of gX and dW rounded to bf16 (the tape's direct adjoints of X are not).
// Its products run on the bf16 tensor cores as K2-bf16's do (taylor_table.cu
// has the design): the head writes the table rows into slots 3-4, the
// epilogue turns them into cotangents there, and reverse_sweep_bf goes on
// from them.
//
// Differences from the Pallas kernel:
//   * Pallas accumulated the value and dW/db over a sequential grid
//     (pl.when(i == 0) then +=).  Here each block owns one partial slot of
//     P_total + 1 values (dW/db, then the value), walks its tiles in a fixed
//     order, and reduce_partials sums the slots in slot order: no atomics,
//     bit-identical run to run.  The block's value is a fixed-order tree sum.
//   * Rows past N.  Pallas padded by replicating X[0] at weight 0, because
//     an all-zero pad row evaluates the f_model at the origin, where a 1/x
//     residual is NaN and 0*NaN poisons the sums.  Here the epilogue is
//     predicated: a row past N runs no tape, adds nothing to the value and
//     writes zero table cotangents (a select, not a multiply), so nothing
//     of it reaches the sums.

#include "taylor_common.cuh"

#define MAXTIN 48     // tape inputs (table columns and coordinates used)
#define MAXTOPS 96    // tape ops
#define MAXTCONST 32  // tape constants
#define MAXEQ 8       // residual equations
#define MAXTREG (MAXTIN + MAXTOPS)

// the epilogue's block sum of the value uses the weight stage as scratch
static_assert(STAGE_F >= NTHREADS && STAGE_BF_F >= NTHREADS,
              "the stage holds one float per thread");

// op codes (ops/residual_tape.py: OPS)
#define OP_CONST 0  // r = cst[a]
#define OP_ADD 1
#define OP_SUB 2
#define OP_MUL 3
#define OP_DIV 4
#define OP_NEG 5
#define OP_POW 6    // r = r[a] ** cst[b]
#define OP_SIN 7
#define OP_COS 8
#define OP_EXP 9
#define OP_TANH 10
#define OP_LOG 11
#define OP_SQRT 12
#define OP_RECIP 13

struct Tape {
  int n_in, n_ops, n_eq;
  // input i: table column c*n_out + o for src < C*n_out, else coordinate
  // src - C*n_out
  int src[MAXTIN];
  int op[MAXTOPS][3];  // (code, a, b); op k writes register n_in + k
  int out[MAXEQ];      // the register of each equation
  float cst[MAXTCONST];
};

static __device__ __forceinline__ float pow_c(float a, float c) {
  if (c == 2.f) return a * a;
  if (c == 3.f) return a * a * a;
  return powf(a, c);
}

// The epilogue of one tile: T holds the table rows [TP*C][ld] (columns <
// n_out) and is overwritten with their cotangents; gX rows of real points
// get the coordinates' direct adjoints; the block's value partial (vslot)
// is assigned on its first tile, else added to.  red: NTHREADS floats of
// scratch.
static __device__ void epilogue(float* T, int ld, const float* __restrict__ X,
                                const float* __restrict__ w,
                                float* __restrict__ gw,
                                float* __restrict__ gX, int N, int p0, int TP,
                                int C, int n_out, int d, const Tape& tp,
                                float* red, float* vslot, bool first) {
  const int n_tab = C * n_out, E = tp.n_eq;
  float vsum = 0.f;
  for (int p = threadIdx.x; p < TP; p += NTHREADS) {
    const int gp = p0 + p;
    float* rows = T + (p * C) * ld;  // channel c, output o at rows[c*ld + o]
    if (gp >= N) {
      // a row past N: no tape, zero cotangents (never evaluated, so a
      // residual singular where these rows sit cannot reach the sums)
      for (int c = 0; c < C; ++c)
        for (int o = 0; o < n_out; ++o) rows[c * ld + o] = 0.f;
      continue;
    }
    float r[MAXTREG], g[MAXTREG];
    for (int i = 0; i < tp.n_in; ++i) {
      const int s = tp.src[i];
      r[i] = (s < n_tab) ? rows[(s / n_out) * ld + s % n_out]
                         : X[(size_t)gp * d + (s - n_tab)];
    }
    for (int k = 0; k < tp.n_ops; ++k) {
      const int a = tp.op[k][1], b = tp.op[k][2];
      float v;
      switch (tp.op[k][0]) {
        case OP_CONST: v = tp.cst[a]; break;
        case OP_ADD: v = r[a] + r[b]; break;
        case OP_SUB: v = r[a] - r[b]; break;
        case OP_MUL: v = r[a] * r[b]; break;
        case OP_DIV: v = r[a] / r[b]; break;
        case OP_NEG: v = -r[a]; break;
        case OP_POW: v = pow_c(r[a], tp.cst[b]); break;
        case OP_SIN: v = sinf(r[a]); break;
        case OP_COS: v = cosf(r[a]); break;
        case OP_EXP: v = expf(r[a]); break;
        case OP_TANH: v = tanhf(r[a]); break;
        case OP_LOG: v = logf(r[a]); break;
        case OP_SQRT: v = sqrtf(r[a]); break;
        default: v = 1.f / r[a]; break;  // OP_RECIP
      }
      r[tp.n_in + k] = v;
    }
    const int n_reg = tp.n_in + tp.n_ops;
    for (int i = 0; i < n_reg; ++i) g[i] = 0.f;
    float val = 0.f;
    for (int e = 0; e < E; ++e) {
      const float f = r[tp.out[e]], we = w[(size_t)gp * E + e];
      const float f2 = f * f;
      gw[(size_t)gp * E + e] = f2;
      val = fmaf(we, f2, val);
      g[tp.out[e]] += 2.f * we * f;
    }
    vsum += val;
    for (int k = tp.n_ops - 1; k >= 0; --k) {
      const int a = tp.op[k][1], b = tp.op[k][2], o = tp.n_in + k;
      const float go = g[o];
      switch (tp.op[k][0]) {
        case OP_CONST: break;
        case OP_ADD: g[a] += go; g[b] += go; break;
        case OP_SUB: g[a] += go; g[b] -= go; break;
        case OP_MUL: {
          const float ra = r[a], rb = r[b];
          g[a] += go * rb;
          g[b] += go * ra;
          break;
        }
        case OP_DIV: {
          const float rb = r[b];
          g[a] += go / rb;
          g[b] -= go * r[o] / rb;
          break;
        }
        case OP_NEG: g[a] -= go; break;
        case OP_POW: {
          const float c = tp.cst[b];
          if (c != 0.f) g[a] += go * c * pow_c(r[a], c - 1.f);
          break;
        }
        case OP_SIN: g[a] += go * cosf(r[a]); break;
        case OP_COS: g[a] -= go * sinf(r[a]); break;
        case OP_EXP: g[a] += go * r[o]; break;
        case OP_TANH: g[a] += go * (1.f - r[o] * r[o]); break;
        case OP_LOG: g[a] += go / r[a]; break;
        case OP_SQRT: g[a] += go * 0.5f / r[o]; break;
        default: g[a] -= go * r[o] * r[o]; break;  // OP_RECIP
      }
    }
    for (int c = 0; c < C; ++c)
      for (int o = 0; o < n_out; ++o) rows[c * ld + o] = 0.f;
    for (int k = 0; k < d; ++k) gX[(size_t)gp * d + k] = 0.f;
    for (int i = 0; i < tp.n_in; ++i) {
      const int s = tp.src[i];
      if (s < n_tab) rows[(s / n_out) * ld + s % n_out] += g[i];
      else gX[(size_t)gp * d + (s - n_tab)] += g[i];
    }
  }
  red[threadIdx.x] = vsum;
  __syncthreads();
  for (int h = NTHREADS / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) *vslot = first ? red[0] : *vslot + red[0];
  __syncthreads();
}

// K3: each block owns partial slot blockIdx.x (P_total + 1 values) and a
// workspace slice, and walks tiles blockIdx.x, blockIdx.x + gridDim.x, ...
// FL: the flavor (taylor_common.cuh: FL_F32, FL_BF16 or FL_TF32); the
// epilogue is f32 in all three.
template <int FL>
__global__ void __launch_bounds__(NTHREADS)
minimax_step_kernel(const float* __restrict__ X, const float* __restrict__ w,
                    const float* __restrict__ prm, float* __restrict__ gw,
                    float* __restrict__ gX, float* __restrict__ part,
                    float* __restrict__ ws, int N, int TP, int n_tiles,
                    Net net, Sched s, Tape tp) {
  extern __shared__ __align__(16) float sm[];
  const int C = s.C, R = TP * C, ld = net.ld, L = net.L, lh = net.L - 1;
  const int Rp = pad16(R);
  if constexpr (FL == FL_BF16) {
    // five bf16 slots (taylor_common.cuh: reverse_sweep_bf)
    float* mypart = part + (size_t)blockIdx.x * slot_stride(net.P_total + 1);
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
    bf16* Hb = slot_of(sm, 2, Rp, ld);
    float* T = reinterpret_cast<float*>(slot_of(sm, 3, Rp, ld));
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const bool first = (tile == blockIdx.x);
      const int p0 = tile * TP;
      stage_forward_bf(X, prm, wbf, N, p0, TP, net, s, myws, F, Hb, wst);
      // the reverse sweep's first staged layer, behind the head and epilogue
      ws_load(F, ws_P(myws, L - 2, R, ld), R, ld, mbar);
      bproduct_fwd<true>(Hb, ld, R, net.w_in[lh], prm + net.offW[lh],
                   wbf + wbf_offset(net, lh), net.n_out, prm + net.offb[lh], C,
                   T, wst, false);
      epilogue(T, ld, X, w, gw, gX, N, p0, TP, C, net.n_out, net.d, tp,
               reinterpret_cast<float*>(wst), mypart + net.P_total, first);
      reverse_sweep_bf(X, prm, wbf, gX, true, mypart, myws, N, p0, TP, first,
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
  float* mypart = part + (size_t)blockIdx.x * slot_stride(net.P_total + 1);
  float* myws = ws + (size_t)blockIdx.x * ws_slices(L) * R * ld;

  zero_buffers(sm, 3 * Rp * ld);
  mbar_init(mbar);
  unsigned phase = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const bool first = (tile == blockIdx.x);
    const int p0 = tile * TP;
    bool head_issued = false;
    float* cur = stage_forward<FL>(X, prm, N, p0, TP, net, s, myws, buf0,
                                   buf1, wst, &head_issued);
    float* oth = (cur == buf0) ? buf1 : buf0;
    // the reverse sweep's first staged layer, behind the head and epilogue
    ws_load(oth, myws + (size_t)(L - 2) * R * ld, R, ld, mbar);
    // the head's channels: the table rows of this tile
    float* T = buf2;
    product_fwd<FL>(cur, ld, R, net.w_in[lh], prm + net.offW[lh], net.n_out,
                prm + net.offb[lh], C, T, wst, head_issued);
    epilogue(T, ld, X, w, gw, gX, N, p0, TP, C, net.n_out, net.d, tp, wst,
             mypart + net.P_total, first);
    reverse_sweep<FL>(X, prm, gX, true, mypart, myws, N, p0, TP, first, net,
                      s, cur, oth, T, wst, mbar, phase);
  }
}

// ------------------------------------------------------------------------
// C interface.  tape_h: [n_in, n_ops, n_eq, src[MAXTIN], op[MAXTOPS*3],
// out[MAXEQ]];  cst_h: [MAXTCONST] floats.  out: P_total + 1 floats (the
// parameter cotangents, then the value).  flavor: FL_F32 (0), FL_BF16 (1)
// or FL_TF32 (2); any other value returns cudaErrorInvalidValue.

static Tape unpack_tape(const int* h, const float* cst) {
  Tape t;
  t.n_in = h[0]; t.n_ops = h[1]; t.n_eq = h[2];
  for (int i = 0; i < MAXTIN; ++i) t.src[i] = h[3 + i];
  for (int k = 0; k < MAXTOPS; ++k)
    for (int j = 0; j < 3; ++j) t.op[k][j] = h[3 + MAXTIN + 3 * k + j];
  for (int e = 0; e < MAXEQ; ++e) t.out[e] = h[3 + MAXTIN + 3 * MAXTOPS + e];
  for (int i = 0; i < MAXTCONST; ++i) t.cst[i] = cst[i];
  return t;
}

extern "C" int tdq_minimax_limits(int* out) {
  out[0] = MAXTIN;
  out[1] = MAXTOPS;
  out[2] = MAXTCONST;
  out[3] = MAXEQ;
  return 0;
}

template <int FL>
static int minimax_step(const float* X, const float* w, const float* prm,
                        float* gw, float* gX, float* part, float* ws,
                        float* out, int N, int TP, int G, const Net& net,
                        const Sched& s, const Tape& tp, cudaStream_t st) {
  constexpr bool BF = FL == FL_BF16;
  const size_t smem = BF ? smem_bytes_bf(5, TP * s.C, net.ld)
                         : smem_bytes(3, TP * s.C, net.ld);
  cudaError_t e = cudaFuncSetAttribute(
      minimax_step_kernel<FL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  minimax_step_kernel<FL><<<G, NTHREADS, smem, st>>>(
      X, w, prm, gw, gX, part, ws, N, TP, n_tiles, net, s, tp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int P = net.P_total + 1;
  reduce_partials<BF><<<(P + 255) / 256, 256, 0, st>>>(part, out, G, P, net);
  return (int)cudaGetLastError();
}

extern "C" int tdq_minimax_step(const float* X, const float* w,
                                const float* prm, float* gw, float* gX,
                                float* part, float* ws, float* out, int N,
                                int TP, int G, const int* net_h,
                                const int* sched_h, const int* tape_h,
                                const float* cst_h, int flavor,
                                void* stream) {
  const Net net = unpack_net(net_h);
  const Sched s = unpack_sched(sched_h);
  // the SIMT loops take their operands into the weight stage
  const bool fits = flavor == FL_BF16
                        ? scratch_fits_bf(net, TP)
                        : (flavor == FL_F32 || flavor == FL_TF32) &&
                              layer0_fits(net.d, net.w_out[0], TP);
  if (!fits) return (int)cudaErrorInvalidValue;
  const Tape tp = unpack_tape(tape_h, cst_h);
  cudaStream_t st = (cudaStream_t)stream;
  if (flavor == FL_BF16)
    return minimax_step<FL_BF16>(X, w, prm, gw, gX, part, ws, out, N, TP, G,
                                 net, s, tp, st);
  if (flavor == FL_TF32)
    return minimax_step<FL_TF32>(X, w, prm, gw, gX, part, ws, out, N, TP, G,
                                 net, s, tp, st);
  return minimax_step<FL_F32>(X, w, prm, gw, gX, part, ws, out, N, TP, G,
                              net, s, tp, st);
}
