// Device code shared by the Taylor-table kernels (taylor_table.cu: K1, K2)
// and the fused minimax step (minimax_step.cu: K3): the packed network and
// channel-schedule descriptors, the channel products on the tensor cores
// (3xTF32 mma.sync, the weights staged by cp.async ahead of use; the bf16
// flavor's on bf16 fragments) and the SIMT loops kept for narrow shapes,
// the tanh chain with its Faa di Bruno lines and their transpose, K2's
// staged forward and reverse sweep with its bulk-copy workspace reads, and
// the slot-ordered partial reduction.
//
// Everything here has internal linkage (static), so each translation unit
// of the one shared library carries its own copy and nothing collides at
// link time.
//
// Three flavors, a template parameter FL of the kernels and of the routines
// that depend on it (FL_F32, FL_BF16, FL_TF32 below).  FL_F32 is the
// float32 flavor above (3xTF32 products, the counterpart of precision
// HIGHEST and HIGH, and the nearest to a TPU's bf16x3).  FL_TF32 is the
// single-pass flavor of precision DEFAULT, what XLA gives an f32 DEFAULT
// product on a GPU: every product (the forward's, dH's and dW's, on the
// tensor cores and in the SIMT loops alike) takes both operands rounded
// to TF32 as cvt.rna.tf32.f32 rounds them (split_tf32's hi part) in one
// pass, with f32 sums; its buffers, stage and sweeps are the float32
// flavor's, and only the product loops differ, at compile time.  FL_BF16
// is the mixed-precision flavor of the JAX package's
// taylor_derivatives(compute_dtype=bfloat16), rounding where its jaxpr
// rounds and nowhere else.  Every layer's product (layer 0 and the head
// included) takes its input channels and W rounded to bf16 (to nearest
// even) and sums in f32; biases, the tanh chain and the Faa di Bruno lines
// stay f32.  The backward products take the f32 cotangent against the
// rounded operand; each layer's input cotangent (dH, and dX at layer 0) is
// rounded to bf16 per element, and each dW once, after reduce_partials'
// slot-ordered sum over all points (db is not rounded).  The bf16 flavor
// keeps its product operands as bf16 in shared memory, each rounded once
// as it is written, and runs its products on the bf16 tensor cores ("The
// bf16 flavor's products" below), with its own buffer layout.
//
// Shared-memory layout of a float32 block: n_buf wavefront buffers of Rp x
// ld floats (Rp = TP*C rounded up to 16 rows for the m16 fragments; the pad
// rows are zeroed once and never written, so they add nothing to a product
// over rows), then the weight stage (STAGE_F floats: a whole 128 x 128
// layer), then one mbarrier for the workspace copies.  ld = 32*ceil(max
// width/32) + 8: every fragment column of a padded width lies inside a
// row, rows stay 16-byte aligned for the copies, and ld = 8 (mod 32) words
// puts a warp's fragment loads on distinct banks (see the tensor-core
// section).  A bf16 block holds slots of Rp x ld bf16 (an f32 array takes
// two), then the bf16 stage (STAGE_BF_BYTES), then the mbarrier.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define MAXL 16          // layers
#define MAXC 16          // channels
#define NTHREADS 256     // 8 warps
#define BLK_M 128        // rows of a product's block tile: 2 warps x 64
#define BLK_N 128        // columns of a block tile: 4 warps x 32
#define WFM 4            // m16 fragments per warp
#define WFN 4            // n8 fragments per warp
#define KT 128           // k rows of the weight stage: a whole 128-wide layer
// stage strides: W by rows (Bs[k][n], the forward product) = 4 (mod 32)
// words, so b0/b1 (k = 2t and 2t+1, n = g) fall on banks 8t + g (+ 4); W by
// columns (Bt[n][k], dH = dP W^T) = 8 (mod 32) words, so each lane's 8-byte
// pair (n = g, k = 2t..2t+1) falls on banks 8g + 2t within a half-warp
#define LDB_ROWS (BLK_N + 4)
#define LDB_COLS (KT + 8)
#define STAGE_F (KT * LDB_ROWS > BLK_N * LDB_COLS ? KT * LDB_ROWS \
                                                  : BLK_N * LDB_COLS)
// the shared memory a block needs besides its wavefront buffers: the
// weight stage and the 16-byte slot of the workspace mbarrier
#define STAGE_BYTES (STAGE_F * 4 + 16)
// The bf16 flavor's weight stage: a KT x BLK_N window of W as W lies (row
// i, column n), rounded to bf16, rows LDS_BF apart (272 bytes = 16 mod 128,
// so the eight row addresses of an ldmatrix phase fall on distinct banks);
// the forward reads it transposed, dH as it lies.  With the mbarrier slot.
#define LDS_BF (BLK_N + 8)
#define STAGE_BF_BYTES (KT * LDS_BF * 2 + 16)
// the floats of scratch the bf16 stage gives the SIMT loops
#define STAGE_BF_F (KT * LDS_BF / 2)
static_assert(KT == BLK_N, "one bf16 stage window serves both products");

typedef __nv_bfloat16 bf16;

// The kernels' flavors (the header note); the C interface's flavor
// argument takes these values.
enum : int { FL_F32 = 0, FL_BF16 = 1, FL_TF32 = 2 };

// products at most this many columns wide (the head's n_out), or this deep
// (the head's dH), stay SIMT loops, one thread per output element: an n8
// fragment would spend nearly all its work on padding
#define NARROW_N 16

struct Net {
  int L, d, n_out, ld, P_total;
  int w_in[MAXL], w_out[MAXL], offW[MAXL], offb[MAXL];
};

struct Sched {
  int C;
  int order[MAXC];
  // order 1: (dir); 2: (i, j) first-channel indices;
  // 3: (i, j, k, ij, ik, jk); 4: (k, kk, kkk)
  int idx[MAXC][6];
};

static __host__ __device__ __forceinline__ int pad16(int r) {
  return (r + 15) & ~15;
}

// ------------------------------------------------------------------------
// Asynchronous copies.  The weight stage is filled by cp.async groups
// (16-byte pieces where W's rows are 16-byte aligned, else 4-byte ones);
// the workspace reads use one bulk copy each (cp.async.bulk), tracked by an
// mbarrier, so they never mix with the stage's groups and one thread issues
// a whole layer.  (Bulk copies for the stage too, one per 512-byte stage
// row on a second mbarrier, were slower per fill on the H100; PERF.md.)

static __device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

static __device__ __forceinline__ void cp_async16(void* dst,
                                                  const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

static __device__ __forceinline__ void cp_async4(float* dst,
                                                 const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

static __device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// bytes from global src to shared dst (both 16-byte aligned, bytes a
// multiple of 16), completing on bar
static __device__ __forceinline__ void bulk_copy(void* dst,
                                                 const void* src,
                                                 unsigned bytes,
                                                 uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// a hint to bring the line holding p into L2
static __device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];\n" :: "l"(p));
}

// the one arrival of bar's phase, which then waits for bytes of copies
static __device__ __forceinline__ void mbar_expect(uint64_t* bar,
                                                   unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// wait until bar's phase of the given parity has completed
static __device__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}

// The workspace mbarrier sits after the weight stage (STAGE_BYTES).
static __device__ __forceinline__ uint64_t* mbar_of(float* wst) {
  return reinterpret_cast<uint64_t*>(wst + STAGE_F);
}

static __device__ __forceinline__ void mbar_init(uint64_t* mbar) {
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_addr(mbar)) : "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
}

// Start copying `bytes` of a staged layer (contiguous in the workspace)
// into dst.  Called by every thread after a barrier that freed dst; thread
// 0 issues.
static __device__ __forceinline__ void ws_load_bytes(
    void* dst, const void* __restrict__ src, unsigned bytes, uint64_t* mbar) {
  if (threadIdx.x == 0) {
    asm volatile("fence.proxy.async;\n" ::: "memory");
    mbar_expect(mbar, bytes);
    bulk_copy(dst, src, bytes, mbar);
  }
}

// Rows [0, R) of a staged f32 layer (R x ld floats).
static __device__ __forceinline__ void ws_load(float* dst,
                                               const float* __restrict__ src,
                                               int R, int ld,
                                               uint64_t* mbar) {
  ws_load_bytes(dst, src, (unsigned)(R * ld * 4), mbar);
}

// Wait for the last ws_load: every thread watches the mbarrier's phase.
static __device__ void ws_wait(uint64_t* mbar, unsigned& phase) {
  mbar_wait(mbar, phase);
  phase ^= 1u;
}

// ------------------------------------------------------------------------
// 3xTF32 on the tensor cores.  Each operand is split as x = hi + lo: hi is
// x rounded to TF32 (to nearest, ties away from zero: what cvt.rna.tf32.f32
// gives a finite x, in two integer operations where ptxas expands cvt.rna
// into four), lo = x - hi exactly, which the tensor core truncates to TF32
// as it reads it (a NaN stays NaN in lo).  Each k8 step takes lo*hi' +
// hi*lo' + hi*hi' into a fresh f32 accumulator whose sum is then added to
// the running one on the CUDA cores (the tensor cores' own accumulation
// truncates, so one accumulator through all 48 passes of a 128-deep
// product would drift toward zero): about 2^-20 relative error per product
// at worst, the counterpart of the JAX package's precision=HIGHEST.
// The TF32 flavor takes the hi*hi pass alone (tf32_bits below).
//
// A block tile is up to 128 x 128: the 8 warps as 2 rows x 4 columns, each
// warp up to WFM m16 by WFN n8 fragments.  mma.m16n8k8.tf32 fragments,
// lane = 4g + t: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4); b0
// (t, g), b1 (t+4, g); c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..2t+1).
//
// A k8 step may take its eight k in any order, as long as A and B take the
// same one.  The products over a row's columns (forward, dH) give the
// fragment slots t and t+4 the k 2t and 2t+1, so each lane's pair is one
// 8-byte load; dW, a sum over the tile's rows, gives them rows t and t+4.
// With ld = 8 (mod 32) words and the stage strides, every fragment load is
// free of bank conflicts.

static __device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                                  unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (split_tf32's hi), as
// the tensor core's operand bits, and as an f32
static __device__ __forceinline__ unsigned tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

static __device__ __forceinline__ float tf32r(float x) {
  return __uint_as_float(tf32_bits(x));
}

// x rounded to bf16 (to nearest even, as XLA's convert_element_type),
// as an f32
static __device__ __forceinline__ float bf16r(float x) {
  return __uint_as_float((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(x))
                         << 16);
}

// x as flavor FL's product operand: rounded to bf16 or to TF32, or as it
// is (a bf16 value is one already)
template <int FL>
static __device__ __forceinline__ float opnd(float x) {
  return FL == FL_BF16 ? bf16r(x) : (FL == FL_TF32 ? tf32r(x) : x);
}

template <int FL>
static __device__ __forceinline__ float opnd(bf16 x) {
  return __bfloat162float(x);
}

// an f32 cotangent as flavor FL's product operand: rounded to TF32 in the
// TF32 flavor, as it is in the others (the bf16 flavor's backward products
// take the f32 cotangent against the rounded operand)
template <int FL>
static __device__ __forceinline__ float gopnd(float x) {
  return FL == FL_TF32 ? tf32r(x) : x;
}

// a value as f32, from f32 or bf16
static __device__ __forceinline__ float tofl(float x) { return x; }
static __device__ __forceinline__ float tofl(bf16 x) {
  return __bfloat162float(x);
}

// d += a*b on the tensor cores (not volatile: the compiler may interleave
// independent products; each accumulator's order is fixed by its data flow)
static __device__ __forceinline__ void mma_tf32(float* d, const unsigned* a,
                                                const unsigned* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a*b: a step's first pass, from zero
static __device__ __forceinline__ void mma_tf32_first(float* d,
                                                      const unsigned* a,
                                                      const unsigned* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));
}

// Where a lane finds its fragment elements in the k8 step at k0: a(mf) the
// four of A fragment mf (rows mf*16 + g and + 8), b(nf) the two of B
// fragment nf (column nf*8 + g).  The pointers are at the lane's element
// of the warp's first fragments.

// A: a wavefront buffer at (row g, column 2t), rows of the product
struct OpRows {
  const float* A;
  int ld;
  __device__ __forceinline__ void a(int mf, int k0, float (&x)[4]) const {
    const float* p = A + mf * 16 * ld + k0;
    const float2 u = *reinterpret_cast<const float2*>(p);
    const float2 v = *reinterpret_cast<const float2*>(p + 8 * ld);
    x[0] = u.x; x[1] = v.x; x[2] = u.y; x[3] = v.y;
  }
};

// the forward H W: B the weight stage by rows (k, n), at (row 2t, column g)
struct OpFwd : OpRows {
  const float* B;
  __device__ OpFwd(const float* A_, int ld_, const float* B_)
      : OpRows{A_, ld_}, B(B_) {}
  __device__ __forceinline__ void b(int nf, int k0, float (&y)[2]) const {
    y[0] = B[k0 * LDB_ROWS + nf * 8];
    y[1] = B[(k0 + 1) * LDB_ROWS + nf * 8];
  }
};

// dH = dP W^T: B the weight stage by columns (n, k), at (row g, column 2t)
struct OpDh : OpRows {
  const float* B;
  __device__ OpDh(const float* A_, int ld_, const float* B_)
      : OpRows{A_, ld_}, B(B_) {}
  __device__ __forceinline__ void b(int nf, int k0, float (&y)[2]) const {
    const float2 u =
        *reinterpret_cast<const float2*>(B + nf * 8 * LDB_COLS + k0);
    y[0] = u.x; y[1] = u.y;
  }
};

// dW = H^T E over the tile's rows: H and E wavefront buffers, both at
// (row t, column g)
struct OpDw {
  const float* A;
  const float* B;
  int ld;
  __device__ __forceinline__ void a(int mf, int k0, float (&x)[4]) const {
    const float* p = A + k0 * ld + mf * 16;
    x[0] = p[0]; x[1] = p[8]; x[2] = p[4 * ld]; x[3] = p[4 * ld + 8];
  }
  __device__ __forceinline__ void b(int nf, int k0, float (&y)[2]) const {
    const float* p = B + k0 * ld + nf * 8;
    y[0] = p[0]; y[1] = p[4 * ld];
  }
};

// The raw fragment elements of k8 step k0: NFM row fragments, WFN column
// fragments (FULL), or nfm and nfn of them (the others read as zero).
template <int NFM, bool FULL, class Op>
static __device__ __forceinline__ void frag_load(const Op& op, int k0,
                                                 int nfm, int nfn,
                                                 float (&x)[NFM][4],
                                                 float (&y)[WFN][2]) {
#pragma unroll
  for (int mf = 0; mf < NFM; ++mf) {
    if (FULL || mf < nfm) {
      op.a(mf, k0, x[mf]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) x[mf][q] = 0.f;
    }
  }
#pragma unroll
  for (int nf = 0; nf < WFN; ++nf) {
    if (FULL || nf < nfn) {
      op.b(nf, k0, y[nf]);
    } else {
      y[nf][0] = 0.f;
      y[nf][1] = 0.f;
    }
  }
}

// acc += the product over `steps` k8 steps of the warp's NFM x WFN
// fragments (FULL), or of its nfm x nfn (a ragged edge: the others load
// zeros and are never stored).  The next step's elements are loaded while
// this step's passes run.  The passes run pass by pass across all the
// warp's fragments: NFM*WFN independent products between dependent ones.
// (Holding two steps' sums, so that a step's sum is added behind the next
// step's passes, is faster alone but spills inside K2/K3's body.)  T1: the
// TF32 flavor's single pass, hi*hi, into the step's fresh accumulator.
template <int NFM, bool FULL, bool T1, class Op>
static __device__ __forceinline__ void mma_steps(float (&acc)[WFM][WFN][4],
                                                 const Op& op, int steps,
                                                 int nfm, int nfn) {
  float x[NFM][4], y[WFN][2];
  frag_load<NFM, FULL>(op, 0, nfm, nfn, x, y);
  if constexpr (T1) {
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
      unsigned ah[NFM][4], bh[WFN][2];
#pragma unroll
      for (int mf = 0; mf < NFM; ++mf)
#pragma unroll
        for (int q = 0; q < 4; ++q) ah[mf][q] = tf32_bits(x[mf][q]);
#pragma unroll
      for (int nf = 0; nf < WFN; ++nf) {
        bh[nf][0] = tf32_bits(y[nf][0]);
        bh[nf][1] = tf32_bits(y[nf][1]);
      }
      if (s + 1 < steps)
        frag_load<NFM, FULL>(op, 8 * (s + 1), nfm, nfn, x, y);
      float st[NFM][WFN][4];
#pragma unroll
      for (int mf = 0; mf < NFM; ++mf)
#pragma unroll
        for (int nf = 0; nf < WFN; ++nf)
          mma_tf32_first(st[mf][nf], ah[mf], bh[nf]);
#pragma unroll
      for (int mf = 0; mf < NFM; ++mf)
#pragma unroll
        for (int nf = 0; nf < WFN; ++nf)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mf][nf][q] += st[mf][nf][q];
    }
    return;
  }
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    unsigned ah[NFM][4], al[NFM][4], bh[WFN][2], bl[WFN][2];
#pragma unroll
    for (int mf = 0; mf < NFM; ++mf)
#pragma unroll
      for (int q = 0; q < 4; ++q) split_tf32(x[mf][q], ah[mf][q], al[mf][q]);
#pragma unroll
    for (int nf = 0; nf < WFN; ++nf) {
      split_tf32(y[nf][0], bh[nf][0], bl[nf][0]);
      split_tf32(y[nf][1], bh[nf][1], bl[nf][1]);
    }
    if (s + 1 < steps) frag_load<NFM, FULL>(op, 8 * (s + 1), nfm, nfn, x, y);
    float st[NFM][WFN][4];
#pragma unroll
    for (int mf = 0; mf < NFM; ++mf)
#pragma unroll
      for (int nf = 0; nf < WFN; ++nf)
        mma_tf32_first(st[mf][nf], al[mf], bh[nf]);
#pragma unroll
    for (int mf = 0; mf < NFM; ++mf)
#pragma unroll
      for (int nf = 0; nf < WFN; ++nf) mma_tf32(st[mf][nf], ah[mf], bl[nf]);
#pragma unroll
    for (int mf = 0; mf < NFM; ++mf)
#pragma unroll
      for (int nf = 0; nf < WFN; ++nf) mma_tf32(st[mf][nf], ah[mf], bh[nf]);
#pragma unroll
    for (int mf = 0; mf < NFM; ++mf)
#pragma unroll
      for (int nf = 0; nf < WFN; ++nf)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mf][nf][q] += st[mf][nf][q];
  }
}

// The warp's fragments as the tile gives them: whole 4 x 4 or 3 x 4 (the
// slice's 128- and 96-row tiles) take a loop with no guards.
template <bool T1 = false, class Op>
static __device__ __forceinline__ void mma_run(float (&acc)[WFM][WFN][4],
                                               const Op& op, int steps,
                                               int nfm, int nfn) {
  if (nfn == WFN && nfm == 4)
    mma_steps<4, true, T1>(acc, op, steps, nfm, nfn);
  else if (nfn == WFN && nfm == 3)
    mma_steps<3, true, T1>(acc, op, steps, nfm, nfn);
  else mma_steps<WFM, false, T1>(acc, op, steps, nfm, nfn);
}

static __device__ __forceinline__ int clamp_frags(int v) {
  return v < 0 ? 0 : (v > WFM ? WFM : v);  // WFM == WFN
}

static __device__ __forceinline__ void zero_acc(float (&acc)[WFM][WFN][4]) {
#pragma unroll
  for (int mf = 0; mf < WFM; ++mf)
#pragma unroll
    for (int nf = 0; nf < WFN; ++nf)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mf][nf][q] = 0.f;
}

// Stage rows k0 .. k0+KT-1 of B(k, n), n0 <= n < n0+BLK_N, into dst, zero
// past K or Nn:  rows (COLS false): B(k, n) = W[k*Nn + n], dst[k][n];
// columns (COLS true): B(k, n) = W[n*K + k], dst[n][k].
template <bool COLS>
static __device__ __forceinline__ void stage_load(const float* __restrict__ W,
                                                 int K, int Nn, int k0,
                                                 int n0, float* dst) {
  const int seg = COLS ? K : Nn;  // length of W's rows
  const bool vec = (seg % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(W) % 16 == 0);
  if (vec) {
    for (int e = threadIdx.x; e < KT * BLK_N / 4; e += NTHREADS) {
      int kk, nn;
      if (COLS) { nn = e / (KT / 4); kk = 4 * (e % (KT / 4)); }
      else { kk = e / (BLK_N / 4); nn = 4 * (e % (BLK_N / 4)); }
      const int k = k0 + kk, n = n0 + nn;
      float* d = COLS ? dst + nn * LDB_COLS + kk : dst + kk * LDB_ROWS + nn;
      if (k < K && n < Nn)
        cp_async16(d, COLS ? W + (size_t)n * K + k : W + (size_t)k * Nn + n);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int e = threadIdx.x; e < KT * BLK_N; e += NTHREADS) {
      int kk, nn;
      if (COLS) { nn = e / KT; kk = e % KT; }
      else { kk = e / BLK_N; nn = e % BLK_N; }
      const int k = k0 + kk, n = n0 + nn;
      float* d = COLS ? dst + nn * LDB_COLS + kk : dst + kk * LDB_ROWS + nn;
      if (k < K && n < Nn)
        cp_async4(d, COLS ? W + (size_t)n * K + k : W + (size_t)k * Nn + n);
      else
        *d = 0.f;
    }
  }
}

// out[r][n] = sum_{k<K} A[r][k] * B(k, n) (+ bias[n] on primal rows r % C
// == 0), r < R, n < Nn, with B(k, n) from W as stage_load<COLS> reads it.
// A and out are wavefront buffers (stride ld).  W comes through the weight
// stage in chunks of KT rows: one chunk for a layer at most 128 wide, which
// the caller issues ahead (issued: chunk 0 of the first column tile is
// already in flight, from before the pass that precedes the product), so
// the warps wait on no copy and pass two barriers.  A wider layer's later
// chunks are each loaded and waited for (a two-slot ring of 64-row chunks,
// one barrier per chunk, ran slower on the 128-wide layers; PERF.md).  A's
// columns K .. pad8(K)-1, which the last k8 step reads against the stage's
// zero rows, are zeroed first, whatever the buffer held there (a staged
// slice's pad, a wider layer's values).  The tile's row fragments split
// between the two warp rows as evenly as they go.  T1: one TF32 pass.
template <bool COLS, bool T1 = false>
static __device__ __forceinline__ void mma_w(float* A, int ld, int R, int K,
                                             const float* __restrict__ W,
                                             int Nn,
                                             const float* __restrict__ bias,
                                             int C, float* out, float* wst,
                                             bool issued) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mtot = pad16(R) / 16, mhalf = (mtot + 1) / 2;
  const int wm0 = (warp & 1) ? mhalf * 16 : 0;
  const int nfm = (warp & 1) ? mtot - mhalf : mhalf;
  const int wn0 = (warp >> 1) * (WFN * 8);
  const int nK = (K + KT - 1) / KT;
  if (K % 8) {  // seen by every warp after the first chunk's barrier
    const int np = 8 - K % 8;
    for (int e = threadIdx.x; e < R * np; e += NTHREADS)
      A[(e / np) * ld + K + e % np] = 0.f;
  }
  for (int n0 = 0; n0 < Nn; n0 += BLK_N) {
    const int nfn = clamp_frags((Nn - n0 - wn0 + 7) / 8);
    float acc[WFM][WFN][4];
    zero_acc(acc);
    for (int c = 0; c < nK; ++c) {
      if (c > 0 || n0 > 0 || !issued) {
        stage_load<COLS>(W, K, Nn, c * KT, n0, wst);
        cp_async_commit();
      }
      cp_async_wait_all();
      __syncthreads();  // the chunk landed for every warp
      const int steps = (min(KT, K - c * KT) + 7) / 8;
      if (nfm > 0 && nfn > 0) {
        const float* Ap = A + (wm0 + g) * ld + c * KT + 2 * t;
        if constexpr (COLS)
          mma_run<T1>(acc,
                      OpDh(Ap, ld, wst + (wn0 + g) * LDB_COLS + 2 * t),
                      steps, nfm, nfn);
        else
          mma_run<T1>(acc,
                      OpFwd(Ap, ld, wst + 2 * t * LDB_ROWS + wn0 + g),
                      steps, nfm, nfn);
      }
      if (c + 1 < nK || n0 + BLK_N < Nn)
        __syncthreads();  // every warp is done with the stage
    }
    // (c0, c1) and (c2, c3) are column pairs of rows g and g + 8: one
    // 8-byte store each
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
          const int n = n0 + wn0 + nf * 8 + 2 * t;
          if (nf >= nfn || n >= Nn) continue;
          float v0 = acc[mf][nf][2 * h], v1 = acc[mf][nf][2 * h + 1];
          if (n + 1 < Nn) {
            if (prim) { v0 += bias[n]; v1 += bias[n + 1]; }
            *reinterpret_cast<float2*>(out + r * ld + n) = make_float2(v0, v1);
          } else {
            if (prim) v0 += bias[n];
            out[r * ld + n] = v0;
          }
        }
      }
    }
  }
  __syncthreads();  // out complete; the stage is free again
}

// The two weight products that go through mma_w (named apart so a
// profile can tell them apart): the forward H W (+ bias), and dH = dP W^T.
template <bool T1 = false>
static __device__ void mma_w_rows(float* A, int ld, int R, int K,
                                  const float* __restrict__ W, int Nn,
                                  const float* __restrict__ bias, int C,
                                  float* out, float* wst, bool issued) {
  mma_w<false, T1>(A, ld, R, K, W, Nn, bias, C, out, wst, issued);
}

template <bool T1 = false>
static __device__ void mma_w_cols(float* dP, int ld, int R, int K,
                                  const float* __restrict__ W, int Ni,
                                  float* out, float* wst, bool issued) {
  mma_w<true, T1>(dP, ld, R, K, W, Ni, nullptr, 1, out, wst, issued);
}

// bmma_dw's slot update, the same code as mma_dw's (which keeps it inline:
// mma_dw calling these, forced inline with or without __restrict__, or a
// macro of the same lines, compiled the f32 K2/K3 to other instructions).
// A hint to bring the slot's old values of a warp's 64 x 32 dW block (rows
// ib.., columns nb..) into L2 while its k steps run (the slots and the
// workspace overflow L2).
static __device__ __forceinline__ void slot_prefetch(const float* part,
                                                     int ib, int nb, int Ni,
                                                     int Nn, int lane) {
  for (int rr = lane; rr < WFM * 16; rr += 32) {
    const int i = ib + rr;
    if (i >= Ni) break;
    const float* row = part + (size_t)i * Nn;
    prefetch_l2(row + nb);
    prefetch_l2(row + min(nb + WFN * 8, Nn) - 1);
  }
}

// A warp's dW block (rows ib.., columns nb.., nfm x nfn fragments) into the
// slot, assigned (first) or added to, an m16 row of fragments at a time:
// its eight old column pairs (c0,c1 and c2,c3) read together before any is
// added (one round trip each; where the block lies whole inside the slot,
// with no guard between the loads), then the sums stored.  pair: the slot's
// rows take 8-byte pairs.
static __device__ __forceinline__ void slot_update(
    const float (&acc)[WFM][WFN][4], float* part, int ib, int nb, int Ni,
    int Nn, int nfm, int nfn, bool pair, bool first, int g, int t) {
  const bool whole = pair && nfm == WFM && nfn == WFN &&
                     ib + WFM * 16 <= Ni && nb + WFN * 8 <= Nn;
#pragma unroll
  for (int mf = 0; mf < WFM; ++mf) {
    if (mf >= nfm) continue;
    float2 old[WFN][2];
#pragma unroll
    for (int nf = 0; nf < WFN; ++nf)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = ib + mf * 16 + g + 8 * h;
        const int n = nb + nf * 8 + 2 * t;
        const float* src = part + (size_t)i * Nn + n;
        old[nf][h] = make_float2(0.f, 0.f);
        if (first) continue;
        if (whole)
          old[nf][h] = *reinterpret_cast<const float2*>(src);
        else if (nf < nfn && i < Ni && n < Nn)
          old[nf][h] = pair ? *reinterpret_cast<const float2*>(src)
                            : make_float2(src[0],
                                          n + 1 < Nn ? src[1] : 0.f);
      }
#pragma unroll
    for (int nf = 0; nf < WFN; ++nf)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = ib + mf * 16 + g + 8 * h;
        const int n = nb + nf * 8 + 2 * t;
        if (!whole && !(nf < nfn && i < Ni && n < Nn)) continue;
        float* dst = part + (size_t)i * Nn + n;
        const float2 v =
            make_float2(old[nf][h].x + acc[mf][nf][2 * h],
                        old[nf][h].y + acc[mf][nf][2 * h + 1]);
        if (pair) {
          *reinterpret_cast<float2*>(dst) = v;
        } else {
          dst[0] = v.x;
          if (n + 1 < Nn) dst[1] = v.y;
        }
      }
  }
}

// part[i*Nn + n] (+)= sum_{r<R} H[r][i] * E[r][n], i < Ni, n < Nn: the
// weight cotangent of one tile, both operands wavefront buffers (the pad
// rows R..pad16(R)-1 are zero), into the block's global partial slot
// (assigned on the block's first tile, else added to).  T1: one TF32 pass.
template <bool T1 = false>
static __device__ void mma_dw(const float* H, const float* E, int ld, int R,
                              int Ni, int Nn, float* __restrict__ part,
                              bool first) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp & 1) * (WFM * 16), wn0 = (warp >> 1) * (WFN * 8);
  const int steps = pad16(R) / 8;
  const bool pair = Nn % 2 == 0 && reinterpret_cast<uintptr_t>(part) % 8 == 0;
  for (int i0 = 0; i0 < Ni; i0 += BLK_M) {
    const int nfm = clamp_frags((Ni - i0 - wm0 + 15) / 16);
    for (int n0 = 0; n0 < Nn; n0 += BLK_N) {
      const int nfn = clamp_frags((Nn - n0 - wn0 + 7) / 8);
      if (nfm == 0 || nfn == 0) continue;
      // the slot's old values of the warp's 64 x 32 block: into L2 while
      // the k8 steps run (a hint; the slots and the workspace overflow L2)
      if (!first) {
        for (int rr = lane; rr < WFM * 16; rr += 32) {
          const int i = i0 + wm0 + rr;
          if (i >= Ni) break;
          const float* row = part + (size_t)i * Nn;
          prefetch_l2(row + n0 + wn0);
          prefetch_l2(row + min(n0 + wn0 + WFN * 8, Nn) - 1);
        }
      }
      float acc[WFM][WFN][4];
      zero_acc(acc);
      mma_run<T1>(acc,
                  OpDw{H + t * ld + i0 + wm0 + g, E + t * ld + n0 + wn0 + g,
                       ld},
                  steps, nfm, nfn);
      // into the slot, an m16 row of fragments at a time: its eight old
      // column pairs (c0,c1 and c2,c3) read together before any is added
      // (one round trip each; where the warp's block lies whole inside the
      // slot, with no guard between the loads), then the sums stored
      const bool whole = pair && nfm == WFM && nfn == WFN &&
                         i0 + wm0 + WFM * 16 <= Ni && n0 + wn0 + WFN * 8 <= Nn;
#pragma unroll
      for (int mf = 0; mf < WFM; ++mf) {
        if (mf >= nfm) continue;
        float2 old[WFN][2];
#pragma unroll
        for (int nf = 0; nf < WFN; ++nf)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = i0 + wm0 + mf * 16 + g + 8 * h;
            const int n = n0 + wn0 + nf * 8 + 2 * t;
            const float* src = part + (size_t)i * Nn + n;
            old[nf][h] = make_float2(0.f, 0.f);
            if (first) continue;
            if (whole)
              old[nf][h] = *reinterpret_cast<const float2*>(src);
            else if (nf < nfn && i < Ni && n < Nn)
              old[nf][h] = pair ? *reinterpret_cast<const float2*>(src)
                                : make_float2(src[0],
                                              n + 1 < Nn ? src[1] : 0.f);
          }
#pragma unroll
        for (int nf = 0; nf < WFN; ++nf)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = i0 + wm0 + mf * 16 + g + 8 * h;
            const int n = n0 + wn0 + nf * 8 + 2 * t;
            if (!whole && !(nf < nfn && i < Ni && n < Nn)) continue;
            float* dst = part + (size_t)i * Nn + n;
            const float2 v =
                make_float2(old[nf][h].x + acc[mf][nf][2 * h],
                            old[nf][h].y + acc[mf][nf][2 * h + 1]);
            if (pair) {
              *reinterpret_cast<float2*>(dst) = v;
            } else {
              dst[0] = v.x;
              if (n + 1 < Nn) dst[1] = v.y;
            }
          }
      }
    }
  }
  __syncthreads();
}

// ------------------------------------------------------------------------
// The bf16 flavor's products, on the bf16 tensor cores.  Its operands lie
// in shared memory as bf16, each rounded once where it is written: the
// stack's post-activations by act_fwd, W as stage_fill_bf lands it in the
// bf16 stage, and the f32 cotangent dG (against which dH and dW run) as
// split_pieces cuts it into three bf16 pieces hi = rn(x), mid = rn(x - hi),
// lo = rn(x - hi - mid), whose sum is x exactly (24 significant bits; the
// subtractions are exact in f32).  Fragments come by ldmatrix, .trans
// where the product runs along the stored rows (the forward's W, both of
// dW's operands); each k16 step is one mma.sync.m16n8k16 bf16 pass per
// piece, smallest piece first, summing in f32 straight into the
// accumulators.  A bf16 x bf16 product is exact in f32, so the forward is
// the bf16 product the reference takes, and dH, dW the f32 cotangent's
// against the rounded operand, up to the order of the f32 sums.
//
// m16n8k16 fragments, lane = 4g + t: a0 (g, 2t..2t+1), a1 (g+8, 2t..),
// a2 (g, 2t+8..), a3 (g+8, 2t+8..); b0 (2t..2t+1, g), b1 (2t+8.., g); c as
// for m16n8k8.  One ldmatrix.x4 loads an m16 A fragment or the B
// fragments of two n8 fragments; each lane gives the address of one
// 16-byte row of one of its four 8 x 8 matrices.

static __device__ __forceinline__ void ldsm4(unsigned addr,
                                             unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

static __device__ __forceinline__ void ldsm4t(unsigned addr,
                                              unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

template <bool T>
static __device__ __forceinline__ void ldsm(unsigned addr, unsigned (&r)[4]) {
  if constexpr (T) ldsm4t(addr, r);
  else ldsm4(addr, r);
}

// d += a*b, bf16 operands, f32 sums
static __device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                                const unsigned* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A lane's ldmatrix addresses for one product: pa[p], pb[p] the shared
// addresses of its rows of piece p's first A and B fragments (an operand of
// one piece uses [0]), and the byte steps from there to m16 fragment mf
// (am), n8 fragment pair q (bq) and k16 step s (as, bs).
struct BFrag {
  unsigned pa[3], pb[3];
  int am, as, bq, bs;
};

// acc += the product over `steps` k16 steps of the warp's NFM x WFN
// fragments (FULL), or of its nfm x nfn: sum over the NP pieces p (1: the
// forward; 3: dH with the pieces on A (PA), dW on B) of A_p B or A B_p,
// smallest piece first.  The fragments of the next (step, piece) load while
// this one's passes run; the operand without pieces loads once per step.
// TA, TB: ldmatrix .trans for A, B.
template <int NFM, bool FULL, int NP, bool PA, bool TA, bool TB>
static __device__ __forceinline__ void bmma_steps(float (&acc)[WFM][WFN][4],
                                                  const BFrag& f, int steps,
                                                  int nfm, int nfn) {
  auto load_a = [&](int p, int s, unsigned (&r)[NFM][4]) {
#pragma unroll
    for (int mf = 0; mf < NFM; ++mf)
      if (FULL || mf < nfm) ldsm<TA>(f.pa[p] + mf * f.am + s * f.as, r[mf]);
  };
  auto load_b = [&](int p, int s, unsigned (&r)[WFN / 2][4]) {
#pragma unroll
    for (int q = 0; q < WFN / 2; ++q)
      if (FULL || 2 * q < nfn) ldsm<TB>(f.pb[p] + q * f.bq + s * f.bs, r[q]);
  };
  unsigned x[NFM][4], y[WFN / 2][4];
  load_a(0, 0, x);
  load_b(0, 0, y);
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const bool last = p + 1 == NP;
      const bool more = !last || s + 1 < steps;
      const int pn = last ? 0 : p + 1, sn = last ? s + 1 : s;
      // which operand the next (step, piece) changes
      const bool roll_a = PA || last, roll_b = !PA || last;
      unsigned xn[NFM][4], yn[WFN / 2][4];
      if (more) {
        if (roll_a) load_a(PA ? pn : 0, sn, xn);
        if (roll_b) load_b(PA ? 0 : pn, sn, yn);
      }
#pragma unroll
      for (int mf = 0; mf < NFM; ++mf)
#pragma unroll
        for (int nf = 0; nf < WFN; ++nf)
          if (FULL || (mf < nfm && nf < nfn))
            mma_bf16(acc[mf][nf], x[mf], &y[nf >> 1][2 * (nf & 1)]);
      if (more) {
        if (roll_a) {
#pragma unroll
          for (int mf = 0; mf < NFM; ++mf)
#pragma unroll
            for (int q = 0; q < 4; ++q) x[mf][q] = xn[mf][q];
        }
        if (roll_b) {
#pragma unroll
          for (int j = 0; j < WFN / 2; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) y[j][q] = yn[j][q];
        }
      }
    }
  }
}

template <int NP, bool PA, bool TA, bool TB>
static __device__ __forceinline__ void bmma_run(float (&acc)[WFM][WFN][4],
                                                const BFrag& f, int steps,
                                                int nfm, int nfn) {
  if (nfm == WFM && nfn == WFN)
    bmma_steps<WFM, true, NP, PA, TA, TB>(acc, f, steps, nfm, nfn);
  else
    bmma_steps<WFM, false, NP, PA, TA, TB>(acc, f, steps, nfm, nfn);
}

// dst[r][c] = W[(r0 + r) * ncol + c0 + c] rounded to bf16 (to nearest
// even), r < KT, c < BLK_N, zero past nrow or ncol: a window of W [nrow]
// [ncol] into the bf16 stage.  Each thread issues all its loads before it
// converts and stores any.
static __device__ void stage_fill_bf(const float* __restrict__ W, int nrow,
                                     int ncol, int r0, int c0, bf16* dst) {
  if (ncol % 4 == 0 && reinterpret_cast<uintptr_t>(W) % 16 == 0) {
    constexpr int NV = KT * BLK_N / 4 / NTHREADS;
    float4 v[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int e = threadIdx.x + i * NTHREADS;
      const int r = e / (BLK_N / 4), c = 4 * (e % (BLK_N / 4));
      v[i] = (r0 + r < nrow && c0 + c < ncol)
                 ? __ldg(reinterpret_cast<const float4*>(
                       W + (size_t)(r0 + r) * ncol + c0 + c))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int e = threadIdx.x + i * NTHREADS;
      const int r = e / (BLK_N / 4), c = 4 * (e % (BLK_N / 4));
      __nv_bfloat162* d =
          reinterpret_cast<__nv_bfloat162*>(dst + r * LDS_BF + c);
      d[0] = __floats2bfloat162_rn(v[i].x, v[i].y);
      d[1] = __floats2bfloat162_rn(v[i].z, v[i].w);
    }
  } else {
    for (int e = threadIdx.x; e < KT * BLK_N; e += NTHREADS) {
      const int r = e / BLK_N, c = e % BLK_N;
      dst[r * LDS_BF + c] = __float2bfloat16_rn(
          (r0 + r < nrow && c0 + c < ncol)
              ? W[(size_t)(r0 + r) * ncol + c0 + c] : 0.f);
    }
  }
}

// The bf16 flavor's copy of the weights in K2/K3 (round_weights): layer l's
// W (l >= 1) as [w_in][pad8(w_out)] bf16, zero past w_out, at wbf_offset(l)
// elements (a multiple of 8: 16-byte rows and layers), so the stage fills
// are 16-byte cp.async pieces of half the bytes of an f32 fill, issued
// ahead of the products as the f32 flavor's are.
static __host__ __device__ __forceinline__ int pad8(int n) {
  return (n + 7) & ~7;
}

static __host__ __device__ __forceinline__ int wbf_offset(const Net& net,
                                                          int l) {
  int o = 0;
  for (int j = 1; j < l; ++j) o += net.w_in[j] * pad8(net.w_out[j]);
  return o;
}

// Start the cp.async copies of a KT x BLK_N window (rows r0.., columns
// c0..) of a bf16 copy W [nrow][pad8(ncol)] into the bf16 stage, zero past
// nrow or ncol; one group.
static __device__ void stage_load_bf(const bf16* __restrict__ W, int nrow,
                                     int ncol, int r0, int c0, bf16* dst) {
  const int ldw = pad8(ncol);
  for (int e = threadIdx.x; e < KT * BLK_N / 8; e += NTHREADS) {
    const int r = e / (BLK_N / 8), c = 8 * (e % (BLK_N / 8));
    bf16* d = dst + r * LDS_BF + c;
    if (r0 + r < nrow && c0 + c < ncol)
      cp_async16(d, W + (size_t)(r0 + r) * ldw + c0 + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_commit();
}

// Issue chunk 0 of a tensor-core product's window of the bf16 copy W
// [nrow][ncol] (the forward's W [K][Nn], dH's W [Ni][K]) ahead of it;
// returns whether it did (not for a SIMT product, nor without a copy).
static __device__ __forceinline__ bool bprefetch(const bf16* __restrict__ W,
                                                 int nrow, int ncol,
                                                 bool tensor, bf16* wst) {
  if (W == nullptr || !tensor) return false;
  stage_load_bf(W, nrow, ncol, 0, 0, wst);
  return true;
}

// out[r][n] = sum_{k<K} A[r][k] * B(k, n), r < R, n < Nn, as mma_w: COLS
// false, the forward H W (+ bias[n] on primal rows r % C == 0), A the bf16
// stack (one piece, A0), B(k, n) = W[k*Nn + n], into f32 out; COLS true,
// dH = dP W^T, A the cotangent's pieces (A0, A1, A2: lo, mid, hi), B(k, n)
// = W[n*K + k], rounded to bf16 into out.  W comes through the bf16 stage
// in chunks of KT of its window (one for a layer at most 128 wide): COPY,
// from its bf16 copy Wb (K2/K3), the first chunk issued ahead when
// `issued`; else rounded from W as it lands (K1).  The tile's row
// fragments split between the two warp rows as in mma_w.  The forward
// first zeroes A's columns K .. pad16(K)-1, which the last k16 step reads
// against the stage's zero rows (split_pieces leaves the pieces' zero).
template <bool COLS, bool COPY>
static __device__ __forceinline__ void bmma_w(
    bf16* A0, const bf16* A1, const bf16* A2, int ld, int R, int K,
    const float* __restrict__ W, const bf16* __restrict__ Wb, int Nn,
    const float* __restrict__ bias, int C,
    std::conditional_t<COLS, bf16, float>* out, bf16* wst, bool issued) {
  constexpr int NP = COLS ? 3 : 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mtot = pad16(R) / 16, mhalf = (mtot + 1) / 2;
  const int wm0 = (warp & 1) ? mhalf * 16 : 0;
  const int nfm = (warp & 1) ? mtot - mhalf : mhalf;
  const int wn0 = (warp >> 1) * (WFN * 8);
  const int nK = (K + KT - 1) / KT;
  if (!COLS && K % 16) {  // seen by every warp after the first fill
    const int np = 16 - K % 16;
    for (int e = threadIdx.x; e < R * np; e += NTHREADS)
      A0[(e / np) * ld + K + e % np] = __float2bfloat16_rn(0.f);
  }
  // A by rows: lane rows l & 15, columns 8 (l >> 4) of each m16 x k16
  // fragment.  B: the forward reads the stage's rows k transposed (lane row
  // k = l & 15, columns n 8 (l >> 4) of a pair of n8 fragments); dH its
  // rows n as they lie (lane row l & 7 + 8 (l >> 4), columns k
  // 8 ((l >> 3) & 1)).
  BFrag f;
  const int arow = (wm0 + (lane & 15)) * ld + 8 * (lane >> 4);
  f.pa[0] = smem_addr(A0 + arow);
  f.pa[1] = COLS ? smem_addr(A1 + arow) : 0u;
  f.pa[2] = COLS ? smem_addr(A2 + arow) : 0u;
  f.am = 16 * ld * 2;
  f.as = 32;
  if constexpr (COLS) {
    f.pb[0] = smem_addr(wst + (wn0 + (lane & 7) + 8 * (lane >> 4)) * LDS_BF
                        + 8 * ((lane >> 3) & 1));
    f.bq = 16 * LDS_BF * 2;
    f.bs = 32;
  } else {
    f.pb[0] = smem_addr(wst + (lane & 15) * LDS_BF + wn0 + 8 * (lane >> 4));
    f.bq = 32;
    f.bs = 16 * LDS_BF * 2;
  }
  for (int n0 = 0; n0 < Nn; n0 += BLK_N) {
    const int nfn = clamp_frags((Nn - n0 - wn0 + 7) / 8);
    float acc[WFM][WFN][4];
    zero_acc(acc);
    for (int c = 0; c < nK; ++c) {
      // the window: rows n0.. of W [Ni][K] (dH), rows c*KT.. of W [K][Nn]
      const int nrow = COLS ? Nn : K, ncol = COLS ? K : Nn;
      const int r0 = COLS ? n0 : c * KT, c0 = COLS ? c * KT : n0;
      if constexpr (COPY) {
        if (c > 0 || n0 > 0 || !issued)
          stage_load_bf(Wb, nrow, ncol, r0, c0, wst);
        cp_async_wait_all();
      } else {
        stage_fill_bf(W, nrow, ncol, r0, c0, wst);
      }
      __syncthreads();  // the chunk landed for every warp
      const int steps = (min(KT, K - c * KT) + 15) / 16;
      if (nfm > 0 && nfn > 0) {
        BFrag fc = f;
#pragma unroll
        for (int p = 0; p < NP; ++p) fc.pa[p] += c * KT * 2;
        bmma_run<NP, true, false, !COLS>(acc, fc, steps, nfm, nfn);
      }
      if (c + 1 < nK || n0 + BLK_N < Nn)
        __syncthreads();  // every warp is done with the stage
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
          const int n = n0 + wn0 + nf * 8 + 2 * t;
          if (nf >= nfn || n >= Nn) continue;
          float v0 = acc[mf][nf][2 * h], v1 = acc[mf][nf][2 * h + 1];
          if constexpr (COLS) {
            bf16* o = out + r * ld + n;
            if (n + 1 < Nn)
              *reinterpret_cast<__nv_bfloat162*>(o) =
                  __floats2bfloat162_rn(v0, v1);
            else
              o[0] = __float2bfloat16_rn(v0);
          } else if (n + 1 < Nn) {
            if (prim) { v0 += bias[n]; v1 += bias[n + 1]; }
            *reinterpret_cast<float2*>(out + r * ld + n) = make_float2(v0, v1);
          } else {
            if (prim) v0 += bias[n];
            out[r * ld + n] = v0;
          }
        }
      }
    }
  }
  __syncthreads();  // out complete; the stage is free again
}

// The two weight products of the bf16 flavor (named apart so a profile can
// tell them apart): the forward H W (+ bias), and dH = dP W^T from dP's
// three pieces.
template <bool COPY>
static __device__ void bmma_w_rows(bf16* A, int ld, int R, int K,
                                   const float* __restrict__ W,
                                   const bf16* __restrict__ Wb, int Nn,
                                   const float* __restrict__ bias, int C,
                                   float* out, bf16* wst, bool issued) {
  bmma_w<false, COPY>(A, nullptr, nullptr, ld, R, K, W, Wb, Nn, bias, C, out,
                      wst, issued);
}

static __device__ void bmma_w_cols(bf16* lo, const bf16* mid,
                                   const bf16* hi, int ld, int R, int K,
                                   const bf16* __restrict__ Wb, int Ni,
                                   bf16* out, bf16* wst, bool issued) {
  bmma_w<true, true>(lo, mid, hi, ld, R, K, nullptr, Wb, Ni, nullptr, 1, out,
                     wst, issued);
}

// dW's slot update off the SMs: a warp's 64 x 32 dW block staged in shared
// memory (rows of 128 bytes) and added into the block's slot by bulk
// reduce-adds, one per row (cp.reduce.async.bulk .add.f32), each lane
// tracking its two rows in its own bulk group.  The slot belongs to the
// block and a lane adds the same rows on every tile, after its last adds
// there completed, so the sums are taken in the tiles' order, run to run.
static __device__ __forceinline__ void bulk_reduce_add(float* dst,
                                                       const float* src,
                                                       unsigned bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
      "[%0], [%1], %2;\n"
      :: "l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
}

static __device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the lane's bulk groups have read their shared memory
static __device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// the lane's bulk groups are complete (their adds done in global memory)
static __device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Bytes of shared memory the bulk route stages for a layer's Ni x Nn dW
// block: 8 KB for each warp up to the last with a fragment in it.
static __host__ __device__ __forceinline__ int dw_stage_bytes(int Ni,
                                                              int Nn) {
  const int nwn = (Nn + WFN * 8 - 1) / (WFN * 8);
  return (2 * (nwn - 1) + (Ni > WFM * 16 ? 2 : 1)) * WFM * 16 * WFN * 8 * 4;
}

// A warp's dW block acc (rows mf*16 + g + 8h, columns nf*8 + 2t) into
// st[64][32]: in each store the lanes of row g write fragment (k + g) % 4,
// so the store's eight rows fall on four bank groups and its 256 bytes take
// two wavefronts (the same fragment in every lane would take eight).
static __device__ __forceinline__ void stage_dw(
    const float (&acc)[WFM][WFN][4], float* st, int g, int t) {
  static_assert(WFN == 4, "the rotation covers four n8 fragments");
#pragma unroll
  for (int mf = 0; mf < WFM; ++mf)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < WFN; ++k) {
        const int nf = (k + g) & 3;
        float v0 = acc[mf][0][2 * h], v1 = acc[mf][0][2 * h + 1];
#pragma unroll
        for (int j = 1; j < WFN; ++j)
          if (nf == j) {
            v0 = acc[mf][j][2 * h];
            v1 = acc[mf][j][2 * h + 1];
          }
        *reinterpret_cast<float2*>(st + (mf * 16 + g + 8 * h) * (WFN * 8) +
                                   nf * 8 + 2 * t) = make_float2(v0, v1);
      }
}

// The bulk route's update of a warp's block (rows ib.., columns nb..) of
// the slot from acc, after every warp's products (the stage may alias what
// they read): staged, fenced for the async proxy, then the lane's rows
// (lane, lane + 32) added once its previous adds completed; the stage is
// read before the barrier returns.
static __device__ __forceinline__ void bulk_update(
    const float (&acc)[WFM][WFN][4], float* __restrict__ part, int ib,
    int nb, int Ni, int Nn, bool active, float* stage, int g, int t) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // every warp's products read their operands
  float* st = stage + warp * (WFM * 16 * WFN * 8);
  if (active) {
    stage_dw(acc, st, g, t);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncwarp();
  if (active) {
    bulk_wait();
    const unsigned bytes = 4u * (unsigned)min(WFN * 8, Nn - nb);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int r = lane + 32 * q;
      if (ib + r < Ni)
        bulk_reduce_add(part + (size_t)(ib + r) * Nn + nb,
                        st + r * (WFN * 8), bytes);
    }
    bulk_commit();
    bulk_wait_read();
  }
}

// part[i*Nn + n] (+)= sum_r H[r][i] * (lo + mid + hi)[r][n] over the tile's
// rows, i < Ni, n < Nn: mma_dw on the bf16 tensor cores, H the bf16 stack
// and the cotangent in its three pieces, every plane's rows R .. pad16(R)-1
// zero.  Both operands are read along their stored rows: ldmatrix .trans.
// Past the block's first tile (which assigns), a layer of one block tile
// whose slot rows take 16-byte pieces goes by bulk_update through `stage`
// (dw_stage_bytes(Ni, Nn) of shared memory, free once the products are
// done; nullptr: slot_update always), else each warp reads and writes its
// block of the slot (slot_update).
static __device__ void bmma_dw(const bf16* H, const bf16* lo, const bf16* mid,
                               const bf16* hi, int ld, int R, int Ni, int Nn,
                               float* __restrict__ part, bool first,
                               float* stage) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp & 1) * (WFM * 16), wn0 = (warp >> 1) * (WFN * 8);
  const int steps = pad16(R) / 16;
  const bool pair = Nn % 2 == 0 && reinterpret_cast<uintptr_t>(part) % 8 == 0;
  const bool bulk = stage != nullptr && !first && Ni <= BLK_M &&
                    Nn <= BLK_N && Nn % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(part) % 16 == 0;
  // A (i, r) = H[r][i]: lane rows r l & 7 + 8 (l >> 4), columns i
  // 8 ((l >> 3) & 1); B (r, n): lane rows r l & 15, columns n 8 (l >> 4)
  const int ar = ((lane & 7) + 8 * (lane >> 4)) * ld + 8 * ((lane >> 3) & 1);
  const int br = (lane & 15) * ld + 8 * (lane >> 4);
  BFrag f;
  f.am = 32;
  f.as = 16 * ld * 2;
  f.bq = 32;
  f.bs = 16 * ld * 2;
  // the bulk route, one block tile, apart from the loop (inside it, the two
  // updates' state spilled registers in K2/K3)
  if (bulk) {
    const int nfm = clamp_frags((Ni - wm0 + 15) / 16);
    const int nfn = clamp_frags((Nn - wn0 + 7) / 8);
    const bool active = nfm > 0 && nfn > 0;
    f.pa[0] = smem_addr(H + ar + wm0);
    f.pb[0] = smem_addr(lo + br + wn0);
    f.pb[1] = smem_addr(mid + br + wn0);
    f.pb[2] = smem_addr(hi + br + wn0);
    float acc[WFM][WFN][4];
    zero_acc(acc);
    if (active) bmma_run<3, false, true, true>(acc, f, steps, nfm, nfn);
    bulk_update(acc, part, wm0, wn0, Ni, Nn, active, stage, g, t);
    __syncthreads();
    return;
  }
  for (int i0 = 0; i0 < Ni; i0 += BLK_M) {
    const int nfm = clamp_frags((Ni - i0 - wm0 + 15) / 16);
    for (int n0 = 0; n0 < Nn; n0 += BLK_N) {
      const int nfn = clamp_frags((Nn - n0 - wn0 + 7) / 8);
      if (nfm == 0 || nfn == 0) continue;
      if (!first) slot_prefetch(part, i0 + wm0, n0 + wn0, Ni, Nn, lane);
      f.pa[0] = smem_addr(H + ar + i0 + wm0);
      f.pb[0] = smem_addr(lo + br + n0 + wn0);
      f.pb[1] = smem_addr(mid + br + n0 + wn0);
      f.pb[2] = smem_addr(hi + br + n0 + wn0);
      float acc[WFM][WFN][4];
      zero_acc(acc);
      bmma_run<3, false, true, true>(acc, f, steps, nfm, nfn);
      slot_update(acc, part, i0 + wm0, n0 + wn0, Ni, Nn, nfm, nfn, pair,
                  first, g, t);
    }
  }
  // the first tile's stores, seen by the bulk adds of the later ones
  if (first) asm volatile("fence.proxy.async;\n" ::: "memory");
  __syncthreads();
}

// The f32 cotangent G (rows < R, columns < w) into its three bf16 pieces
// (hi = rn(x), mid = rn(x - hi), lo = rn(x - hi - mid)), over rows <
// pad16(R) and columns < pad16(w), zero past R or w: every row and column
// dH's and dW's k16 steps read.
static __device__ void split_pieces(const float* G, int ld, int R, int w,
                                    bf16* hi, bf16* mid, bf16* lo) {
  const int half = pad16(w) / 2, n = pad16(R) * half;
  for (int e = threadIdx.x; e < n; e += NTHREADS) {
    const int r = e / half, c = 2 * (e % half), o = r * ld + c;
    float2 x = make_float2(0.f, 0.f);
    if (r < R && c < w) {
      x = *reinterpret_cast<const float2*>(G + o);
      if (c + 1 >= w) x.y = 0.f;
    }
    const __nv_bfloat162 h = __floats2bfloat162_rn(x.x, x.y);
    const float2 hf = __bfloat1622float2(h);
    const float2 r1 = make_float2(x.x - hf.x, x.y - hf.y);
    const __nv_bfloat162 m = __floats2bfloat162_rn(r1.x, r1.y);
    const float2 mf = __bfloat1622float2(m);
    *reinterpret_cast<__nv_bfloat162*>(hi + o) = h;
    *reinterpret_cast<__nv_bfloat162*>(mid + o) = m;
    *reinterpret_cast<__nv_bfloat162*>(lo + o) =
        __floats2bfloat162_rn(r1.x - mf.x, r1.y - mf.y);
  }
  __syncthreads();
}

// ------------------------------------------------------------------------
// The SIMT loops for narrow products (the head), one thread per output
// element, each summing k in order.

// Copy n floats from global src into shared dst, every thread a share (the
// caller's barrier makes them every warp's); rounded as flavor FL's
// product operand (opnd).
template <int FL = FL_F32>
static __device__ __forceinline__ void to_shared(float* dst,
                                                 const float* __restrict__ src,
                                                 int n) {
  for (int e = threadIdx.x; e < n; e += NTHREADS) dst[e] = opnd<FL>(src[e]);
}

// out[r][n] = sum_k A[r][k] * W[k*Nn + n] (+ bias[n] on primal rows); W
// and the bias are read from shared scratch (the weight stage), where one
// pass of loads puts them, not each from global memory in the sums.  A and
// W rounded as flavor FL's operands (opnd: to bf16 or TF32, whose
// products are exact in f32; A may be a bf16 plane, rounded already).
template <int FL, class TA>
static __device__ void narrow_fwd(const TA* A, int ld, int R, int K,
                                  const float* __restrict__ W, int Nn,
                                  const float* __restrict__ bias, int C,
                                  float* out, float* scratch) {
  float* sW = scratch;
  float* sb = scratch + K * Nn;
  to_shared<FL>(sW, W, K * Nn);
  if (bias != nullptr) to_shared(sb, bias, Nn);
  __syncthreads();
  for (int e = threadIdx.x; e < R * Nn; e += NTHREADS) {
    const int r = e / Nn, n = e % Nn;
    float acc = 0.f;
    for (int k = 0; k < K; ++k)
      acc = fmaf(opnd<FL>(A[r * ld + k]), sW[k * Nn + n], acc);
    if (bias != nullptr && r % C == 0) acc += sb[n];
    out[r * ld + n] = acc;
  }
  __syncthreads();
}

// out[r][i] = sum_{n<K} dP[r][n] * W[i*K + n]  (dH through a narrow layer;
// W from shared scratch).  BF16: W rounded to bf16, the sum rounded too
// (out may be a bf16 plane); TF32: W and dP rounded to TF32.
template <int FL, class TO>
static __device__ void narrow_dh(const float* dP, int ld, int R, int K,
                                 const float* __restrict__ W, int Ni,
                                 TO* out, float* scratch) {
  to_shared<FL>(scratch, W, Ni * K);
  __syncthreads();
  for (int e = threadIdx.x; e < R * Ni; e += NTHREADS) {
    const int r = e / Ni, i = e % Ni;
    float acc = 0.f;
    for (int n = 0; n < K; ++n)
      acc = fmaf(gopnd<FL>(dP[r * ld + n]), scratch[i * K + n], acc);
    if constexpr (std::is_same_v<TO, bf16>)
      out[r * ld + i] = __float2bfloat16_rn(acc);
    else
      out[r * ld + i] = FL == FL_BF16 ? bf16r(acc) : acc;
  }
  __syncthreads();
}

// part[i*Nn + n] (+)= sum_r A[r][i] * E[r][n]  (dW of a narrow layer;
// BF16: A rounded to bf16, or a bf16 plane; TF32: A and E rounded to TF32)
template <int FL, class TA>
static __device__ void narrow_dw(const TA* A, int ld, int Ni,
                                 const float* E, int Nn, int R,
                                 float* __restrict__ part, bool first) {
  for (int e = threadIdx.x; e < Ni * Nn; e += NTHREADS) {
    const int i = e / Nn, n = e % Nn;
    float acc = 0.f;
    for (int r = 0; r < R; ++r)
      acc = fmaf(opnd<FL>(A[r * ld + i]), gopnd<FL>(E[r * ld + n]), acc);
    float* dst = part + (size_t)i * Nn + n;
    *dst = first ? acc : *dst + acc;
  }
  __syncthreads();
}

// ------------------------------------------------------------------------
// The products as the sweeps call them: the tensor cores, or the SIMT loop
// for a narrow shape.

// Issue chunk 0 of a forward product (W [K][Nn]) into the weight stage ahead
// of it; returns whether it did (not for a narrow product).
static __device__ __forceinline__ bool prefetch_fwd(
    const float* __restrict__ W, int K, int Nn, float* wst) {
  if (Nn <= NARROW_N) return false;
  stage_load<false>(W, K, Nn, 0, 0, wst);
  cp_async_commit();
  return true;
}

// The same for dH = dP W^T (W [Ni][K]).
static __device__ __forceinline__ bool prefetch_dh(
    const float* __restrict__ W, int K, int Ni, float* wst) {
  if (K <= NARROW_N) return false;
  stage_load<true>(W, K, Ni, 0, 0, wst);
  cp_async_commit();
  return true;
}

// FL: the f32 layout's flavors, FL_F32 (3xTF32) or FL_TF32 (one pass).
template <int FL = FL_F32>
static __device__ __forceinline__ void product_fwd(
    float* A, int ld, int R, int K, const float* __restrict__ W, int Nn,
    const float* __restrict__ bias, int C, float* out, float* wst,
    bool issued) {
  if (Nn <= NARROW_N) narrow_fwd<FL>(A, ld, R, K, W, Nn, bias, C, out, wst);
  else mma_w_rows<FL == FL_TF32>(A, ld, R, K, W, Nn, bias, C, out, wst, issued);
}

template <int FL = FL_F32>
static __device__ __forceinline__ void product_dh(
    float* dP, int ld, int R, int K, const float* __restrict__ W,
    int Ni, float* out, float* wst, bool issued) {
  if (K <= NARROW_N) narrow_dh<FL>(dP, ld, R, K, W, Ni, out, wst);
  else mma_w_cols<FL == FL_TF32>(dP, ld, R, K, W, Ni, out, wst, issued);
}

template <int FL = FL_F32>
static __device__ __forceinline__ void product_dw(
    const float* H, const float* E, int ld, int R, int Ni, int Nn,
    float* __restrict__ part, bool first) {
  if (Nn <= NARROW_N) narrow_dw<FL>(H, ld, Ni, E, Nn, R, part, first);
  else mma_dw<FL == FL_TF32>(H, E, ld, R, Ni, Nn, part, first);
}

// The bf16 flavor's forward product: A the bf16 stack, W through the bf16
// stage (COPY: from its bf16 copy Wb), or, narrow, read into the stage as
// SIMT scratch.
template <bool COPY>
static __device__ __forceinline__ void bproduct_fwd(
    bf16* A, int ld, int R, int K, const float* __restrict__ W,
    const bf16* __restrict__ Wb, int Nn, const float* __restrict__ bias,
    int C, float* out, bf16* wst, bool issued) {
  if (Nn <= NARROW_N)
    narrow_fwd<true>(A, ld, R, K, W, Nn, bias, C, out,
                     reinterpret_cast<float*>(wst));
  else
    bmma_w_rows<COPY>(A, ld, R, K, W, Wb, Nn, bias, C, out, wst, issued);
}

// part[j] (+)= sum_p G[p*C][j]: the bias sees only the primal channel.
static __device__ void bias_accum(const float* G, int ld, int w, int TP,
                                  int C, float* __restrict__ part,
                                  bool first) {
  for (int j = threadIdx.x; j < w; j += NTHREADS) {
    float s = 0.f;
    for (int p = 0; p < TP; ++p) s += G[(p * C) * ld + j];
    part[j] = first ? s : part[j] + s;
  }
  __syncthreads();
}

// Zero the wavefront buffers once per block: the pad rows, which the
// products over rows (dW) read, stay zero.
static __device__ void zero_buffers(float* sm, int n) {
  float4* p = reinterpret_cast<float4*>(sm);
  for (int e = threadIdx.x; e < n / 4; e += NTHREADS)
    p[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
}

// Layer 0's pre-activation channels: the primal is X @ W0 + b0; a
// first-order channel along direction k is its seed e_k @ W0 = W0[k][:];
// higher orders start at zero.  W0, b0 and the tile's rows of X (zero past
// N) are read from shared scratch (the weight stage, free here; the
// kernels' C interface checks they fit).  W0 and X rounded as flavor FL's
// operands (to bf16 or TF32; the seeds are then rows of the rounded W0),
// b0 not.
template <int FL>
static __device__ void layer0_fwd(const float* __restrict__ X,
                                  const float* __restrict__ prm, int N,
                                  int p0, int TP, const Net& net,
                                  const Sched& s, float* out, float* scratch) {
  const int C = s.C, d = net.d, w = net.w_out[0], ld = net.ld;
  float* sW = scratch;
  float* sb = sW + d * w;
  float* sx = sb + w;
  to_shared<FL>(sW, prm + net.offW[0], d * w);
  to_shared(sb, prm + net.offb[0], w);
  for (int e = threadIdx.x; e < TP * d; e += NTHREADS)
    sx[e] = (p0 + e / d < N) ? opnd<FL>(X[(size_t)p0 * d + e]) : 0.f;
  __syncthreads();
  for (int e = threadIdx.x; e < TP * w; e += NTHREADS) {
    const int p = e / w, j = e % w;
    float* col = out + (p * C) * ld + j;
    float acc = 0.f;
    for (int k = 0; k < d; ++k) acc = fmaf(sx[p * d + k], sW[k * w + j], acc);
    col[0] = acc + sb[j];
    for (int c = 1; c < C; ++c)
      col[c * ld] = (s.order[c] == 1) ? sW[s.idx[c][0] * w + j] : 0.f;
  }
  __syncthreads();
}

// Whether layer 0's operands fit the scratch that layer0_fwd and
// layer0_bwd take them into: W0, b0 and TP rows of X.
static __host__ __device__ __forceinline__ bool layer0_fits(int d, int w,
                                                           int TP) {
  return d * w + w + TP * d <= STAGE_F;
}

struct TanhChain {
  float z, d1, d2, d3, d4;
};

static __device__ __forceinline__ TanhChain tanh_chain(float u) {
  TanhChain t;
  t.z = tanhf(u);
  t.d1 = 1.f - t.z * t.z;
  t.d2 = -2.f * t.z * t.d1;
  t.d3 = -2.f * t.d1 * (1.f - 3.f * t.z * t.z);
  t.d4 = -2.f * t.d2 * (1.f - 3.f * t.z * t.z) + 12.f * t.z * t.d1 * t.d1;
  return t;
}

// Channel c's post-activation value at one (point, column), by its Faa di
// Bruno line over the pre-activation channels col[c' * ld] (c' <= c).
static __device__ __forceinline__ float fdb_line(const float* col, int ld,
                                                 const TanhChain& t, int order,
                                                 const int* ix, float Pc) {
  switch (order) {
    case 1:
      return t.d1 * Pc;
    case 2:
      return t.d1 * Pc + t.d2 * col[ix[0] * ld] * col[ix[1] * ld];
    case 3: {
      const float qi = col[ix[0] * ld], qj = col[ix[1] * ld],
                  qk = col[ix[2] * ld], rij = col[ix[3] * ld],
                  rik = col[ix[4] * ld], rjk = col[ix[5] * ld];
      return t.d3 * qi * qj * qk + t.d2 * (rij * qk + rik * qj + rjk * qi)
             + t.d1 * Pc;
    }
    default: {  // 4: unmixed along k
      const float q = col[ix[0] * ld], r = col[ix[1] * ld],
                  v = col[ix[2] * ld];
      return t.d1 * Pc + 4.f * t.d2 * v * q + 3.f * t.d2 * r * r
             + 6.f * t.d3 * r * q * q + t.d4 * q * q * q * q;
    }
  }
}

// A post-activation of the bf16 flavor, rounded, into the plane hb at
// offset o and, streaming, into the workspace slice stage_h.
static __device__ __forceinline__ void put_h(bf16* hb, bf16* stage_h, int o,
                                             float v) {
  const bf16 b = __float2bfloat16_rn(v);
  hb[o] = b;
  if (stage_h != nullptr)
    __stcs(reinterpret_cast<unsigned short*>(stage_h + o),
           __bfloat16_as_ushort(b));
}

// act_fwd on NI (point, column) items at buffer offsets base[]: their
// tanh chains and lines are independent, so a thread keeps NI in flight.
// Channels run from the highest order down (each reads only lower-order
// channels, so in place is safe); all items' lines of a channel are
// computed before any is stored.  BF: the post-activations go to the bf16
// plane hb (and stage_h) rounded, and buf keeps the pre-activations.
template <bool BF>
using hval_t = std::conditional_t<BF, bf16, float>;

template <int NI, bool BF>
static __device__ __forceinline__ void act_fwd_items(
    float* buf, int ld, const Sched& s, float* __restrict__ stage,
    hval_t<BF>* __restrict__ stage_h, bf16* hb, const int* base) {
  TanhChain t[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const float u = buf[base[i]];
    if (stage != nullptr) __stcs(stage + base[i], u);
    t[i] = tanh_chain(u);
  }
  for (int c = s.C - 1; c >= 1; --c) {
    float h[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const float* col = buf + base[i];
      const float Pc = col[c * ld];
      if (stage != nullptr) __stcs(stage + base[i] + c * ld, Pc);
      h[i] = fdb_line(col, ld, t[i], s.order[c], s.idx[c], Pc);
    }
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      if constexpr (BF) {
        put_h(hb, stage_h, base[i] + c * ld, h[i]);
      } else {
        buf[base[i] + c * ld] = h[i];
        if (stage_h != nullptr) __stcs(stage_h + base[i] + c * ld, h[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    if constexpr (BF) {
      put_h(hb, stage_h, base[i], t[i].z);
    } else {
      buf[base[i]] = t[i].z;
      if (stage_h != nullptr) __stcs(stage_h + base[i], t[i].z);
    }
  }
}

// The pointwise passes take ITEMS items per thread at a time: with one
// block of 8 warps per SM, the independent tanh chains and lines of
// several items are what hides the latency of each.
#define ITEMS 4

// Buffer offset of item e of a pass over TP points x w columns: column
// e % w of point e / w, channel 0.
static __device__ __forceinline__ int item_base(int e, int w, int C, int ld) {
  return (e / w) * C * ld + e % w;
}

// Pre-activation channels -> post-activation channels, in place.  Item
// (p, j) is column j of point p across all channels.  stage != nullptr:
// each pre-activation value is also written there, at its buffer offset,
// and stage_h != nullptr: each post-activation value (K2/K3's workspace;
// consecutive threads write consecutive columns, 128 bytes per warp store,
// marked to stream through L2 so the partial slots stay there).  BF: into
// the bf16 plane hb instead, buf left as it is (act_fwd_items).
template <bool BF = false>
static __device__ void act_fwd(float* buf, int ld, int TP, int w,
                               const Sched& s, float* __restrict__ stage,
                               hval_t<BF>* __restrict__ stage_h,
                               bf16* hb = nullptr) {
  const int C = s.C, n = TP * w;
  int e = threadIdx.x;
  for (; e + (ITEMS - 1) * NTHREADS < n; e += ITEMS * NTHREADS) {
    int base[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
      base[i] = item_base(e + i * NTHREADS, w, C, ld);
    act_fwd_items<ITEMS, BF>(buf, ld, s, stage, stage_h, hb, base);
  }
  for (; e < n; e += NTHREADS) {
    const int base[1] = {item_base(e, w, C, ld)};
    act_fwd_items<1, BF>(buf, ld, s, stage, stage_h, hb, base);
  }
  // the staged values are read back by the async proxy (ws_load)
  if (stage != nullptr) asm volatile("fence.proxy.async;\n" ::: "memory");
  __syncthreads();
}

// The cotangents of an item's z and chain d1..d4.
struct ChainGrad {
  float z, d1, d2, d3, d4;
};

// act_vjp on NI items at buffer offsets base[] (see act_fwd_items).
template <int NI, class TH>
static __device__ __forceinline__ void act_vjp_items(
    const float* P, const TH* dH, float* dG, int ld, const Sched& s,
    const int* base) {
  const int C = s.C;
  TanhChain t[NI];
  ChainGrad gt[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    t[i] = tanh_chain(P[base[i]]);
    gt[i] = ChainGrad{tofl(dH[base[i]]), 0.f, 0.f, 0.f, 0.f};
    for (int c = 0; c < C; ++c) dG[base[i] + c * ld] = 0.f;
  }
  for (int c = 1; c < C; ++c) {
    const int* ix = s.idx[c];
    const int order = s.order[c];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const float* col = P + base[i];
      float* gc = dG + base[i];
      const float g = tofl(dH[base[i] + c * ld]), Pc = col[c * ld];
      gt[i].d1 += g * Pc;
      gc[c * ld] += g * t[i].d1;
      switch (order) {
        case 1:
          break;
        case 2: {
          const float a = col[ix[0] * ld], b = col[ix[1] * ld];
          gt[i].d2 += g * a * b;
          gc[ix[0] * ld] += g * t[i].d2 * b;
          gc[ix[1] * ld] += g * t[i].d2 * a;
          break;
        }
        case 3: {
          const float qi = col[ix[0] * ld], qj = col[ix[1] * ld],
                      qk = col[ix[2] * ld], rij = col[ix[3] * ld],
                      rik = col[ix[4] * ld], rjk = col[ix[5] * ld];
          gt[i].d3 += g * qi * qj * qk;
          gt[i].d2 += g * (rij * qk + rik * qj + rjk * qi);
          gc[ix[0] * ld] += g * (t[i].d3 * qj * qk + t[i].d2 * rjk);
          gc[ix[1] * ld] += g * (t[i].d3 * qi * qk + t[i].d2 * rik);
          gc[ix[2] * ld] += g * (t[i].d3 * qi * qj + t[i].d2 * rij);
          gc[ix[3] * ld] += g * t[i].d2 * qk;
          gc[ix[4] * ld] += g * t[i].d2 * qj;
          gc[ix[5] * ld] += g * t[i].d2 * qi;
          break;
        }
        default: {  // 4
          const float q = col[ix[0] * ld], r = col[ix[1] * ld],
                      v = col[ix[2] * ld];
          gt[i].d2 += g * (4.f * v * q + 3.f * r * r);
          gt[i].d3 += g * 6.f * r * q * q;
          gt[i].d4 += g * q * q * q * q;
          gc[ix[0] * ld] += g * (4.f * t[i].d2 * v + 12.f * t[i].d3 * r * q
                                 + 4.f * t[i].d4 * q * q * q);
          gc[ix[1] * ld] += g * (6.f * t[i].d2 * r + 6.f * t[i].d3 * q * q);
          gc[ix[2] * ld] += g * 4.f * t[i].d2 * q;
          break;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    // d z/du = d1 and d(d_k)/du = d_{k+1}; d5 = d1 (16 - 120 z^2 + 120 z^4)
    const TanhChain& ti = t[i];
    const float z2 = ti.z * ti.z;
    const float d5 = ti.d1 * (16.f - z2 * (120.f - 120.f * z2));
    dG[base[i]] += gt[i].z * ti.d1 + gt[i].d1 * ti.d2 + gt[i].d2 * ti.d3
                   + gt[i].d3 * ti.d4 + gt[i].d4 * d5;
  }
}

// The transpose of act_fwd: cotangents dH of the post-activation channels
// -> cotangents dG of the pre-activation channels P (all [TP*C][ld]; dH
// f32, or the bf16 flavor's bf16 plane).
template <class TH>
static __device__ void act_vjp(const float* P, const TH* dH, float* dG,
                               int ld, int TP, int w, const Sched& s) {
  const int C = s.C, n = TP * w;
  int e = threadIdx.x;
  for (; e + (ITEMS - 1) * NTHREADS < n; e += ITEMS * NTHREADS) {
    int base[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
      base[i] = item_base(e + i * NTHREADS, w, C, ld);
    act_vjp_items<ITEMS, TH>(P, dH, dG, ld, s, base);
  }
  for (; e < n; e += NTHREADS) {
    const int base[1] = {item_base(e, w, C, ld)};
    act_vjp_items<1, TH>(P, dH, dG, ld, s, base);
  }
  __syncthreads();
}

// ------------------------------------------------------------------------
// The slices of a block's workspace, each R x ld floats: the pre-activation
// channels P_0 .. P_{L-2} of the hidden layers, then the post-activation
// channels H_1 .. H_{L-2} (the inputs of layers 1 .. L-2).
static __host__ __device__ __forceinline__ int ws_slices(int L) {
  return 2 * L - 3;
}

// The backward kernels' forward recompute over the hidden layers of one
// tile (points p0 .. p0+TP-1): stages each hidden layer's pre-activation
// channels and each hidden layer's input in the block's workspace slice
// myws (see ws_slices; rows < R, stride ld, as act_fwd transforms them) and
// returns the buffer (buf0 or buf1) holding the last hidden layer's
// post-activations.  Each layer's first weight chunk is issued before the
// activation pass that precedes its product.  head_issued != nullptr: the
// head's first chunk too (K3's head product); *head_issued says whether it
// was.  FL: FL_F32 or FL_TF32 (the f32 layout's flavors).
template <int FL = FL_F32>
static __device__ float* stage_forward(const float* __restrict__ X,
                                       const float* __restrict__ prm, int N,
                                       int p0, int TP, const Net& net,
                                       const Sched& s, float* myws,
                                       float* buf0, float* buf1, float* wst,
                                       bool* head_issued) {
  const int C = s.C, R = TP * C, ld = net.ld, lh = net.L - 1;
  const size_t slice = (size_t)R * ld;
  float* cur = buf0;
  float* oth = buf1;
  layer0_fwd<FL>(X, prm, N, p0, TP, net, s, cur, wst);
  for (int l = 1; l < lh; ++l) {
    const bool issued = prefetch_fwd(prm + net.offW[l], net.w_in[l],
                                     net.w_out[l], wst);
    act_fwd(cur, ld, TP, net.w_out[l - 1], s, myws + (l - 1) * slice,
            myws + (lh + l - 1) * slice);
    product_fwd<FL>(cur, ld, R, net.w_in[l], prm + net.offW[l],
                    net.w_out[l], prm + net.offb[l], C, oth, wst, issued);
    float* t = cur; cur = oth; oth = t;
  }
  if (head_issued != nullptr)
    *head_issued = prefetch_fwd(prm + net.offW[lh], net.w_in[lh], net.n_out,
                                wst);
  act_fwd(cur, ld, TP, net.w_out[lh - 1], s, myws + (lh - 1) * slice,
          nullptr);
  return cur;
}

// Layer 0's weight and input cotangents from its pre-activation cotangents
// dG: its input channels are X (the primal) and constant one-hot seeds, so
// dW_0 sums X against the primal rows and the seeds' rows, and dX =
// dG_primal W_0^T for points < N (dX = acc, or += acc when add_dX).  W0 and
// the tile's rows of X come from shared scratch, as in layer0_fwd (BF16:
// rounded to bf16, and acc rounded before it reaches dX; TF32: rounded to
// TF32, and dG too where it is a product's operand).
template <int FL>
static __device__ void layer0_bwd(const float* __restrict__ X,
                                  const float* __restrict__ prm,
                                  float* __restrict__ dX, bool add_dX,
                                  float* __restrict__ mypart, int N, int p0,
                                  int TP, bool first, const Net& net,
                                  const Sched& s, const float* dG,
                                  float* scratch) {
  const int C = s.C, ld = net.ld, d = net.d, w = net.w_out[0];
  float* sW = scratch;
  float* sx = sW + d * w;
  to_shared<FL>(sW, prm + net.offW[0], d * w);
  for (int e = threadIdx.x; e < TP * d; e += NTHREADS)
    sx[e] = (p0 + e / d < N) ? opnd<FL>(X[(size_t)p0 * d + e]) : 0.f;
  __syncthreads();
  float* pW = mypart + net.offW[0];
  for (int e = threadIdx.x; e < d * w; e += NTHREADS) {
    int k = e / w, j = e % w;
    float acc = 0.f;
    for (int p = 0; p < TP; ++p)
      acc = fmaf(sx[p * d + k], gopnd<FL>(dG[(p * C) * ld + j]), acc);
    for (int c = 1; c < C; ++c) {
      if (s.order[c] != 1 || s.idx[c][0] != k) continue;
      for (int p = 0; p < TP; ++p) acc += gopnd<FL>(dG[(p * C + c) * ld + j]);
    }
    pW[e] = first ? acc : pW[e] + acc;
  }
  for (int e = threadIdx.x; e < TP * d; e += NTHREADS) {
    int p = e / d, k = e % d, gp = p0 + p;
    if (gp >= N) continue;
    float acc = 0.f;
    for (int j = 0; j < w; ++j)
      acc = fmaf(gopnd<FL>(dG[(p * C) * ld + j]), sW[k * w + j], acc);
    if (FL == FL_BF16) acc = bf16r(acc);
    float* dst = dX + (size_t)gp * d + k;
    *dst = add_dX ? *dst + acc : acc;
  }
  __syncthreads();
}

// The reverse sweep from the head's pre-activation cotangents dP (the
// table cotangents, [TP*C][ld], columns < n_out) down to layer 0.  cur
// holds the last hidden layer's post-activations (stage_forward's result);
// the caller has issued the ws_load of the last hidden layer's staged
// pre-activations into oth.  All three buffers are clobbered.  Accumulates
// dW/db into the block's partial slot mypart (assigned on the block's
// first tile) and writes dX rows for points < N: dX = acc, or dX += acc
// when add_dX (K3 has put the coordinates' direct adjoints there).
//
// Per hidden layer l the buffers keep their roles: Pb receives P_l (the
// staged pre-activations), dH holds the cotangent of H_l, dG receives dP_l.
// Pb then receives the staged layer input H_l for dW_l, and P_{l-1} behind
// the dH product, for layer l-1's act_vjp.  FL: FL_F32 or FL_TF32.
template <int FL = FL_F32>
static __device__ void reverse_sweep(const float* __restrict__ X,
                                     const float* __restrict__ prm,
                                     float* __restrict__ dX, bool add_dX,
                                     float* __restrict__ mypart,
                                     const float* myws, int N, int p0, int TP,
                                     bool first, const Net& net,
                                     const Sched& s, float* cur, float* oth,
                                     float* dP, float* wst, uint64_t* mbar,
                                     unsigned& phase) {
  const int C = s.C, R = TP * C, ld = net.ld, L = net.L, n_out = net.n_out;
  const int lh = L - 1;
  product_dw<FL>(cur, dP, ld, R, net.w_in[lh], n_out, mypart + net.offW[lh],
                 first);
  bias_accum(dP, ld, n_out, TP, C, mypart + net.offb[lh], first);
  product_dh<FL>(dP, ld, R, n_out, prm + net.offW[lh], net.w_in[lh], cur,
                 wst, false);

  float* Pb = oth;
  float* dH = cur;
  float* dG = dP;
  for (int l = L - 2; l >= 0; --l) {
    const int w = net.w_out[l];
    const bool issued =
        (l > 0) && prefetch_dh(prm + net.offW[l], w, net.w_in[l], wst);
    ws_wait(mbar, phase);
    act_vjp(Pb, dH, dG, ld, TP, w, s);
    if (l > 0) {
      const float* Pprev = myws + (size_t)(l - 1) * R * ld;
      // the layer input H_l, staged by stage_forward
      ws_load(Pb, myws + (size_t)(L - 2 + l) * R * ld, R, ld, mbar);
      ws_wait(mbar, phase);
      product_dw<FL>(Pb, dG, ld, R, net.w_in[l], w, mypart + net.offW[l],
                     first);
      bias_accum(dG, ld, w, TP, C, mypart + net.offb[l], first);
      // P_{l-1} again, for the next act_vjp, behind the dH product
      ws_load(Pb, Pprev, R, ld, mbar);
      product_dh<FL>(dG, ld, R, w, prm + net.offW[l], net.w_in[l], dH, wst,
                     issued);
    } else {
      layer0_bwd<FL>(X, prm, dX, add_dX, mypart, N, p0, TP, first, net, s,
                     dG, wst);
      bias_accum(dG, ld, w, TP, C, mypart + net.offb[0], first);
    }
  }
}

// ------------------------------------------------------------------------
// The bf16 flavor's sweeps.  A block's shared memory is slots of Rp x ld
// bf16 (an f32 array takes two, as Rp x ld floats), then the bf16 stage.
// Its workspace slice holds the pre-activation channels P_0 .. P_{L-2} (f32,
// R x ld each, as the f32 flavor's) and then the layer inputs H_1 ..
// H_{L-2} as the products take them, rounded to bf16, Rp x ld each, their
// pad rows zero (zero_ws_pads) so that a bulk copy of Rp rows brings dW the
// zero rows it sums over.

static __device__ __forceinline__ bf16* slot_of(float* sm, int k, int Rp,
                                                int ld) {
  return reinterpret_cast<bf16*>(sm) + (size_t)k * Rp * ld;
}

static __device__ __forceinline__ float* ws_P(float* myws, int l, int R,
                                              int ld) {
  return myws + (size_t)l * R * ld;
}

static __device__ __forceinline__ bf16* ws_H(float* myws, int L, int l,
                                             int R, int ld) {
  return reinterpret_cast<bf16*>(myws + (size_t)(L - 1) * R * ld) +
         (size_t)(l - 1) * pad16(R) * ld;
}

// Floats of a block's workspace slice in the bf16 flavor.
static __host__ __device__ __forceinline__ size_t ws_floats_bf(int L, int R,
                                                               int ld) {
  return (size_t)(L - 1) * R * ld + (size_t)(L - 2) * pad16(R) * ld / 2;
}

// Zero the pad rows R .. pad16(R)-1 of the block's H slices, once per
// launch: act_fwd writes rows < R only.  (Every thread's later act_fwd
// fences them for the bulk copies that read them.)
static __device__ void zero_ws_pads(float* myws, int L, int R, int ld) {
  const int n = (pad16(R) - R) * ld;
  for (int l = 1; l < L - 1; ++l) {
    bf16* h = ws_H(myws, L, l, R, ld) + (size_t)R * ld;
    for (int e = threadIdx.x; e < n; e += NTHREADS)
      h[e] = __float2bfloat16_rn(0.f);
  }
}

// stage_forward in the bf16 flavor: the pre-activation channels in F (f32,
// slots 0-1), each hidden layer's post-activations rounded into the plane
// Hb by act_fwd, both staged in myws (the H slices for layers 1 .. L-2).
// Each layer's first weight chunk (from the bf16 copy wbf) is issued
// before the activation pass that precedes its product.  On return Hb
// holds the last hidden layer's post-activations.
static __device__ void stage_forward_bf(const float* __restrict__ X,
                                        const float* __restrict__ prm,
                                        const bf16* __restrict__ wbf, int N,
                                        int p0, int TP, const Net& net,
                                        const Sched& s, float* myws,
                                        float* F, bf16* Hb, bf16* wst) {
  const int C = s.C, R = TP * C, ld = net.ld, L = net.L, lh = L - 1;
  layer0_fwd<true>(X, prm, N, p0, TP, net, s, F,
                   reinterpret_cast<float*>(wst));
  for (int l = 1; l < lh; ++l) {
    const bf16* Wb = wbf + wbf_offset(net, l);
    const bool issued = bprefetch(Wb, net.w_in[l], net.w_out[l],
                                  net.w_out[l] > NARROW_N, wst);
    act_fwd<true>(F, ld, TP, net.w_out[l - 1], s, ws_P(myws, l - 1, R, ld),
                  ws_H(myws, L, l, R, ld), Hb);
    bproduct_fwd<true>(Hb, ld, R, net.w_in[l], prm + net.offW[l], Wb,
                 net.w_out[l], prm + net.offb[l], C, F, wst, issued);
  }
  act_fwd<true>(F, ld, TP, net.w_out[lh - 1], s, ws_P(myws, lh - 1, R, ld),
                nullptr, Hb);
}

// reverse_sweep in the bf16 flavor, over five slots (sm, Rp rows).  On
// entry slot 2 holds the last hidden layer's post-activations, slots 3-4
// the head's pre-activation cotangents dP (f32), and P_{L-2} is in flight
// into slots 0-1.  The head's cotangent products run SIMT at any width
// (the tensor cores would want dP in pieces, and no slots are free for
// them).  Per hidden layer l: P_l in slots 0-1, the cotangent of H_l (bf16)
// in slot h (2 or 4); act_vjp writes dG (f32) into the other two.  Then,
// past NARROW_N columns, split_pieces cuts dG into hi, mid (slots 0-1) and
// lo (slot h); H_l comes into slot 3, which dG held either way, for dW_l;
// dH's product writes the cotangent of H_{l-1} into the other of slots 2
// and 4, and P_{l-1} comes into slots 0-1 behind it.  A narrow layer keeps
// dG for its SIMT products, H_l in slot 0 and the new cotangent in slot h.
static __device__ void reverse_sweep_bf(const float* __restrict__ X,
                                        const float* __restrict__ prm,
                                        const bf16* __restrict__ wbf,
                                        float* __restrict__ dX, bool add_dX,
                                        float* __restrict__ mypart,
                                        float* myws, int N, int p0, int TP,
                                        bool first, const Net& net,
                                        const Sched& s, float* sm, bf16* wst,
                                        uint64_t* mbar, unsigned& phase) {
  const int C = s.C, R = TP * C, Rp = pad16(R), ld = net.ld, L = net.L;
  const int lh = L - 1, n_out = net.n_out;
  const unsigned h_bytes = (unsigned)(Rp * ld * 2);
  float* scratch = reinterpret_cast<float*>(wst);
  float* P = reinterpret_cast<float*>(slot_of(sm, 0, Rp, ld));
  float* dP = reinterpret_cast<float*>(slot_of(sm, 3, Rp, ld));
  narrow_dw<true>(slot_of(sm, 2, Rp, ld), ld, net.w_in[lh], dP, n_out, R,
                  mypart + net.offW[lh], first);
  bias_accum(dP, ld, n_out, TP, C, mypart + net.offb[lh], first);
  narrow_dh<true>(dP, ld, R, n_out, prm + net.offW[lh], net.w_in[lh],
                  slot_of(sm, 2, Rp, ld), scratch);

  int h = 2;
  for (int l = L - 2; l >= 0; --l) {
    const int w = net.w_out[l];
    float* G = reinterpret_cast<float*>(slot_of(sm, h == 2 ? 3 : 2, Rp, ld));
    const bf16* Wb = wbf + wbf_offset(net, l);
    const bool issued =
        l > 0 && bprefetch(Wb, net.w_in[l], w, w > NARROW_N, wst);
    ws_wait(mbar, phase);
    act_vjp(P, slot_of(sm, h, Rp, ld), G, ld, TP, w, s);
    bias_accum(G, ld, w, TP, C, mypart + net.offb[l], first);
    if (l == 0) {
      layer0_bwd<true>(X, prm, dX, add_dX, mypart, N, p0, TP, first, net, s,
                       G, scratch);
      break;
    }
    const float* W = prm + net.offW[l];
    float* pW = mypart + net.offW[l];
    if (w <= NARROW_N) {
      bf16* Hl = slot_of(sm, 0, Rp, ld);
      ws_load_bytes(Hl, ws_H(myws, L, l, R, ld), h_bytes, mbar);
      ws_wait(mbar, phase);
      narrow_dw<true>(Hl, ld, net.w_in[l], G, w, R, pW, first);
      narrow_dh<true>(G, ld, R, w, W, net.w_in[l], slot_of(sm, h, Rp, ld),
                      scratch);
    } else {
      bf16* hi = slot_of(sm, 0, Rp, ld);
      bf16* mid = slot_of(sm, 1, Rp, ld);
      bf16* lo = slot_of(sm, h, Rp, ld);
      bf16* Hl = slot_of(sm, 3, Rp, ld);
      split_pieces(G, ld, R, w, hi, mid, lo);
      ws_load_bytes(Hl, ws_H(myws, L, l, R, ld), h_bytes, mbar);
      ws_wait(mbar, phase);
      // dW's stage: slot 3 (H_l, free once the products are done) and the
      // other of slots 2 and 4 (dH's output, written after), side by side
      const bool room = dw_stage_bytes(net.w_in[l], w) <= 4 * Rp * ld;
      bmma_dw(Hl, lo, mid, hi, ld, R, net.w_in[l], w, pW, first,
              room ? reinterpret_cast<float*>(slot_of(sm, min(3, 6 - h), Rp,
                                                      ld))
                   : nullptr);
      h = 6 - h;
      bmma_w_cols(lo, mid, hi, ld, R, w, Wb, net.w_in[l],
                  slot_of(sm, h, Rp, ld), wst, issued);
    }
    ws_load(P, ws_P(myws, l - 1, R, ld), R, ld, mbar);
  }
}

// The stride of the per-block partial slots holding P values: a multiple
// of 4 floats, so every slot starts 16-byte aligned (ops/cuda_taylor.py
// allocates them so).
static __host__ __device__ __forceinline__ int slot_stride(int P) {
  return (P + 3) & ~3;
}

// Whether packed parameter e lies in a layer's W (not a bias, nor K3's
// value after the parameters).
static __device__ __forceinline__ bool is_weight(const Net& net, int e) {
  for (int l = 0; l < net.L; ++l)
    if (e >= net.offW[l] && e < net.offb[l]) return true;
  return false;
}

// Sum the per-block partial slots (G slots of P values each) in slot
// order: deterministic, no atomics.  BF: each dW sum is then rounded to
// bf16 (the JAX package's XLA flavor rounds dW once, over all points).
template <bool BF>
static __global__ void reduce_partials(const float* __restrict__ part,
                                       float* __restrict__ out, int G, int P,
                                       Net net) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= P) return;
  const size_t stride = slot_stride(P);
  float acc = 0.f;
  for (int g = 0; g < G; ++g) acc += part[g * stride + e];
  if (BF && is_weight(net, e)) acc = bf16r(acc);
  out[e] = acc;
}

// Floats of K2/K3's bf16 weight copy (it follows the blocks' workspace
// slices), a multiple of 4 so the slices before it keep 16-byte alignment.
static inline size_t wbf_floats(const Net& net) {
  return (size_t)(wbf_offset(net, net.L) + 7) / 8 * 4;
}

// The bf16 flavor's weight copy (see wbf_offset), once per launch: W of
// layers 1 .. L-1 rounded to bf16 (to nearest even), rows padded to 8.
static __global__ void round_weights(const float* __restrict__ prm,
                                     bf16* __restrict__ wbf, Net net) {
  const int total = wbf_offset(net, net.L);
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += gridDim.x * blockDim.x) {
    int l = 1;
    while (l + 1 < net.L && e >= wbf_offset(net, l + 1)) ++l;
    const int ldw = pad8(net.w_out[l]), o = e - wbf_offset(net, l);
    const int i = o / ldw, n = o % ldw;
    wbf[e] = __float2bfloat16_rn(
        n < net.w_out[l] ? prm[net.offW[l] + i * net.w_out[l] + n] : 0.f);
  }
}

// ------------------------------------------------------------------------
// Host side.  net_h: [L, d, n_out, ld, P_total, w_in[MAXL], w_out[MAXL],
// offW[MAXL], offb[MAXL]];  sched_h: [C, order[MAXC], idx[MAXC*6]].

static inline Net unpack_net(const int* h) {
  Net n;
  n.L = h[0]; n.d = h[1]; n.n_out = h[2]; n.ld = h[3]; n.P_total = h[4];
  for (int i = 0; i < MAXL; ++i) {
    n.w_in[i] = h[5 + i];
    n.w_out[i] = h[5 + MAXL + i];
    n.offW[i] = h[5 + 2 * MAXL + i];
    n.offb[i] = h[5 + 3 * MAXL + i];
  }
  return n;
}

static inline Sched unpack_sched(const int* h) {
  Sched s;
  s.C = h[0];
  for (int c = 0; c < MAXC; ++c) {
    s.order[c] = h[1 + c];
    for (int k = 0; k < 6; ++k) s.idx[c][k] = h[1 + MAXC + 6 * c + k];
  }
  return s;
}

// Dynamic shared memory of a block with n_buf wavefront buffers for tiles
// of R rows: the buffers, the weight stage, the mbarrier slot.
static inline size_t smem_bytes(int n_buf, int R, int ld) {
  const size_t Rp = (size_t)((R + 15) & ~15);
  return sizeof(float) * (size_t)n_buf * Rp * ld + STAGE_BYTES;
}

// Where the weight stage lies in a block's dynamic shared memory.
static __device__ __forceinline__ float* stage_of(float* sm, int n_buf, int R,
                                                 int ld) {
  return sm + (size_t)n_buf * pad16(R) * ld;
}

// The bf16 flavor's: n_slots slots of Rp x ld bf16, the bf16 stage, its
// mbarrier.
static inline size_t smem_bytes_bf(int n_slots, int R, int ld) {
  return 2 * (size_t)n_slots * pad16(R) * ld + STAGE_BF_BYTES;
}

static __device__ __forceinline__ bf16* stage_of_bf(float* sm, int n_slots,
                                                   int R, int ld) {
  return slot_of(sm, n_slots, pad16(R), ld);
}

static __device__ __forceinline__ uint64_t* mbar_of_bf(bf16* wst) {
  return reinterpret_cast<uint64_t*>(wst + KT * LDS_BF);
}

// Whether the SIMT loops' operands fit the bf16 stage they take as
// scratch: layer 0's (layer0_fits), each narrow layer's W and bias, and the
// head's W, whose cotangent products run SIMT at any width in this flavor.
static inline bool scratch_fits_bf(const Net& net, int TP) {
  const int w0 = net.w_out[0];
  if (net.d * w0 + w0 + TP * net.d > STAGE_BF_F) return false;
  for (int l = 1; l < net.L; ++l) {
    const bool simt = net.w_out[l] <= NARROW_N || l == net.L - 1;
    if (simt && net.w_in[l] * net.w_out[l] + net.w_out[l] > STAGE_BF_F)
      return false;
  }
  return true;
}

