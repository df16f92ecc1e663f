// Hopper's warpgroup products (wgmma.mma_async, sm_90a) as the new K1
// route takes them (taylor_fwd_wg.cu): B from shared memory through a
// matrix descriptor, A from registers, the sum in registers.
//
// B's layout.  K-major ("no swizzle" canonical layout): the N x K operand
// is cut into core matrices of 8 rows (n) by 16 bytes of k (4 tf32 or 8
// bf16), each 128 contiguous bytes, row by row; core matrices follow each
// other along k (LBO = 128 bytes), and 8-row groups follow after a whole
// row of them (SBO = KC/epc * 128 bytes, KC the plane's depth, epc the
// elements per 16 bytes).  A k step (8 tf32 or 16 bf16, 32 bytes) is two
// core matrices along k, so the descriptor of step s starts 256*s bytes in.
// Every core matrix is one 128-byte line, which the tensor cores read
// without bank conflicts; the weights are written in this order once per
// launch (prep_wg_weights), so a plain bulk copy brings them in.
//
// A from registers, chained.  A product's accumulator (m64nN, f32) gives
// lane 4g + t of warp w rows 16w + g and 16w + g + 8 at columns 8j + 2t and
// 8j + 2t + 1 of every n8 block j: registers d[4j .. 4j+3] = (g, 2t),
// (g, 2t+1), (g+8, 2t), (g+8, 2t+1).  The next product's A fragment of a
// k step wants, for bf16 (m64nNk16), (g, 2t..2t+1), (g+8, 2t..2t+1), (g,
// 2t+8..9), (g+8, 2t+8..9) of the step's 16 columns: exactly d[8s .. 8s+7]
// packed in pairs, in k's natural order.  For tf32 (m64nNk8) it wants (g,
// t), (g+8, t), (g, t+4), (g+8, t+4) of the step's 8 columns; with the k
// order of each step permuted so that fragment slot t holds column 2t and
// slot t+4 column 2t+1 (wg_kslot), d[4s], d[4s+2], d[4s+1], d[4s+3] are
// the fragment, and the weight copy takes the same permutation of its k
// rows.  So a layer's output never leaves the registers on its way into
// the next product.

#pragma once

#include "taylor_common.cuh"  // split_tf32, smem_addr

// The matrix descriptor of a K-major, no-swizzle operand at shared address
// addr, with the core-matrix strides above.
static __device__ __forceinline__ uint64_t wg_desc(unsigned addr,
                                                   unsigned lbo,
                                                   unsigned sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

static __device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

static __device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

static __device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving uses of a register across the asynchronous
// product that reads or writes it (the counterpart of CUTLASS's
// warpgroup_fence_operand).
static __device__ __forceinline__ void wg_keep(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}

static __device__ __forceinline__ void wg_keep(unsigned& x) {
  asm volatile("" : "+r"(x)::"memory");
}

// Element (n, k) of a K-major plane of KC columns, epc elements per 16
// bytes (4 tf32, 8 bf16), as an element offset.
static __host__ __device__ __forceinline__ int wg_cm_offset(int n, int k,
                                                           int KC, int epc) {
  return ((n >> 3) * (KC / epc) + k / epc) * (8 * epc) + (n & 7) * epc +
         k % epc;
}

// The column of the layer's input that tf32 fragment slot q (within a k8
// step) holds: slots t and t + 4 take columns 2t and 2t + 1.
static __host__ __device__ __forceinline__ int wg_kslot(int q) {
  return q < 4 ? 2 * q : 2 * (q - 4) + 1;
}

// d (+)= A B over one k step: BF the bf16 flavor (m64nNk16), else tf32
// (m64nNk8); N the product's width; scale_d 0 starts the sum afresh.
template <bool BF, int N>
struct WgMma;

template <>
struct WgMma<false, 64> {
  static __device__ __forceinline__ void run(float (&d)[32], const unsigned (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  }
};

template <>
struct WgMma<false, 128> {
  static __device__ __forceinline__ void run(float (&d)[64], const unsigned (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  }
};

template <>
struct WgMma<true, 64> {
  static __device__ __forceinline__ void run(float (&d)[32], const unsigned (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  }
};

template <>
struct WgMma<true, 128> {
  static __device__ __forceinline__ void run(float (&d)[64], const unsigned (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  }
};


// One weight chunk's products, issued and waited for: the chunk's k steps
// of A, taken from h (the previous layer's output, in the accumulator
// layout; the chunk covers its columns chunk*KC .. chunk*KC + KC - 1),
// against the chunk's B at shared address base, added into d (first: the
// layer's first chunk, which starts d afresh).  FL_BF16: one bf16 pass per
// k16 step, A rounded to bf16 (to nearest even) as it is packed.  FL_F32:
// three tf32 passes per k8 step, A_lo B_hi + A_hi B_lo + A_hi B_hi
// (3xTF32, the hi plane at base and the lo plane after it): A is split in
// registers (split_tf32), once per element.  FL_TF32: the A_hi B_hi pass
// alone (the chunk holds the hi plane only).  The A registers and d are
// held past the wait, so nothing reuses or reads them while the products
// run.
template <int FL, int NP, int KC>
static __device__ __forceinline__ void wg_chunk(float (&d)[NP / 2],
                                                const float (&h)[NP / 2],
                                                int chunk, unsigned base,
                                                bool first) {
  if constexpr (FL == FL_TF32) {
    constexpr int S8 = KC / 8;
    unsigned ahi[S8][4];
#pragma unroll
    for (int s = 0; s < S8; ++s) {
      const int j = chunk * S8 + s;
      ahi[s][0] = tf32_bits(h[4 * j]);
      ahi[s][1] = tf32_bits(h[4 * j + 2]);
      ahi[s][2] = tf32_bits(h[4 * j + 1]);
      ahi[s][3] = tf32_bits(h[4 * j + 3]);
    }
    wg_fence();
    constexpr unsigned sbo = (KC / 4) * 128;
#pragma unroll
    for (int s = 0; s < S8; ++s)
      WgMma<false, NP>::run(d, ahi[s], wg_desc(base + 256 * s, 128, sbo),
                            (first && s == 0) ? 0 : 1);
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int s = 0; s < S8; ++s)
#pragma unroll
      for (int q = 0; q < 4; ++q) wg_keep(ahi[s][q]);
  } else if constexpr (FL == FL_BF16) {
    constexpr int S16 = KC / 16;
    unsigned a[S16][4];
#pragma unroll
    for (int s = 0; s < S16; ++s) {
      const int j = chunk * S16 + s;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const __nv_bfloat162 v =
            __floats2bfloat162_rn(h[8 * j + 2 * q], h[8 * j + 2 * q + 1]);
        a[s][q] = *reinterpret_cast<const unsigned*>(&v);
      }
    }
    wg_fence();
    constexpr unsigned sbo = (KC / 8) * 128;
#pragma unroll
    for (int s = 0; s < S16; ++s)
      WgMma<true, NP>::run(d, a[s], wg_desc(base + 256 * s, 128, sbo),
                           (first && s == 0) ? 0 : 1);
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int s = 0; s < S16; ++s)
#pragma unroll
      for (int q = 0; q < 4; ++q) wg_keep(a[s][q]);
  } else {
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
      const uint64_t bh = wg_desc(base + 256 * s, 128, sbo);
      const uint64_t bl = wg_desc(lo + 256 * s, 128, sbo);
      WgMma<false, NP>::run(d, alo[s], bh, (first && s == 0) ? 0 : 1);
      WgMma<false, NP>::run(d, ahi[s], bl, 1);
      WgMma<false, NP>::run(d, ahi[s], bh, 1);
    }
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
  for (int i = 0; i < NP / 2; ++i) wg_keep(d[i]);
}
