// Device code shared by the Taylor-table kernels (taylor_table.cu: K1, K2)
// and the fused minimax step (minimax_step.cu: K3): the packed network and
// channel-schedule descriptors, the shared-memory SIMT matmuls, the tanh
// chain with its Faa di Bruno lines and their transpose, K2's staged
// forward and reverse sweep, and the slot-ordered partial reduction.
//
// Everything here has internal linkage (static), so each translation unit
// of the one shared library carries its own copy and nothing collides at
// link time.

#pragma once

#include <cuda_runtime.h>

#define MAXL 16          // layers
#define MAXC 16          // channels
#define NTHREADS 256     // 16 x 16
#define TM 8             // register tile rows per thread
#define TN 8             // register tile cols per thread
#define KT 16            // streamed k-chunk
#define SUP_R (16 * TM)  // rows per register super-tile
#define SUP_N (16 * TN)  // cols per register super-tile
#define BS_LD (SUP_N + 1)
// outputs at most this many columns wide (the head's n_out) take a
// dot-product loop, one thread per output element: the register tile would
// spend nearly all its FMAs on masked columns.  Both sum k (or r) in the
// same order, so the results are the same bits.
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

// ------------------------------------------------------------------------
// out[r][n] = sum_k A[r][k] * B(k, n) (+ bias[n] on primal rows), for
// r < R, n < Nn, k < K.  A and out live in shared memory (row strides lda,
// ldo); B(k, n) = B[k*sbk + n*sbn] in global memory, streamed in KT-row
// chunks through Bs.
static __device__ void mm_smem(const float* A, int lda, int R, int K,
                               const float* __restrict__ B, int sbk, int sbn,
                               int Nn, const float* __restrict__ bias, int C,
                               float* out, int ldo, float* Bs) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  if (Nn <= NARROW_N) {
    for (int e = tid; e < R * Nn; e += NTHREADS) {
      const int r = e / Nn, n = e % Nn;
      float acc = 0.f;
      for (int k = 0; k < K; ++k)
        acc = fmaf(A[r * lda + k], B[(size_t)k * sbk + (size_t)n * sbn], acc);
      if (bias != nullptr && r % C == 0) acc += bias[n];
      out[r * ldo + n] = acc;
    }
    __syncthreads();
    return;
  }
  for (int r0 = 0; r0 < R; r0 += SUP_R) {
    for (int n0 = 0; n0 < Nn; n0 += SUP_N) {
      float acc[TM][TN];
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int n = 0; n < TN; ++n) acc[m][n] = 0.f;
      for (int k0 = 0; k0 < K; k0 += KT) {
        __syncthreads();
        for (int e = tid; e < KT * SUP_N; e += NTHREADS) {
          // keep consecutive threads on consecutive global addresses
          int kk, nn;
          if (sbn == 1) { kk = e / SUP_N; nn = e % SUP_N; }
          else { kk = e % KT; nn = e / KT; }
          int k = k0 + kk, n = n0 + nn;
          Bs[kk * BS_LD + nn] = (k < K && n < Nn)
              ? B[(size_t)k * sbk + (size_t)n * sbn] : 0.f;
        }
        __syncthreads();
        const int kmax = min(KT, K - k0);
        for (int kk = 0; kk < kmax; ++kk) {
          float a[TM], b[TN];
#pragma unroll
          for (int m = 0; m < TM; ++m) {
            int r = r0 + ty + 16 * m;
            a[m] = (r < R) ? A[r * lda + k0 + kk] : 0.f;
          }
#pragma unroll
          for (int n = 0; n < TN; ++n) b[n] = Bs[kk * BS_LD + tx + 16 * n];
#pragma unroll
          for (int m = 0; m < TM; ++m)
#pragma unroll
            for (int n = 0; n < TN; ++n) acc[m][n] = fmaf(a[m], b[n], acc[m][n]);
        }
      }
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        int r = r0 + ty + 16 * m;
        if (r >= R) continue;
#pragma unroll
        for (int n = 0; n < TN; ++n) {
          int nn = n0 + tx + 16 * n;
          if (nn >= Nn) continue;
          float v = acc[m][n];
          if (bias != nullptr && r % C == 0) v += bias[nn];
          out[r * ldo + nn] = v;
        }
      }
    }
  }
  __syncthreads();
}

// part[i*Nn + n] (+)= sum_r A[r][i] * E[r][n]  for i < Ni, n < Nn, r < R
// (A and E in shared memory; part is this block's global partial slot).
static __device__ void mm_tn_accum(const float* A, int lda, int Ni,
                                   const float* E, int lde, int Nn, int R,
                                   float* __restrict__ part, bool first) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  if (Nn <= NARROW_N) {
    for (int e = tid; e < Ni * Nn; e += NTHREADS) {
      const int i = e / Nn, n = e % Nn;
      float acc = 0.f;
      for (int r = 0; r < R; ++r)
        acc = fmaf(A[r * lda + i], E[r * lde + n], acc);
      float* dst = part + (size_t)i * Nn + n;
      *dst = first ? acc : *dst + acc;
    }
    __syncthreads();
    return;
  }
  for (int i0 = 0; i0 < Ni; i0 += SUP_R) {
    for (int n0 = 0; n0 < Nn; n0 += SUP_N) {
      float acc[TM][TN];
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int n = 0; n < TN; ++n) acc[m][n] = 0.f;
      for (int r = 0; r < R; ++r) {
        float a[TM], b[TN];
#pragma unroll
        for (int m = 0; m < TM; ++m) {
          int i = i0 + ty + 16 * m;
          a[m] = (i < Ni) ? A[r * lda + i] : 0.f;
        }
#pragma unroll
        for (int n = 0; n < TN; ++n) {
          int nn = n0 + tx + 16 * n;
          b[n] = (nn < Nn) ? E[r * lde + nn] : 0.f;
        }
#pragma unroll
        for (int m = 0; m < TM; ++m)
#pragma unroll
          for (int n = 0; n < TN; ++n) acc[m][n] = fmaf(a[m], b[n], acc[m][n]);
      }
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        int i = i0 + ty + 16 * m;
        if (i >= Ni) continue;
#pragma unroll
        for (int n = 0; n < TN; ++n) {
          int nn = n0 + tx + 16 * n;
          if (nn >= Nn) continue;
          float* dst = part + (size_t)i * Nn + nn;
          *dst = first ? acc[m][n] : *dst + acc[m][n];
        }
      }
    }
  }
  __syncthreads();
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

// Layer 0's pre-activation channels: the primal is X @ W0 + b0; a
// first-order channel along direction k is its seed e_k @ W0 = W0[k][:];
// higher orders start at zero.
static __device__ void layer0_fwd(const float* __restrict__ X,
                                  const float* __restrict__ prm, int N,
                                  int p0, int TP, const Net& net,
                                  const Sched& s, float* out) {
  const int C = s.C, d = net.d, w = net.w_out[0], R = TP * C;
  const float* W0 = prm + net.offW[0];
  const float* b0 = prm + net.offb[0];
  for (int e = threadIdx.x; e < R * w; e += NTHREADS) {
    int r = e / w, j = e % w, p = r / C, c = r % C, gp = p0 + p;
    float v;
    if (c == 0) {
      float acc = 0.f;
      for (int k = 0; k < d; ++k) {
        float x = (gp < N) ? X[(size_t)gp * d + k] : 0.f;
        acc = fmaf(x, W0[k * w + j], acc);
      }
      v = acc + b0[j];
    } else if (s.order[c] == 1) {
      v = W0[s.idx[c][0] * w + j];
    } else {
      v = 0.f;
    }
    out[r * net.ld + j] = v;
  }
  __syncthreads();
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

// Pre-activation channels -> post-activation channels, in place.  Thread
// (p, j) owns column j of point p across all channels; channels run from
// the highest order down, because each reads only lower-order channels.
static __device__ void act_fwd(float* buf, int ld, int TP, int w,
                               const Sched& s) {
  const int C = s.C;
  for (int e = threadIdx.x; e < TP * w; e += NTHREADS) {
    int p = e / w, j = e % w;
    float* col = buf + (p * C) * ld + j;
    const TanhChain t = tanh_chain(col[0]);
    for (int c = C - 1; c >= 1; --c) {
      const int* ix = s.idx[c];
      const float Pc = col[c * ld];
      float h;
      switch (s.order[c]) {
        case 1:
          h = t.d1 * Pc;
          break;
        case 2:
          h = t.d1 * Pc + t.d2 * col[ix[0] * ld] * col[ix[1] * ld];
          break;
        case 3: {
          const float qi = col[ix[0] * ld], qj = col[ix[1] * ld],
                      qk = col[ix[2] * ld], rij = col[ix[3] * ld],
                      rik = col[ix[4] * ld], rjk = col[ix[5] * ld];
          h = t.d3 * qi * qj * qk + t.d2 * (rij * qk + rik * qj + rjk * qi)
              + t.d1 * Pc;
          break;
        }
        default: {  // 4: unmixed along k
          const float q = col[ix[0] * ld], r = col[ix[1] * ld],
                      v = col[ix[2] * ld];
          h = t.d1 * Pc + 4.f * t.d2 * v * q + 3.f * t.d2 * r * r
              + 6.f * t.d3 * r * q * q + t.d4 * q * q * q * q;
          break;
        }
      }
      col[c * ld] = h;
    }
    col[0] = t.z;
  }
  __syncthreads();
}

// The transpose of act_fwd: cotangents dH of the post-activation channels
// -> cotangents dG of the pre-activation channels P (all [TP*C][ld]).
static __device__ void act_vjp(const float* P, const float* dH, float* dG,
                               int ld, int TP, int w, const Sched& s) {
  const int C = s.C;
  for (int e = threadIdx.x; e < TP * w; e += NTHREADS) {
    int p = e / w, j = e % w;
    const int base = (p * C) * ld + j;
    const float* col = P + base;
    const float* hc = dH + base;
    float* gc = dG + base;
    const TanhChain t = tanh_chain(col[0]);
    for (int c = 0; c < C; ++c) gc[c * ld] = 0.f;
    // cotangents of z and of the chain d1..d4 (all functions of u = P[0])
    float gz = hc[0], gd1 = 0.f, gd2 = 0.f, gd3 = 0.f, gd4 = 0.f;
    for (int c = 1; c < C; ++c) {
      const int* ix = s.idx[c];
      const float g = hc[c * ld], Pc = col[c * ld];
      gd1 += g * Pc;
      gc[c * ld] += g * t.d1;
      switch (s.order[c]) {
        case 1:
          break;
        case 2: {
          const float a = col[ix[0] * ld], b = col[ix[1] * ld];
          gd2 += g * a * b;
          gc[ix[0] * ld] += g * t.d2 * b;
          gc[ix[1] * ld] += g * t.d2 * a;
          break;
        }
        case 3: {
          const float qi = col[ix[0] * ld], qj = col[ix[1] * ld],
                      qk = col[ix[2] * ld], rij = col[ix[3] * ld],
                      rik = col[ix[4] * ld], rjk = col[ix[5] * ld];
          gd3 += g * qi * qj * qk;
          gd2 += g * (rij * qk + rik * qj + rjk * qi);
          gc[ix[0] * ld] += g * (t.d3 * qj * qk + t.d2 * rjk);
          gc[ix[1] * ld] += g * (t.d3 * qi * qk + t.d2 * rik);
          gc[ix[2] * ld] += g * (t.d3 * qi * qj + t.d2 * rij);
          gc[ix[3] * ld] += g * t.d2 * qk;
          gc[ix[4] * ld] += g * t.d2 * qj;
          gc[ix[5] * ld] += g * t.d2 * qi;
          break;
        }
        default: {  // 4
          const float q = col[ix[0] * ld], r = col[ix[1] * ld],
                      v = col[ix[2] * ld];
          gd2 += g * (4.f * v * q + 3.f * r * r);
          gd3 += g * 6.f * r * q * q;
          gd4 += g * q * q * q * q;
          gc[ix[0] * ld] += g * (4.f * t.d2 * v + 12.f * t.d3 * r * q
                                 + 4.f * t.d4 * q * q * q);
          gc[ix[1] * ld] += g * (6.f * t.d2 * r + 6.f * t.d3 * q * q);
          gc[ix[2] * ld] += g * 4.f * t.d2 * q;
          break;
        }
      }
    }
    // d z/du = d1 and d(d_k)/du = d_{k+1}; d5 = d1 (16 - 120 z^2 + 120 z^4)
    const float z2 = t.z * t.z;
    const float d5 = t.d1 * (16.f - z2 * (120.f - 120.f * z2));
    gc[0] += gz * t.d1 + gd1 * t.d2 + gd2 * t.d3 + gd3 * t.d4 + gd4 * d5;
  }
  __syncthreads();
}

static __device__ void copy_rows(const float* src, float* dst, int R, int w,
                                 int ld) {
  for (int e = threadIdx.x; e < R * w; e += NTHREADS) {
    int r = e / w, j = e % w;
    dst[r * ld + j] = src[r * ld + j];
  }
  __syncthreads();
}

// ------------------------------------------------------------------------
// The backward kernels' forward recompute over the hidden layers of one
// tile (points p0 .. p0+TP-1): stages each hidden layer's pre-activation
// channels in the block's workspace slice myws and returns the buffer
// (buf0 or buf1) holding the last hidden layer's post-activations.
static __device__ float* stage_forward(const float* __restrict__ X,
                                       const float* __restrict__ prm, int N,
                                       int p0, int TP, const Net& net,
                                       const Sched& s, float* myws,
                                       float* buf0, float* buf1, float* Bs) {
  const int C = s.C, R = TP * C, ld = net.ld;
  float* cur = buf0;
  float* oth = buf1;
  layer0_fwd(X, prm, N, p0, TP, net, s, cur);
  copy_rows(cur, myws, R, net.w_out[0], ld);
  act_fwd(cur, ld, TP, net.w_out[0], s);
  for (int l = 1; l < net.L - 1; ++l) {
    mm_smem(cur, ld, R, net.w_in[l], prm + net.offW[l], net.w_out[l], 1,
            net.w_out[l], prm + net.offb[l], C, oth, ld, Bs);
    copy_rows(oth, myws + (size_t)l * R * ld, R, net.w_out[l], ld);
    act_fwd(oth, ld, TP, net.w_out[l], s);
    float* t = cur; cur = oth; oth = t;
  }
  return cur;
}

// The reverse sweep from the head's pre-activation cotangents dP (the
// table cotangents, [TP*C][ld], columns < n_out) down to layer 0.  cur
// holds the last hidden layer's post-activations (stage_forward's result)
// and oth is the other wavefront buffer; both are clobbered, as is dP.
// Accumulates dW/db into the block's partial slot mypart (assigned on the
// block's first tile) and writes dX rows for points < N: dX = acc, or
// dX += acc when add_dX (K3 has put the coordinates' direct adjoints there).
static __device__ void reverse_sweep(const float* __restrict__ X,
                                     const float* __restrict__ prm,
                                     float* __restrict__ dX, bool add_dX,
                                     float* __restrict__ mypart,
                                     const float* myws, int N, int p0, int TP,
                                     bool first, const Net& net,
                                     const Sched& s, float* cur, float* oth,
                                     float* dP, float* Bs) {
  const int C = s.C, R = TP * C, ld = net.ld, L = net.L, n_out = net.n_out;
  const int lh = L - 1;
  mm_tn_accum(cur, ld, net.w_in[lh], dP, ld, n_out, R,
              mypart + net.offW[lh], first);
  bias_accum(dP, ld, n_out, TP, C, mypart + net.offb[lh], first);
  float* dH = oth;  // dH = dP @ W^T
  mm_smem(dP, ld, R, n_out, prm + net.offW[lh], 1, n_out, net.w_in[lh],
          nullptr, C, dH, ld, Bs);

  float* Pb = cur;
  for (int l = L - 2; l >= 0; --l) {
    const int w = net.w_out[l];
    copy_rows(myws + (size_t)l * R * ld, Pb, R, w, ld);
    act_vjp(Pb, dH, dP, ld, TP, w, s);
    if (l > 0) {
      // the layer input H_l = act(P_{l-1})
      copy_rows(myws + (size_t)(l - 1) * R * ld, Pb, R, net.w_in[l], ld);
      act_fwd(Pb, ld, TP, net.w_in[l], s);
      mm_tn_accum(Pb, ld, net.w_in[l], dP, ld, w, R, mypart + net.offW[l],
                  first);
      bias_accum(dP, ld, w, TP, C, mypart + net.offb[l], first);
      mm_smem(dP, ld, R, w, prm + net.offW[l], 1, w, net.w_in[l], nullptr,
              C, dH, ld, Bs);
    } else {
      // layer 0: the input channels are X (primal) and constant seeds
      const int d = net.d;
      const float* W0 = prm + net.offW[0];
      float* pW = mypart + net.offW[0];
      float* pb = mypart + net.offb[0];
      for (int e = threadIdx.x; e < d * w; e += NTHREADS) {
        int k = e / w, j = e % w;
        float acc = 0.f;
        for (int p = 0; p < TP; ++p) {
          int gp = p0 + p;
          float x = (gp < N) ? X[(size_t)gp * d + k] : 0.f;
          acc = fmaf(x, dP[(p * C) * ld + j], acc);
        }
        for (int c = 1; c < C; ++c) {
          if (s.order[c] != 1 || s.idx[c][0] != k) continue;
          for (int p = 0; p < TP; ++p) acc += dP[(p * C + c) * ld + j];
        }
        pW[e] = first ? acc : pW[e] + acc;
      }
      bias_accum(dP, ld, w, TP, C, pb, first);
      for (int e = threadIdx.x; e < TP * d; e += NTHREADS) {
        int p = e / d, k = e % d, gp = p0 + p;
        if (gp >= N) continue;
        float acc = 0.f;
        for (int j = 0; j < w; ++j)
          acc = fmaf(dP[(p * C) * ld + j], W0[k * w + j], acc);
        float* dst = dX + (size_t)gp * d + k;
        *dst = add_dX ? *dst + acc : acc;
      }
      __syncthreads();
    }
  }
}

// Sum the per-block partial slots (G slots of P values each) in slot
// order: deterministic, no atomics.
static __global__ void reduce_partials(const float* __restrict__ part,
                                       float* __restrict__ out, int G, int P) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= P) return;
  float acc = 0.f;
  for (int g = 0; g < G; ++g) acc += part[(size_t)g * P + e];
  out[e] = acc;
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

static inline size_t smem_bytes(int n_buf, int R, int ld) {
  return sizeof(float) * ((size_t)n_buf * R * ld + (size_t)KT * BS_LD);
}
