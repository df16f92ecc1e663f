// The residual tape of the fused minimax step (K3): its layout, which K3's
// two routes share (minimax_step.cu, and the TF32 flavor's wgmma route in
// wg_backward.cuh), and the interpretation of one point as the wgmma route
// runs it (tape_point: minimax_step.cu's epilogue loop body, the point's
// coordinates read from shared memory; the epilogue keeps its own copy, so
// the mma.sync route's code stays as it was).  minimax_step.cu's header
// note says what the tape is and why the kernel interprets it.

#pragma once

#include "taylor_common.cuh"

#define MAXTIN 48     // tape inputs (table columns and coordinates used)
#define MAXTOPS 96    // tape ops
#define MAXTCONST 32  // tape constants
#define MAXEQ 8       // residual equations
#define MAXTREG (MAXTIN + MAXTOPS)

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

// One point gp < N of a tile: rows holds its table rows (channel c, output
// o at rows[c*ld + o], c < C) and is overwritten with their cotangents, x
// its d coordinates; gw[gp] gets f_e^2 and gX[gp] the coordinates' direct
// adjoints.  The tape's constants are read from cst (tp.cst itself, or the
// member's row of a family's constant table: the members of a tape group
// share tp's ops).  Returns the point's sum_e w_e * f_e^2.  Registers live
// in per-thread local arrays (dynamically indexed).
static __device__ __forceinline__ float tape_point(
    float* rows, int ld, const float* x, const float* __restrict__ w,
    float* __restrict__ gw, float* __restrict__ gX, int gp, int C,
    int n_out, int d, const Tape& tp, const float* cst) {
  const int n_tab = C * n_out, E = tp.n_eq;
  float r[MAXTREG], g[MAXTREG];
  for (int i = 0; i < tp.n_in; ++i) {
    const int s = tp.src[i];
    r[i] = (s < n_tab) ? rows[(s / n_out) * ld + s % n_out] : x[s - n_tab];
  }
  for (int k = 0; k < tp.n_ops; ++k) {
    const int a = tp.op[k][1], b = tp.op[k][2];
    float v;
    switch (tp.op[k][0]) {
      case OP_CONST: v = cst[a]; break;
      case OP_ADD: v = r[a] + r[b]; break;
      case OP_SUB: v = r[a] - r[b]; break;
      case OP_MUL: v = r[a] * r[b]; break;
      case OP_DIV: v = r[a] / r[b]; break;
      case OP_NEG: v = -r[a]; break;
      case OP_POW: v = pow_c(r[a], cst[b]); break;
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
        const float c = cst[b];
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
  return val;
}

// The C interface's tape: h = [n_in, n_ops, n_eq, src[MAXTIN],
// op[MAXTOPS*3], out[MAXEQ]], cst = [MAXTCONST] floats.
static inline Tape unpack_tape(const int* h, const float* cst) {
  Tape t;
  t.n_in = h[0]; t.n_ops = h[1]; t.n_eq = h[2];
  for (int i = 0; i < MAXTIN; ++i) t.src[i] = h[3 + i];
  for (int k = 0; k < MAXTOPS; ++k)
    for (int j = 0; j < 3; ++j) t.op[k][j] = h[3 + MAXTIN + 3 * k + j];
  for (int e = 0; e < MAXEQ; ++e) t.out[e] = h[3 + MAXTIN + 3 * MAXTOPS + e];
  for (int i = 0; i < MAXTCONST; ++i) t.cst[i] = cst[i];
  return t;
}
