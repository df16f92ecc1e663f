// The C interface of K3's wgmma route, in its f32 (3xTF32), TF32 and bf16
// flavors, for one network and for a member axis of M networks
// (wg_backward.cuh has the kernel and its note, wg_backward_wide.cuh the
// f32 and TF32 design at NP = 256; minimax_wg_{f32,tf32,bf16}_{64,128}.cu
// and minimax_wg_{f32,tf32}_256.cu the instances; its plan is
// taylor_bwd_wg.cu's tdq_wb_plan).  Loaded with ctypes; the descriptors and
// the tape as in minimax_step.cu's C interface, the flavor as
// taylor_common.cuh's FL_F32 / FL_TF32 / FL_BF16.
#include "wg_backward.cuh"

typedef int (*K3wbLaunch)(WB_ARGS);

// The route's launch in a flavor and at a plan, or nullptr.
static K3wbLaunch k3wb_launch(int flavor, const WbPlan& wp) {
  if (wp.NP == 256)
    return flavor == FL_F32 ? k3wb_f32_256
                            : (flavor == FL_TF32 ? k3wb_tf32_256 : nullptr);
  if (wp.NP != 64 && wp.NP != 128) return nullptr;
  if (flavor == FL_F32) return wp.NP == 64 ? k3wb_f32_64 : k3wb_f32_128;
  if (flavor == FL_TF32) return wp.NP == 64 ? k3wb_tf32_64 : k3wb_tf32_128;
  if (flavor == FL_BF16) return wp.NP == 64 ? k3wb_bf16_64 : k3wb_bf16_128;
  return nullptr;
}

// K3 on this route in a flavor at the plan plan_h: the weight planes into
// the workspace after the blocks' slices, the kernel (value, dW/db into
// the G = grid partial slots of P_total + 1 values; gw, gX), then the
// slots' sum into out (the parameter cotangents, then the value).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a flavor or plan
// the route has no instance of or a slot array not 16-byte aligned.
extern "C" int tdq_minimax_wg(const float* X, const float* w,
                              const float* prm, float* gw, float* gX,
                              float* part, float* ws, float* out, int N,
                              const int* net_h, const int* sched_h,
                              const int* tape_h, const float* cst_h,
                              int flavor, const int* plan_h, void* stream) {
  const Net net = unpack_net(net_h);
  const Sched s = unpack_sched(sched_h);
  const Tape tp = unpack_tape(tape_h, cst_h);
  const WbPlan wp = unpack_wb(plan_h);
  if (reinterpret_cast<uintptr_t>(part) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const K3wbLaunch launch = k3wb_launch(flavor, wp);
  if (launch == nullptr) return (int)cudaErrorInvalidValue;
  return launch(X, w, prm, nullptr, gw, gX, part, ws, out, N, net, s, &tp,
                nullptr, 1, wp.grid, wp, (cudaStream_t)stream);
}

// K3 on this route over M members that share N, the plan and the tape's
// ops (tape_h; their constants are cst, a device table of MAXTCONST floats
// a member): X [M, N, d], w and gw [M, N, E], prm [M, P_total], gX [M, N,
// d], out [M, P_total + 1]; part holds M * plan.grid slots (member m's G =
// plan.grid slots after the members' before it), ws grid * (L - 1) * 128 *
// NP floats of the blocks' slices and then M members' planes.  One launch
// of the member planes, one of the kernel on grid persistent blocks
// (1 <= grid <= M * G), one of the members' slot sums: each member's
// outputs are its single launch's bit for bit (wg_backward.cuh).  Returns
// cudaGetLastError(), or cudaErrorInvalidValue as tdq_minimax_wg does and
// for M < 1 or a grid out of range.
extern "C" int tdq_minimax_wg_family(const float* X, const float* w,
                                     const float* prm, float* gw, float* gX,
                                     float* part, float* ws, float* out,
                                     int N, int M, int grid,
                                     const int* net_h, const int* sched_h,
                                     const int* tape_h, const float* cst,
                                     int flavor, const int* plan_h,
                                     void* stream) {
  const Net net = unpack_net(net_h);
  const Sched s = unpack_sched(sched_h);
  const float unused[MAXTCONST] = {};  // the constants are cst's
  const Tape tp = unpack_tape(tape_h, unused);
  const WbPlan wp = unpack_wb(plan_h);
  if (reinterpret_cast<uintptr_t>(part) % 16 != 0 || M < 1 || grid < 1 ||
      (long long)grid > (long long)M * wp.grid || cst == nullptr)
    return (int)cudaErrorInvalidValue;
  const K3wbLaunch launch = k3wb_launch(flavor, wp);
  if (launch == nullptr) return (int)cudaErrorInvalidValue;
  return launch(X, w, prm, nullptr, gw, gX, part, ws, out, N, net, s, &tp,
                cst, M, grid, wp, (cudaStream_t)stream);
}
