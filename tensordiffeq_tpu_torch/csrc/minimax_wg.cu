// The C interface of K3's wgmma route, in its f32 (3xTF32), TF32 and bf16
// flavors (wg_backward.cuh has the kernel and its note;
// minimax_wg_{f32,tf32,bf16}_{64,128}.cu the instances; its plan is
// taylor_bwd_wg.cu's tdq_wb_plan).  Loaded with ctypes; the descriptors and
// the tape as in minimax_step.cu's C interface, the flavor as
// taylor_common.cuh's FL_F32 / FL_TF32 / FL_BF16.
#include "wg_backward.cuh"

// K3 on this route in a flavor at the plan plan_h: the weight planes into
// the workspace after the blocks' slices, the kernel (value, dW/db into the
// G = grid partial slots of P_total + 1 values; gw, gX), then
// reduce_partials into out (the parameter cotangents, then the value).
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
  cudaStream_t st = (cudaStream_t)stream;
  int (*launch)(WB_ARGS) = nullptr;
  if (flavor == FL_F32) launch = wp.NP == 64 ? k3wb_f32_64 : k3wb_f32_128;
  if (flavor == FL_TF32) launch = wp.NP == 64 ? k3wb_tf32_64 : k3wb_tf32_128;
  if (flavor == FL_BF16) launch = wp.NP == 64 ? k3wb_bf16_64 : k3wb_bf16_128;
  if (launch == nullptr || (wp.NP != 64 && wp.NP != 128))
    return (int)cudaErrorInvalidValue;
  return launch(X, w, prm, nullptr, gw, gX, part, ws, out, N, net, s, &tp,
                wp, st);
}
