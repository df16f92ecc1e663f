// The C interface of K3-TF32's wgmma route (wg_backward.cuh has the kernel
// and its note; minimax_wg_tf32_{64,128}.cu the instances; its plan is
// taylor_bwd_wg.cu's tdq_wb_plan).  Loaded with ctypes; the descriptors and
// the tape as in minimax_step.cu's C interface.
#include "wg_backward.cuh"

// K3-TF32 on this route at the plan plan_h: the weight planes into the
// workspace after the blocks' slices, the kernel (value, dW/db into the
// G = grid partial slots of P_total + 1 values; gw, gX), then
// reduce_partials into out (the parameter cotangents, then the value).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a plan the route
// has no instance of or a slot array not 16-byte aligned.
extern "C" int tdq_minimax_wg(const float* X, const float* w,
                              const float* prm, float* gw, float* gX,
                              float* part, float* ws, float* out, int N,
                              const int* net_h, const int* sched_h,
                              const int* tape_h, const float* cst_h,
                              const int* plan_h, void* stream) {
  const Net net = unpack_net(net_h);
  const Sched s = unpack_sched(sched_h);
  const Tape tp = unpack_tape(tape_h, cst_h);
  const WbPlan wp = unpack_wb(plan_h);
  if (reinterpret_cast<uintptr_t>(part) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (wp.NP == 64)
    return k3wb_tf32_64(X, w, prm, nullptr, gw, gX, part, ws, out, N, net, s,
                        &tp, wp, st);
  if (wp.NP == 128)
    return k3wb_tf32_128(X, w, prm, nullptr, gw, gX, part, ws, out, N, net,
                         s, &tp, wp, st);
  return (int)cudaErrorInvalidValue;
}
