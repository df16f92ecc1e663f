// The C interface of K2's wgmma route, in its f32 (3xTF32), TF32 and bf16
// flavors, and of the route's plan (wg_backward.cuh has the kernels, their
// note and the plan, wg_backward_wide.cuh the f32 and TF32 design at NP =
// 256; taylor_bwd_wg_{f32,tf32,bf16}_{64,128}.cu and
// taylor_bwd_wg_{f32,tf32}_256.cu the instances).  Loaded with ctypes;
// the descriptors as in taylor_common.cuh, the flavor as
// taylor_common.cuh's FL_F32 / FL_TF32 / FL_BF16.
#include "wg_backward.cuh"

// The route's plan (K2's and K3's alike) in a flavor into out[0 ..
// WB_PLAN_INTS) (WbPlan's fields in order); returns 1, or 0 where the
// shape is the mma.sync route's.
extern "C" int tdq_wb_plan(const int* net_h, const int* sched_h, int flavor,
                           int smem_optin, int n_sm, int N, int* out) {
  WbPlan wp;
  if (!wb_plan(unpack_net(net_h), unpack_sched(sched_h), flavor, smem_optin,
               n_sm, N, &wp))
    return 0;
  const int v[WB_PLAN_INTS] = {wp.NP, wp.CP, wp.KC, wp.S, wp.P,
                               wp.stage_bytes, wp.n_tiles, wp.grid, wp.smem,
                               wp.bulk, wp.ws_floats};
  for (int i = 0; i < WB_PLAN_INTS; ++i) out[i] = v[i];
  return 1;
}

// K2 on this route in a flavor, at the plan plan_h (as tdq_wb_plan gives
// it for that flavor; the wrapper holds its own plan to that before the
// flavor's first launch): the weight planes into the workspace after the
// blocks' slices (ws: ws_floats floats), the kernel (dW/db into the G =
// grid partial slots of P_total values, dX), then reduce_partials into
// grad.  Returns cudaGetLastError(), or cudaErrorInvalidValue for a flavor
// or plan the route has no instance of or a slot array not 16-byte
// aligned.
extern "C" int tdq_taylor_bwd_wg(const float* X, const float* prm,
                                 const float* gtab, float* dX, float* part,
                                 float* ws, float* grad, int N,
                                 const int* net_h, const int* sched_h,
                                 int flavor, const int* plan_h,
                                 void* stream) {
  const Net net = unpack_net(net_h);
  const Sched s = unpack_sched(sched_h);
  const WbPlan wp = unpack_wb(plan_h);
  if (reinterpret_cast<uintptr_t>(part) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int (*launch)(WB_ARGS) = nullptr;
  if (flavor == FL_F32) launch = wp.NP == 64 ? k2wb_f32_64 : k2wb_f32_128;
  if (flavor == FL_TF32) launch = wp.NP == 64 ? k2wb_tf32_64 : k2wb_tf32_128;
  if (flavor == FL_BF16) launch = wp.NP == 64 ? k2wb_bf16_64 : k2wb_bf16_128;
  if (wp.NP == 256)
    launch = flavor == FL_F32 ? k2wb_f32_256
                              : (flavor == FL_TF32 ? k2wb_tf32_256 : nullptr);
  else if (wp.NP != 64 && wp.NP != 128) launch = nullptr;
  if (launch == nullptr) return (int)cudaErrorInvalidValue;
  return launch(X, nullptr, prm, gtab, nullptr, dX, part, ws, grad, N, net,
                s, nullptr, nullptr, 1, wp.grid, wp, st);
}
