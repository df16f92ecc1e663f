// The C interface of K1's wgmma route (taylor_fwd_wg.cuh has the kernel,
// its note and its plan; taylor_fwd_wg_{f32,bf16}_{64,128}.cu its
// instances).  Loaded with ctypes; the descriptors and the flavor argument
// (FL_F32, FL_BF16 or FL_TF32) as in taylor_common.cuh.
#include "taylor_fwd_wg.cuh"

// The route's plan into out[0 .. WG_PLAN_INTS) (WgPlan's fields in order);
// returns 1, or 0 where the shape is taylor_table.cu's route.
extern "C" int tdq_k1wg_plan(const int* net_h, const int* sched_h,
                             int flavor, int smem_optin, int n_sm, int N,
                             int* out) {
  WgPlan wp;
  if (!wg_plan(unpack_net(net_h), unpack_sched(sched_h), flavor, smem_optin,
               n_sm, N, &wp))
    return 0;
  const int v[WG_PLAN_INTS] = {wp.NP, wp.CP, wp.KC, wp.S, wp.P, wp.resident,
                               wp.stage_bytes, wp.n_tiles, wp.grid, wp.smem};
  for (int i = 0; i < WG_PLAN_INTS; ++i) out[i] = v[i];
  return 1;
}

// K1 on this route, at the plan plan_h (WgPlan's fields in order, as
// tdq_k1wg_plan gives them; the wrapper holds its own plan to that before a
// flavor's first launch): the weights' chunks into wprep (P * stage_bytes
// bytes), then the table.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan the route has no instance of.
extern "C" int tdq_taylor_fwd_wg(const float* X, const float* prm,
                                 void* wprep, float* table, int N,
                                 const int* net_h, const int* sched_h,
                                 int flavor, const int* plan_h,
                                 void* stream) {
  const Net net = unpack_net(net_h);
  const Sched s = unpack_sched(sched_h);
  const WgPlan wp{plan_h[0], plan_h[1], plan_h[2], plan_h[3], plan_h[4],
                  plan_h[5], plan_h[6], plan_h[7], plan_h[8], plan_h[9]};
  cudaStream_t st = (cudaStream_t)stream;
  char* w = static_cast<char*>(wprep);
  if (flavor == FL_F32 && wp.NP == 64)
    return k1wg_f32_64(X, prm, w, table, N, net, s, wp, st);
  if (flavor == FL_F32 && wp.NP == 128)
    return k1wg_f32_128(X, prm, w, table, N, net, s, wp, st);
  if (flavor == FL_BF16 && wp.NP == 64)
    return k1wg_bf16_64(X, prm, w, table, N, net, s, wp, st);
  if (flavor == FL_BF16 && wp.NP == 128)
    return k1wg_bf16_128(X, prm, w, table, N, net, s, wp, st);
  if (flavor == FL_TF32 && wp.NP == 64)
    return k1wg_tf32_64(X, prm, w, table, N, net, s, wp, st);
  if (flavor == FL_TF32 && wp.NP == 128)
    return k1wg_tf32_128(X, prm, w, table, N, net, s, wp, st);
  return (int)cudaErrorInvalidValue;
}
