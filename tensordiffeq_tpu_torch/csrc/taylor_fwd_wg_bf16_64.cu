// The bf16 flavor's instances of K1's wgmma route at NP = 64
// (taylor_fwd_wg.cuh).
#include "taylor_fwd_wg.cuh"

K1WG_INSTANCES(k1wg_bf16_64, FL_BF16, 64)
