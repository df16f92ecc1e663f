// The f32 flavor's instances of K1's wgmma route at NP = 128
// (taylor_fwd_wg.cuh).
#include "taylor_fwd_wg.cuh"

K1WG_INSTANCES(k1wg_f32_128, FL_F32, 128)
