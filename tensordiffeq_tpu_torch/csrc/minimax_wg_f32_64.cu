// The f32 (3xTF32) instances of K3's wgmma route at NP = 64 (wg_backward.cuh).
#include "wg_backward.cuh"

WB_INSTANCES(k3wb_f32_64, FL_F32, 64, true)
