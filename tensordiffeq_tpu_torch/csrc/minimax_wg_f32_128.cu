// The f32 (3xTF32) instances of K3's wgmma route at NP = 128 (wg_backward.cuh).
#include "wg_backward.cuh"

WB_INSTANCES(k3wb_f32_128, FL_F32, 128, true)
