// The f32 (3xTF32) instances of K2's wgmma route at NP = 128 (wg_backward.cuh).
#include "wg_backward.cuh"

WB_INSTANCES(k2wb_f32_128, FL_F32, 128, false)
