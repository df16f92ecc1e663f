// The f32 (3xTF32) instances of K3's wgmma route at NP = 256
// (wg_backward_wide.cuh).
#include "wg_backward_wide.cuh"

WBW_INSTANCES(k3wb_f32_256, FL_F32, true)
