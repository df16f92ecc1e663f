// The instances of K3-TF32's wgmma route at NP = 256
// (wg_backward_wide.cuh).
#include "wg_backward_wide.cuh"

WBW_INSTANCES(k3wb_tf32_256, FL_TF32, true)
