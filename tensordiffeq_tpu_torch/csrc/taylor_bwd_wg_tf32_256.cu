// The instances of K2-TF32's wgmma route at NP = 256
// (wg_backward_wide.cuh).
#include "wg_backward_wide.cuh"

WBW_INSTANCES(k2wb_tf32_256, FL_TF32, false)
