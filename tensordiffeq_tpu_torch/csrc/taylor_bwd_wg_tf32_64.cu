// The instances of K2-TF32's wgmma route at NP = 64 (wg_backward.cuh).
#include "wg_backward.cuh"

WB_INSTANCES(k2wb_tf32_64, FL_TF32, 64, false)
