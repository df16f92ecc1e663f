// The instances of K3-bf16's wgmma route at NP = 64 (wg_backward.cuh).
#include "wg_backward.cuh"

WB_INSTANCES(k3wb_bf16_64, FL_BF16, 64, true)
