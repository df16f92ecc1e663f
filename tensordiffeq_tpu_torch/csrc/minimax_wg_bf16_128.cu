// The instances of K3-bf16's wgmma route at NP = 128 (wg_backward.cuh).
#include "wg_backward.cuh"

WB_INSTANCES(k3wb_bf16_128, FL_BF16, 128, true)
