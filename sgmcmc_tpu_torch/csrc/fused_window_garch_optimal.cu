// The fused window of fused_window.cuh on GarchOptimalBody (garch_body.cuh):
// its eight variants (host or in-kernel normals, with or without the ESS
// gate and the valid gate) behind the entry points
// sgmcmc_fused_window_garch_optimal(_smem).
#include "fused_window.cuh"
#include "garch_body.cuh"

SGMCMC_FUSED_WINDOW_ENTRY(garch_optimal, GarchOptimalBody)
