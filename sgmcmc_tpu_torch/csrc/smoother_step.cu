// The unfused smoother's window step of smoother_step.cuh on the fused
// window's bodies whose unfused kernels run the same operations in the same
// order (svm_body.cuh, garch_body.cuh), behind the entry points
// sgmcmc_smoother_step_<body>.
#include "smoother_step.cuh"
#include "garch_body.cuh"
#include "svm_body.cuh"

SGMCMC_SMOOTHER_STEP_ENTRY(svm, SvmBody)
SGMCMC_SMOOTHER_STEP_ENTRY(garch_optimal, GarchOptimalBody)
SGMCMC_SMOOTHER_STEP_ENTRY(garch_prior, GarchPriorBody)
