// The CUDA runtime's message for an error code that an entry point of the
// kernel library returned.
#include <cuda_runtime.h>

extern "C" const char* sgmcmc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
