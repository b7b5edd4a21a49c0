// Error strings for the kernels' plain-C entry points (see common.cuh).
#include <cuda_runtime.h>

#include "common.cuh"

extern "C" const char* sldm_error_string(int code) {
  if (code == SLDM_ERR_SMEM)
    return "the kernel needs more shared memory than one block may use on this device";
  if (code == SLDM_ERR_SHAPE) return "a size the kernel does not take";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
