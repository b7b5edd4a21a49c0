// Error codes shared by the kernels' plain-C entry points. Every entry
// point returns 0, a cudaError_t from cudaGetLastError() after its launch,
// or one of the codes below (all above any cudaError_t value).
#pragma once

#define SLDM_ERR_SMEM 100001   // needs more shared memory than a block may have
#define SLDM_ERR_SHAPE 100002  // a size the kernel does not take
