// Helpers shared by the port's kernels. Each csrc/*.cu is built into a
// shared library of its own (ds2i_torch/kernels.py), so the C entry point
// below is defined once in each library.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ds2i {

// word i of the stream, the index clamped to [0, nw - 1] like the JAX
// package's window gathers (the pad tile reads word 0, a window past the
// stream's end its last word)
__device__ __forceinline__ uint32_t load_word(const uint32_t* __restrict__ words,
                                              long long nw, long long i) {
  i = i < 0 ? 0 : (i > nw - 1 ? nw - 1 : i);
  return __ldg(words + i);
}

}  // namespace ds2i

extern "C" const char* ds2i_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
