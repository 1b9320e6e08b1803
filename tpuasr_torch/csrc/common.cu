// Shared C entry points of the tpuasr_torch kernel library.
#include <cuda_runtime.h>

extern "C" const char* tpuasr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
