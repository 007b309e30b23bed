// The error-string entry point every kernel library exports: each C entry
// point returns a cudaError_t as int, and the Python wrapper turns a non-zero
// code into a message with this function before it raises.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* repro_torch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
