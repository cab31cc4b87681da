// Shared by every kernel library of the port: the launch-status convention.
//
// Each C entry point launches on the caller's stream, never synchronises,
// and returns cudaGetLastError() so that a refused launch (too many
// threads, too much shared memory) reaches the Python wrapper, which
// raises on any non-zero code and asks error_string() for the text.
#pragma once
#include <cuda_runtime.h>

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

static inline int launch_status() { return static_cast<int>(cudaGetLastError()); }
