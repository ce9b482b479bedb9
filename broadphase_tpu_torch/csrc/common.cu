// The entry point every wrapper shares: the message of a CUDA error code.
#include <cuda_runtime.h>

extern "C" const char* bpt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
