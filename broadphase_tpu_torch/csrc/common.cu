// Entry points every wrapper shares: the message of a CUDA error code, and
// the tile of the three-phase scan (scan.cuh), with which the run-ends and
// merge wrappers size their scratch.
#include <cuda_runtime.h>

#include "scan.cuh"

extern "C" const char* bpt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" long long bpt_scan_tile() { return bpt::kTile; }
