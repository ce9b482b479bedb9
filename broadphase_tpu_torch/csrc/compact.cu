// Kernel 5: ordered stream compaction of up to four int64 columns.
//
// Replaces broadphase_tpu/ops/pallas_compact.py::stream_compact.  The TPU
// kernel walks the tiles in order with an SMEM carry and a staging buffer;
// here the order comes from a device-wide exclusive scan of the keep flags
// (scan.cuh), and every kept lane is scattered straight to its slot.
//
// Bound on the H100: device memory.  Per lane it reads the keep byte twice
// (scan and scatter) and each column once, and writes each column once:
// ~ n * (2 + 16 * ncols) bytes.  Lanes at or past the kept count get the
// column's fill value, written by the lane with that index, so the output
// needs no separate initialisation pass.
#include "scan.cuh"

namespace {

struct KeepFlag {
  const unsigned char* keep;
  __device__ long long operator()(long long i) const {
    return keep[i] ? 1 : 0;
  }
};

struct Columns {
  const long long* in[4];
  long long* out[4];
  long long fill[4];
  int n;
};

__global__ void __launch_bounds__(bpt::kThreads)
compact_scatter_kernel(KeepFlag f, long long n, const long long* tile_off,
                       const long long* count, Columns c) {
  long long vals[bpt::kItems], pref[bpt::kItems];
  bpt::tile_scan(f, n, tile_off, vals, pref);
  const long long kept = *count;
  const long long base = (long long)blockIdx.x * bpt::kTile +
                         (long long)threadIdx.x * bpt::kItems;
#pragma unroll
  for (int k = 0; k < bpt::kItems; ++k) {
    const long long i = base + k;
    if (i >= n) break;
    if (vals[k])
      for (int j = 0; j < c.n; ++j) c.out[j][pref[k]] = c.in[j][i];
    if (i >= kept)
      for (int j = 0; j < c.n; ++j) c.out[j][i] = c.fill[j];
  }
}

}  // namespace

extern "C" int bpt_compact(const void* keep, void* count, const void* in0,
                           const void* in1, const void* in2, const void* in3,
                           void* out0, void* out1, void* out2, void* out3,
                           long long fill0, long long fill1, long long fill2,
                           long long fill3, long long ncols, long long n,
                           void* tile_sums, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  KeepFlag f{(const unsigned char*)keep};
  Columns c{{(const long long*)in0, (const long long*)in1,
             (const long long*)in2, (const long long*)in3},
            {(long long*)out0, (long long*)out1, (long long*)out2,
             (long long*)out3},
            {fill0, fill1, fill2, fill3},
            (int)ncols};
  long long* sums = (long long*)tile_sums;
  long long* total = (long long*)count;
  bpt::launch_tile_offsets<long long>(f, n, sums, total, s);
  compact_scatter_kernel<<<(unsigned)bpt::n_tiles_for(n), bpt::kThreads, 0,
                           s>>>(f, n, sums, total, c);
  return (int)cudaGetLastError();
}

extern "C" const char* bpt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" long long bpt_scan_tile() { return bpt::kTile; }
