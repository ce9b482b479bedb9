// Kernel 3: run lengths, their exclusive prefix sum, and the compaction of
// the nonempty runs.
//
// Replaces broadphase_tpu/ops/pallas_prep.py::prep_runs.  For j < count:
//   run[j]  = max(min(e[j], count) - j - 1, 0)
//   starts  = exclusive prefix sum of run (int64: no wrap)
// and every j with run[j] > 0 becomes one entry k (in order of j):
//   sv[k] = starts[j], ab[k] = j + 1 - starts[j], bid[k] = ids[j],
//   bmeta[k] = meta[j]   (the b-side rule byte (depth << dim) | aux).
// Entries k >= m hold sv = 0x7FFF_FFFF, ab = 0, bid = PAD, bmeta = 0.
// stats receives m, total and wrapped (total >= 2^31, where the JAX
// package's int32 prefix sum wraps).
//
// The run sums and the nonempty flags are scanned together as one
// (int64, int64) pair through scan.cuh, so one scan yields both the slot
// starts and each entry's output index.  Bound on the H100: device memory,
// ~2 * (4 + 4) bytes read per element for the two scan phases plus
// 8 + 4 + 28 bytes per nonempty entry.
#include "scan.cuh"

namespace {

constexpr long long kHuge = 0x7FFFFFFFLL;
constexpr long long kPadId = 0xFFFFFFFFLL;

struct RunVal {
  const int* e;
  const long long* count;
  __device__ bpt::I64x2 operator()(long long j) const {
    const long long c = *count;
    if (j >= c) return {0, 0};
    const long long em = (long long)e[j] < c ? (long long)e[j] : c;
    const long long r = em - j - 1;
    return r > 0 ? bpt::I64x2{r, 1} : bpt::I64x2{0, 0};
  }
};

__global__ void __launch_bounds__(bpt::kThreads)
prep_scatter_kernel(RunVal f, long long n, const bpt::I64x2* tile_off,
                    const bpt::I64x2* total, const long long* ids,
                    const int* meta, long long* sv, long long* ab,
                    long long* bid, int* bmeta, long long* stats) {
  bpt::I64x2 vals[bpt::kItems], pref[bpt::kItems];
  bpt::tile_scan(f, n, tile_off, vals, pref);
  const bpt::I64x2 tot = *total;
  const long long base = (long long)blockIdx.x * bpt::kTile +
                         (long long)threadIdx.x * bpt::kItems;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    stats[0] = tot.y;
    stats[1] = tot.x;
    stats[2] = tot.x >= (1LL << 31);
  }
#pragma unroll
  for (int k = 0; k < bpt::kItems; ++k) {
    const long long j = base + k;
    if (j >= n) break;
    if (vals[k].y) {
      const long long o = pref[k].y;
      sv[o] = pref[k].x;
      ab[o] = j + 1 - pref[k].x;
      bid[o] = ids[j];
      bmeta[o] = meta[j];
    }
    if (j >= tot.y) {
      sv[j] = kHuge;
      ab[j] = 0;
      bid[j] = kPadId;
      bmeta[j] = 0;
    }
  }
}

}  // namespace

extern "C" int bpt_prep(const void* e, const void* ids, const void* meta,
                        const void* count, void* sv, void* ab, void* bid,
                        void* bmeta, void* stats, void* scratch, long long n,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  RunVal f{(const int*)e, (const long long*)count};
  // scratch: n_tiles_for(n) tile sums, then the total
  bpt::I64x2* sums = (bpt::I64x2*)scratch;
  bpt::I64x2* total = sums + bpt::n_tiles_for(n);
  bpt::launch_tile_offsets<bpt::I64x2>(f, n, sums, total, s);
  prep_scatter_kernel<<<(unsigned)bpt::n_tiles_for(n), bpt::kThreads, 0,
                        s>>>(f, n, sums, total, (const long long*)ids,
                             (const int*)meta, (long long*)sv,
                             (long long*)ab, (long long*)bid, (int*)bmeta,
                             (long long*)stats);
  return (int)cudaGetLastError();
}
