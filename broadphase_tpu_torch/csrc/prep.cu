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
// package's int32 prefix sum wraps).  The v2 scan's expansion has no rule
// and passes no meta: the kMeta = false instantiation neither reads meta
// nor writes bmeta.
//
// One pass over the data, by decoupled look-back (scan1.cuh, the wide
// variant: the run sums need 64 bits):
//
//  - a block takes a tile of 4096 lanes from the ticket.  In row r, lane l
//    of warp w loads e of tile lane 512w + 32r + l (128 contiguous bytes a
//    warp), and turns it into its run length.  It asks L2 for the tile's
//    ids and meta at the same time, so that their reads overlap the scan;
//  - each warp sums its 512 runs and counts the nonempty ones; warp 0
//    scans the 8 warps' pairs and looks back for the tile's (sum, count)
//    prefix;
//  - each warp walks its rows again: a shuffle scan of the row's runs and
//    a ballot of the nonempty lanes give every nonempty lane its start and
//    its slot; start and lane are staged in shared memory in order;
//  - the staged entries are written as the run [prefix count, + kept) with
//    coalesced stores; ids and meta are read from the staged lanes (L2
//    hits after the request above);
//  - lanes that are not kept take the fill with no second launch: the
//    dropped lanes of tile t (size - kept) fill the run of output positions
//    that ends D_t before cap, D_t = 4096 t - prefix count being the lanes
//    dropped by the tiles before t.  These runs tile [m, cap) exactly;
//  - the block that takes the last ticket writes m, total and wrapped from
//    its inclusive prefix.
//
// The entry point clears the status words and the ticket with one
// cudaMemsetAsync (16 bytes a tile), so the kernel keeps no state across
// calls.  Bound on the H100: device memory, 4 + 8 + 4 bytes read and
// 8 + 8 + 8 + 4 bytes written per lane.
#include <cuda_runtime.h>

#include "scan1.cuh"

namespace {

namespace wide = bpt::onepass::wide;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                     // 32-lane rows a warp owns
constexpr int kTile = kThreads * kRows;       // 4096 lanes
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kHuge = 0x7FFFFFFFLL;
constexpr long long kPadId = 0xFFFFFFFFLL;

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// four blocks an SM: at most 64 registers a thread
template <bool kMeta>
__global__ void __launch_bounds__(kThreads, 4)
prep_onepass_kernel(const int* e, const long long* ids, const int* meta,
                    const long long* count, long long n, long long* sv,
                    long long* ab, long long* bid, int* bmeta,
                    long long* stats, unsigned long long* scratch,
                    int n_tiles) {
  __shared__ long long stage_start[kTile];
  __shared__ unsigned short stage_lane[kTile];
  __shared__ long long warp_sum[kWarps];
  __shared__ int warp_kept[kWarps];
  __shared__ long long tile_sum, tile_off;
  __shared__ int tile_kept;
  __shared__ long long s_count;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_count = *count;
  const int tile = wide::take_ticket(scratch, n_tiles);  // syncs the block
  const long long base = (long long)tile * kTile;
  const int size = (int)min(n - base, (long long)kTile);
  const long long c = s_count;

  // ids: 32 KB of the tile, 128 bytes a thread; meta: 16 KB, 128 threads
  const int t = threadIdx.x;
  if (16 * t < size) prefetch_l2(ids + base + 16 * t);
  if (kMeta && 32 * t < size) prefetch_l2(meta + base + 32 * t);

  // run lengths of tile lanes 512 warp + 32 r + lane
  const long long row0 = base + 32 * kRows * warp + lane;
  int run[kRows];
  long long sum = 0;
  int kept = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long j = row0 + 32 * r;
    long long len = 0;
    if (j < n && j < c) {
      const long long em = min((long long)__ldcs(e + j), c);
      len = max(em - j - 1, 0LL);
    }
    run[r] = (int)len;  // len < count <= cap < 2^31
    sum += len;
    kept += __popc(__ballot_sync(kFull, len > 0));
  }
  sum = wide::warp_sum(sum);
  if (lane == 0) {
    warp_sum[warp] = sum;
    warp_kept[warp] = kept;
  }
  __syncthreads();

  // warp 0: the warps' offsets within the tile, then the tile's prefix
  if (warp == 0) {
    long long ws = lane < kWarps ? warp_sum[lane] : 0;
    int wk = lane < kWarps ? warp_kept[lane] : 0;
    long long is = ws;
    int ik = wk;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const long long os = __shfl_up_sync(kFull, is, d);
      const int ok = __shfl_up_sync(kFull, ik, d);
      if (lane >= d) {
        is += os;
        ik += ok;
      }
    }
    const long long tsum = __shfl_sync(kFull, is, kWarps - 1);
    const int tkept = __shfl_sync(kFull, ik, kWarps - 1);
    if (lane < kWarps) {
      warp_sum[lane] = is - ws;
      warp_kept[lane] = ik - wk;
    }
    const wide::Pair x = wide::lookback(scratch, tile, {tsum, tkept});
    if (lane == 0) {
      tile_sum = x.sum;
      tile_off = x.count;
      tile_kept = tkept;
      if (tile == n_tiles - 1) {
        const long long total = x.sum + tsum;
        stats[0] = x.count + tkept;
        stats[1] = total;
        stats[2] = total >= (1LL << 31);
      }
    }
  }
  __syncthreads();

  // every nonempty lane's start and slot, staged in order
  long long start = tile_sum + warp_sum[warp];
  int slot = warp_kept[warp];
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long v = run[r];
    long long inc = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long o = __shfl_up_sync(kFull, inc, d);
      if (lane >= d) inc += o;
    }
    const unsigned nz = __ballot_sync(kFull, v > 0);
    if (v > 0) {
      const int k = slot + __popc(nz & below);
      stage_start[k] = start + inc - v;
      stage_lane[k] = (unsigned short)(32 * kRows * warp + 32 * r + lane);
    }
    start += __shfl_sync(kFull, inc, 31);
    slot += __popc(nz);
  }
  __syncthreads();

  const long long out = tile_off;
  const int n_kept = tile_kept;
#pragma unroll 4
  for (int i = t; i < n_kept; i += kThreads) {
    const long long s = stage_start[i];
    const long long j = base + stage_lane[i];
    sv[out + i] = s;
    ab[out + i] = j + 1 - s;
    bid[out + i] = ids[j];
    if (kMeta) bmeta[out + i] = meta[j];
  }
  const int dropped = size - n_kept;
  const long long fill = (n - base - size) + out + n_kept;
  for (int i = t; i < dropped; i += kThreads) {
    sv[fill + i] = kHuge;
    ab[fill + i] = 0;
    bid[fill + i] = kPadId;
    if (kMeta) bmeta[fill + i] = 0;
  }
}

}  // namespace

extern "C" int bpt_prep(const void* e, const void* ids, const void* meta,
                        const void* count, void* sv, void* ab, void* bid,
                        void* bmeta, void* stats, void* scratch, long long n,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0) return (int)cudaMemsetAsync(stats, 0, 3 * sizeof(long long), s);
  const long long tiles = (n + kTile - 1) / kTile;
  unsigned long long* words = (unsigned long long*)scratch;
  const cudaError_t err = wide::clear(words, tiles, s);
  if (err != cudaSuccess) return (int)err;
  const auto kernel = meta != nullptr ? &prep_onepass_kernel<true>
                                      : &prep_onepass_kernel<false>;
  kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
      (const int*)e, (const long long*)ids, (const int*)meta,
      (const long long*)count, n, (long long*)sv, (long long*)ab,
      (long long*)bid, (int*)bmeta, (long long*)stats, words, (int)tiles);
  return (int)cudaGetLastError();
}

// Lanes a block of the kernel takes; the wrapper sizes the scratch with it
// (two status words a tile, then the ticket).
extern "C" long long bpt_prep_tile() { return kTile; }
