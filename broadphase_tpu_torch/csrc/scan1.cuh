// Shared building block: single-pass device-wide exclusive scan by
// decoupled look-back (Merrill and Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back", 2016).
//
// A caller's kernel launches one block per tile.  Each block
//   1. takes its tile index from an atomic ticket (take_ticket), so tiles
//      are numbered in the order their blocks started and a tile only ever
//      waits on tiles whose blocks are already running;
//   2. reduces its tile to one 32-bit aggregate;
//   3. calls lookback() from one whole warp: it publishes the aggregate in
//      the tile's status word, walks back over the predecessors' words 32
//      at a time until it meets an inclusive prefix, and publishes its own
//      inclusive prefix.  Flag and value share one 64-bit word, so a single
//      load sees both and no fence is needed between them.
//
// The scratch is n_tiles status words followed by the ticket.  It needs a
// clean start on every call: the caller's C entry point clears it with
// clear() (cudaMemsetAsync on the caller's stream) before the launch.
// lookback() scans 32-bit values: compact.cu (kernel 5) and merge.cu
// (kernel 6) each scan fewer than 2^31 kept lanes.
//
// lookback_wide() scans a (sum, count) pair of 62-bit values, for prep.cu
// (kernel 3), whose run-length sum reaches about cap^2 / 2.  A tile's
// status is two 64-bit words, the sum and the count, each with the flag in
// its top two bits.  The two words are written one after the other, so a
// reader may see them in different states; it reads both again until their
// flags are set and equal.  Each word only goes empty -> aggregate ->
// prefix, so two equal flags are one state of the tile, and again no fence
// is needed.  Its scratch is 2 * n_tiles words followed by the ticket
// (wide::clear, wide::take_ticket).
#pragma once

#include <cuda_runtime.h>

namespace bpt {
namespace onepass {

constexpr unsigned long long kAggregate = 1ull << 32;  // flag: tile sum only
constexpr unsigned long long kPrefix = 2ull << 32;     // flag: inclusive prefix
constexpr unsigned kFullMask = 0xffffffffu;

// Words of scratch a scan over n_tiles tiles needs.
inline long long scratch_words(long long n_tiles) { return n_tiles + 1; }

inline cudaError_t clear(unsigned long long* scratch, long long n_tiles,
                         cudaStream_t stream) {
  return cudaMemsetAsync(scratch, 0,
                         scratch_words(n_tiles) * sizeof(unsigned long long),
                         stream);
}

// The block's tile index, in the order the blocks started.  Every thread of
// the block must call it, once.
__device__ __forceinline__ int take_ticket(unsigned long long* scratch,
                                           long long n_tiles) {
  __shared__ int tile;
  if (threadIdx.x == 0) tile = (int)atomicAdd(scratch + n_tiles, 1ull);
  __syncthreads();
  return tile;
}

__device__ __forceinline__ void store_status(unsigned long long* word,
                                             unsigned long long v) {
  *(volatile unsigned long long*)word = v;
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* word) {
  return *(const volatile unsigned long long*)word;
}

// Called by one whole warp of the block that owns `tile`.  Publishes
// `aggregate`, returns the tile's exclusive prefix (the sum of the
// aggregates of tiles 0 .. tile-1) to every lane, and publishes the
// inclusive prefix.
__device__ __forceinline__ unsigned lookback(unsigned long long* status,
                                             int tile, unsigned aggregate) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) store_status(status, kPrefix | aggregate);
    return 0;
  }
  if (lane == 0) store_status(status + tile, kAggregate | aggregate);
  unsigned exclusive = 0;
  for (int end = tile - 1;; end -= 32) {
    // lane l reads tile end - l; before tile 0 reads as a prefix of 0
    const int i = end - lane;
    unsigned long long w;
    do {
      w = i >= 0 ? load_status(status + i) : kPrefix;
    } while (__any_sync(kFullMask, (w >> 32) == 0));
    const unsigned prefixes = __ballot_sync(kFullMask, (w & kPrefix) != 0);
    unsigned v = (unsigned)w;
    if (prefixes) {  // stop at the nearest inclusive prefix
      if (lane > __ffs(prefixes) - 1) v = 0;
      exclusive += __reduce_add_sync(kFullMask, v);
      break;
    }
    exclusive += __reduce_add_sync(kFullMask, v);
  }
  if (lane == 0) store_status(status + tile, kPrefix | (exclusive + aggregate));
  return exclusive;
}

namespace wide {

constexpr int kFlagShift = 62;
constexpr unsigned long long kAggregate = 1ull << kFlagShift;
constexpr unsigned long long kPrefix = 2ull << kFlagShift;
constexpr unsigned long long kValue = kAggregate - 1;

struct Pair {
  long long sum, count;  // each in [0, 2^62)
};

inline long long scratch_words(long long n_tiles) { return 2 * n_tiles + 1; }

inline cudaError_t clear(unsigned long long* scratch, long long n_tiles,
                         cudaStream_t stream) {
  return cudaMemsetAsync(scratch, 0,
                         scratch_words(n_tiles) * sizeof(unsigned long long),
                         stream);
}

__device__ __forceinline__ int take_ticket(unsigned long long* scratch,
                                           long long n_tiles) {
  return onepass::take_ticket(scratch, 2 * n_tiles);
}

__device__ __forceinline__ void publish(unsigned long long* status, int tile,
                                        unsigned long long flag, Pair v) {
  store_status(status + 2 * tile, flag | (unsigned long long)v.sum);
  store_status(status + 2 * tile + 1, flag | (unsigned long long)v.count);
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFullMask, v, d);
  return v;
}

// lookback() for a (sum, count) pair: called by one whole warp of the
// block that owns `tile`; returns the sums of tiles 0 .. tile-1 to every
// lane.
__device__ __forceinline__ Pair lookback(unsigned long long* status, int tile,
                                         Pair aggregate) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) publish(status, 0, kPrefix, aggregate);
    return {0, 0};
  }
  if (lane == 0) publish(status, tile, kAggregate, aggregate);
  Pair exclusive{0, 0};
  for (int end = tile - 1;; end -= 32) {
    // lane l reads tile end - l; before tile 0 reads as a prefix of 0
    const int i = end - lane;
    unsigned long long s, c;
    bool ready;
    do {
      s = i >= 0 ? load_status(status + 2 * i) : kPrefix;
      c = i >= 0 ? load_status(status + 2 * i + 1) : kPrefix;
      ready = (s >> kFlagShift) != 0 && (s >> kFlagShift) == (c >> kFlagShift);
    } while (!__all_sync(kFullMask, ready));
    const unsigned prefixes = __ballot_sync(kFullMask, (s & kPrefix) != 0);
    // stop at the nearest inclusive prefix
    const bool counted = !prefixes || lane <= __ffs(prefixes) - 1;
    exclusive.sum += warp_sum(counted ? (long long)(s & kValue) : 0);
    exclusive.count += warp_sum(counted ? (long long)(c & kValue) : 0);
    if (prefixes) break;
  }
  if (lane == 0)
    publish(status, tile, kPrefix,
            {exclusive.sum + aggregate.sum, exclusive.count + aggregate.count});
  return exclusive;
}

}  // namespace wide
}  // namespace onepass
}  // namespace bpt
