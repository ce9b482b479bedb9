// Shared building block: device-wide exclusive prefix sum in three phases.
//
//   1. tile_sums_kernel     one block per tile of kTile elements writes the
//                           tile's sum of f(i);
//   2. scan_tile_sums_kernel one block turns the tile sums into exclusive
//                           tile offsets, in place, and writes the total;
//   3. the caller's kernel  calls tile_scan() to get each element's
//                           exclusive prefix (tile offset + in-tile prefix)
//                           and does its own scatter with it.
//
// f(i) is a functor giving element i's value, an int64 count.  Phase 3
// re-reads the inputs instead of storing the prefix,
// so the scan moves the input twice and writes only the tile sums.
// Used by merge.cu (kernel 6); runends.cu (kernel 2) takes only its tile
// shape.  Kernels 3 and 5 use the single pass of scan1.cuh.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bpt {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ long long shfl_up(long long v, int d) {
  return __shfl_up_sync(kFull, v, d);
}

// Exclusive prefix sum of one value per thread over a block of kThreads
// threads; *total receives the block's sum.  Every thread must call it.
template <typename T>
__device__ T block_exclusive_scan(T v, T* total) {
  __shared__ T warp_part[kThreads / 32];
  __shared__ T block_total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    T o = shfl_up(inc, d);
    if (lane >= d) inc = inc + o;
  }
  T exc = shfl_up(inc, 1);
  if (lane == 0) exc = T{};
  if (lane == 31) warp_part[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    T w = lane < kThreads / 32 ? warp_part[lane] : T{};
    T winc = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      T o = shfl_up(winc, d);
      if (lane >= d) winc = winc + o;
    }
    T wexc = shfl_up(winc, 1);
    if (lane == 0) wexc = T{};
    if (lane < kThreads / 32) warp_part[lane] = wexc;
    if (lane == kThreads / 32 - 1) block_total = winc;
  }
  __syncthreads();
  T out = exc + warp_part[warp];
  *total = block_total;
  __syncthreads();  // warp_part and block_total are reused by the next call
  return out;
}

// Phase 1.  Thread t of tile b covers elements b*kTile + t*kItems + [0, kItems).
template <typename T, typename F>
__global__ void __launch_bounds__(kThreads)
tile_sums_kernel(F f, long long n, T* tile_sums) {
  const long long base =
      (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems;
  T s{};
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    if (base + k < n) s = s + f(base + k);
  T tot;
  block_exclusive_scan(s, &tot);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = tot;
}

// Phase 2.  One block; tile sums become exclusive offsets in place.
template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_tile_sums_kernel(T* tile_sums, long long n_tiles, T* total) {
  T carry{};
  for (long long c = 0; c < n_tiles; c += kThreads) {
    const long long i = c + threadIdx.x;
    T v = i < n_tiles ? tile_sums[i] : T{};
    T chunk;
    T exc = block_exclusive_scan(v, &chunk);
    if (i < n_tiles) tile_sums[i] = carry + exc;
    carry = carry + chunk;
  }
  if (threadIdx.x == 0) *total = carry;
}

// Phase 3 helper: vals[k] = f(i) and pref[k] = exclusive prefix of element
// i = tile base + threadIdx.x*kItems + k (T{} past n).  Every thread of the
// block must call it.
template <typename T, typename F>
__device__ __forceinline__ void tile_scan(F f, long long n,
                                          const T* tile_offsets,
                                          T (&vals)[kItems],
                                          T (&pref)[kItems]) {
  const long long base =
      (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems;
  T s{};
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    vals[k] = base + k < n ? f(base + k) : T{};
    s = s + vals[k];
  }
  T tot;
  T run = tile_offsets[blockIdx.x] + block_exclusive_scan(s, &tot);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    pref[k] = run;
    run = run + vals[k];
  }
}

inline long long n_tiles_for(long long n) {
  long long t = (n + kTile - 1) / kTile;
  return t < 1 ? 1 : t;
}

// Phases 1 and 2: tile_sums (n_tiles_for(n) entries) ends as the exclusive
// tile offsets, *total as the sum over all n elements.
template <typename T, typename F>
void launch_tile_offsets(F f, long long n, T* tile_sums, T* total,
                         cudaStream_t stream) {
  const long long tiles = n_tiles_for(n);
  tile_sums_kernel<T, F><<<(unsigned)tiles, kThreads, 0, stream>>>(
      f, n, tile_sums);
  scan_tile_sums_kernel<T><<<1, kThreads, 0, stream>>>(tile_sums, tiles,
                                                       total);
}

}  // namespace bpt
