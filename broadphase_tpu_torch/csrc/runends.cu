// Kernel 2: descendant-run ends, e[j] = 1 + min{ i >= j : lca[i] < depth[j] }.
//
// Replaces broadphase_tpu/ops/pallas_runends.py::run_ends.  The TPU kernel
// walks the tiles backward with one SMEM carry per depth level; blocks on
// the H100 run in no order, so the carry becomes its own pass:
//
//   A. per tile and depth level d: the first position in the tile with
//      lca < d (INT_MAX if none);
//   B. per depth level, an exclusive suffix minimum of A over the tiles:
//      the first qualifying position in any LATER tile;
//   C. per tile: each thread's first qualifying position per level over its
//      kItems elements, an exclusive suffix minimum over the block's threads
//      (merged with B's carry), then each element checks its own thread's
//      remaining elements.
//
// Every element does a bounded amount of work, whatever the run lengths:
// a depth-0 object, whose run covers the whole tree, costs the same as any
// other.  Bound on the H100: device memory, two int32 reads and one int32
// write per element plus one pass over the inputs for A.
#include "scan.cuh"

#include <climits>

namespace {

constexpr int kMaxDepths = 32;
constexpr int kInf = INT_MAX;

__device__ __forceinline__ void load_items(const int* lca, long long n,
                                           long long base,
                                           int (&l)[bpt::kItems]) {
#pragma unroll
  for (int k = 0; k < bpt::kItems; ++k)
    l[k] = base + k < n ? lca[base + k] : INT_MAX;  // never qualifies
}

// First position among this thread's elements with lca < d.
__device__ __forceinline__ int thread_first(const int (&l)[bpt::kItems],
                                            int pos0, int d) {
  int f = kInf;
#pragma unroll
  for (int k = bpt::kItems - 1; k >= 0; --k)
    if (l[k] < d) f = pos0 + k;
  return f;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(bpt::kFull, v, o));
  return v;
}

__global__ void __launch_bounds__(bpt::kThreads)
tile_first_kernel(const int* lca, long long n, int n_depths, int* tile_first) {
  __shared__ int s_first[kMaxDepths];
  if (threadIdx.x < kMaxDepths) s_first[threadIdx.x] = kInf;
  __syncthreads();
  const long long base = (long long)blockIdx.x * bpt::kTile +
                         (long long)threadIdx.x * bpt::kItems;
  int l[bpt::kItems];
  load_items(lca, n, base, l);
  for (int d = 0; d < n_depths; ++d) {
    const int f = warp_min(thread_first(l, (int)base, d));
    if ((threadIdx.x & 31) == 0 && f != kInf) atomicMin(&s_first[d], f);
  }
  __syncthreads();
  if (threadIdx.x < n_depths)
    tile_first[(long long)blockIdx.x * n_depths + threadIdx.x] =
        s_first[threadIdx.x];
}

// One block per depth level: carry[t][d] = min over tiles t' > t of
// tile_first[t'][d].  Thread order walks the tiles from the last one.
__global__ void __launch_bounds__(bpt::kThreads)
carry_kernel(const int* tile_first, long long n_tiles, int n_depths,
             int* carry) {
  const int d = blockIdx.x;
  __shared__ int s_part[bpt::kThreads / 32];
  int running = kInf;
  for (long long c = 0; c < n_tiles; c += bpt::kThreads) {
    const long long r = c + threadIdx.x;          // rank from the end
    const long long t = n_tiles - 1 - r;
    int v = r < n_tiles ? tile_first[t * n_depths + d] : kInf;
    // exclusive min-scan over the thread order
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int inc = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int u = __shfl_up_sync(bpt::kFull, inc, o);
      if (lane >= o) inc = min(inc, u);
    }
    int exc = __shfl_up_sync(bpt::kFull, inc, 1);
    if (lane == 0) exc = kInf;
    if (lane == 31) s_part[warp] = inc;
    __syncthreads();
    int before = running;
    for (int w = 0; w < warp; ++w) before = min(before, s_part[w]);
    int chunk = running;
    for (int w = 0; w < bpt::kThreads / 32; ++w) chunk = min(chunk, s_part[w]);
    if (r < n_tiles) carry[t * n_depths + d] = min(before, exc);
    __syncthreads();
    running = chunk;
  }
}

__global__ void __launch_bounds__(bpt::kThreads)
run_ends_kernel(const int* lca, const int* depth, long long n, int n_depths,
                const int* carry, int* e) {
  // s_after[d][t]: first qualifying position for level d after thread t's
  // elements (later threads of this tile, then later tiles)
  __shared__ int s_after[kMaxDepths][bpt::kThreads];
  const long long base = (long long)blockIdx.x * bpt::kTile +
                         (long long)threadIdx.x * bpt::kItems;
  int l[bpt::kItems];
  load_items(lca, n, base, l);
  for (int d = 0; d < n_depths; ++d)
    s_after[d][threadIdx.x] = thread_first(l, (int)base, d);
  __syncthreads();

  // warp w resolves levels w, w + 8, ...; lane q owns threads 8q .. 8q + 7
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kPer = bpt::kThreads / 32;
  for (int d = warp; d < n_depths; d += bpt::kThreads / 32) {
    int own = kInf;
#pragma unroll
    for (int q = 0; q < kPer; ++q) own = min(own, s_after[d][lane * kPer + q]);
    int inc = own;  // suffix min over lanes >= lane
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int u = __shfl_down_sync(bpt::kFull, inc, o);
      if (lane + o < 32) inc = min(inc, u);
    }
    int after = __shfl_down_sync(bpt::kFull, inc, 1);
    const int c = carry[(long long)blockIdx.x * n_depths + d];
    after = lane == 31 ? c : min(after, c);
#pragma unroll
    for (int q = kPer - 1; q >= 0; --q) {
      const int v = s_after[d][lane * kPer + q];
      s_after[d][lane * kPer + q] = after;
      after = min(after, v);
    }
  }
  __syncthreads();

#pragma unroll
  for (int k = 0; k < bpt::kItems; ++k) {
    const long long j = base + k;
    if (j >= n) break;
    const int dj = depth[j];
    if (dj < 0 || dj >= n_depths) {
      e[j] = 0;
      continue;
    }
    int ans = s_after[dj][threadIdx.x];
#pragma unroll
    for (int q = bpt::kItems - 1; q >= k; --q)
      if (l[q] < dj) ans = (int)base + q;
    e[j] = ans + 1;
  }
}

}  // namespace

extern "C" int bpt_runends(const void* lca, const void* depth, void* e,
                           void* tile_first, void* carry, long long n,
                           long long n_depths, void* stream) {
  if (n_depths < 1 || n_depths > kMaxDepths || n >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const long long tiles = bpt::n_tiles_for(n);
  tile_first_kernel<<<(unsigned)tiles, bpt::kThreads, 0, s>>>(
      (const int*)lca, n, (int)n_depths, (int*)tile_first);
  carry_kernel<<<(unsigned)n_depths, bpt::kThreads, 0, s>>>(
      (const int*)tile_first, tiles, (int)n_depths, (int*)carry);
  run_ends_kernel<<<(unsigned)tiles, bpt::kThreads, 0, s>>>(
      (const int*)lca, (const int*)depth, n, (int)n_depths,
      (const int*)carry, (int*)e);
  return (int)cudaGetLastError();
}
