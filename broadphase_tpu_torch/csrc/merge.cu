// Kernel 6: merge a sorted churn buffer into the sorted tree, cancel each
// tombstone with its twin, and compact.
//
// Replaces broadphase_tpu/ops/pallas_merge.py::merge_cancel_compact.  Both
// inputs are (key, meta) int64 column pairs sorted lexicographically;
// meta's lowest bit is the tag (1 = tombstone or pad) and a tombstone
// equals the tree entry it kills except in that bit.  Pads are
// (INT64_MAX, INT64_MAX): they sort last and carry the tag.  Churn lanes
// at or past churn_count count as pads.  The merged order puts a tree
// entry before an equal churn entry.  An element dies if its own tag is
// set, or if the next merged element has its key, its meta >> 1 and the
// tag.  Survivors come out in merged order, PAD past the count.
//
// One pass by merge path (Odeh et al., "Merge Path - Parallel Merging Made
// Simple", 2012; Green, McColl and Bader, "GPU Merge Path", 2012), with no
// merged copy in device memory:
//
//  - a block takes a tile of 2048 merged positions from the ticket.  Warps
//    0 and 1 find where the diagonals at the tile's two ends cross the
//    merge path, by a 32-ary search (each round the 32 lanes probe 32
//    evenly spaced splits; five rounds at 3.7M elements);
//  - the block loads its tree slice and its churn slice, each with one
//    element of look-ahead, coalesced into one shared buffer of (key,
//    meta) pairs, 16 bytes an element, one load each: the two slices
//    together hold at most 2048 + 2 elements.  Each thread issues all of
//    its loads (9 elements) before it stores any;
//  - each thread finds its own 8 merged positions by a binary search of
//    the diagonal in shared memory, merges them, and one step more for the
//    element after its last, and decides which survive;
//  - the survivors' ranks within the tile come from a shuffle scan and the
//    tile's output offset from scan1.cuh's 32-bit look-back; survivors are
//    staged in order in the shared buffer while warp 0 looks back, then
//    written as the run [offset, offset + kept) with coalesced stores;
//  - the tiles span max(cap + nc, out_cap) lanes, those past cap + nc
//    holding nothing, and lanes that do not survive take the pad with no
//    second launch: the dropped lanes of tile t fill the run of output
//    positions that ends D_t lanes before the end, D_t = 2048 t - offset
//    being the lanes dropped by the tiles before t.  These runs tile
//    [count, end) exactly; positions at or past out_cap are not written;
//  - the block with the last tile writes the count.
//
// The TPU kernel's per-tile bitonic network, reversed churn windows and
// staging flushes exist because a TPU tile cannot gather; its window bound
// exists because the window must fit VMEM.  Here nothing bounds the churn
// per key range, so window_overflow is always false.
//
// Bound on the H100: device memory, the tree and the live churn read once
// and the output written once, 16 bytes an element each.  The entry point
// clears the status words and the ticket with one cudaMemsetAsync (8 bytes
// a tile).
#include <cuda_runtime.h>

#include <climits>

#include "scan1.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                     // merged positions a thread
constexpr int kTile = kThreads * kItems;      // 2048 positions
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kPad = 0x7FFFFFFFFFFFFFFFLL;

struct Cols {
  const long long* tk;   // tree keys (cap)
  const long long* tm;   // tree metas
  const long long* ck;   // churn keys (nc); lanes >= cc read as pads
  const long long* cm;
  long long cap, nc, cc;  // cc: the churn count, set by each block
};

__device__ __forceinline__ bool lex_le(long long k1, long long m1,
                                       long long k2, long long m2) {
  return k1 < k2 || (k1 == k2 && m1 <= m2);
}

__device__ __forceinline__ bool lex_le(longlong2 a, longlong2 b) {
  return lex_le(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void churn_at(const Cols& c, long long j,
                                         long long& k, long long& m) {
  if (j < c.cc) {
    k = c.ck[j];
    m = c.cm[j];
  } else {
    k = kPad;
    m = kPad;
  }
}

// Called by one whole warp: the number of tree elements among the first
// `diag` merged elements.  Ties go tree-first, so it is the least i in
// [max(0, diag - nc), min(diag, cap)] at which tree[i] <= churn[diag-1-i]
// fails (the predicate holds, then fails, as i grows).
__device__ __forceinline__ long long merge_path_warp(const Cols& c,
                                                     long long diag) {
  const int lane = threadIdx.x & 31;
  long long lo = max(0LL, diag - c.nc), hi = min(diag, c.cap);
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    const long long x = lo + lane * step;
    bool before = false;
    if (x < hi) {   // the four loads issued together
      long long k, m;
      const long long tk = c.tk[x], tm = c.tm[x];
      churn_at(c, diag - 1 - x, k, m);
      before = lex_le(tk, tm, k, m);
    }
    const int t = __popc(__ballot_sync(kFull, before));
    if (t == 0) {
      hi = lo;
    } else {
      hi = min(hi, lo + t * step);
      lo = lo + (t - 1) * step + 1;
    }
  }
  return lo;
}

// two blocks an SM at least: at most 128 registers a thread
__global__ void __launch_bounds__(kThreads, 2)
merge_path_kernel(Cols c, const long long* churn_count, long long total,
                  long long n, long long out_cap, long long* ok,
                  long long* om, long long* count,
                  unsigned long long* scratch, int n_tiles) {
  // the tile's tree slice then its churn slice, each with its look-ahead;
  // later the staged survivors
  __shared__ longlong2 s_el[kTile + 2];
  __shared__ long long s_split[2];
  __shared__ int warp_off[kWarps];
  __shared__ long long tile_off;
  __shared__ long long s_cc;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // read beside thread 0's ticket, before take_ticket's barrier
  if (threadIdx.x == 32) s_cc = min(max(*churn_count, 0LL), c.nc);
  const int tile = bpt::onepass::take_ticket(scratch, n_tiles);
  c.cc = s_cc;
  const long long base = (long long)tile * kTile;
  const int size = (int)min(n - base, (long long)kTile);
  const long long p0 = min(base, total), p1 = min(base + kTile, total);
  if (warp < 2) {
    const long long s = merge_path_warp(c, warp == 0 ? p0 : p1);
    if (lane == 0) s_split[warp] = s;
  }
  __syncthreads();
  const long long i0 = s_split[0], i1 = s_split[1];
  const long long j0 = p0 - i0, j1 = p1 - i1;
  const int la = (int)(i1 - i0), lb = (int)(j1 - j0);
  // slice lengths with the look-ahead element, where there is one
  const int la_x = la + (i1 < c.cap), lb_x = lb + (j1 < c.nc);
  longlong2 v[kItems + 1];   // kThreads * (kItems + 1) >= kTile + 2
#pragma unroll
  for (int q = 0; q <= kItems; ++q) {
    const int x = threadIdx.x + q * kThreads;
    long long k = kPad, m = kPad;
    if (x < la_x) {
      k = __ldcs(c.tk + i0 + x);
      m = __ldcs(c.tm + i0 + x);
    } else if (x < la_x + lb_x) {
      churn_at(c, j0 + x - la_x, k, m);
    }
    v[q] = make_longlong2(k, m);
  }
#pragma unroll
  for (int q = 0; q <= kItems; ++q) {
    const int x = threadIdx.x + q * kThreads;
    if (x < la_x + lb_x) s_el[x] = v[q];
  }
  __syncthreads();

  // this thread's positions [d, d + kItems) of the tile, and the one after
  const int len = la + lb;
  const int d = min(kItems * (int)threadIdx.x, len);
  int lo = max(0, d - lb), hi = min(d, la);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (lex_le(s_el[mid], s_el[la_x + d - 1 - mid])) lo = mid + 1;
    else hi = mid;
  }
  int ia = lo, ib = d - lo;
  longlong2 el[kItems + 1];
  longlong2 a = ia < la_x ? s_el[ia] : make_longlong2(kPad, kPad);
  longlong2 b = ib < lb_x ? s_el[la_x + ib] : make_longlong2(kPad, kPad);
#pragma unroll
  for (int q = 0; q <= kItems; ++q) {
    const bool a_ok = ia < la_x, b_ok = ib < lb_x;
    if (a_ok && (!b_ok || lex_le(a, b))) {
      el[q] = a;
      ++ia;
      if (q < kItems && ia < la_x) a = s_el[ia];
    } else if (b_ok) {
      el[q] = b;
      ++ib;
      if (q < kItems && ib < lb_x) b = s_el[la_x + ib];
    } else {   // past the last merged element
      el[q] = make_longlong2(kPad, kPad);
    }
  }
  unsigned alive = 0;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const longlong2 x = el[q], y = el[q + 1];
    const bool dead = (x.y & 1) ||
                      (y.x == x.x && (y.y >> 1) == (x.y >> 1) && (y.y & 1));
    if (d + q < len && !dead) alive |= 1u << q;
  }

  // ranks: within the warp by shuffles, across warps in shared memory
  const int cnt = __popc(alive);
  int inc = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += v;
  }
  if (lane == 31) warp_off[warp] = inc;
  __syncthreads();   // also: every thread is done reading the slices
  int wbase = 0, kept = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int v = warp_off[w];
    wbase += w < warp ? v : 0;
    kept += v;
  }
  if (warp == 0) {
    const unsigned off = bpt::onepass::lookback(scratch, tile, kept);
    if (lane == 0) {
      tile_off = off;
      if (tile == n_tiles - 1) *count = (long long)off + kept;
    }
  }
  // stage the survivors in order while warp 0 looks back
  int slot = wbase + inc - cnt;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    if ((alive >> q) & 1) s_el[slot++] = el[q];
  }
  __syncthreads();

  const long long out = tile_off;
  for (int x = threadIdx.x; x < kept && out + x < out_cap; x += kThreads) {
    const longlong2 v = s_el[x];
    ok[out + x] = v.x;
    om[out + x] = v.y;
  }
  const int dropped = size - kept;
  const long long fill = (n - base - size) + out + kept;
  for (int x = threadIdx.x; x < dropped && fill + x < out_cap;
       x += kThreads) {
    ok[fill + x] = kPad;
    om[fill + x] = kPad;
  }
}

}  // namespace

// tree (key, meta) int64 (cap), churn (key, meta) int64 (nc), churn_count
// an int64 on the card; writes (key, meta) int64 (out_cap) and count.
// scratch: one 64-bit word a tile plus the ticket, tiles = ceil(max(cap +
// nc, out_cap) / bpt_merge_tile()).
extern "C" int bpt_merge(const void* tree_key, const void* tree_meta,
                         const void* churn_key, const void* churn_meta,
                         const void* churn_count, void* out_key,
                         void* out_meta, void* count, void* scratch,
                         long long cap, long long nc, long long out_cap,
                         void* stream) {
  if (cap < 0 || nc < 0 || out_cap < 0 || cap + nc >= INT_MAX ||
      out_cap >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long total = cap + nc;
  const long long n = total > out_cap ? total : out_cap;
  if (n == 0) return (int)cudaMemsetAsync(count, 0, sizeof(long long), s);
  const long long tiles = (n + kTile - 1) / kTile;
  unsigned long long* words = (unsigned long long*)scratch;
  const cudaError_t err = bpt::onepass::clear(words, tiles, s);
  if (err != cudaSuccess) return (int)err;
  const Cols c{(const long long*)tree_key, (const long long*)tree_meta,
               (const long long*)churn_key, (const long long*)churn_meta,
               cap, nc, 0};
  merge_path_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
      c, (const long long*)churn_count, total, n, out_cap,
      (long long*)out_key, (long long*)out_meta, (long long*)count, words,
      (int)tiles);
  return (int)cudaGetLastError();
}

// Lanes a block of the kernel takes; the wrapper sizes the scratch with it
// (one status word a tile, then the ticket).
extern "C" long long bpt_merge_tile() { return kTile; }
