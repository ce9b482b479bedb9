// Kernel 6: merge a sorted churn buffer into the sorted tree, cancel each
// tombstone with its twin, and compact.
//
// Replaces broadphase_tpu/ops/pallas_merge.py::merge_cancel_compact.  Both
// inputs are (key, meta) int64 column pairs sorted lexicographically;
// meta's lowest bit is the tag (1 = tombstone or pad) and a tombstone
// equals the tree entry it kills except in that bit.  Pads are
// (INT64_MAX, INT64_MAX): they sort last and carry the tag.  Churn lanes
// at or past churn_count count as pads.
//
//   1. merge_rank_kernel: one thread per tree lane and per churn lane.
//      Each binary-searches the other sorted sequence for its merged
//      position (tree lane i: i + lower_bound(churn, tree[i]); churn lane
//      j: j + upper_bound(tree, churn[j]); ties go tree-first, so the
//      positions are a permutation) and for the element that follows it
//      in the merged order.  An element dies if its own tag is set, or if
//      that next element has its key, its meta >> 1 and the tag.  It
//      writes (key, meta, alive) at its merged position.
//   2. scan.cuh's tile sums and their scan over the alive flags.
//   3. merge_scatter_kernel: every alive merged element moves to its
//      output slot; slots at or past the count get the pad.
//
// The TPU kernel's per-tile bitonic network, reversed churn windows and
// staging flushes exist because a TPU tile cannot gather; its window
// bound exists because the window must fit VMEM.  Here nothing bounds the
// churn per key range, so window_overflow is always false.
//
// Bound on the H100: device memory.  The least it must move is the tree
// and the live churn read once and the output written once (16 bytes per
// element each); this form also writes and re-reads the merged sequence
// (17 bytes per element each way) and reads the flags twice in the scan,
// about 2x that least.
#include "scan.cuh"

namespace {

constexpr long long kPad = 0x7FFFFFFFFFFFFFFFLL;

__device__ __forceinline__ bool lex_lt(long long k1, long long m1,
                                       long long k2, long long m2) {
  return k1 < k2 || (k1 == k2 && m1 < m2);
}

__global__ void __launch_bounds__(256)
merge_rank_kernel(const long long* tk, const long long* tm,
                  const long long* ck, const long long* cm,
                  const long long* churn_count, long long cap, long long nc,
                  long long* mk, long long* mm, unsigned char* alive) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= cap + nc) return;
  long long cc = *churn_count;
  cc = cc < 0 ? 0 : (cc > nc ? nc : cc);
  long long k, m, pos, nk = kPad, nm = kPad;
  if (lane < cap) {
    const long long i = lane;
    k = tk[i];
    m = tm[i];
    long long lo = 0, hi = cc;  // lower_bound(churn[0, cc), (k, m))
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (lex_lt(ck[mid], cm[mid], k, m)) lo = mid + 1;
      else hi = mid;
    }
    pos = i + lo;
    // next in merged order: tree[i + 1] unless churn[lo] sorts before it
    if (i + 1 < cap && (lo >= cc || !lex_lt(ck[lo], cm[lo], tk[i + 1],
                                            tm[i + 1]))) {
      nk = tk[i + 1];
      nm = tm[i + 1];
    } else if (lo < cc) {
      nk = ck[lo];
      nm = cm[lo];
    }
  } else {
    const long long j = lane - cap;
    if (j >= cc) {  // a pad lane keeps its place after every live element
      mk[cap + j] = kPad;
      mm[cap + j] = kPad;
      alive[cap + j] = 0;
      return;
    }
    k = ck[j];
    m = cm[j];
    long long lo = 0, hi = cap;  // upper_bound(tree, (k, m))
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (!lex_lt(k, m, tk[mid], tm[mid])) lo = mid + 1;
      else hi = mid;
    }
    pos = j + lo;
    // next in merged order: tree[lo] unless churn[j + 1] sorts before it
    if (lo < cap && (j + 1 >= cc || !lex_lt(ck[j + 1], cm[j + 1], tk[lo],
                                            tm[lo]))) {
      nk = tk[lo];
      nm = tm[lo];
    } else if (j + 1 < cc) {
      nk = ck[j + 1];
      nm = cm[j + 1];
    }
  }
  const bool dead = (m & 1) ||
                    (nk == k && (nm >> 1) == (m >> 1) && (nm & 1));
  mk[pos] = k;
  mm[pos] = m;
  alive[pos] = dead ? 0 : 1;
}

struct AliveFlag {
  const unsigned char* alive;
  long long merged;
  __device__ long long operator()(long long p) const {
    return p < merged && alive[p] ? 1 : 0;
  }
};

__global__ void __launch_bounds__(bpt::kThreads)
merge_scatter_kernel(AliveFlag f, long long n, const long long* tile_off,
                     const long long* count, const long long* mk,
                     const long long* mm, long long out_cap,
                     long long* ok, long long* om) {
  long long vals[bpt::kItems], pref[bpt::kItems];
  bpt::tile_scan(f, n, tile_off, vals, pref);
  const long long kept = *count;
  const long long base = (long long)blockIdx.x * bpt::kTile +
                         (long long)threadIdx.x * bpt::kItems;
#pragma unroll
  for (int k = 0; k < bpt::kItems; ++k) {
    const long long p = base + k;
    if (p >= n) break;
    if (vals[k] && pref[k] < out_cap) {
      ok[pref[k]] = mk[p];
      om[pref[k]] = mm[p];
    }
    if (p < out_cap && p >= kept) {
      ok[p] = kPad;
      om[p] = kPad;
    }
  }
}

}  // namespace

extern "C" int bpt_merge(const void* tree_key, const void* tree_meta,
                         const void* churn_key, const void* churn_meta,
                         const void* churn_count, void* merged_key,
                         void* merged_meta, void* alive, void* out_key,
                         void* out_meta, void* count, void* tile_sums,
                         long long cap, long long nc, long long out_cap,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long merged = cap + nc;
  if (merged > 0) {
    merge_rank_kernel<<<(unsigned)((merged + 255) / 256), 256, 0, s>>>(
        (const long long*)tree_key, (const long long*)tree_meta,
        (const long long*)churn_key, (const long long*)churn_meta,
        (const long long*)churn_count, cap, nc, (long long*)merged_key,
        (long long*)merged_meta, (unsigned char*)alive);
  }
  const long long n = merged > out_cap ? merged : out_cap;
  AliveFlag f{(const unsigned char*)alive, merged};
  long long* sums = (long long*)tile_sums;
  long long* total = (long long*)count;
  bpt::launch_tile_offsets<long long>(f, n, sums, total, s);
  merge_scatter_kernel<<<(unsigned)bpt::n_tiles_for(n), bpt::kThreads, 0,
                         s>>>(f, n, sums, total,
                              (const long long*)merged_key,
                              (const long long*)merged_meta, out_cap,
                              (long long*)out_key, (long long*)out_meta);
  return (int)cudaGetLastError();
}
