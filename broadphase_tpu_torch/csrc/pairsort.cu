// Kernel 8: the canonical pair sort of layer.scan, as one chain: pack, a
// bucket histogram, one most-significant-digit scatter into buckets, and a
// bucket kernel that sorts, deduplicates and decodes each bucket in
// shared memory.
//
// Replaces no TPU kernel: the JAX package sorts the pairs with lax.sort
// (broadphase_tpu/layer.py canonical_pairs, with its 20-bit pack where the
// ids allow), and the port called torch.sort on a 64-bit key with torch's
// elementwise glue around it.  The chain takes (a, b) int64 columns with
// a valid byte a lane (without one, a lane is valid where a != b: the
// expansion writes PAD on both sides of a dropped or empty slot), every
// valid id below 2^32 - 1, and writes the sorted, deduplicated (a, b)
// pairs to the front of two int64 columns of `cap` lanes, PAD_ID past the
// count:
//
//  - bound (only without a caller's id bound): the OR of a | b over the
//    valid lanes, whose bit length is that of the largest live id;
//  - pack, one pass by decoupled look-back (scan1.cuh), as kernel 5: the
//    valid lanes in emission order, the first `cap` of them written as
//    the unsigned key (a << w) | b, w the bit length of the id bound, read
//    on the device; the count of valid lanes; and the least, the largest,
//    the OR and the AND of the keys written.  The block that finishes
//    last plans: the live count min(total, cap); the 8-bit digits on which
//    the live keys differ (scan.sort_passes, what an LSD sort would make);
//    and the buckets, bucket(key) = (key - least) >> shift.  The shift is
//    the largest that leaves ceil(live / kTarget) buckets or more, so that
//    the buckets follow the live keys' range wherever in the 2w bits it
//    lies (ids offset by 2^25 or shared by every pair move the buckets,
//    not their size).  A bucket's keys are offsets below 2^shift from its
//    base: where shift passes 32 they take 8 bytes in place of 4, and the
//    plan asks for buckets half the size;
//  - hist: each bucket's count, from block-local shared histograms; the
//    block that finishes last writes each bucket's start and cursor and
//    the spilled count, the live keys of the buckets over what shared
//    memory holds (kBucketKeys offsets of 4 bytes, half that of 8);
//  - scatter, 8192 keys a block: each key's rank among the block's keys
//    of its bucket from shared atomics, one global atomic a bucket the
//    block holds, and each key written into its bucket.  The order within
//    a bucket is free: the bucket kernel sorts each bucket whole;
//  - spill: each spilled bucket sorted in place by one block through
//    global memory (stable 8-bit LSD passes, chunk by chunk); it returns
//    at once where nothing spilled;
//  - buckets, a persistent grid taking buckets in order by ticket: a
//    block loads its bucket into shared memory as offsets from the
//    bucket's base, groups them into 2048 sub-bins on their top 11 bits
//    (counted, scanned, scattered by shared atomics), and writes each key
//    back at its rank among its sub-bin's few keys (equal keys by their
//    place): the bucket sorted.  It keeps each key that differs from the
//    one before it (the dedup that v2 and wide-id emissions need: equal
//    keys share a bucket), decodes a = key >> w and b = key & (2^w - 1),
//    and writes the kept pairs at the offset that a decoupled look-back
//    over the buckets' kept counts gives.  Its dropped lanes write the pad
//    as kernel 5 fills, from the live count backwards, and the grid
//    shares the lanes past the live count, so every output lane is
//    written once.  A spilled bucket comes sorted and is deduplicated and
//    written a block row at a time.
//
// The host launches a fixed chain and reads nothing back: the width, the
// live count, the plan and the buckets stay on the device.
//
// Bound on the H100: device memory.  The contract reads each live pair
// and writes each kept pair once, 8 bytes a pair; the chain reads the
// valid bytes and both id columns of the input once and writes the live
// keys (pack), reads them twice (hist, scatter) and writes them into their
// buckets, reads the buckets once and writes both output columns whole.
// At 1M boxes (8.5M live pairs, 16.8M emission lanes, 9M output lanes)
// that is about 285 + 68 + 2 x 68 + 68 + 68 + 144 MB.  What bounds it in
// practice is latency: the scatter's stores land one key a sector, and
// the bucket kernel's phases are short, with a sync between each.
#include <cuda_runtime.h>

#include "scan1.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                    // pack: lanes a thread
constexpr int kTile = kThreads * kItems;      // pack: 4096 lanes a block
constexpr int kRows = kItems;                 // pack: 32-lane rows a warp holds
constexpr int kDigitBits = 8;
constexpr int kRadix = 1 << kDigitBits;       // = kThreads: a digit a thread
constexpr int kWide = 512;                    // hist, scatter: threads a block
constexpr int kWideWarps = kWide / 32;
constexpr int kScatterTile = kWide * kItems;  // scatter: 8192 keys a block
constexpr int kCountBlocks = 132;             // hist: blocks at most
constexpr int kBucketRows = 24;               // spill: 32-key rows a warp holds
// the most keys a bucket sorts in shared memory: 6144 as 4-byte offsets
// from its base (shift <= 32), half that as 8-byte ones
constexpr int kBucketKeys = kThreads * kBucketRows;
constexpr int kTarget = 2560;                 // keys a bucket averages at most
constexpr int kBucketBlocks = 132 * 3;        // buckets: blocks, three an SM
constexpr int kMaxBuckets = 16384;
constexpr int kSubBits = 11;                  // buckets: a sub-bin's digit
constexpr int kSubBins = 1 << kSubBits;
constexpr int kBatch = 8;                     // buckets: loads in flight
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kPadId = 0xFFFFFFFFLL;
constexpr unsigned kNone = 0xffffffffu;       // a lane past the keys

static_assert(kRadix == kThreads, "one digit a thread");
static_assert(32 * kBucketRows < (1 << 16), "a rank in a warp fits 16 bits");
static_assert(kSubBins % kThreads == 0, "whole sub-bins a thread");

// The chain's scratch, in 64-bit words, cleared by one memset.
enum Info {
  kTotal,     // valid lanes of the input
  kLive,      // min(total, cap): the keys the chain sorts
  kWidth,     // w, the bit length of the id bound, at most 32
  kPasses,    // 8-bit digits on which the live keys differ
  kSpilled,   // live keys in buckets over bucket_keys(shift)
  kBoundOr,   // the bound kernel's OR of the valid ids
  kMinNot,    // ~ the least live key (atomicMax of ~key from 0)
  kMax,       // the largest live key
  kOr,        // OR of the live keys
  kAndNot,    // ~ the AND of the live keys (atomicOr of ~key from 0)
  kShift,     // bucket(key) = (key - least) >> shift
  kBuckets,   // buckets of the plan
  kPackDone,  // pack blocks finished
  kHistDone,  // hist blocks finished
  kInfoWords = 16
};
// the bucket kernel's dynamic shared memory: the keys twice (kBucketKeys
// 4-byte offsets or half that of 8 bytes), then the sub-bins' cursors and
// starts
constexpr int kBucketSmem = 2 * kBucketKeys * 4 + (2 * kSubBins + 8) * 4;

struct Layout {
  long long pack, hist, start, cursor, status, words;
  int buckets;  // the most buckets a plan over `cap` live keys asks for
};

__host__ __device__ inline long long tiles_of(long long n) {
  return (n + kTile - 1) / kTile;
}

// A plan asks for want = min(ceil(live / target), kMaxBuckets / 2)
// buckets, target kTarget or half that, and gets at most max(2, 2 want)
// of them; live <= cap.
inline int bucket_cap(long long cap) {
  long long want = (cap + kTarget / 2 - 1) / (kTarget / 2);
  if (want > kMaxBuckets / 2) want = kMaxBuckets / 2;
  return (int)(want < 1 ? 2 : 2 * want);
}

inline long long u32_words(long long n) { return (n + 1) / 2; }

inline Layout layout(long long n, long long cap) {
  Layout l;
  l.buckets = bucket_cap(cap);
  l.pack = kInfoWords;
  l.hist = l.pack + bpt::onepass::scratch_words(tiles_of(n));
  l.start = l.hist + u32_words(l.buckets);
  l.cursor = l.start + u32_words(l.buckets);
  l.status = l.cursor + u32_words(l.buckets);
  l.words = l.status + bpt::onepass::scratch_words(l.buckets);
  return l;
}

__device__ __forceinline__ int bit_length(unsigned long long x) {
  return x ? 64 - __clzll(x) : 0;
}

__device__ __forceinline__ int width_of(const long long* bound) {
  return min(bit_length((unsigned long long)*bound), 32);
}

__device__ __forceinline__ int passes_of(int w) {
  return (2 * w + kDigitBits - 1) / kDigitBits;
}

// The largest shift in [0, 63] that leaves at least want =
// ceil(live / target) buckets of keys that span `span` (at most
// kMaxBuckets / 2 asked for), 0 where none does; for one bucket, the
// smallest shift that leaves one.
__device__ __forceinline__ int shift_for(unsigned long long span,
                                         unsigned long long live,
                                         int target) {
  unsigned long long want = (live + target - 1) / target;
  if (want > kMaxBuckets / 2) want = kMaxBuckets / 2;
  if (want <= 1) return min(bit_length(span), 63);
  int shift = 63;
  while (shift > 0 && (span >> shift) < want - 1) --shift;
  return shift;
}

// The most keys a bucket of the plan sorts in shared memory: offsets of
// at most 32 bits take 4 bytes.
__device__ __forceinline__ long long bucket_keys(int shift) {
  return shift <= 32 ? kBucketKeys : kBucketKeys / 2;
}

__device__ __forceinline__ unsigned long long warp_or(unsigned long long v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v |= __shfl_xor_sync(kFull, v, d);
  return v;
}

__device__ __forceinline__ unsigned long long warp_and(unsigned long long v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v &= __shfl_xor_sync(kFull, v, d);
  return v;
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const unsigned long long o = __shfl_xor_sync(kFull, v, d);
    v = o > v ? o : v;
  }
  return v;
}

// Exclusive scan of one value a thread over a block of W warps; every
// thread calls it.  `tmp` holds W words.
template <int W = kWarps>
__device__ __forceinline__ unsigned block_exclusive(unsigned v,
                                                    unsigned* tmp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned o = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += o;
  }
  if (lane == 31) tmp[warp] = inc;
  __syncthreads();
  unsigned before = 0;
#pragma unroll
  for (int w = 0; w < W; ++w)
    if (w < warp) before += tmp[w];
  __syncthreads();  // tmp is free for the next call
  return before + inc - v;
}

// The sum of one value a thread over the block, to every thread.
__device__ __forceinline__ unsigned block_sum(unsigned v, unsigned* tmp) {
  v = __reduce_add_sync(kFull, v);
  if ((threadIdx.x & 31) == 0) tmp[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned s = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += tmp[w];
  __syncthreads();
  return s;
}

// The OR and the AND of one pair of values a thread over the block, to
// every thread.  `red` holds 2 kWarps words.
__device__ __forceinline__ void block_or_and(unsigned long long& o,
                                             unsigned long long& an,
                                             unsigned long long* red) {
  const int warp = threadIdx.x >> 5;
  o = warp_or(o);
  an = warp_and(an);
  if ((threadIdx.x & 31) == 0) {
    red[warp] = o;
    red[kWarps + warp] = an;
  }
  __syncthreads();
  o = 0;
  an = ~0ull;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    o |= red[w];
    an &= red[kWarps + w];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
pairsort_bound_kernel(const long long* a, const long long* b,
                      const unsigned char* valid, long long n,
                      unsigned long long* out) {
  unsigned long long acc = 0;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads)
    if (valid ? valid[i] != 0 : a[i] != b[i])
      acc |= (unsigned long long)a[i] | (unsigned long long)b[i];
  acc = warp_or(acc);
  if ((threadIdx.x & 31) == 0 && acc) atomicOr(out, acc);
}

// 16 valid bytes -> bit k set for byte k != 0 (as kernel 5).
__device__ __forceinline__ unsigned mask_of(uint4 v) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned bits = __vcmpne4(w[k], 0u) & 0x01010101u;
    m |= ((bits * 0x01020408u) >> 24) << (4 * k);
  }
  return m;
}

// three blocks an SM: at most 85 registers a thread
__global__ void __launch_bounds__(kThreads, 3)
pairsort_pack_kernel(const unsigned char* valid, const long long* a,
                     const long long* b, long long n, long long cap,
                     const long long* bound, unsigned long long* scratch,
                     Layout l, int n_tiles, unsigned long long* keys) {
  __shared__ unsigned long long stage[kTile];
  __shared__ unsigned long long red[4][kWarps];
  __shared__ int warp_off[kWarps];
  __shared__ int tile_kept;
  __shared__ long long tile_off;
  __shared__ int last_block;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned long long* info = scratch;
  unsigned long long* status = scratch + l.pack;
  const int tile = bpt::onepass::take_ticket(status, n_tiles);
  const long long base = (long long)tile * kTile;
  const int size = (int)min(n - base, (long long)kTile);
  const int w = width_of(bound);

  // the valid bits of lanes base + 16 * threadIdx.x + [0, 16)
  const long long mine = base + kItems * threadIdx.x;
  unsigned mask = 0;
  if (valid == nullptr) {
    // a lane is valid where its ids differ: found below, from the rows
  } else if (size == kTile && ((size_t)valid & 15) == 0) {
    mask = mask_of(__ldcs((const uint4*)(valid + mine)));
  } else {
    for (int k = 0; k < kItems; ++k)
      if (mine + k < n && valid[mine + k]) mask |= 1u << k;
  }
  // the keys of lanes row0 + 32 r, loaded now so that the loads overlap
  // the look-back
  const long long row0 = base + 32 * kRows * warp + lane;
  unsigned long long key[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long i = row0 + 32 * r;
    key[r] = i < n ? (unsigned long long)__ldcs(a + i) : 0;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long i = row0 + 32 * r;
    const unsigned long long bi =
        i < n ? (unsigned long long)__ldcs(b + i) : 0;
    if (valid == nullptr) {
      // row r's lanes belong to the warp's threads 2r (lanes 0-15) and
      // 2r + 1 (lanes 16-31)
      const unsigned differ = __ballot_sync(kFull, i < n && key[r] != bi);
      if ((lane >> 1) == r) mask = (differ >> (16 * (lane & 1))) & 0xffffu;
    }
    key[r] = (key[r] << w) | bi;
  }

  const int cnt = __popc(mask);
  int inc = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += o;
  }
  if (lane == 31) warp_off[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < kWarps ? warp_off[lane] : 0;
    int winc = v;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int o = __shfl_up_sync(kFull, winc, d);
      if (lane >= d) winc += o;
    }
    const int kept = __shfl_sync(kFull, winc, kWarps - 1);
    if (lane < kWarps) warp_off[lane] = winc - v;
    const unsigned off = bpt::onepass::lookback(status, tile, kept);
    if (lane == 0) {
      tile_kept = kept;
      tile_off = off;
    }
  }
  __syncthreads();

  // stage the valid lanes' keys in order (kernel 5's shuffled ranks)
  const unsigned packed = ((unsigned)(inc - cnt) << 16) | mask;
  const int bit = lane & 15;
  const unsigned below = (1u << bit) - 1;
  const int wbase = warp_off[warp];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const unsigned p = __shfl_sync(kFull, packed, 2 * r + (lane >> 4));
    if ((p >> bit) & 1) stage[wbase + (int)(p >> 16) + __popc(p & below)] =
        key[r];
  }
  __syncthreads();
  const int kept = tile_kept;
  const long long off = tile_off;
  const int n_out = (int)max(0LL, min((long long)kept, cap - off));
  // the keys written, and their least (as ~ its complement's greatest),
  // largest, OR and AND
  unsigned long long lo_not = 0, hi = 0, o = 0, an_not = 0;
  for (int i = threadIdx.x; i < n_out; i += kThreads) {
    const unsigned long long k = stage[i];
    keys[off + i] = k;
    lo_not = ~k > lo_not ? ~k : lo_not;
    hi = k > hi ? k : hi;
    o |= k;
    an_not |= ~k;
  }
  lo_not = warp_max(lo_not);
  hi = warp_max(hi);
  o = warp_or(o);
  an_not = warp_or(an_not);
  if (lane == 0) {
    red[0][warp] = lo_not;
    red[1][warp] = hi;
    red[2][warp] = o;
    red[3][warp] = an_not;
  }
  if (tile == n_tiles - 1 && threadIdx.x == 0)
    info[kTotal] = (unsigned long long)(off + kept);
  __syncthreads();
  if (threadIdx.x == 0 && n_out > 0) {
    for (int v = 1; v < kWarps; ++v) {
      lo_not = red[0][v] > lo_not ? red[0][v] : lo_not;
      hi = red[1][v] > hi ? red[1][v] : hi;
      o |= red[2][v];
      an_not |= red[3][v];
    }
    atomicMax(info + kMinNot, lo_not);
    atomicMax(info + kMax, hi);
    atomicOr(info + kOr, o);
    atomicOr(info + kAndNot, an_not);
  }

  // the block that finishes last plans
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last_block = atomicAdd(info + kPackDone, 1ull) ==
                 (unsigned long long)(n_tiles - 1);
  __syncthreads();
  if (!last_block || threadIdx.x != 0) return;
  __threadfence();
  const unsigned long long total = __ldcg(info + kTotal);
  const unsigned long long live =
      min(total, (unsigned long long)max(cap, 0LL));
  unsigned long long passes = 0, shift = 0, buckets = 0;
  if (live > 0) {
    // the bits on which the live keys differ: OR and not AND
    const unsigned long long vary =
        __ldcg(info + kOr) & __ldcg(info + kAndNot);
    for (int p = 0; p < passes_of(w); ++p)
      passes += ((vary >> (kDigitBits * p)) & (kRadix - 1)) != 0;
    // buckets of 4-byte offsets where they span at most 2^32 keys, else
    // of 8-byte ones, half as many keys
    const unsigned long long span =
        __ldcg(info + kMax) - ~__ldcg(info + kMinNot);
    shift = shift_for(span, live, kTarget);
    if (shift > 32) shift = shift_for(span, live, kTarget / 2);
    buckets = (span >> shift) + 1;
  }
  info[kLive] = live;
  info[kWidth] = (unsigned long long)w;
  info[kPasses] = passes;
  info[kShift] = shift;
  info[kBuckets] = buckets;
}

// The bucket of each live key, counted in shared memory; the block that
// finishes last writes the buckets' starts and cursors and the spilled
// count.  Dynamic shared memory: a count a bucket of the layout.
__global__ void __launch_bounds__(kWide)
pairsort_hist_kernel(unsigned long long* scratch, Layout l,
                     const unsigned long long* keys) {
  extern __shared__ unsigned local[];
  __shared__ unsigned tmp[kWideWarps];
  __shared__ int last_block;
  unsigned long long* info = scratch;
  const long long live = (long long)info[kLive];
  const int buckets = (int)info[kBuckets];
  const int shift = (int)info[kShift];
  const unsigned long long least = ~info[kMinNot];
  for (int j = threadIdx.x; j < buckets; j += kWide) local[j] = 0;
  __syncthreads();
  for (long long i0 = (long long)blockIdx.x * kWide * kItems + threadIdx.x;
       i0 < live; i0 += (long long)gridDim.x * kWide * kItems) {
    unsigned long long k[kItems];
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const long long i = i0 + (long long)r * kWide;
      k[r] = i < live ? keys[i] : 0;
    }
#pragma unroll
    for (int r = 0; r < kItems; ++r)
      if (i0 + (long long)r * kWide < live)
        atomicAdd(local + (unsigned)((k[r] - least) >> shift), 1u);
  }
  __syncthreads();
  unsigned* hist = (unsigned*)(scratch + l.hist);
  for (int j = threadIdx.x; j < buckets; j += kWide)
    if (local[j]) atomicAdd(hist + j, local[j]);

  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last_block = atomicAdd(info + kHistDone, 1ull) ==
                 (unsigned long long)(gridDim.x - 1);
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  // thread t: buckets [t * per, (t + 1) * per)
  const int per = (buckets + kWide - 1) / kWide;
  const int first = min((int)threadIdx.x * per, buckets);
  const int end = min(first + per, buckets);
  const long long fits = bucket_keys(shift);
  unsigned sum = 0, spilled = 0;
  for (int j = first; j < end; ++j) {
    const unsigned c = __ldcg(hist + j);
    sum += c;
    if (c > fits) spilled += c;
  }
  unsigned at = block_exclusive<kWideWarps>(sum, tmp);
  unsigned* start = (unsigned*)(scratch + l.start);
  unsigned* cursor = (unsigned*)(scratch + l.cursor);
  for (int j = first; j < end; ++j) {
    start[j] = at;
    cursor[j] = at;
    at += __ldcg(hist + j);
  }
  spilled = __reduce_add_sync(kFull, spilled);
  if ((threadIdx.x & 31) == 0 && spilled)
    atomicAdd(info + kSpilled, (unsigned long long)spilled);
}

// The scatter, kScatterTile live keys a block: each key's rank among the
// block's keys of its bucket from shared atomics, then one global atomic a
// bucket the block holds for the start of its run there.  Dynamic shared
// memory: a count a bucket of the layout, which becomes the run's start.
__global__ void __launch_bounds__(kWide)
pairsort_scatter_kernel(unsigned long long* scratch, Layout l,
                        const unsigned long long* in,
                        unsigned long long* out) {
  extern __shared__ unsigned cnt[];
  const unsigned long long* info = scratch;
  const long long live = (long long)info[kLive];
  const long long base = (long long)blockIdx.x * kScatterTile;
  if (base >= live) return;
  const int buckets = (int)info[kBuckets];
  const int shift = (int)info[kShift];
  const unsigned long long least = ~info[kMinNot];
  unsigned* cursor = (unsigned*)(scratch + l.cursor);
  for (int j = threadIdx.x; j < buckets; j += kWide) cnt[j] = 0;
  const int n = (int)min(live - base, (long long)kScatterTile);
  unsigned long long k[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int i = r * kWide + threadIdx.x;
    k[r] = i < n ? __ldcs(in + base + i) : 0;
  }
  __syncthreads();
  unsigned rank[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r)
    rank[r] = r * kWide + (int)threadIdx.x < n
                  ? atomicAdd(cnt + (unsigned)((k[r] - least) >> shift), 1u)
                  : 0;
  __syncthreads();
  // each bucket's run in the bucket, eight atomics in flight a thread
  for (int j0 = threadIdx.x; j0 < buckets; j0 += 8 * kWide) {
    unsigned c[8], g[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = j0 + q * kWide;
      c[q] = j < buckets ? cnt[j] : 0;
      g[q] = c[q] ? atomicAdd(cursor + j, c[q]) : 0;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (c[q]) cnt[j0 + q * kWide] = g[q];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kItems; ++r)
    if (r * kWide + (int)threadIdx.x < n)
      out[cnt[(unsigned)((k[r] - least) >> shift)] + rank[r]] = k[r];
}

// Ranks the warp's rows of keys by their digit at bit `lo`: rank[r] =
// (digit << 16) | the key's rank among the warp's keys of that digit, in
// row-then-lane order (0xffff << 16 past the m keys); `wcount` holds the
// warp's kRadix counters and ends with its count of each digit.  Warp
// `warp` holds keys [first, first + 32 rows) of the block's m.
__device__ __forceinline__ void rank_rows(
    const unsigned long long (&key)[kBucketRows], int rows, int first,
    int m, int lo, unsigned* wcount, unsigned (&rank)[kBucketRows]) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1;
#pragma unroll
  for (int r = 0; r < kBucketRows; ++r) {
    if (r < rows) {
      const bool ok = first + 32 * r + lane < m;
      const unsigned d = ok ? (unsigned)(key[r] >> lo) & (kRadix - 1) : kNone;
      const unsigned peers = __match_any_sync(kFull, d);
      const unsigned seen = ok ? wcount[d] : 0;
      __syncwarp();
      if (ok && lane == __ffs(peers) - 1) wcount[d] = seen + __popc(peers);
      __syncwarp();
      rank[r] = (d << 16) | (seen + __popc(peers & lt));
    }
  }
}

// rank_rows over the block: afterwards wcount[w * kRadix + d] holds the
// keys of digit d in the rows of the warps before w, and thread d returns
// the block's count of digit d.  The caller adds digit d's start to
// column d (thread d's alone) and syncs before it scatters.
__device__ __forceinline__ unsigned rank_block(
    const unsigned long long (&key)[kBucketRows], int rows, int first,
    int m, int lo, unsigned* wcount, unsigned (&rank)[kBucketRows]) {
  for (int i = threadIdx.x; i < kWarps * kRadix; i += kThreads) wcount[i] = 0;
  __syncthreads();
  rank_rows(key, rows, first, m, lo, wcount + (threadIdx.x >> 5) * kRadix,
            rank);
  __syncthreads();
  unsigned before = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned c = wcount[w * kRadix + threadIdx.x];
    wcount[w * kRadix + threadIdx.x] = before;
    before += c;
  }
  return before;
}

// Loads keys [0, m) of `src`, less `base`, into the rows of warp layout
// (rows, first); zero past m.
__device__ __forceinline__ void load_rows(
    unsigned long long (&key)[kBucketRows], const unsigned long long* src,
    int rows, int first, int m, unsigned long long base) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kBucketRows; ++r) {
    if (r < rows) {
      const int i = first + 32 * r + lane;
      key[r] = i < m ? src[i] - base : 0;
    }
  }
}

// Each spilled bucket (over bucket_keys(shift) keys) sorted in its range of
// keys1 by a block, through global memory: stable 8-bit LSD passes over
// the bits that vary in the bucket, chunk by chunk of kBucketKeys, each
// digit counted over the bucket first and then scattered, ping-ponging
// with the bucket's range of keys0 (the pack's keys, which the scatter
// has read).  Returns at once where nothing spilled.
__global__ void __launch_bounds__(kThreads)
pairsort_spill_kernel(unsigned long long* scratch, Layout l,
                      unsigned long long* keys0, unsigned long long* keys1) {
  __shared__ unsigned wcount[kWarps * kRadix];
  __shared__ unsigned tmp[kWarps];
  __shared__ unsigned long long red[2 * kWarps];
  const unsigned long long* info = scratch;
  if (info[kSpilled] == 0) return;
  const int warp = threadIdx.x >> 5;
  const int d = threadIdx.x;
  const int buckets = (int)info[kBuckets];
  const int shift = (int)info[kShift];
  const unsigned* hist = (const unsigned*)(scratch + l.hist);
  const unsigned* starts = (const unsigned*)(scratch + l.start);
  unsigned long long key[kBucketRows];
  unsigned rank[kBucketRows];
  const long long fits = bucket_keys(shift);
  for (int t = blockIdx.x; t < buckets; t += gridDim.x) {
    const long long m = hist[t];
    if (m <= fits) continue;
    const unsigned long long base =
        ~info[kMinNot] + ((unsigned long long)t << shift);
    unsigned long long* src = keys1 + starts[t];
    unsigned long long* dst = keys0 + starts[t];
    unsigned long long o = 0, an = ~0ull;
    for (long long i = threadIdx.x; i < m; i += kThreads) {
      const unsigned long long s = src[i] - base;
      o |= s;
      an &= s;
    }
    block_or_and(o, an, red);
    const unsigned long long vary = o & ~an;
    for (int lo = 0; lo < 64; lo += kDigitBits) {
      if (!((vary >> lo) & (kRadix - 1))) continue;
      unsigned total = 0;
      for (long long c0 = 0; c0 < m; c0 += kBucketKeys) {
        const int mc = (int)min(m - c0, (long long)kBucketKeys);
        const int rows = (mc + 32 * kWarps - 1) / (32 * kWarps);
        const int first = warp * 32 * rows;
        load_rows(key, src + c0, rows, first, mc, base);
        total += rank_block(key, rows, first, mc, lo, wcount, rank);
        __syncthreads();
      }
      unsigned cursor = block_exclusive(total, tmp);
      for (long long c0 = 0; c0 < m; c0 += kBucketKeys) {
        const int mc = (int)min(m - c0, (long long)kBucketKeys);
        const int rows = (mc + 32 * kWarps - 1) / (32 * kWarps);
        const int first = warp * 32 * rows;
        load_rows(key, src + c0, rows, first, mc, base);
        const unsigned in_chunk = rank_block(key, rows, first, mc, lo, wcount,
                                             rank);
#pragma unroll
        for (int v = 0; v < kWarps; ++v) wcount[v * kRadix + d] += cursor;
        cursor += in_chunk;
        __syncthreads();
#pragma unroll
        for (int r = 0; r < kBucketRows; ++r)
          if (r < rows && (rank[r] >> 16) != 0xffffu)
            dst[wcount[warp * kRadix + (rank[r] >> 16)] +
                (rank[r] & 0xffffu)] = key[r] + base;
        __syncthreads();
      }
      unsigned long long* was = src;
      src = dst;
      dst = was;
    }
    if (src != keys1 + starts[t]) {
      for (long long i = threadIdx.x; i < m; i += kThreads)
        keys1[starts[t] + i] = src[i];
      __syncthreads();
    }
  }
}

// The pad of a bucket's dropped lanes: the dropped lanes of buckets 0 .. t
// fill the run that ends at the live count, (end - kept_end) lanes long,
// end and kept_end being the live and the kept lanes through bucket t.
__device__ __forceinline__ void pad_dropped(long long* out_a, long long* out_b,
                                            long long live, long long end,
                                            long long kept_end,
                                            long long dropped) {
  const long long from = live - (end - kept_end);
  for (long long j = threadIdx.x; j < dropped; j += kThreads) {
    out_a[from + j] = kPadId;
    out_b[from + j] = kPadId;
  }
}

// One bucket of m live keys at `src` whose base is `base`: a spilled one
// (over bucket_keys) comes sorted from the spill kernel; else the keys go
// to buf as K offsets from the base, are grouped into sub-bins by the top
// kSubBits bits that vary (counted, their starts scanned, scattered into
// buf2 by shared atomics) and each is written back into buf at its rank
// in its sub-bin (equal keys by their place).  Then each key that
// differs from the one before it is kept, decoded and written at the
// offset that the look-back over the buckets' kept counts gives.
template <typename K>
__device__ __forceinline__ void bucket_block(
    int t, int buckets, long long m, long long start, unsigned long long base,
    int shift, int w, long long live, const unsigned long long* src,
    unsigned long long* status, unsigned char* smem, unsigned* tmp,
    int* warp_off, unsigned* bucket_off, long long* out_a, long long* out_b,
    long long* count) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1;
  const unsigned long long low = (1ull << w) - 1;
  constexpr int kCap = kBucketKeys * 4 / (int)sizeof(K);
  if (m > kCap) {
    // count the kept keys, look back, then write them in order, a block
    // row at a time
    unsigned kept_mine = 0;
    for (long long i = threadIdx.x; i < m; i += kThreads)
      kept_mine += i == 0 || src[i] != src[i - 1];
    const unsigned kept = block_sum(kept_mine, tmp);
    if (warp == 0) {
      const unsigned off = bpt::onepass::lookback(status, t, kept);
      if (lane == 0) {
        *bucket_off = off;
        if (t == buckets - 1) *count = (long long)off + kept;
      }
    }
    __syncthreads();
    const long long off = *bucket_off;
    long long at = off;
    for (long long c0 = 0; c0 < m; c0 += kThreads) {
      const long long i = c0 + threadIdx.x;
      const bool keep = i < m && (i == 0 || src[i] != src[i - 1]);
      const unsigned before = block_exclusive(keep, tmp);
      if (keep) {
        const unsigned long long k = src[i];
        out_a[at + before] = (long long)(k >> w);
        out_b[at + before] = (long long)(k & low);
      }
      at += __syncthreads_count(keep);
    }
    pad_dropped(out_a, out_b, live, start + m, off + kept, m - kept);
    __syncthreads();  // shared memory is free for the next bucket
    return;
  }
  K* __restrict__ buf = (K*)smem;
  K* __restrict__ buf2 = buf + kCap;
  unsigned* __restrict__ sub = (unsigned*)(smem + 2 * kBucketKeys * 4);
  unsigned* __restrict__ sub_start = sub + kSubBins;
  const int mi = (int)m;
  // the keys to buf as offsets from the base, below 2^shift, each counted
  // in the sub-bin of its top kSubBits bits
  const int lo = max(shift - kSubBits, 0);
  for (int i = threadIdx.x; i < kSubBins; i += kThreads) sub[i] = 0;
  __syncthreads();
  // (a batch's loads before its stores and atomics, so that they overlap)
  for (int i0 = threadIdx.x; i0 < mi; i0 += kBatch * kThreads) {
    K v[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int i = i0 + q * kThreads;
      v[q] = i < mi ? (K)(__ldcg(src + i) - base) : 0;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int i = i0 + q * kThreads;
      if (i < mi) {
        buf[i] = v[q];
        atomicAdd(sub + ((unsigned)(v[q] >> lo) & (kSubBins - 1)), 1u);
      }
    }
  }
  __syncthreads();
  constexpr int kPer = kSubBins / kThreads;
  unsigned own = 0;
#pragma unroll
  for (int q = 0; q < kPer; ++q) own += sub[kPer * threadIdx.x + q];
  unsigned sub_at = block_exclusive(own, tmp);
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const unsigned c = sub[kPer * threadIdx.x + q];
    sub_start[kPer * threadIdx.x + q] = sub_at;
    sub[kPer * threadIdx.x + q] = sub_at;
    sub_at += c;
  }
  if (threadIdx.x == kThreads - 1) sub_start[kSubBins] = sub_at;
  __syncthreads();
  for (int i0 = threadIdx.x; i0 < mi; i0 += kBatch * kThreads) {
    K v[kBatch];
    unsigned p[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int i = i0 + q * kThreads;
      v[q] = i < mi ? buf[i] : 0;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      if (i0 + q * kThreads < mi)
        p[q] = atomicAdd(sub + ((unsigned)(v[q] >> lo) & (kSubBins - 1)), 1u);
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      if (i0 + q * kThreads < mi) buf2[p[q]] = v[q];
  }
  __syncthreads();
  for (int i0 = threadIdx.x; i0 < mi; i0 += kBatch * kThreads) {
    K v[kBatch];
    int at[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int i = i0 + q * kThreads;
      v[q] = i < mi ? buf2[i] : 0;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int i = i0 + q * kThreads;
      const unsigned dd = (unsigned)(v[q] >> lo) & (kSubBins - 1);
      const int s0 = i < mi ? (int)sub_start[dd] : 0;
      const int s1 = i < mi ? (int)sub_start[dd + 1] : 0;
      int before = 0;
      for (int j = s0; j < s1; ++j) {
        const K u = buf2[j];
        before += u < v[q] || (u == v[q] && j < i);
      }
      at[q] = s0 + before;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      if (i0 + q * kThreads < mi) buf[at[q]] = v[q];
  }
  __syncthreads();

  // warp w holds positions [first, first + 32 rows)
  const int rows = (mi + 32 * kWarps - 1) / (32 * kWarps);
  const int first = warp * 32 * rows;
  int kept_warp = 0;
  for (int r = 0; r < rows; ++r) {
    const int i = first + 32 * r + lane;
    kept_warp += __popc(
        __ballot_sync(kFull, i < mi && (i == 0 || buf[i] != buf[i - 1])));
  }
  if (lane == 0) warp_off[warp] = kept_warp;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < kWarps ? warp_off[lane] : 0;
    int winc = v;
#pragma unroll
    for (int s = 1; s < kWarps; s <<= 1) {
      const int o2 = __shfl_up_sync(kFull, winc, s);
      if (lane >= s) winc += o2;
    }
    const int kept = __shfl_sync(kFull, winc, kWarps - 1);
    if (lane < kWarps) warp_off[lane] = winc - v;
    const unsigned off = bpt::onepass::lookback(status, t, kept);
    if (lane == 0) {
      bucket_off[0] = off;
      bucket_off[1] = kept;
      if (t == buckets - 1) *count = (long long)off + kept;
    }
  }
  __syncthreads();
  const long long off = bucket_off[0];
  const unsigned kept = bucket_off[1];
  long long at = off + warp_off[warp];
  for (int r = 0; r < rows; ++r) {
    const int i = first + 32 * r + lane;
    const bool keep = i < mi && (i == 0 || buf[i] != buf[i - 1]);
    const unsigned ball = __ballot_sync(kFull, keep);
    if (keep) {
      const long long o2 = at + __popc(ball & lt);
      const unsigned long long k = base + buf[i];
      out_a[o2] = (long long)(k >> w);
      out_b[o2] = (long long)(k & low);
    }
    at += __popc(ball);
  }
  pad_dropped(out_a, out_b, live, start + m, off + kept, m - kept);
  __syncthreads();  // shared memory is free for the next bucket
}

// The buckets, taken in order by ticket by a persistent grid, three
// blocks an SM; the lanes past the live count shared by the grid.
__global__ void __launch_bounds__(kThreads, 3)
pairsort_bucket_kernel(unsigned long long* scratch, Layout l,
                       const unsigned long long* keys1, long long* out_a,
                       long long* out_b, long long cap, long long* count) {
  extern __shared__ unsigned long long smem[];
  __shared__ unsigned tmp[kWarps];
  __shared__ int warp_off[kWarps];
  __shared__ unsigned bucket_off[2];
  const unsigned long long* info = scratch;
  unsigned long long* status = scratch + l.status;
  const long long live = (long long)info[kLive];
  for (long long j = live + (long long)blockIdx.x * kThreads + threadIdx.x;
       j < cap; j += (long long)gridDim.x * kThreads) {
    out_a[j] = kPadId;
    out_b[j] = kPadId;
  }
  const int buckets = (int)info[kBuckets];
  const int shift = (int)info[kShift];
  const int w = (int)info[kWidth];
  const unsigned long long least = ~info[kMinNot];
  const unsigned* hist = (const unsigned*)(scratch + l.hist);
  const unsigned* starts = (const unsigned*)(scratch + l.start);
  for (;;) {
    const int t = bpt::onepass::take_ticket(status, l.buckets);
    if (t >= buckets) {
      if (t == 0 && threadIdx.x == 0) *count = 0;  // no live key
      return;
    }
    const long long m = hist[t], start = starts[t];
    const unsigned long long base = least + ((unsigned long long)t << shift);
    if (shift <= 32)
      bucket_block<unsigned>(t, buckets, m, start, base, shift, w, live,
                             keys1 + start, status, (unsigned char*)smem, tmp,
                             warp_off, bucket_off, out_a, out_b, count);
    else
      bucket_block<unsigned long long>(
          t, buckets, m, start, base, shift, w, live, keys1 + start, status,
          (unsigned char*)smem, tmp, warp_off, bucket_off, out_a, out_b,
          count);
  }
}

}  // namespace

// The chain on the stream: `valid` holds a byte a lane (NULL: a lane is
// valid where a != b); `bound` is a device int64 at least every valid id
// (NULL: the bound kernel computes one).  The chain runs the pack, the
// histogram, the scatter, the spill sort and the bucket kernel (out_a,
// out_b, count).  keys0 and keys1 hold cap lanes each; the scratch holds
// bpt_pairsort_scratch(n, cap) words, and its first words are the Info
// fields.
extern "C" int bpt_pairsort(const void* a, const void* b, const void* valid,
                            const void* bound, void* keys0, void* keys1,
                            void* out_a, void* out_b, void* count,
                            void* scratch, long long n, long long cap,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Layout l = layout(n, cap);
  unsigned long long* words = (unsigned long long*)scratch;
  cudaError_t err =
      cudaMemsetAsync(words, 0, l.words * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;
  if (bound == nullptr && n > 0) {
    const long long blocks =
        tiles_of(n) * kItems < 132 * 8 ? tiles_of(n) * kItems : 132 * 8;
    pairsort_bound_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        (const long long*)a, (const long long*)b, (const unsigned char*)valid,
        n, words + kBoundOr);
  }
  if (bound == nullptr) bound = words + kBoundOr;
  if (n > 0)
    pairsort_pack_kernel<<<(unsigned)tiles_of(n), kThreads, 0, s>>>(
        (const unsigned char*)valid, (const long long*)a, (const long long*)b,
        n, cap, (const long long*)bound, words, l, (int)tiles_of(n),
        (unsigned long long*)keys0);
  if (cap <= 0) {
    err = cudaMemsetAsync(count, 0, sizeof(long long), s);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
  }
  const int counts_smem = l.buckets * (int)sizeof(unsigned);
  err = cudaFuncSetAttribute(pairsort_hist_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             counts_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(pairsort_scatter_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               counts_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(pairsort_bucket_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kBucketSmem);
  if (err != cudaSuccess) return (int)err;
  const long long wide_tiles = (cap + kScatterTile - 1) / kScatterTile;
  const unsigned hist_blocks =
      (unsigned)(wide_tiles < kCountBlocks ? wide_tiles : kCountBlocks);
  pairsort_hist_kernel<<<hist_blocks, kWide, counts_smem, s>>>(
      words, l, (const unsigned long long*)keys0);
  pairsort_scatter_kernel<<<(unsigned)wide_tiles, kWide, counts_smem, s>>>(
      words, l, (const unsigned long long*)keys0, (unsigned long long*)keys1);
  pairsort_spill_kernel<<<132, kThreads, 0, s>>>(
      words, l, (unsigned long long*)keys0, (unsigned long long*)keys1);
  const unsigned bucket_blocks =
      (unsigned)(l.buckets < kBucketBlocks ? l.buckets : kBucketBlocks);
  pairsort_bucket_kernel<<<bucket_blocks, kThreads, kBucketSmem, s>>>(
      words, l, (const unsigned long long*)keys1, (long long*)out_a,
      (long long*)out_b, cap, (long long*)count);
  return (int)cudaGetLastError();
}

// Words of scratch the chain needs for n input lanes and cap output lanes.
extern "C" long long bpt_pairsort_scratch(long long n, long long cap) {
  return layout(n, cap).words;
}
