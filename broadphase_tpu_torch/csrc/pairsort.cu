// Kernel 8: the canonical pair sort of layer.scan, as one chain: pack,
// LSD radix passes over the live keys, and a dedup epilogue.
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
//    on the device; the count of valid lanes; and, from the keys staged in
//    shared memory, the histograms of every radix digit the passes need.
//    The block that finishes last plans the passes: 8-bit digits over the
//    2w key bits, ceil(2w / 8) of them (5 for ids below 2^20, 8 for 32-bit
//    ids), less any digit that every live key shares, since a stable pass
//    over one digit moves nothing;
//  - passes, launched for all 8 digits: onesweep (Adinets and Merrill,
//    "Onesweep: A Faster Least Significant Digit Radix Sort for GPUs",
//    2022), keys only.  A pass that the plan drops returns at once; a live
//    pass runs blocks only over the live count.  A block counts its 4096
//    keys' digits and publishes the counts at once (one status word a tile
//    and digit, tagged with the pass so that one cleared region serves all
//    eight), ranks the keys by digit with warp match-any and per-warp
//    counters (stable: warp-major, then row, then lane, the tile's order),
//    looks back for each digit's prefix over the tiles before it, adds
//    the digit's global start from the pack's histogram,
//    stages the keys in digit order in shared memory and writes each
//    digit's run.  Passes ping-pong between two key buffers; which one
//    holds the result follows from the plan on the device;
//  - finish, one pass by decoupled look-back over the `cap` lanes: a live
//    key is kept where it differs from its predecessor (the dedup that
//    v2 and wide-id emissions need), decoded into a = key >> w and b =
//    key & (2^w - 1), and written at its rank; dropped lanes write the
//    pad as kernel 5 fills, so every output lane is written once.
//
// The host launches a fixed chain and reads nothing back: the width, the
// live count and the plan stay on the device.
//
// Bound on the H100: device memory.  The contract reads each live pair
// and writes each kept pair once, 8 bytes a pair; the chain reads the
// valid bytes and both id columns of the input once, reads and writes
// each live key once a live pass (8 bytes each way), and writes both
// output columns whole.  At 1M boxes (8.5M live pairs, 16.8M emission
// lanes, 9M output lanes) that is about 290 + 5 x 137 + 210 MB.
#include <cuda_runtime.h>

#include "scan1.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                    // lanes a thread
constexpr int kTile = kThreads * kItems;      // 4096 lanes a block
constexpr int kRows = kItems;                 // 32-lane rows a warp holds
constexpr int kDigitBits = 8;
constexpr int kRadix = 1 << kDigitBits;       // = kThreads: a digit a thread
constexpr int kMaxPasses = 64 / kDigitBits;   // two 32-bit ids
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kPadId = 0xFFFFFFFFLL;
constexpr unsigned kNoDigit = 0xffffffffu;    // a lane past the live count

static_assert(kRadix == kThreads, "one digit a thread");

// The chain's scratch, in 64-bit words, cleared by one memset.
enum Info {
  kTotal,    // valid lanes of the input
  kLive,     // min(total, cap): the keys the passes sort
  kWidth,    // w, the bit length of the id bound, at most 32
  kPlan,     // bit p set: pass p does work
  kPasses,   // passes that do work
  kDone,     // pack blocks finished
  kBoundOr,  // the bound kernel's OR of the valid ids
  kInfoWords = 8
};
constexpr long long kHistWords = kMaxPasses * kRadix / 2;  // u32 counts
constexpr long long kTicketWords = kMaxPasses;             // one a pass

struct Layout {
  long long hist, tickets, pack, finish, status, words;
};

__host__ __device__ inline long long tiles_of(long long n) {
  return (n + kTile - 1) / kTile;
}

inline Layout layout(long long n, long long cap) {
  Layout l;
  l.hist = kInfoWords;
  l.tickets = l.hist + kHistWords;
  l.pack = l.tickets + kTicketWords;
  l.finish = l.pack + bpt::onepass::scratch_words(tiles_of(n));
  l.status = l.finish + bpt::onepass::scratch_words(tiles_of(cap));
  l.words = l.status + tiles_of(cap) * kRadix;
  return l;
}

// A pass's status word: the pass's tag (pass + 1) in bits 40-47, the
// prefix flag in bit 32, the count in the low 32 bits.  A word of another
// tag is from an earlier pass, or cleared: not ready.
constexpr unsigned long long kStatusPrefix = 1ull << 32;
constexpr int kTagShift = 40;

__device__ __forceinline__ int bit_length(unsigned long long x) {
  return x ? 64 - __clzll(x) : 0;
}

__device__ __forceinline__ int width_of(const long long* bound) {
  return min(bit_length((unsigned long long)*bound), 32);
}

__device__ __forceinline__ int passes_of(int w) {
  return (2 * w + kDigitBits - 1) / kDigitBits;
}

__device__ __forceinline__ unsigned digit_of(unsigned long long key,
                                             int pass) {
  return (unsigned)(key >> (kDigitBits * pass)) & (kRadix - 1);
}

__device__ __forceinline__ unsigned long long warp_or(unsigned long long v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v |= __shfl_xor_sync(kFull, v, d);
  return v;
}

// Exclusive scan of one value a thread over the block; every thread calls
// it.  `tmp` holds kWarps words.
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
  for (int w = 0; w < kWarps; ++w)
    if (w < warp) before += tmp[w];
  __syncthreads();  // tmp is free for the next call
  return before + inc - v;
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
  __shared__ unsigned hist[kMaxPasses][kRadix];
  __shared__ int warp_off[kWarps];
  __shared__ int tile_kept;
  __shared__ long long tile_off;
  __shared__ int last_block;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned long long* info = scratch;
  unsigned* ghist = (unsigned*)(scratch + l.hist);
  unsigned long long* status = scratch + l.pack;
  const int tile = bpt::onepass::take_ticket(status, n_tiles);
  const long long base = (long long)tile * kTile;
  const int size = (int)min(n - base, (long long)kTile);
  const int w = width_of(bound);
  const int passes = passes_of(w);
  for (int i = threadIdx.x; i < kMaxPasses * kRadix; i += kThreads)
    (&hist[0][0])[i] = 0;

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
  for (int i = threadIdx.x; i < n_out; i += kThreads) keys[off + i] = stage[i];
  // the digits of the keys written, every pass the width needs
  for (int i = threadIdx.x; i < n_out; i += kThreads) {
    const unsigned long long k = stage[i];
    for (int p = 0; p < passes; ++p) atomicAdd(&hist[p][digit_of(k, p)], 1u);
  }
  __syncthreads();
  for (int p = 0; p < passes; ++p) {
    const unsigned v = hist[p][threadIdx.x];
    if (v) atomicAdd(ghist + p * kRadix + threadIdx.x, v);
  }
  if (tile == n_tiles - 1 && threadIdx.x == 0)
    info[kTotal] = (unsigned long long)(off + kept);

  // the block that finishes last plans the passes
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last_block = atomicAdd(info + kDone, 1ull) == (unsigned long long)(n_tiles - 1);
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  const unsigned long long total = __ldcg(info + kTotal);
  const unsigned long long live =
      min(total, (unsigned long long)max(cap, 0LL));
  unsigned plan = 0;
  for (int p = 0; p < passes; ++p) {
    // a digit every live key shares (all of them when none is live)
    const bool one =
        (unsigned long long)__ldcg(ghist + p * kRadix + threadIdx.x) == live;
    if (!__syncthreads_or(one)) plan |= 1u << p;
  }
  if (threadIdx.x == 0) {
    info[kLive] = live;
    info[kWidth] = (unsigned long long)w;
    info[kPlan] = plan;
    info[kPasses] = (unsigned long long)__popc(plan);
  }
}

// three blocks an SM (as the pack): at most 85 registers a thread
__global__ void __launch_bounds__(kThreads, 3)
pairsort_pass_kernel(unsigned long long* scratch, Layout l,
                     unsigned long long* keys0, unsigned long long* keys1,
                     int pass) {
  __shared__ unsigned long long stage[kTile];
  __shared__ unsigned wcount[kWarps][kRadix];
  __shared__ unsigned dstart[kRadix];
  __shared__ unsigned gstart[kRadix];
  __shared__ unsigned tmp[kWarps];
  __shared__ unsigned bins[kRadix];
  const unsigned long long* info = scratch;
  const unsigned plan = (unsigned)info[kPlan];
  if (!((plan >> pass) & 1)) return;
  const long long live = (long long)info[kLive];
  if ((long long)blockIdx.x * kTile >= live) return;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // tiles in the order the blocks started, over the blocks that did not
  // return: exactly the live tiles
  const int tile = bpt::onepass::take_ticket(scratch + l.tickets, pass);
  const bool odd = __popc(plan & ((1u << pass) - 1)) & 1;
  const unsigned long long* in = odd ? keys1 : keys0;
  unsigned long long* out = odd ? keys0 : keys1;
  for (int i = threadIdx.x; i < kWarps * kRadix; i += kThreads)
    (&wcount[0][0])[i] = 0;
  bins[threadIdx.x] = 0;
  const long long base = (long long)tile * kTile;
  const int size = (int)min(live - base, (long long)kTile);
  const long long row0 = base + 32 * kRows * warp + lane;
  unsigned long long key[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long i = row0 + 32 * r;
    key[r] = i < live ? in[i] : 0;
  }
  __syncthreads();

  // the tile's count of each digit, published before the ranking so that
  // the tiles after this one can look back past it early
  const int d = threadIdx.x;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (row0 + 32 * r < live) atomicAdd(&bins[digit_of(key[r], pass)], 1u);
  __syncthreads();
  const unsigned count = bins[d];
  unsigned long long* status = scratch + l.status;
  const unsigned long long tag = (unsigned long long)(pass + 1) << kTagShift;
  unsigned long long* mine = status + (long long)tile * kRadix + d;
  bpt::onepass::store_status(
      mine, tag | (tile == 0 ? kStatusPrefix : 0ull) | count);

  // rank each key among the warp's keys of its digit, in row-then-lane
  // order: rank[r] = (digit << 16) | rank
  const unsigned lt = (1u << lane) - 1;
  unsigned rank[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const bool ok = row0 + 32 * r < live;
    const unsigned digit = ok ? digit_of(key[r], pass) : kNoDigit;
    const unsigned peers = __match_any_sync(kFull, digit);
    const unsigned seen = ok ? wcount[warp][digit] : 0;
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1)
      wcount[warp][digit] = seen + __popc(peers);
    __syncwarp();
    rank[r] = (digit << 16) | (seen + __popc(peers & lt));
  }
  __syncthreads();

  // thread d: each warp's start within the tile's keys of digit d
  unsigned before = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned c = wcount[w][d];
    wcount[w][d] = before;
    before += c;
  }
  // look back over the tiles before this one for digit d
  unsigned exclusive = 0;
  if (tile > 0) {
    for (int t = tile - 1; t >= 0; --t) {
      unsigned long long word;
      do {
        word = bpt::onepass::load_status(status + (long long)t * kRadix + d);
      } while ((word >> kTagShift) != (unsigned long long)(pass + 1));
      exclusive += (unsigned)word;
      if (word & kStatusPrefix) break;
    }
    bpt::onepass::store_status(mine, tag | kStatusPrefix | (exclusive + count));
  }
  const unsigned h = __ldcg((const unsigned*)(scratch + l.hist) +
                            pass * kRadix + d);
  const unsigned hstart = block_exclusive(h, tmp);
  const unsigned lstart = block_exclusive(count, tmp);
  dstart[d] = lstart;
  gstart[d] = hstart + exclusive;
  __syncthreads();

  // stage the tile in digit order, then write each digit's run
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const unsigned dr = rank[r] >> 16;
    if (dr != (kNoDigit >> 16))
      stage[dstart[dr] + wcount[warp][dr] + (rank[r] & 0xffff)] = key[r];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < size; i += kThreads) {
    const unsigned long long k = stage[i];
    const unsigned dk = digit_of(k, pass);
    out[(long long)gstart[dk] + (i - (int)dstart[dk])] = k;
  }
}

// four blocks an SM: at most 64 registers a thread
__global__ void __launch_bounds__(kThreads, 4)
pairsort_finish_kernel(const unsigned long long* scratch, Layout l,
                       const unsigned long long* keys0,
                       const unsigned long long* keys1, long long* out_a,
                       long long* out_b, long long cap, int n_tiles,
                       long long* count) {
  __shared__ int warp_off[kWarps];
  __shared__ int tile_kept;
  __shared__ long long tile_off;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned long long* status = (unsigned long long*)scratch + l.finish;
  const int tile = bpt::onepass::take_ticket(status, n_tiles);
  const long long live = (long long)scratch[kLive];
  const int w = (int)scratch[kWidth];
  const unsigned long long* keys =
      (__popc((unsigned)scratch[kPlan]) & 1) ? keys1 : keys0;
  const unsigned long long low = (1ull << w) - 1;
  const long long base = (long long)tile * kTile;
  const int size = (int)min(cap - base, (long long)kTile);
  const long long row0 = base + 32 * kRows * warp + lane;

  unsigned long long key[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long i = row0 + 32 * r;
    key[r] = i < live ? keys[i] : 0;
  }
  // a live key is kept where it differs from the one before it
  unsigned ball[kRows];
  int kept_warp = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long i = row0 + 32 * r;
    unsigned long long prev = __shfl_up_sync(kFull, key[r], 1);
    if (lane == 0 && i > 0 && i < live) prev = keys[i - 1];
    const bool keep = i < live && (i == 0 || key[r] != prev);
    ball[r] = __ballot_sync(kFull, keep);
    kept_warp += __popc(ball[r]);
  }
  if (lane == 0) warp_off[warp] = kept_warp;
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
      if (tile == n_tiles - 1) *count = (long long)off + kept;
    }
  }
  __syncthreads();
  long long at = tile_off + warp_off[warp];
  const unsigned lt = (1u << lane) - 1;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if ((ball[r] >> lane) & 1) {
      const long long o = at + __popc(ball[r] & lt);
      out_a[o] = (long long)(key[r] >> w);
      out_b[o] = (long long)(key[r] & low);
    }
    at += __popc(ball[r]);
  }
  const int kept = tile_kept;
  const int dropped = size - kept;
  const long long fill_at = (cap - base - size) + tile_off + kept;
  for (int i = threadIdx.x; i < dropped; i += kThreads) {
    out_a[fill_at + i] = kPadId;
    out_b[fill_at + i] = kPadId;
  }
}

}  // namespace

// The chain on the stream: `valid` holds a byte a lane (NULL: a lane is
// valid where a != b); `bound` is a device int64 at least every valid id
// (NULL: the bound kernel computes one).  The chain runs the pack, the
// passes and the finish (out_a, out_b, count).  keys0 and keys1 hold cap
// lanes each; the scratch holds bpt_pairsort_scratch(n, cap) words, and
// its first words are the Info fields.
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
  if (cap > 0) {
    for (int p = 0; p < kMaxPasses; ++p)
      pairsort_pass_kernel<<<(unsigned)tiles_of(cap), kThreads, 0, s>>>(
          words, l, (unsigned long long*)keys0, (unsigned long long*)keys1,
          p);
    pairsort_finish_kernel<<<(unsigned)tiles_of(cap), kThreads, 0, s>>>(
        words, l, (const unsigned long long*)keys0,
        (const unsigned long long*)keys1, (long long*)out_a,
        (long long*)out_b, cap, (int)tiles_of(cap), (long long*)count);
  } else {
    err = cudaMemsetAsync(count, 0, sizeof(long long), s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// Words of scratch the chain needs for n input lanes and cap output lanes.
extern "C" long long bpt_pairsort_scratch(long long n, long long cap) {
  return layout(n, cap).words;
}
