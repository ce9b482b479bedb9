// Kernel 9: the tree sort of layer.build, as one chain: a bound, a pack of
// the live lanes, LSD radix passes over them, and a finish.
//
// Replaces no TPU kernel: the JAX package sorts the tree with lax.sort
// (broadphase_tpu/layer.py _sort_now, aux riding the id column where the
// ids allow), and the port called two stable torch.sort over the whole
// capacity, by (id << dim) | aux and then by key, with torch's glue around
// them.  The chain takes the tree's (key, id, aux) columns, int64, int64
// and int32, of n lanes; a lane is a pad where its id is PAD_ID, live ids
// are below 2^32 - 1, live keys below 2^key_bits and aux below 2^dim.  It
// writes the live lanes ordered by (key, id, aux), ties in lane order,
// then PAD_KEY / PAD_ID / 0, with aux masked as layer.mask_aux does (0
// everywhere once the largest live id reaches 2^29 - 1): exactly what the
// two stable sorts leave, and, on request, their permutation.
//
//  - bound: the largest live id, one partial a block (so nothing needs
//    clearing before it), and the clear of the chain's scratch;
//  - pack, one pass by decoupled look-back (scan1.cuh): the live lanes in
//    lane order, each written as a record of its key (u64) and a u32
//    payload: the tiebreak t = (id << dim) | aux, or the id where aux is
//    masked, which decodes back into id and aux; or, where the caller asks
//    for the permutation, the lane (the pads' lanes go to a list of their
//    own, in order).  From the records staged in shared memory it counts
//    the histograms of every digit the passes need and checks that t
//    never falls from one live lane to the next, across tiles too (a
//    block looks back past the pads before its tile for the last live
//    lane).  The block that finishes last plans the passes: 8-bit digits
//    of t (ceil((bitlen(max id) + dim) / 8), or of bitlen(max id) where
//    aux is masked), then of the key (ceil(key_bits / 8)), less any digit
//    every live record shares, and less every digit of t when t is
//    already in order: a stable sort by key alone then gives the order
//    the two stable sorts give, permutation included;
//  - passes, launched for 4 + ceil(key_bits / 8) digits: kernel 8's
//    onesweep passes (Adinets and Merrill, 2022) widened to carry the u32
//    payload beside the u64 key, over tiles of 6144 records (4096 in the
//    pack).  A pass that the plan drops returns at once; a live pass runs
//    blocks only over the live count.  A digit of t is read from the
//    payload, or through the lane from the input columns where the
//    payload is the lane;
//  - finish, one elementwise pass over the n output lanes: the sorted
//    keys, and ids and aux decoded from t (or gathered through the lane),
//    then the pads; the permutation when asked for.
//
// The host launches a fixed chain and reads nothing back: the largest id,
// the live count, the order flag and the plan stay on the device.
//
// Bound on the H100: device memory.  The contract reads the key, id and
// aux of each lane once and writes them once, 20 bytes each way; the
// chain reads the input columns once (and the ids twice), reads and writes
// each live record once a live pass (12 bytes each way), and writes the
// output columns once.  At 1M boxes (3.7M lanes, 3.28M live) that is
// about 150 + 5 x 79 + 100 MB.
#include <cuda_runtime.h>

#include "scan1.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                    // lanes a thread
constexpr int kTile = kThreads * kItems;      // 4096 lanes a block
constexpr int kRows = kItems;                 // 32-lane rows a warp holds
// lanes a thread in a pass: 24 runs the 1M passes 8% faster than 16 (and
// 3% faster than 20) on the H100, for a few bytes of spills
constexpr int kPassItems = 24;
constexpr int kPassTile = kThreads * kPassItems;
constexpr int kPassRows = kPassItems;
constexpr int kDigitBits = 8;
constexpr int kRadix = 1 << kDigitBits;       // = kThreads: a digit a thread
constexpr int kTbDigits = 4;                  // t: at most 32 bits
constexpr int kMaxKeyDigits = 8;              // keys: at most 63 bits
constexpr int kMaxPasses = kTbDigits + kMaxKeyDigits;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kPadId = 0xFFFFFFFFLL;
constexpr long long kPadKey = 0x7FFFFFFFFFFFFFFFLL;
// aux is masked once the largest live id reaches this (layer.mask_aux)
constexpr unsigned long long kNarrowIdBound = (1ull << 29) - 1;
constexpr unsigned kNoDigit = 0xffffffffu;    // a lane past the live count
constexpr int kBoundBlocks = 132 * 4;

static_assert(kRadix == kThreads, "one digit a thread");

// The chain's scratch, in 64-bit words.  The bound kernel clears all of it
// but the partial maxima, which it writes whole.
enum Info {
  kLive,       // live lanes: the records the passes sort
  kMaxId,      // the largest live id
  kPlan,       // bit p set: pass p does work (0-3 digits of t, then the key)
  kPasses,     // passes that do work
  kUnordered,  // set where t falls from one live lane to the next
  kDone,       // pack blocks finished
  kInfoWords = 8
};
constexpr long long kHistWords = kMaxPasses * kRadix / 2;  // u32 counts
constexpr long long kTicketWords = kMaxPasses;             // one a pass

struct Layout {
  long long hist, tickets, pack, status, cleared, partial, words;
};

__host__ __device__ inline long long tiles_of(long long n) {
  return (n + kTile - 1) / kTile;
}

__host__ __device__ inline long long pass_tiles_of(long long n) {
  return (n + kPassTile - 1) / kPassTile;
}

inline Layout layout(long long n) {
  Layout l;
  l.hist = kInfoWords;
  l.tickets = l.hist + kHistWords;
  l.pack = l.tickets + kTicketWords;
  l.status = l.pack + bpt::onepass::scratch_words(tiles_of(n));
  l.cleared = l.status + pass_tiles_of(n) * kRadix;
  l.partial = l.cleared;
  l.words = l.partial + kBoundBlocks;
  return l;
}

// Dynamic shared memory: the pack stages each record's key, t and (by
// lane) lane; a pass stages key, payload and digit.
constexpr int pack_smem(bool by_lane) {
  return kTile * (8 + 4 + (by_lane ? 4 : 0));
}
constexpr int kPassSmem = kPassTile * (8 + 4 + 1);

// A pass's status word: the pass's tag (pass + 1) in bits 40-47, the
// prefix flag in bit 32, the count in the low 32 bits.  A word of another
// tag is from an earlier pass, or cleared: not ready.
constexpr unsigned long long kStatusPrefix = 1ull << 32;
constexpr int kTagShift = 40;

__device__ __forceinline__ int bit_length(unsigned long long x) {
  return x ? 64 - __clzll(x) : 0;
}

__device__ __forceinline__ unsigned digit_of(unsigned long long v, int d) {
  return (unsigned)(v >> (kDigitBits * d)) & (kRadix - 1);
}

// t of a live lane: (id << dim) | aux, or the id where aux is masked
__device__ __forceinline__ unsigned tiebreak(long long id, int a, bool masked,
                                             int dim) {
  return masked ? (unsigned)id
                : (unsigned)(((unsigned long long)id << dim) | (unsigned)a);
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const unsigned long long o = __shfl_xor_sync(kFull, v, d);
    v = o > v ? o : v;
  }
  return v;
}

// The block's largest v; every thread calls it and gets it.  `tmp` holds
// kWarps words.
__device__ __forceinline__ unsigned long long block_max(
    unsigned long long v, unsigned long long* tmp) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) tmp[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned long long m = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m = tmp[w] > m ? tmp[w] : m;
  __syncthreads();  // tmp is free for the next call
  return m;
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

// Adds the warp's valid lanes to histogram h, one atomic for the warp where
// they share their digit (the zero digits and the ids' high digits), one a
// lane otherwise.  The whole warp calls it; valid lanes come first.
__device__ __forceinline__ void hist_add(unsigned* h, unsigned d,
                                         bool valid) {
  const unsigned first = __shfl_sync(kFull, d, 0);
  const unsigned on = __ballot_sync(kFull, valid);
  if (__all_sync(kFull, !valid || d == first)) {
    if ((threadIdx.x & 31) == 0 && on) atomicAdd(h + first, __popc(on));
  } else if (valid) {
    atomicAdd(h + d, 1u);
  }
}

__global__ void __launch_bounds__(kThreads)
treesort_bound_kernel(const long long* ids, long long n,
                      unsigned long long* scratch, long long cleared,
                      unsigned long long* partial) {
  __shared__ unsigned long long tmp[kWarps];
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (long long i = first; i < cleared; i += stride) scratch[i] = 0;
  unsigned long long m = 0;
  for (long long i = first; i < n; i += stride) {
    const long long id = __ldcs(ids + i);
    if (id != kPadId && (unsigned long long)id > m)
      m = (unsigned long long)id;
  }
  m = block_max(m, tmp);
  if (threadIdx.x == 0) partial[blockIdx.x] = m;
}

// two blocks an SM: at most 128 registers a thread
template <bool kByLane>
__global__ void __launch_bounds__(kThreads, 2)
treesort_pack_kernel(const long long* keys, const long long* ids,
                     const int* aux, long long n, int dim, int key_digits,
                     unsigned long long* scratch, Layout l, int n_tiles,
                     int n_partials, unsigned long long* k0, unsigned* q0,
                     unsigned* pads) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* stage_key = smem;
  unsigned* stage_t = (unsigned*)(smem + kTile);
  unsigned* stage_lane = stage_t + kTile;  // by lane only
  __shared__ unsigned hist[kMaxPasses][kRadix];
  __shared__ unsigned long long tmp[kWarps];
  __shared__ int warp_off[kWarps];
  __shared__ int tile_kept;
  __shared__ long long tile_off;
  __shared__ unsigned long long prev_lane;  // 1 + the lane, 0 for none
  __shared__ int last_block;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned long long* info = scratch;
  unsigned* ghist = (unsigned*)(scratch + l.hist);
  unsigned long long* status = scratch + l.pack;
  const int tile = bpt::onepass::take_ticket(status, n_tiles);
  const long long base = (long long)tile * kTile;

  // the keys, ids and aux of lanes row0 + 32 r, loaded now so that the
  // loads overlap the bound's reduction and the look-back
  const long long row0 = base + 32 * kRows * warp + lane;
  unsigned long long key[kRows];
  long long id[kRows];
  int a[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long i = row0 + 32 * r;
    id[r] = i < n ? __ldcs(ids + i) : kPadId;
    key[r] = i < n ? (unsigned long long)__ldcs(keys + i) : 0;
    a[r] = i < n ? __ldcs(aux + i) : 0;
  }

  unsigned long long m = 0;
  for (int i = threadIdx.x; i < n_partials; i += kThreads)
    m = max(m, __ldcg(scratch + l.partial + i));
  m = block_max(m, tmp);
  const bool masked = m >= kNarrowIdBound;
  const int t_digits =
      (bit_length(m) + (masked ? 0 : dim) + kDigitBits - 1) / kDigitBits;
  for (int i = threadIdx.x; i < kMaxPasses * kRadix; i += kThreads)
    (&hist[0][0])[i] = 0;

  // the live lanes of each row, and t in place of the id
  unsigned ball[kRows];
  unsigned t[kRows];
  int cnt = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    ball[r] = __ballot_sync(kFull, id[r] != kPadId);
    cnt += __popc(ball[r]);
    t[r] = tiebreak(id[r], a[r], masked, dim);
  }
  if (lane == 0) warp_off[warp] = cnt;
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
      prev_lane = 0;
    }
  }
  __syncthreads();

  // stage the live lanes' records in lane order; the pads' lanes go to
  // their list at (lane - live lanes before it)
  const unsigned lt = (1u << lane) - 1;
  const long long off = tile_off;
  int at = warp_off[warp];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long i = row0 + 32 * r;
    const int pos = at + __popc(ball[r] & lt);
    if ((ball[r] >> lane) & 1) {
      stage_key[pos] = key[r];
      stage_t[pos] = t[r];
      if (kByLane) stage_lane[pos] = (unsigned)i;
    } else if (kByLane && i < n) {
      pads[i - off - pos] = (unsigned)i;
    }
    at += __popc(ball[r]);
  }
  __syncthreads();
  const int kept = tile_kept;
  for (int j = threadIdx.x; j < kept; j += kThreads) {
    k0[off + j] = stage_key[j];
    q0[off + j] = kByLane ? stage_lane[j] : stage_t[j];
  }

  // t in order: within the tile, and the tile's first live lane against
  // the last live lane before the tile
  bool down = false;
  for (int j = threadIdx.x + 1; j < kept; j += kThreads)
    down |= stage_t[j] < stage_t[j - 1];
  if (kept > 0 && base > 0) {
    // the lane just before the tile, else a walk back over the pads
    if (threadIdx.x == 0 && __ldg(ids + base - 1) != kPadId)
      prev_lane = (unsigned long long)base;
    __syncthreads();
    for (long long end = base - 2; end >= 0; end -= kThreads) {
      const bool found_before = prev_lane != 0;
      __syncthreads();  // every thread has read it before it changes
      if (found_before) break;
      const long long i = end - threadIdx.x;
      const bool live = i >= 0 && __ldg(ids + i) != kPadId;
      // the warp's highest live lane is its lowest thread's
      const unsigned found = __ballot_sync(kFull, live);
      if (found && lane == __ffs(found) - 1)
        atomicMax(&prev_lane, (unsigned long long)i + 1);
      __syncthreads();
    }
    if (threadIdx.x == 0 && prev_lane > 0) {
      const long long p = (long long)prev_lane - 1;
      down |= stage_t[0] < tiebreak(__ldg(ids + p), __ldg(aux + p), masked,
                                    dim);
    }
  }
  if (__syncthreads_or(down) && threadIdx.x == 0)
    atomicOr(info + kUnordered, 1ull);

  // the digits of the records, every pass the widths need
  const int rounded = (kept + kThreads - 1) / kThreads * kThreads;
  for (int j = threadIdx.x; j < rounded; j += kThreads) {
    const bool valid = j < kept;
    const unsigned tj = stage_t[j];
    const unsigned long long kj = stage_key[j];
    for (int p = 0; p < t_digits; ++p)
      hist_add(hist[p], digit_of(tj, p), valid);
    for (int p = 0; p < key_digits; ++p)
      hist_add(hist[kTbDigits + p], digit_of(kj, p), valid);
  }
  __syncthreads();
  for (int p = 0; p < kTbDigits + key_digits; ++p) {
    const unsigned v = hist[p][threadIdx.x];
    if (v) atomicAdd(ghist + p * kRadix + threadIdx.x, v);
  }
  if (tile == n_tiles - 1 && threadIdx.x == 0)
    info[kLive] = (unsigned long long)(off + kept);

  // the block that finishes last plans the passes
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last_block =
        atomicAdd(info + kDone, 1ull) == (unsigned long long)(n_tiles - 1);
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  const unsigned long long live = __ldcg(info + kLive);
  const bool unordered = __ldcg(info + kUnordered) != 0;
  unsigned plan = 0;
  for (int p = 0; p < kTbDigits + key_digits; ++p) {
    if (p < kTbDigits && (!unordered || p >= t_digits)) continue;
    // a digit every live record shares (all of them when none is live)
    const bool one =
        (unsigned long long)__ldcg(ghist + p * kRadix + threadIdx.x) == live;
    if (!__syncthreads_or(one)) plan |= 1u << p;
  }
  if (threadIdx.x == 0) {
    info[kMaxId] = m;
    info[kPlan] = plan;
    info[kPasses] = (unsigned long long)__popc(plan);
  }
}

// two blocks an SM: at most 128 registers a thread
template <bool kByLane>
__global__ void __launch_bounds__(kThreads, 2)
treesort_pass_kernel(unsigned long long* scratch, Layout l,
                     unsigned long long* k0, unsigned long long* k1,
                     unsigned* q0, unsigned* q1, const long long* ids,
                     const int* aux, int dim, int pass) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* stage_key = smem;
  unsigned* stage_pay = (unsigned*)(smem + kPassTile);
  unsigned char* stage_digit = (unsigned char*)(stage_pay + kPassTile);
  __shared__ unsigned wcount[kWarps][kRadix];
  __shared__ unsigned dstart[kRadix];
  __shared__ unsigned gstart[kRadix];
  __shared__ unsigned tmp[kWarps];
  __shared__ unsigned bins[kRadix];
  const unsigned long long* info = scratch;
  const unsigned plan = (unsigned)info[kPlan];
  if (!((plan >> pass) & 1)) return;
  const long long live = (long long)info[kLive];
  if ((long long)blockIdx.x * kPassTile >= live) return;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // tiles in the order the blocks started, over the blocks that did not
  // return: exactly the live tiles
  const int tile = bpt::onepass::take_ticket(scratch + l.tickets, pass);
  const bool odd = __popc(plan & ((1u << pass) - 1)) & 1;
  const unsigned long long* kin = odd ? k1 : k0;
  unsigned long long* kout = odd ? k0 : k1;
  const unsigned* qin = odd ? q1 : q0;
  unsigned* qout = odd ? q0 : q1;
  const bool masked = info[kMaxId] >= kNarrowIdBound;
  for (int i = threadIdx.x; i < kWarps * kRadix; i += kThreads)
    (&wcount[0][0])[i] = 0;
  bins[threadIdx.x] = 0;
  const long long base = (long long)tile * kPassTile;
  const int size = (int)min(live - base, (long long)kPassTile);
  const long long row0 = base + 32 * kPassRows * warp + lane;
  // each record's digit: of t for passes 0-3, read from the payload or
  // through the lane, else of the key
  unsigned long long key[kPassRows];
  unsigned rank[kPassRows];
#pragma unroll
  for (int r = 0; r < kPassRows; ++r) {
    const long long i = row0 + 32 * r;
    const bool ok = i < live;
    key[r] = ok ? kin[i] : 0;
    if (pass >= kTbDigits) {
      rank[r] = digit_of(key[r], pass - kTbDigits);
    } else if (!ok) {
      rank[r] = 0;
    } else if (kByLane) {
      const unsigned p = qin[i];
      rank[r] = digit_of(tiebreak(ids[p], aux[p], masked, dim), pass);
    } else {
      rank[r] = digit_of(qin[i], pass);
    }
  }
  __syncthreads();

  // the tile's count of each digit, published before the ranking so that
  // the tiles after this one can look back past it early
  const int d = threadIdx.x;
#pragma unroll
  for (int r = 0; r < kPassRows; ++r)
    if (row0 + 32 * r < live) atomicAdd(&bins[rank[r]], 1u);
  __syncthreads();
  const unsigned count = bins[d];
  unsigned long long* status = scratch + l.status;
  const unsigned long long tag = (unsigned long long)(pass + 1) << kTagShift;
  unsigned long long* mine = status + (long long)tile * kRadix + d;
  bpt::onepass::store_status(
      mine, tag | (tile == 0 ? kStatusPrefix : 0ull) | count);

  // rank each record among the warp's records of its digit, in
  // row-then-lane order: rank[r] = (digit << 16) | rank
  const unsigned lt = (1u << lane) - 1;
#pragma unroll
  for (int r = 0; r < kPassRows; ++r) {
    const bool ok = row0 + 32 * r < live;
    const unsigned digit = ok ? rank[r] : kNoDigit;
    const unsigned peers = __match_any_sync(kFull, digit);
    const unsigned seen = ok ? wcount[warp][digit] : 0;
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1)
      wcount[warp][digit] = seen + __popc(peers);
    __syncwarp();
    rank[r] = (digit << 16) | (seen + __popc(peers & lt));
  }
  __syncthreads();

  // thread d: each warp's start within the tile's records of digit d
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
  for (int r = 0; r < kPassRows; ++r) {
    const unsigned dr = rank[r] >> 16;
    if (dr != (kNoDigit >> 16)) {
      const int pos = dstart[dr] + wcount[warp][dr] + (rank[r] & 0xffff);
      stage_key[pos] = key[r];
      stage_pay[pos] = qin[row0 + 32 * r];
      stage_digit[pos] = (unsigned char)dr;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < size; i += kThreads) {
    const unsigned dk = stage_digit[i];
    const long long o = (long long)gstart[dk] + (i - (int)dstart[dk]);
    kout[o] = stage_key[i];
    qout[o] = stage_pay[i];
  }
}

template <bool kByLane>
__global__ void __launch_bounds__(kThreads)
treesort_finish_kernel(const unsigned long long* scratch,
                       const unsigned long long* k0,
                       const unsigned long long* k1, const unsigned* q0,
                       const unsigned* q1, const long long* ids,
                       const int* aux, const unsigned* pads, long long n,
                       int dim, long long* out_keys, long long* out_ids,
                       int* out_aux, long long* perm) {
  const long long live = (long long)scratch[kLive];
  const bool masked = scratch[kMaxId] >= kNarrowIdBound;
  const bool odd = __popc((unsigned)scratch[kPlan]) & 1;
  const unsigned long long* k = odd ? k1 : k0;
  const unsigned* q = odd ? q1 : q0;
  const unsigned low = (1u << dim) - 1;
  for (long long j = (long long)blockIdx.x * kThreads + threadIdx.x; j < n;
       j += (long long)gridDim.x * kThreads) {
    long long key = kPadKey, id = kPadId;
    int a = 0;
    if (j < live) {
      key = (long long)k[j];
      const unsigned p = q[j];
      if (kByLane) {
        id = ids[p];
        a = masked ? 0 : aux[p];
        perm[j] = p;
      } else {
        id = masked ? p : p >> dim;
        a = masked ? 0 : (int)(p & low);
      }
    } else if (kByLane) {
      perm[j] = pads[j - live];
    }
    out_keys[j] = key;
    out_ids[j] = id;
    out_aux[j] = a;
  }
}

template <bool kByLane>
cudaError_t launch_chain(const long long* keys, const long long* ids,
                         const int* aux, unsigned long long* k0,
                         unsigned long long* k1, unsigned* q0, unsigned* q1,
                         unsigned* pads, long long* out_keys,
                         long long* out_ids, int* out_aux, long long* perm,
                         unsigned long long* scratch, long long n, int dim,
                         int key_digits, cudaStream_t s) {
  const Layout l = layout(n);
  const int n_tiles = (int)tiles_of(n);
  const int n_partials = n_tiles < kBoundBlocks ? n_tiles : kBoundBlocks;
  cudaError_t err = cudaFuncSetAttribute(
      treesort_pack_kernel<kByLane>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, pack_smem(kByLane));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(treesort_pass_kernel<kByLane>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kPassSmem);
  if (err != cudaSuccess) return err;
  treesort_bound_kernel<<<n_partials, kThreads, 0, s>>>(
      ids, n, scratch, l.cleared, scratch + l.partial);
  treesort_pack_kernel<kByLane><<<n_tiles, kThreads, pack_smem(kByLane), s>>>(
      keys, ids, aux, n, dim, key_digits, scratch, l, n_tiles, n_partials, k0,
      q0, pads);
  for (int p = 0; p < kTbDigits + key_digits; ++p)
    treesort_pass_kernel<kByLane>
        <<<(unsigned)pass_tiles_of(n), kThreads, kPassSmem, s>>>(
        scratch, l, k0, k1, q0, q1, ids, aux, dim, p);
  const long long blocks = (n + kThreads - 1) / kThreads;
  treesort_finish_kernel<kByLane>
      <<<(unsigned)(blocks < 132 * 64 ? blocks : 132 * 64), kThreads, 0, s>>>(
          scratch, k0, k1, q0, q1, ids, aux, pads, n, dim, out_keys, out_ids,
          out_aux, perm);
  return cudaGetLastError();
}

}  // namespace

// The chain on the stream, over n lanes of (keys, ids, aux): int64, int64,
// int32.  k0, k1 hold n u64 records' keys and q0, q1 their u32 payloads;
// out_keys, out_ids (int64) and out_aux (int32) take n lanes; key_digits
// is ceil(key_bits / 8), at most 8.  With by_lane set the chain also
// writes the permutation to perm (int64, n lanes), listing the pads'
// lanes in pads (u32, n lanes); without it both may be NULL.  The scratch
// holds bpt_treesort_scratch(n) words, and its first words are the Info
// fields.
extern "C" int bpt_treesort(const void* keys, const void* ids, const void* aux,
                            void* k0, void* k1, void* q0, void* q1,
                            void* pads, void* out_keys, void* out_ids,
                            void* out_aux, void* perm, void* scratch,
                            long long n, long long dim, long long key_digits,
                            long long by_lane, void* stream) {
  if (n <= 0) return 0;
  if (key_digits < 1 || key_digits > kMaxKeyDigits || dim < 1 || dim > 3)
    return (int)cudaErrorInvalidValue;
  auto chain = by_lane ? &launch_chain<true> : &launch_chain<false>;
  return (int)chain(
      (const long long*)keys, (const long long*)ids, (const int*)aux,
      (unsigned long long*)k0, (unsigned long long*)k1, (unsigned*)q0,
      (unsigned*)q1, (unsigned*)pads, (long long*)out_keys,
      (long long*)out_ids, (int*)out_aux, (long long*)perm,
      (unsigned long long*)scratch, n, (int)dim, (int)key_digits,
      (cudaStream_t)stream);
}

// Words of scratch the chain needs for n lanes.
extern "C" long long bpt_treesort_scratch(long long n) {
  return layout(n).words;
}
