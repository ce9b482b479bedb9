// Kernel 2, pass 1 of the scan: descendant-run ends and the two rule-byte
// columns, in one pass straight from the sorted keys.
//
// Replaces broadphase_tpu/ops/pallas_runends.py::run_ends and the columns
// the JAX package computes around it in XLA (broadphase_tpu/layer.py:913-914,
// :928-929, :946).  For every lane j of the sorted tree, pads included:
//
//   lca[j]   = depth of the lowest common ancestor of keys j and j + 1: the
//              leading zeros of their XOR within key_bits, over dim, clamped
//              to axis_bits; -1 for the last lane
//   dep[j]   = the key's depth field
//   e[j]     = 1 + min{ i >= j : lca[i] < dep[j] }, 0 for dep[j] > axis_bits
//   bmeta[j] = ((dep << dim) | (aux & (2^dim - 1))) & 0xFF
//   ameta[j] = ((alpha << dim) | (aux & (2^dim - 1))) & 0xFF, alpha =
//              clamp(dep - min over the axes k with aux bit k of tz_k, 0, 31)
//              and tz_k the trailing zeros of the cell's axis-k coordinate
//              in depth units (index.tz_pack)
//
// Every clz and ctz is one instruction here (__clzll, __ffsll); the torch
// formulation emulates each in six rounds of shifts and selects.
//
// e is a suffix minimum per depth level.  A block takes a tile of 4096
// lanes from a ticket that hands out the tiles from the LAST one backward.
// In row r, lane l of warp w holds tile lane 512 w + 32 r + l:
//
//  - the warp loads its 16 rows of keys and aux coalesced, all before it
//    computes (a lane's successor key is a shuffle away; lane 31 of the
//    last row loads one more), and writes each row's rule bytes;
//  - each lane sets bit d of a word for every level d with lca < d (all
//    bits below the levels for lca = -1, none past n), and a 32 x 32 bit
//    transpose across the warp (five shuffle rounds) gives lane d the
//    row's lanes with lca < d: what 20 to 30 ballots would give;
//  - lane d of each warp finds the warp's first position with lca < d; warp
//    0 takes their minimum, the tile's aggregate per level, and looks
//    "back" over the LATER tiles by decoupled look-back (Merrill and
//    Garland, 2016) to find, per level, the first qualifying position after
//    the tile.  Min is associative and idempotent, and the first qualifying
//    position is non-increasing in d, so a tile whose minimum lca is z - 1
//    has positions at every level d >= z and none below.  Its status word
//    holds a flag and z; its 32 per-level positions live in a row of their
//    own, written before the flag with a fence.  Level d is resolved by the
//    first tile in the window that has a position at d (z <= d) or has
//    published its inclusive row; lane l of the warp reads the status of
//    the tile 1 + l after it, 32 tiles a round.  The last tile needs no
//    look-back: lca = -1 at its last lane qualifies at every level;
//  - each lane's answer is the first lane at or after it in its row's word
//    of its own depth (one shuffle from lane dep), else the first position
//    after the row at that depth (a second shuffle), which lane d carries
//    as it walks the rows from the last one up.
//
// Every lane does the same bounded work whatever the run lengths: a depth-0
// object, whose run covers the whole tree, costs nothing extra.  The entry
// point clears the status words and the ticket with one cudaMemsetAsync (4
// bytes a tile); the per-level rows need no clearing.
//
// Bound on the H100: device memory.  It reads the keys (8 bytes) and aux (4)
// once and writes e, ameta and bmeta (4 each): 24 bytes a lane, 12 without
// the rule bytes.
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                     // 32-lane rows a warp owns
constexpr int kTile = kThreads * kRows;       // 4096 lanes
constexpr int kMaxLevels = 32;
constexpr int kInf = INT_MAX;
constexpr int kNever = 127;                   // an lca no level is above
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kAggregate = 1u << 16;     // status: the tile's own row
constexpr unsigned kInclusive = 2u << 16;     // status: the inclusive row
constexpr unsigned kZ = 0xffffu;              // status: z

struct Spec {
  long long key_mask;        // (1 << key_bits) - 1
  long long origin_mask;     // the Morton field
  long long axis_mask[3];    // the Morton bits of each axis, unshifted
  int key_bits, axis_bits, origin_shift, depth_mask;
  int levels;                // axis_bits + 1
};

__device__ __forceinline__ unsigned load_status(const unsigned* word) {
  return *(const volatile unsigned*)word;
}

// Lane l holds row l of a 32 x 32 bit matrix (bit d: column d); returns to
// lane d its column d (bit l: row l's bit d).  Each round swaps the
// off-diagonal blocks of every 2j x 2j block with the partner lane l ^ j.
__device__ __forceinline__ unsigned transpose32(unsigned x) {
  const int lane = threadIdx.x & 31;
  unsigned low = 0x0000ffffu;
#pragma unroll
  for (int j = 16; j > 0; j >>= 1, low ^= low << j) {
    const unsigned y = __shfl_xor_sync(kFull, x, j);
    x = (lane & j) ? (x & ~low) | ((y & ~low) >> j)
                   : (x & low) | ((y & low) << j);
  }
  return x;
}

// The rule bytes of one live lane.
template <int DIM>
__device__ __forceinline__ void rule_bytes(const Spec& sp, long long key,
                                           int dep, int a, int* ameta,
                                           int* bmeta, long long p) {
  constexpr int kEMask = (1 << DIM) - 1;
  bmeta[p] = ((dep << DIM) | (a & kEMask)) & 0xFF;
  const long long morton = (key & sp.origin_mask) >> sp.origin_shift;
  int mtz = 31;
#pragma unroll
  for (int ax = 0; ax < DIM; ++ax) {
    const long long m = morton & sp.axis_mask[ax];
    int tz = 31;
    if (m != 0) {
      const int j = (__ffsll(m) - 1 - ax) / DIM;
      tz = min(max(j - (sp.axis_bits - dep), 0), 31);
    }
    if ((a >> ax) & 1) mtz = min(mtz, tz);
  }
  const int alpha = min(max(dep - mtz, 0), 31);
  ameta[p] = ((alpha << DIM) | (a & kEMask)) & 0xFF;
}

// Called by warp 0 of the block that owns `tile`, lane d holding the
// tile's first position with lca < d (kInf if none).  Publishes it, and
// returns to lane d the first such position after the tile (kInf for the
// last tile); publishes the tile's inclusive row.
__device__ __forceinline__ int lookback(unsigned* status, int* rows,
                                        int tile, int n_tiles, int levels,
                                        int agg) {
  const int lane = threadIdx.x & 31;
  const unsigned has = __ballot_sync(kFull, lane < levels && agg != kInf);
  const unsigned z = has ? __ffs(has) - 1 : 32;
  int* row = rows + (long long)tile * kMaxLevels;
  row[lane] = agg;
  if (z == 0) {          // the last tile: its own row is inclusive
    __threadfence();
    __syncwarp();
    if (lane == 0) *(volatile unsigned*)(status + tile) = kInclusive | z;
    return kInf;
  }
  __threadfence();
  __syncwarp();
  if (lane == 0) *(volatile unsigned*)(status + tile) = kAggregate | z;

  int carry = kInf;
  unsigned todo = __ballot_sync(kFull, lane < levels);
  for (int t0 = tile + 1; todo; t0 += 32) {
    const int i = t0 + lane;
    unsigned w;
    do {   // past the last tile reads as an inclusive row (never reached)
      w = i < n_tiles ? load_status(status + i) : kInclusive;
    } while (__any_sync(kFull, (w & ~kZ) == 0));
    __threadfence();
    // lane d: the first tile of the window that settles level d
    int src = -1;
    for (int d = 0; d < levels; ++d) {
      const unsigned m =
          __ballot_sync(kFull, (w & kInclusive) || (int)(w & kZ) <= d);
      if (lane == d && m) src = __ffs(m) - 1;
    }
    const bool settle = ((todo >> lane) & 1) && src >= 0;
    if (settle)
      carry = __ldcg(rows + (long long)(t0 + src) * kMaxLevels + lane);
    todo &= ~__ballot_sync(kFull, settle);
  }
  // the inclusive row: the tile's own position where it has one
  if (lane < levels && agg == kInf) row[lane] = carry;
  __threadfence();
  __syncwarp();
  if (lane == 0) *(volatile unsigned*)(status + tile) = kInclusive | z;
  return carry;
}

// two blocks an SM: at most 128 registers a thread
template <int DIM>
__global__ void __launch_bounds__(kThreads, 2)
pass1_kernel(const long long* keys, const int* aux, long long n, Spec sp,
             int rules, int* e, int* ameta, int* bmeta, unsigned* scratch,
             int n_tiles) {
  __shared__ int s_first[kWarps][kMaxLevels];
  __shared__ int s_carry[kMaxLevels];
  __shared__ int s_tile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* rows = (int*)scratch;
  unsigned* status = scratch + (long long)kMaxLevels * n_tiles;
  if (threadIdx.x == 0)
    s_tile = n_tiles - 1 - (int)atomicAdd(status + n_tiles, 1u);
  __syncthreads();
  const int tile = s_tile;
  const long long wbase = (long long)tile * kTile + 32 * kRows * warp;
  const int levels = sp.levels;

  // every row's keys and aux first, so that their loads are in flight
  // together
  long long key[kRows];
  int a[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long p = wbase + 32 * r + lane;
    key[r] = p < n ? __ldcs(keys + p) : 0;
    a[r] = rules && aux && p < n ? __ldcs(aux + p) : 0;
  }
  const long long last = wbase + 32 * kRows;  // lane 31's successor, row 15
  const long long halo = lane == 31 && last < n ? keys[last] : 0;
  const unsigned level_mask = levels >= 32 ? kFull : (1u << levels) - 1;

  // per row: this lane's depth (kNever past n) and, in lane d, the row's
  // lanes with lca < d
  int dep[kRows];
  unsigned bits[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long p = wbase + 32 * r + lane;
    const long long down = __shfl_down_sync(kFull, key[r], 1);
    const long long next_row =
        __shfl_sync(kFull, r + 1 < kRows ? key[r + 1] : 0, 0);
    const long long nxt =
        lane < 31 ? down : (r + 1 < kRows ? next_row : halo);
    unsigned below = 0;   // bit d: lca < d
    dep[r] = kNever;
    if (p < n) {
      dep[r] = (int)(key[r] & sp.depth_mask);
      if (p == n - 1) {
        below = kFull;
      } else {
        const int nlz =
            sp.key_bits - 64 + __clzll((key[r] ^ nxt) & sp.key_mask);
        const int lca = min(nlz / DIM, sp.axis_bits);
        below = lca >= 31 ? 0 : ~((2u << lca) - 1);
      }
      if (rules) rule_bytes<DIM>(sp, key[r], dep[r], a[r], ameta, bmeta, p);
    }
    bits[r] = transpose32(below & level_mask);
  }

  // lane d: the warp's first position with lca < d
  int first = kInf;
#pragma unroll
  for (int r = kRows - 1; r >= 0; --r)
    if (bits[r]) first = (int)(wbase + 32 * r) + __ffs(bits[r]) - 1;
  s_first[warp][lane] = first;
  __syncthreads();

  if (warp == 0) {
    int agg = kInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) agg = min(agg, s_first[w][lane]);
    s_carry[lane] = lookback(status, rows, tile, n_tiles, levels, agg);
  }
  __syncthreads();

  // lane d: the first position with lca < d after this warp, then after
  // each row as the walk goes up
  int after = s_carry[lane];
#pragma unroll
  for (int w = kWarps - 1; w > 0; --w)
    if (w > warp) after = min(after, s_first[w][lane]);
#pragma unroll
  for (int r = kRows - 1; r >= 0; --r) {
    const long long row = wbase + 32 * r;
    const int q = dep[r];
    const unsigned b = __shfl_sync(kFull, bits[r], q & 31);
    const int later = __shfl_sync(kFull, after, q & 31);
    const unsigned m = b & (kFull << lane);
    const int pos = m ? (int)row + __ffs(m) - 1 : later;
    if (row + lane < n) e[row + lane] = q < levels ? pos + 1 : 0;
    if (bits[r]) after = (int)row + __ffs(bits[r]) - 1;
  }
}

}  // namespace

// keys int64 (n), aux int32 (n) or null (aux 0); writes e, and with rules
// != 0 ameta and bmeta, int32 (n).  scratch: 33 * tiles + 1 int32 words,
// tiles = ceil(n / bpt_runends_tile()).
extern "C" int bpt_runends(const void* keys, const void* aux, void* e,
                           void* ameta, void* bmeta, void* scratch,
                           long long n, long long dim, long long key_bits,
                           long long axis_bits, long long depth_bits,
                           long long axis_mask0, long long axis_mask1,
                           long long axis_mask2, long long rules,
                           void* stream) {
  if (n < 0 || n >= INT_MAX - kTile || (dim != 2 && dim != 3) ||
      axis_bits < 1 || axis_bits + 1 > kMaxLevels || key_bits < 1 ||
      key_bits > 63 || depth_bits < 1 ||
      dim * axis_bits + depth_bits != key_bits)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const long long tiles = (n + kTile - 1) / kTile;
  unsigned* words = (unsigned*)scratch;
  const cudaError_t err = cudaMemsetAsync(
      words + kMaxLevels * tiles, 0, (tiles + 1) * sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  Spec sp;
  sp.key_mask = (long long)((1ull << key_bits) - 1);
  sp.origin_mask = (long long)(((1ull << (dim * axis_bits)) - 1)
                               << depth_bits);
  sp.axis_mask[0] = axis_mask0;
  sp.axis_mask[1] = axis_mask1;
  sp.axis_mask[2] = axis_mask2;
  sp.key_bits = (int)key_bits;
  sp.axis_bits = (int)axis_bits;
  sp.origin_shift = (int)depth_bits;
  sp.depth_mask = (int)((1ll << depth_bits) - 1);
  sp.levels = (int)axis_bits + 1;
  if (dim == 3)
    pass1_kernel<3><<<(unsigned)tiles, kThreads, 0, s>>>(
        (const long long*)keys, (const int*)aux, n, sp, (int)rules, (int*)e,
        (int*)ameta, (int*)bmeta, words, (int)tiles);
  else
    pass1_kernel<2><<<(unsigned)tiles, kThreads, 0, s>>>(
        (const long long*)keys, (const int*)aux, n, sp, (int)rules, (int*)e,
        (int*)ameta, (int*)bmeta, words, (int)tiles);
  return (int)cudaGetLastError();
}

// Lanes a block of the kernel takes; the wrapper sizes the scratch with it.
extern "C" long long bpt_runends_tile() { return kTile; }
