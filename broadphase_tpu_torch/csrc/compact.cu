// Kernel 5: ordered stream compaction of up to four int64 columns.
//
// Replaces broadphase_tpu/ops/pallas_compact.py::stream_compact.  The TPU
// kernel walks its tiles in order on one core, carrying the output offset
// in SMEM and flushing a staging buffer in aligned blocks.  Here one pass
// over the data does it all, by decoupled look-back (scan1.cuh):
//
//  - a block takes a tile of 4096 lanes from the ticket.  Thread t loads
//    the keep bytes of lanes 16t .. 16t+15 as one 16-byte vector, so warp
//    w holds the flags of lanes [512w, 512w + 512) of the tile;
//  - each thread's kept count (popc of its 16-bit mask) is scanned within
//    the warp by shuffles and across the 8 warps in shared memory, and
//    warp 0 looks back for the tile's output offset;
//  - each column is loaded warp-striped: in row r, lane l of warp w reads
//    tile lane 512w + 32r + l, 256 contiguous bytes per warp.  The first
//    column's loads are issued before the scan, so they overlap the
//    look-back, and each later column's as soon as the one before is
//    staged, so they overlap its stores.  A lane's rank is its 16-lane
//    owner's offset plus the owner's mask bits below it, one shuffle away;
//  - kept values are staged in shared memory in order, then written as
//    the run [offset, offset + kept) with coalesced stores;
//  - the column loop is unrolled (the column pointers stay kernel
//    parameters, no local-memory copy) and the kernel is held to 3 blocks
//    an SM: 80 registers, no spills, 32.8 KB of shared memory a block;
//  - lanes at or past the count take the fill with no second launch: the
//    dropped lanes of tile t (size - kept) fill the run that ends D_t lanes
//    before n, where D_t = 4096 t - offset is the number of dropped lanes in
//    the tiles before t.  These runs tile [count, n) exactly, so every
//    output lane is written once.
//
// The old design (thread t owning 8 consecutive lanes, so each load and
// store touched 32 addresses 64 bytes apart; the keep bytes read twice;
// three launches, one of them a single block walking every tile sum) is
// gone.  Status words and the ticket are cleared by a cudaMemsetAsync in
// the entry point: 8 bytes per tile.
//
// Bound on the H100: device memory.  It reads each keep byte and each
// column once and writes each column once: n * (1 + 16 * ncols) bytes.
#include <cuda_runtime.h>

#include "scan1.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanesPerThread = 16;  // one 16-byte vector of keep bytes
constexpr int kRows = kLanesPerThread;  // 32-lane rows a warp loads
constexpr int kTile = kThreads * kLanesPerThread;  // 4096 lanes
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxCols = 4;

struct Columns {
  const long long* in[kMaxCols];
  long long* out[kMaxCols];
  long long fill[kMaxCols];
  int n;
};

// 16 keep bytes -> bit k set for byte k != 0.  __vcmpne4 leaves 0x01 in
// each nonzero byte of a word (after the mask); the multiply gathers the
// four bits 0, 8, 16, 24 into bits 24..27, with no carries.
__device__ __forceinline__ unsigned mask_of(uint4 v) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned b = __vcmpne4(w[k], 0u) & 0x01010101u;
    m |= ((b * 0x01020408u) >> 24) << (4 * k);
  }
  return m;
}

// v[r] = col[row0 + 32 r], 0 past n.
__device__ __forceinline__ void load_rows(const long long* col,
                                          long long row0, long long n,
                                          long long (&v)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long i = row0 + 32 * r;
    v[r] = i < n ? __ldcs(col + i) : 0;
  }
}

// three blocks an SM: at most 85 registers a thread
__global__ void __launch_bounds__(kThreads, 3)
compact_onepass_kernel(const unsigned char* keep, long long n, Columns c,
                       unsigned long long* scratch, int n_tiles,
                       long long* count) {
  __shared__ long long stage[kTile];
  __shared__ int warp_off[kWarps];
  __shared__ int tile_kept;
  __shared__ long long tile_off;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile = bpt::onepass::take_ticket(scratch, n_tiles);
  const long long base = (long long)tile * kTile;
  const int size = (int)min(n - base, (long long)kTile);

  // keep flags of lanes base + 16 * threadIdx.x + [0, 16)
  const long long mine = base + kLanesPerThread * threadIdx.x;
  unsigned mask = 0;
  if (size == kTile && ((size_t)keep & 15) == 0) {
    mask = mask_of(__ldcs((const uint4*)(keep + mine)));
  } else {
    for (int k = 0; k < kLanesPerThread; ++k)
      if (mine + k < n && keep[mine + k]) mask |= 1u << k;
  }

  // the first column, loaded now so that the loads overlap the look-back
  const long long row0 = base + 32 * kRows * warp + lane;
  long long v[kRows];
  load_rows(c.in[0], row0, n, v);

  // the thread's offset within its warp, the warp's within the tile
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
    const int w = lane < kWarps ? warp_off[lane] : 0;
    int winc = w;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int o = __shfl_up_sync(kFull, winc, d);
      if (lane >= d) winc += o;
    }
    const int kept = __shfl_sync(kFull, winc, kWarps - 1);
    if (lane < kWarps) warp_off[lane] = winc - w;
    const unsigned off = bpt::onepass::lookback(scratch, tile, kept);
    if (lane == 0) {
      tile_kept = kept;
      tile_off = off;
      if (tile == n_tiles - 1) *count = (long long)off + kept;
    }
  }
  __syncthreads();

  // A lane's slot in the stage, found as it is stored: lane l of row r
  // belongs to the thread at warp lane 2r + l/16, bit l%16, whose offset
  // and mask ride one shuffled word.
  const unsigned packed = ((unsigned)(inc - cnt) << 16) | mask;
  const int bit = lane & 15;
  const unsigned below = (1u << bit) - 1;
  const int wbase = warp_off[warp];

  const int kept = tile_kept;
  const int dropped = size - kept;
  const long long out_at = tile_off;
  const long long fill_at = (n - base - size) + tile_off + kept;
  // unrolled so that c.in[j], c.out[j] and c.fill[j] stay kernel
  // parameters, not a copy in local memory
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) {
    if (j >= c.n) break;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const unsigned p = __shfl_sync(kFull, packed, 2 * r + (lane >> 4));
      if ((p >> bit) & 1) stage[wbase + (int)(p >> 16) + __popc(p & below)] =
          v[r];
    }
    // the next column's loads overlap this column's stores
    if (j + 1 < kMaxCols && j + 1 < c.n) load_rows(c.in[j + 1], row0, n, v);
    __syncthreads();
    long long* out = c.out[j];
    for (int i = threadIdx.x; i < kept; i += kThreads)
      out[out_at + i] = stage[i];
    const long long f = c.fill[j];
    for (int i = threadIdx.x; i < dropped; i += kThreads) out[fill_at + i] = f;
    __syncthreads();  // the next column reuses the stage
  }
}

}  // namespace

extern "C" int bpt_compact(const void* keep, void* count, const void* in0,
                           const void* in1, const void* in2, const void* in3,
                           void* out0, void* out1, void* out2, void* out3,
                           long long fill0, long long fill1, long long fill2,
                           long long fill3, long long ncols, long long n,
                           void* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0) return (int)cudaMemsetAsync(count, 0, sizeof(long long), s);
  const long long tiles = (n + kTile - 1) / kTile;
  unsigned long long* words = (unsigned long long*)scratch;
  const cudaError_t err = bpt::onepass::clear(words, tiles, s);
  if (err != cudaSuccess) return (int)err;
  Columns c{{(const long long*)in0, (const long long*)in1,
             (const long long*)in2, (const long long*)in3},
            {(long long*)out0, (long long*)out1, (long long*)out2,
             (long long*)out3},
            {fill0, fill1, fill2, fill3},
            (int)ncols};
  compact_onepass_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
      (const unsigned char*)keep, n, c, words, (int)tiles, (long long*)count);
  return (int)cudaGetLastError();
}

// Lanes a block of the kernel takes; the wrapper sizes the scratch with it
// (one status word a tile, then the ticket).
extern "C" long long bpt_compact_tile() { return kTile; }
