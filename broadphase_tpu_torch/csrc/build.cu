// Kernel 1: fused cell emission for build.
//
// Replaces broadphase_tpu/ops/pallas_build.py::emit_build.  Each object
// runs geom.depth_for_bounds -> truncate_to_depth -> per-axis spans and
// steps -> Morton spreads -> up to A^dim cell keys with their block-offset
// aux bits, exactly in u32 arithmetic as the JAX code does.  The valid
// cells of contained objects are written in object-major, x-fastest order,
// the plain version's order slot for slot; writes stop at out_cap, so an
// overflowing build keeps the same prefix as the JAX package, and the
// count takes every valid cell.
//
// One block takes a tile of 256 objects, in one pass by decoupled
// look-back (scan1.cuh, the wide variant: the cell count of a large A may
// pass 2^32):
//
//  - its tile index comes from the ticket, so a block only waits on tiles
//    whose blocks are already running;
//  - it loads their (dim) bounds, contained bytes and ids as contiguous
//    runs into shared memory, and each thread then reads its own object;
//  - each axis has only A distinct cell coordinates, tmin + a * step, so a
//    thread spreads each of them once, with the spec's constant shift and
//    mask stages (index.py::_spread_stages, at most 5), not a loop over
//    the bits; a cell's Morton code is the OR of its axes' codes;
//  - A is a template parameter: 2, LayerBuilder's default, unrolls the
//    cell walk with no division; one more instantiation takes any A;
//  - a block scan of the objects' cell counts gives each object its place
//    in the tile, and warp 0 looks back for the tile's base: the cells of
//    the tiles before it.  The block that takes the last ticket writes the
//    count.  The cells are staged in shared memory in object order and
//    written as one run with coalesced stores (keys, ids looked up from
//    the staged object, aux), 2048 cells at a time: all of them at once
//    for A = 2 in 2D or 3D;
//  - the cell-overflow flag takes one atomic a block.
//
// The entry point clears the status words and the ticket with one
// cudaMemsetAsync (16 bytes a tile).
//
// Bound on the H100: device memory.  It reads 2 * dim * 8 + 9 bytes per
// object and writes 20 bytes per emitted cell; the integer work (2 * dim
// spreads of 5 stages an object) is small beside that.
#include <cuda_runtime.h>

#include "scan1.cuh"

namespace {

namespace wide = bpt::onepass::wide;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStageCells = 2048;  // 256 objects x 8 cells (A = 2, 3D)
constexpr int kSpreadStages = 5;   // for axis_bits in [9, 32]
constexpr unsigned kFull = 0xffffffffu;

struct Spread {
  unsigned long long mask[kSpreadStages];
  int shift[kSpreadStages];
};

struct BuildArgs {
  const long long* lmin;  // (n, dim) u32 values held in int64
  const long long* lmax;
  const unsigned char* contained;
  const long long* ids;
  long long n;
  int axis_bits, depth_bits, A;
  unsigned min_depth;
  Spread spread;
  long long out_cap;
  long long* out_keys;
  long long* out_ids;
  int* out_aux;
  unsigned long long* stats;  // [0] cell count, [1] cell overflow flag
  unsigned long long* scratch;  // look-back status words, then the ticket
  int n_tiles;
};

__device__ __forceinline__ unsigned truncate_to_depth(unsigned x,
                                                      unsigned depth) {
  if (depth == 0) return x;
  const unsigned low = 32u - depth;  // in [1, 31] for depth in [1, 31]
  return x & ~((1u << low) - 1u);
}

// The top axis_bits of x, bit b moved to bit b * dim.
__device__ __forceinline__ unsigned long long spread(unsigned x,
                                                     const BuildArgs& p) {
  unsigned long long v = x >> (32 - p.axis_bits);
#pragma unroll
  for (int s = 0; s < kSpreadStages; ++s)
    v = (v | (v << p.spread.shift[s])) & p.spread.mask[s];
  return v;
}

// Exclusive sum of v over the block; *total receives the block's sum.
__device__ __forceinline__ int block_exclusive_sum(int v, int* total) {
  __shared__ int warp_part[kWarps];
  __shared__ int block_total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += o;
  }
  if (lane == 31) warp_part[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? warp_part[lane] : 0;
    int winc = w;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int o = __shfl_up_sync(kFull, winc, d);
      if (lane >= d) winc += o;
    }
    if (lane < kWarps) warp_part[lane] = winc - w;
    if (lane == kWarps - 1) block_total = winc;
  }
  __syncthreads();
  *total = block_total;
  return inc - v + warp_part[warp];
}

// A_T > 0: A is A_T; A_T == 0: A is p.A, any value >= 1.
template <int DIM, int A_T>
__global__ void __launch_bounds__(kThreads)
build_kernel(BuildArgs p) {
  __shared__ long long s_lo[kThreads * DIM], s_hi[kThreads * DIM];
  __shared__ long long s_ids[kThreads];
  __shared__ long long stage_key[kStageCells];
  __shared__ unsigned short stage_tag[kStageCells];  // object << 8 | aux
  __shared__ long long s_base;
  const int A = A_T > 0 ? A_T : p.A;
  const int t = threadIdx.x;
  const int tile = wide::take_ticket(p.scratch, p.n_tiles);  // syncs
  const long long obj0 = (long long)tile * kThreads;
  const int nb = (int)min(p.n - obj0, (long long)kThreads);
  for (int q = t; q < nb * DIM; q += kThreads) {
    s_lo[q] = p.lmin[obj0 * DIM + q];
    s_hi[q] = p.lmax[obj0 * DIM + q];
  }
  const bool mine = t < nb && p.contained[obj0 + t];
  if (t < nb) s_ids[t] = p.ids[obj0 + t];
  __syncthreads();

  // lim: cells along the axis, min(naxis, A)
  unsigned tmin[DIM] = {}, lim[DIM];
#pragma unroll
  for (int k = 0; k < DIM; ++k) lim[k] = 1;
  unsigned depth = 0, step = 0;
  int cells = 0;
  bool ovf = false;
  if (mine) {
    unsigned lmn[DIM], lmx[DIM];
    unsigned size_max = 0;
#pragma unroll
    for (int k = 0; k < DIM; ++k) {
      lmn[k] = (unsigned)s_lo[t * DIM + k];
      lmx[k] = (unsigned)s_hi[t * DIM + k];
      const unsigned s = lmx[k] - lmn[k] + 1u;  // wrapping u32
      size_max = s > size_max ? s : size_max;
    }
    const unsigned v = size_max - 1u;  // wrapping u32
    const unsigned lz = v == 0 ? 32u : (unsigned)__clz(v);
    depth = lz > p.min_depth ? lz : p.min_depth;
    depth = depth < (unsigned)p.axis_bits ? depth : (unsigned)p.axis_bits;
    const unsigned shift =
        depth == 0 ? 31u : (32u - depth < 31u ? 32u - depth : 31u);
    step = depth == 0 ? 0u : 1u << shift;
    cells = 1;
#pragma unroll
    for (int k = 0; k < DIM; ++k) {
      tmin[k] = truncate_to_depth(lmn[k], depth);
      const unsigned tmax = truncate_to_depth(lmx[k], depth);
      const unsigned span = depth == 0 ? 0u : (tmax - tmin[k]) >> shift;
      // naxis = span + 1 <= 2^31: no wrap
      ovf |= span >= (unsigned)A;
      lim[k] = span < (unsigned)A ? span + 1 : (unsigned)A;
      cells *= (int)lim[k];
    }
  }

  // each axis's cell codes, spread once: code0 for a = 0, code1 for a = 1
  // (A_T == 2; other A spread per cell)
  unsigned long long code0[DIM] = {}, code1[DIM] = {};
  if (mine) {
#pragma unroll
    for (int k = 0; k < DIM; ++k) {
      code0[k] = spread(tmin[k], p) << k;
      code1[k] = A_T == 2 && lim[k] > 1 ? spread(tmin[k] + step, p) << k : 0;
    }
  }

  int block_cells;
  const int off = block_exclusive_sum(cells, &block_cells);
  if (t < 32) {  // warp 0: the tile's base, from the tiles before it
    const wide::Pair x = wide::lookback(p.scratch, tile, {block_cells, 0});
    if (t == 0) {
      s_base = x.sum;
      if (tile == p.n_tiles - 1)
        p.stats[0] = (unsigned long long)(x.sum + block_cells);
    }
  }
  if (__syncthreads_or(ovf) && t == 0) atomicOr(&p.stats[1], 1ull);
  const long long base = s_base;

  for (int r0 = 0; r0 < block_cells; r0 += kStageCells) {
    // this thread's cells with block index in [r0, r0 + kStageCells)
    const int first = max(r0 - off, 0);
    const int last = min(r0 + kStageCells - off, cells);
    unsigned a[DIM] = {};  // the cell's per-axis slot, x fastest
    if (first > 0) {  // a later round (A > 2 only)
      unsigned rem = (unsigned)first;
#pragma unroll
      for (int k = 0; k < DIM; ++k) {
        a[k] = rem % lim[k];
        rem /= lim[k];
      }
    }
    for (int c = first; c < last; ++c) {
      unsigned long long morton = 0;
      int aux = 0;
#pragma unroll
      for (int k = 0; k < DIM; ++k) {
        if (A_T == 2)
          morton |= a[k] ? code1[k] : code0[k];
        else
          morton |= a[k] ? spread(tmin[k] + a[k] * step, p) << k : code0[k];
        aux |= (a[k] > 0) << k;
      }
      const int q = off + c - r0;
      stage_key[q] = depth == 0 ? 0
                                : (long long)(morton << p.depth_bits) |
                                      (long long)depth;
      stage_tag[q] = (unsigned short)((t << 8) | (depth == 0 ? 0 : aux));
      // next cell: odometer over the axes' slots
#pragma unroll
      for (int k = 0; k < DIM; ++k) {
        if (++a[k] < lim[k]) break;
        a[k] = 0;
      }
    }
    __syncthreads();
    const int staged = min(block_cells - r0, kStageCells);
    for (int i = t; i < staged; i += kThreads) {
      const long long pos = base + r0 + i;
      if (pos < p.out_cap) {
        const unsigned tag = stage_tag[i];
        p.out_keys[pos] = stage_key[i];
        p.out_ids[pos] = s_ids[tag >> 8];
        p.out_aux[pos] = (int)(tag & 0xFF);
      }
    }
    __syncthreads();  // the next round reuses the stage
  }
}

unsigned long long positions_mask(int nbits, int stride, int granularity) {
  unsigned long long m = 0;
  for (int i = 0; i < nbits; ++i)
    m |= 1ull << ((i / granularity) * granularity * stride +
                  i % granularity);
  return m;
}

// index.py::_spread_stages, padded at the front with no-op stages (shift
// 0, all bits kept) to kSpreadStages.
bool spread_stages(int nbits, int stride, Spread* s) {
  int top = 1;
  while (top < nbits) top <<= 1;
  int n_stages = 0;
  for (int c = top >> 1; c >= 1; c >>= 1) ++n_stages;
  if (n_stages > kSpreadStages || nbits * stride > 64) return false;
  int i = 0;
  for (; i < kSpreadStages - n_stages; ++i) {
    s->shift[i] = 0;
    s->mask[i] = ~0ull;
  }
  for (int c = top >> 1; c >= 1; c >>= 1, ++i) {
    s->shift[i] = c * (stride - 1);
    s->mask[i] = positions_mask(nbits, stride, c);
  }
  return true;
}

template <int DIM>
void launch_dim(const BuildArgs& p, unsigned blocks, cudaStream_t s) {
  if (p.A == 2)
    build_kernel<DIM, 2><<<blocks, kThreads, 0, s>>>(p);
  else
    build_kernel<DIM, 0><<<blocks, kThreads, 0, s>>>(p);
}

}  // namespace

extern "C" int bpt_build(const void* lmin, const void* lmax,
                         const void* contained, const void* ids, void* stats,
                         void* scratch, void* out_keys, void* out_ids,
                         void* out_aux, long long n, long long dim,
                         long long axis_bits, long long depth_bits,
                         long long slots_per_axis, long long min_depth,
                         long long out_cap, void* stream) {
  const long long tiles = (n + kThreads - 1) / kThreads;
  BuildArgs p{(const long long*)lmin, (const long long*)lmax,
              (const unsigned char*)contained, (const long long*)ids, n,
              (int)axis_bits, (int)depth_bits, (int)slots_per_axis,
              (unsigned)min_depth, {}, out_cap,
              (long long*)out_keys, (long long*)out_ids, (int*)out_aux,
              (unsigned long long*)stats, (unsigned long long*)scratch,
              (int)tiles};
  if (dim < 2 || dim > 3 || slots_per_axis < 1 || tiles >= (1LL << 31) ||
      !spread_stages((int)axis_bits, (int)dim, &p.spread))
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const cudaError_t err = wide::clear(p.scratch, tiles, s);
    if (err != cudaSuccess) return (int)err;
    if (dim == 2)
      launch_dim<2>(p, (unsigned)tiles, s);
    else
      launch_dim<3>(p, (unsigned)tiles, s);
  }
  return (int)cudaGetLastError();
}

// Objects a block of the kernel takes; the wrapper sizes the scratch with
// it (two status words a tile, then the ticket).
extern "C" long long bpt_build_tile() { return kThreads; }
