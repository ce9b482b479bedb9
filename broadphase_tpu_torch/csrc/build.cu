// Kernel 1: fused cell emission for build.
//
// Replaces broadphase_tpu/ops/pallas_build.py::emit_build.  One thread per
// object runs geom.depth_for_bounds -> truncate_to_depth -> per-axis spans
// and steps -> Morton spreads -> up to A^dim cell keys with their
// block-offset aux bits, exactly in u32 arithmetic as the JAX code does.
// Valid cells of contained objects are appended through a block-wide scan
// of the per-thread cell counts and one atomicAdd on a global cursor, so
// the emission order is not deterministic; build sorts the full
// (key, id, aux) tuple right after, which makes the tree deterministic.
// Writes stop at out_cap, but the cursor counts every valid cell.
//
// Bound on the H100: device memory.  It reads 2 * dim * 8 + 9 bytes per
// object and writes 20 bytes per emitted cell; the per-thread integer work
// (spreads of up to 2 * dim coordinates) is small beside that.
#include "scan.cuh"

namespace {

struct BuildArgs {
  const long long* lmin;  // (n, dim) u32 values held in int64
  const long long* lmax;
  const unsigned char* contained;
  const long long* ids;
  long long n;
  int dim, axis_bits, depth_bits, A;
  unsigned min_depth;
  long long out_cap;
  long long* out_keys;
  long long* out_ids;
  int* out_aux;
  unsigned long long* stats;  // [0] cell cursor, [1] cell overflow flag
};

__device__ __forceinline__ unsigned truncate_to_depth(unsigned x,
                                                      unsigned depth) {
  if (depth == 0) return x;
  const unsigned low = 32u - depth;  // in [1, 31] for depth in [1, 31]
  return x & ~((1u << low) - 1u);
}

__device__ __forceinline__ long long spread(unsigned x, int axis_bits,
                                            int dim) {
  x >>= (32 - axis_bits);
  long long out = 0;
  for (int b = 0; b < axis_bits; ++b)
    out |= (long long)((x >> b) & 1u) << (b * dim);
  return out;
}

__global__ void __launch_bounds__(bpt::kThreads)
build_kernel(BuildArgs p) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int dim = p.dim, A = p.A;
  unsigned tmin[3] = {0, 0, 0};
  long long naxis[3] = {1, 1, 1};
  unsigned depth = 0, step = 0;
  long long cells = 0;
  if (i < p.n && p.contained[i]) {
    unsigned lmn[3], lmx[3];
    unsigned size_max = 0;
    for (int k = 0; k < dim; ++k) {
      lmn[k] = (unsigned)p.lmin[i * dim + k];
      lmx[k] = (unsigned)p.lmax[i * dim + k];
      const unsigned s = lmx[k] - lmn[k] + 1u;  // wrapping u32
      size_max = s > size_max ? s : size_max;
    }
    const unsigned v = size_max - 1u;  // wrapping u32
    unsigned lz = v == 0 ? 32u : (unsigned)__clz(v);
    depth = lz > p.min_depth ? lz : p.min_depth;
    depth = depth < (unsigned)p.axis_bits ? depth : (unsigned)p.axis_bits;
    const unsigned shift = depth == 0 ? 31u : (32u - depth < 31u ? 32u - depth : 31u);
    step = depth == 0 ? 0u : 1u << shift;
    bool ovf = false;
    cells = 1;
    for (int k = 0; k < dim; ++k) {
      tmin[k] = truncate_to_depth(lmn[k], depth);
      const unsigned tmax = truncate_to_depth(lmx[k], depth);
      const unsigned span = depth == 0 ? 0u : (tmax - tmin[k]) >> shift;
      naxis[k] = (long long)span + 1;
      ovf |= naxis[k] > A;
      cells *= naxis[k] < A ? naxis[k] : A;
    }
    if (ovf) atomicOr(&p.stats[1], 1ull);
  }

  long long block_cells;
  const long long off = bpt::block_exclusive_scan(cells, &block_cells);
  __shared__ unsigned long long base;
  if (threadIdx.x == 0 && block_cells > 0)
    base = atomicAdd(&p.stats[0], (unsigned long long)block_cells);
  __syncthreads();
  if (cells == 0) return;

  long long pos = (long long)base + off;
  int n_slots = 1;
  for (int k = 0; k < dim; ++k) n_slots *= A;
  for (int s = 0; s < n_slots; ++s) {
    int rem = s;
    bool valid = true;
    long long morton = 0;
    int aux = 0;
    for (int k = 0; k < dim; ++k) {
      const int a = rem % A;
      rem /= A;
      valid &= a < naxis[k];
      aux |= (a > 0) << k;
      morton |= spread(tmin[k] + (unsigned)a * step, p.axis_bits, dim) << k;
    }
    if (!valid) continue;
    if (pos < p.out_cap) {
      p.out_keys[pos] =
          depth == 0 ? 0 : (morton << p.depth_bits) | (long long)depth;
      p.out_ids[pos] = p.ids[i];
      p.out_aux[pos] = depth == 0 ? 0 : aux;
    }
    ++pos;
  }
}

}  // namespace

extern "C" int bpt_build(const void* lmin, const void* lmax,
                         const void* contained, const void* ids, void* stats,
                         void* out_keys, void* out_ids, void* out_aux,
                         long long n, long long dim, long long axis_bits,
                         long long depth_bits, long long slots_per_axis,
                         long long min_depth, long long out_cap,
                         void* stream) {
  if (dim < 1 || dim > 3) return (int)cudaErrorInvalidValue;
  BuildArgs p{(const long long*)lmin, (const long long*)lmax,
              (const unsigned char*)contained, (const long long*)ids, n,
              (int)dim, (int)axis_bits, (int)depth_bits,
              (int)slots_per_axis, (unsigned)min_depth, out_cap,
              (long long*)out_keys, (long long*)out_ids, (int*)out_aux,
              (unsigned long long*)stats};
  if (n > 0) {
    const long long blocks = (n + bpt::kThreads - 1) / bpt::kThreads;
    build_kernel<<<(unsigned)blocks, bpt::kThreads, 0,
                   (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}
