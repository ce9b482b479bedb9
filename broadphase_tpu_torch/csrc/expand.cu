// Kernel 7: the v2 pair expansion from run starts, with no emit-once rule.
//
// Replaces broadphase_tpu/ops/pallas_expand.py::expand_pairs.  One thread
// per pair slot t < P.  For t < total the slot lies in run
// j = upper_bound(starts[0, cap), t) - 1, the last element whose start is
// <= t; among elements with equal starts that is the nonempty run, since
// every later one starts past t.  Then
//   a = ids[j + 1 + (t - starts[j])]   (the later, descendant-side element)
//   b = ids[j]                         (the earlier, ancestor-side element)
// and every slot t >= total writes PAD on both sides.
//
// The TPU kernel compacts the starts to nonempty runs, prefetches each
// tile's covering run and resolves the id gathers window by window,
// because a TPU lane cannot gather; here each thread searches and gathers
// directly.
//
// Bound on the H100: device memory.  Per slot it writes 16 bytes; the
// inputs (ids and starts, 16 bytes per tree element) are read by gather.
// Neighbouring slots mostly share j and read consecutive a-side ids, so
// the gathers coalesce, and the search's top levels stay in L2.
#include <cuda_runtime.h>

namespace {

constexpr long long kPadId = 0xFFFFFFFFLL;

__global__ void __launch_bounds__(256)
expand_v2_kernel(const long long* ids, const long long* starts,
                 const long long* total_p, long long cap, long long P,
                 long long* a_out, long long* b_out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= P) return;
  const long long total = *total_p;
  long long a = kPadId, b = kPadId;
  if (t < total && cap > 0) {  // an empty tree has no runs
    long long lo = 0, hi = cap;  // upper_bound(starts[0, cap), t)
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (starts[mid] <= t) lo = mid + 1;
      else hi = mid;
    }
    const long long j = lo - 1;
    a = ids[j + 1 + (t - starts[j])];
    b = ids[j];
  }
  a_out[t] = a;
  b_out[t] = b;
}

}  // namespace

extern "C" int bpt_expand_v2(const void* ids, const void* starts,
                             const void* total, void* a_out, void* b_out,
                             long long cap, long long P, void* stream) {
  if (P > 0) {
    const long long blocks = (P + 255) / 256;
    expand_v2_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
        (const long long*)ids, (const long long*)starts,
        (const long long*)total, cap, P, (long long*)a_out,
        (long long*)b_out);
  }
  return (int)cudaGetLastError();
}
