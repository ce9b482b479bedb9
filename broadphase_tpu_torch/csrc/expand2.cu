// Kernel 4: pair expansion from the prepped nonempty runs, with the
// emit-once rule.
//
// Replaces broadphase_tpu/ops/pallas_expand2.py::expand_pairs_prepped.
// One thread per pair slot t < P.  For t < total the slot lies in run
// k = (last entry with sv[k] <= t), found by binary search over sv[0, m):
//   a = ids[t + ab[k]]   (the later, descendant-side element)
//   b = bid[k]           (the earlier, ancestor-side element)
// With the rule on, the emission is kept iff layer._emit_once_keep holds
// for (ameta[t + ab[k]], bmeta[k]); a dropped emission and every slot
// t >= total write PAD on both sides.  The output equals the TPU kernel's
// slot for slot.  The TPU kernel's placement network and windowed id DMA
// exist because a TPU lane cannot gather; here each thread gathers.
//
// Bound on the H100: device memory.  Per slot it writes 16 bytes and reads
// ~28 bytes by gather (neighbouring slots mostly share k, and their a-side
// indices are consecutive, so the gathers coalesce); the binary search's
// top levels stay in L2.
#include <cuda_runtime.h>

namespace {

constexpr long long kPadId = 0xFFFFFFFFLL;

__global__ void __launch_bounds__(256)
expand_kernel(const long long* ids, const int* ameta, const long long* sv,
              const long long* ab, const long long* bid, const int* bmeta,
              const long long* stats, const unsigned char* rule,
              long long P, int dim, long long* a_out, long long* b_out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= P) return;
  const long long m = stats[0];
  const long long total = stats[1];
  long long a = kPadId, b = kPadId;
  if (t < total) {
    long long lo = 0, hi = m;  // upper_bound(sv[0, m), t)
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (sv[mid] <= t) lo = mid + 1;
      else hi = mid;
    }
    const long long k = lo - 1;
    const long long idx = t + ab[k];
    a = ids[idx];
    b = bid[k];
    if (*rule) {
      const int am = ameta[idx], bm = bmeta[k];
      const int emask = (1 << dim) - 1;
      const bool keep = ((am & bm & emask) == 0) && ((am >> dim) <= (bm >> dim));
      if (!keep) a = b = kPadId;
    }
  }
  a_out[t] = a;
  b_out[t] = b;
}

}  // namespace

extern "C" int bpt_expand(const void* ids, const void* ameta, const void* sv,
                          const void* ab, const void* bid, const void* bmeta,
                          const void* stats, const void* rule, void* a_out,
                          void* b_out, long long P, long long dim,
                          void* stream) {
  if (P > 0) {
    const long long blocks = (P + 255) / 256;
    expand_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
        (const long long*)ids, (const int*)ameta, (const long long*)sv,
        (const long long*)ab, (const long long*)bid, (const int*)bmeta,
        (const long long*)stats, (const unsigned char*)rule, P, (int)dim,
        (long long*)a_out, (long long*)b_out);
  }
  return (int)cudaGetLastError();
}
