// Kernels 4 and 7: pair expansion from the prepped nonempty runs, with the
// emit-once rule (kernel 4) and without it (kernel 7, the v2 expansion).
//
// Kernel 4 replaces broadphase_tpu/ops/pallas_expand2.py::
// expand_pairs_prepped, kernel 7 broadphase_tpu/ops/pallas_expand.py::
// expand_pairs.  For each slot t < total, in run k (the last entry with
// sv[k] <= t):
//   a = ids[t + ab[k]]   (the later, descendant-side element)
//   b = bid[k]           (the earlier, ancestor-side element)
// With the rule on, the emission is kept iff layer._emit_once_keep holds
// for (ameta[t + ab[k]], bmeta[k]); a dropped emission and every slot
// t >= total write PAD on both sides.  The output equals the TPU kernel's
// slot for slot.  Live starts sv[0, m) strictly increase from sv[0] = 0.
//
// The v2 expansion is this with the rule switched off: its run j starts
// at starts[j] and writes a = ids[j + 1 + t - starts[j]], b = ids[j], and
// prep.cu's entries for the same runs are sv = starts[j],
// ab = j + 1 - starts[j], bid = ids[j].  So one kernel template serves
// both: kRule = false reads no ameta and no bmeta, and stages 16 bytes a
// run instead of 20.
//
// A load-balanced search, the CUDA form of the TPU kernel's covering run
// c0 per tile.  Each block owns kT = 1024 consecutive slots:
//  - warps 0 and 1 find the first and the last run its live slots touch,
//    each by one 32-ary search of sv in device memory: 32 probes a round,
//    5 dependent rounds at 2M runs against 21 for a binary search;
//  - since live starts strictly increase, at most kT runs touch the
//    block.  It copies their ab, bid (and bmeta) into shared memory in one
//    coalesced read and marks each run's local index at its start slot;
//  - an inclusive max-scan over the kT marks (a forward fill) gives every
//    slot its run: one shared-memory read a slot, no search a slot;
//  - thread i takes slots t0 + i + 256 r, so neighbouring lanes take
//    neighbouring slots: within a run the a-side gathers of ids (and
//    ameta) are consecutive, and the a and b stores are coalesced;
//  - slots past total only store PAD; a block wholly past it searches
//    nothing.
// kT = 1024 keeps shared memory at 24 KB (8 + 8 + 4 bytes of run and 4 of
// mark a slot; 20 KB without the rule), under the 48 KB static limit, so
// 8 blocks fit on an SM and their searches overlap one another's stores.
// kT = 2048 would halve the searches a slot but need the dynamic
// shared-memory attribute and halve the resident blocks.
//
// Bound on the H100: device memory.  It writes 16 bytes a slot and reads
// the live tree's ids (and ameta: 8 or 12 bytes an element) and the runs'
// sv, ab, bid (and bmeta: 24 or 28 bytes a run).  Neighbouring runs
// overlap on the a-side, whose 30-44 MB at 1M objects mostly stays in the
// 50 MB L2; the streaming stores (st.global.cs) keep the outputs from
// evicting it.
#include <cuda_runtime.h>

namespace {

constexpr long long kPadId = 0xFFFFFFFFLL;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlotsPerThread = 4;
constexpr int kT = kThreads * kSlotsPerThread;  // slots a block
constexpr unsigned kFull = 0xffffffffu;

// upper_bound(sv[0, m), t) by one whole warp: each round probes 32 evenly
// spaced entries and keeps the stretch between the last probe <= t and the
// first probe > t.
__device__ long long warp_upper_bound(const long long* sv, long long m,
                                      long long t) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = m;  // every entry < lo is <= t, every >= hi is > t
  while (hi - lo > 32) {
    const long long step = (hi - lo + 31) / 32;
    const long long p = lo + (lane + 1) * step - 1;
    const bool le = p < hi && __ldg(sv + p) <= t;
    const int c = __popc(__ballot_sync(kFull, le));
    if (c < 32) hi = min(hi, lo + (c + 1) * step - 1);
    lo += c * step;
  }
  const bool le = lo + lane < hi && __ldg(sv + lo + lane) <= t;
  return lo + __popc(__ballot_sync(kFull, le));
}

template <bool kRule>
__global__ void __launch_bounds__(kThreads)
expand_partitioned_kernel(const long long* ids, const int* ameta,
                          const long long* sv, const long long* ab,
                          const long long* bid, const int* bmeta,
                          const long long* m_p, const long long* total_p,
                          const unsigned char* rule_p, long long cap,
                          long long P, int dim, long long* a_out,
                          long long* b_out) {
  __shared__ long long s_ab[kT], s_bid[kT];
  __shared__ int s_bm[kRule ? kT : 1];
  __shared__ __align__(16) int s_run[kT];
  __shared__ long long s_k[2];
  __shared__ int s_part[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long t0 = (long long)blockIdx.x * kT;
  const long long m = *m_p;
  const long long live = (m > 0 && cap > 0) ? min(*total_p, P) : 0;
  const long long tend = min(t0 + kT, live);  // slots [t0, tend) emit
  if (tend <= t0) {
#pragma unroll
    for (int r = 0; r < kSlotsPerThread; ++r) {
      const long long t = t0 + tid + kThreads * r;
      if (t < P) {
        __stcs(a_out + t, kPadId);
        __stcs(b_out + t, kPadId);
      }
    }
    return;
  }

  // the first and the last run of the block's live slots
  if (warp < 2) {
    const long long ub = warp_upper_bound(sv, m, warp == 0 ? t0 : tend - 1);
    if (lane == 0) s_k[warp] = ub > 0 ? ub - 1 : 0;
  }
  for (int i = tid; i < kT; i += kThreads) s_run[i] = 0;
  __syncthreads();

  // stage the runs, and mark each later run's index at its start slot
  const long long k0 = s_k[0];
  const int nr = (int)min(s_k[1] - k0 + 1, (long long)kT);
  for (int i = tid; i < nr; i += kThreads) {
    const long long k = k0 + i;
    s_ab[i] = ab[k];
    s_bid[i] = bid[k];
    if (kRule) s_bm[i] = bmeta[k];
    const long long s = sv[k] - t0;
    if (i > 0 && s > 0 && s < kT) s_run[s] = i;
  }
  __syncthreads();

  // forward fill: inclusive max-scan of the marks; thread tid scans marks
  // 4 tid .. 4 tid + 3, then the threads' maxima are scanned
  int4 q = ((int4*)s_run)[tid];
  q.y = max(q.x, q.y);
  q.z = max(q.y, q.z);
  q.w = max(q.z, q.w);
  int inc = q.w;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc = max(inc, o);
  }
  if (lane == 31) s_part[warp] = inc;
  int pre = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) pre = 0;
  __syncthreads();
  for (int w = 0; w < warp; ++w) pre = max(pre, s_part[w]);
  ((int4*)s_run)[tid] = make_int4(max(q.x, pre), max(q.y, pre),
                                  max(q.z, pre), max(q.w, pre));
  __syncthreads();

  const bool rule = kRule && *rule_p != 0;
  const int emask = (1 << dim) - 1;
  long long idx[kSlotsPerThread], a[kSlotsPerThread], b[kSlotsPerThread];
  int run[kSlotsPerThread];
#pragma unroll
  for (int r = 0; r < kSlotsPerThread; ++r) {
    const int s = tid + kThreads * r;
    run[r] = s_run[s];
    idx[r] = t0 + s + s_ab[run[r]];
    idx[r] = idx[r] < 0 ? 0 : (idx[r] >= cap ? cap - 1 : idx[r]);
    a[r] = t0 + s < tend ? __ldg(ids + idx[r]) : kPadId;
  }
#pragma unroll
  for (int r = 0; r < kSlotsPerThread; ++r) {
    const long long t = t0 + tid + kThreads * r;
    if (t >= P) break;
    b[r] = kPadId;
    if (t < tend) {
      b[r] = s_bid[run[r]];
      if (rule) {
        const int am = __ldg(ameta + idx[r]), bm = s_bm[run[r]];
        const bool keep =
            ((am & bm & emask) == 0) && ((am >> dim) <= (bm >> dim));
        if (!keep) a[r] = b[r] = kPadId;
      }
    }
    __stcs(a_out + t, a[r]);
    __stcs(b_out + t, b[r]);
  }
}

}  // namespace

// Kernel 4: the rule byte columns, and the rule flag on the card.
extern "C" int bpt_expand(const void* ids, const void* ameta, const void* sv,
                          const void* ab, const void* bid, const void* bmeta,
                          const void* m, const void* total, const void* rule,
                          void* a_out, void* b_out, long long cap, long long P,
                          long long dim, void* stream) {
  if (P > 0) {
    const long long blocks = (P + kT - 1) / kT;
    expand_partitioned_kernel<true><<<(unsigned)blocks, kThreads, 0,
                                      (cudaStream_t)stream>>>(
        (const long long*)ids, (const int*)ameta, (const long long*)sv,
        (const long long*)ab, (const long long*)bid, (const int*)bmeta,
        (const long long*)m, (const long long*)total,
        (const unsigned char*)rule, cap, P, (int)dim, (long long*)a_out,
        (long long*)b_out);
  }
  return (int)cudaGetLastError();
}

// Kernel 7: the same entries with no rule.
extern "C" int bpt_expand_v2(const void* ids, const void* sv, const void* ab,
                             const void* bid, const void* m,
                             const void* total, void* a_out, void* b_out,
                             long long cap, long long P, void* stream) {
  if (P > 0) {
    const long long blocks = (P + kT - 1) / kT;
    expand_partitioned_kernel<false><<<(unsigned)blocks, kThreads, 0,
                                       (cudaStream_t)stream>>>(
        (const long long*)ids, nullptr, (const long long*)sv,
        (const long long*)ab, (const long long*)bid, nullptr,
        (const long long*)m, (const long long*)total, nullptr, cap, P, 0,
        (long long*)a_out, (long long*)b_out);
  }
  return (int)cudaGetLastError();
}
