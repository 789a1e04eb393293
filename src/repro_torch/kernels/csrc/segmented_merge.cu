// Bounded per-row merge of two sorted HashPrune reservoirs: R(A u B).
//
// Replaces the Pallas kernel repro/kernels/segmented_merge.py::
// merge_sorted_reservoirs.  Both inputs are [n, l] reservoirs whose rows are
// sorted by (dist, id), hold at most one slot per residual-hash bucket and
// pad with (id -1, dist +inf).  One warp merges one row without a sort:
//   * cross-side bucket dedup: an A slot dies if a B slot with the same hash
//     has a strictly smaller (dist, id) key; a B slot dies if an A slot with
//     the same hash has a key no larger (exact ties keep A);
//   * rank placement: a survivor's output slot is its rank among its own
//     side's survivors (a warp ballot prefix count) plus the number of the
//     other side's survivors with a smaller key (A wins key ties);
//   * slots past l are dropped, the tail pads with (-1, 0, +inf).
// The result is written over A in place: the reservoir is updated in place
// across the stream, as the reference's fused step donates it.  Each warp
// reads its whole row into shared memory before it writes any of it, and
// rows are independent, so the in-place write is safe.
//
// Bound: bytes, 6 [n, l] inputs read and 3 written (36 bytes a slot).  The
// O(l^2) compares run on shared-memory broadcasts.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;

__global__ void merge_kernel(int* __restrict__ a_ids, int* __restrict__ a_h, float* __restrict__ a_d,
                             const int* __restrict__ b_ids, const int* __restrict__ b_h,
                             const float* __restrict__ b_d, long long n, int l) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * WARPS + warp;
  // per-warp slices: ai ah bi bh (int) | ad bd (float) | ka kb (char)
  int* ai = reinterpret_cast<int*>(smem) + (size_t)warp * 6 * l;
  int* ah = ai + l;
  int* bi = ah + l;
  int* bh = bi + l;
  float* ad = reinterpret_cast<float*>(bh + l);
  float* bd = ad + l;
  unsigned char* ka = reinterpret_cast<unsigned char*>(reinterpret_cast<int*>(smem) + (size_t)WARPS * 6 * l) + (size_t)warp * 2 * l;
  unsigned char* kb = ka + l;
  if (row >= n) return;  // whole warp leaves together

  const size_t base = (size_t)row * l;
  for (int s = lane; s < l; s += 32) {
    ai[s] = a_ids[base + s];
    ah[s] = a_h[base + s];
    ad[s] = a_d[base + s];
    bi[s] = b_ids[base + s];
    bh[s] = b_h[base + s];
    bd[s] = b_d[base + s];
  }
  __syncwarp();

  // bucket dedup across the two sides
  for (int s = lane; s < l; s += 32) {
    bool keep = ai[s] != -1;
    for (int j = 0; keep && j < l; ++j)
      if (bi[j] != -1 && bh[j] == ah[s] && pipnn::lex_less(bd[j], bi[j], ad[s], ai[s])) keep = false;
    ka[s] = keep;
    keep = bi[s] != -1;
    for (int i = 0; keep && i < l; ++i)
      if (ai[i] != -1 && ah[i] == bh[s] && !pipnn::lex_less(bd[s], bi[s], ad[i], ai[i])) keep = false;
    kb[s] = keep;
  }
  __syncwarp();

  // rank placement, then the pad tail
  const unsigned lt_mask = (1u << lane) - 1u;
  int base_a = 0, base_b = 0;
  for (int s0 = 0; s0 < l; s0 += 32) {
    const int s = s0 + lane;
    const bool in = s < l;
    const bool kpa = in && ka[s];
    const bool kpb = in && kb[s];
    const unsigned ma = __ballot_sync(0xffffffffu, kpa);
    const unsigned mb = __ballot_sync(0xffffffffu, kpb);
    if (kpa) {
      int pos = base_a + __popc(ma & lt_mask);
      for (int j = 0; j < l; ++j) pos += kb[j] && pipnn::lex_less(bd[j], bi[j], ad[s], ai[s]);
      if (pos < l) {
        a_ids[base + pos] = ai[s];
        a_h[base + pos] = ah[s];
        a_d[base + pos] = ad[s];
      }
    }
    if (kpb) {
      int pos = base_b + __popc(mb & lt_mask);
      for (int i = 0; i < l; ++i) pos += ka[i] && !pipnn::lex_less(bd[s], bi[s], ad[i], ai[i]);
      if (pos < l) {
        a_ids[base + pos] = bi[s];
        a_h[base + pos] = bh[s];
        a_d[base + pos] = bd[s];
      }
    }
    base_a += __popc(ma);
    base_b += __popc(mb);
  }
  for (int s = base_a + base_b + lane; s < l; s += 32) {
    a_ids[base + s] = -1;
    a_h[base + s] = 0;
    a_d[base + s] = CUDART_INF_F;
  }
}

}  // namespace

// a_* [n, l] (merged in place), b_* [n, l]; ids/hashes int32, dists f32
PIPNN_EXPORT int pipnn_merge_sorted_reservoirs(void* a_ids, void* a_h, void* a_d, const void* b_ids,
                                               const void* b_h, const void* b_d, long long n, int l,
                                               void* stream) {
  const long long blocks = (n + WARPS - 1) / WARPS;
  const size_t smem = (size_t)WARPS * l * (6 * sizeof(int) + 2);
  if (blocks > 0)
    merge_kernel<<<(unsigned)blocks, WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<int*>(a_ids), static_cast<int*>(a_h), static_cast<float*>(a_d),
        static_cast<const int*>(b_ids), static_cast<const int*>(b_h),
        static_cast<const float*>(b_d), n, l);
  return cudaGetLastError();
}
