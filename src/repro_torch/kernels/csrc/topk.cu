// Row-wise k smallest entries of an existing [rows, N] float32 matrix.
//
// Replaces the Pallas kernel repro/kernels/topk.py::rowwise_topk, whose
// selection rule is repro/kernels/leaf_knn.py::_merge_topk: ascending by
// value, equal values to the lower column, and every slot whose value is
// not finite (+inf is the mask, and the padding past N) gets id -1.
//
// One warp handles one row.  Each lane walks the columns lane, lane + 32,
// ... and keeps a sorted (value, column) list of the K best it has seen in
// registers; a column is compared with the list's last entry first, so most
// columns cost one comparison.  The 32 lists are then merged with xor
// shuffles in five rounds (each round joins two disjoint halves), after
// which every lane holds the row's top K.  Every comparison is on the
// (value, column) pair, so the result does not depend on which lane saw
// which column.  +inf and NaN entries are never inserted.
//
// Bound: bytes, the matrix read once and the [rows, k] ids and values
// written once.
#include "common.cuh"

namespace {

constexpr int WARPS = 4;

template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], float dv, int ci) {
  // branch-free sorted insert; descending j so bd[j-1] is still the old value
#pragma unroll
  for (int j = K - 1; j > 0; --j) {
    const bool before_prev = pipnn::lex_less(dv, ci, bd[j - 1], bi[j - 1]);
    const bool before_here = pipnn::lex_less(dv, ci, bd[j], bi[j]);
    const float nd = before_prev ? bd[j - 1] : (before_here ? dv : bd[j]);
    const int ni = before_prev ? bi[j - 1] : (before_here ? ci : bi[j]);
    bd[j] = nd;
    bi[j] = ni;
  }
  if (pipnn::lex_less(dv, ci, bd[0], bi[0])) {
    bd[0] = dv;
    bi[0] = ci;
  }
}

template <int K>
__device__ __forceinline__ void offer(float (&bd)[K], int (&bi)[K], float dv, int ci) {
  if (dv < CUDART_INF_F && pipnn::lex_less(dv, ci, bd[K - 1], bi[K - 1]))
    insert<K>(bd, bi, dv, ci);
}

template <int K>
__global__ void __launch_bounds__(WARPS * 32)
rowwise_topk_kernel(const float* __restrict__ d, long long rows, int N, int k,
                    int* __restrict__ out_ids, float* __restrict__ out_vals) {
  const long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= rows) return;   // the whole warp leaves together
  const int lane = threadIdx.x % 32;
  const float* r = d + row * N;

  float bd[K];
  int bi[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    bd[j] = CUDART_INF_F;
    bi[j] = 0x7fffffff;
  }
  for (int c = lane; c < N; c += 32) offer<K>(bd, bi, r[c], c);

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float od[K];
    int oi[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      od[j] = __shfl_xor_sync(0xffffffffu, bd[j], off);
      oi[j] = __shfl_xor_sync(0xffffffffu, bi[j], off);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) offer<K>(bd, bi, od[j], oi[j]);
  }

  // lane j < k writes slot j
  float v = bd[0];
  int c = bi[0];
#pragma unroll
  for (int j = 1; j < K; ++j) {
    if (lane == j) {
      v = bd[j];
      c = bi[j];
    }
  }
  if (lane < k) {
    out_ids[row * k + lane] = isfinite(v) ? c : -1;
    out_vals[row * k + lane] = v;
  }
}

template <int K>
cudaError_t launch(const float* d, long long rows, int N, int k, int* ids, float* vals,
                   cudaStream_t stream) {
  const long long blocks = (rows + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (blocks > 0)
    rowwise_topk_kernel<K><<<(unsigned)blocks, WARPS * 32, 0, stream>>>(d, rows, N, k, ids,
                                                                         vals);
  return cudaGetLastError();
}

}  // namespace

// d [rows, N] f32 -> ids [rows, k] int32 (columns, -1 where the value is
// not finite), vals [rows, k] f32; 1 <= k <= 16
PIPNN_EXPORT int pipnn_rowwise_topk(const void* d, long long rows, int N, int k, void* ids,
                                    void* vals, void* stream) {
  const float* p = static_cast<const float*>(d);
  int* oi = static_cast<int*>(ids);
  float* ov = static_cast<float*>(vals);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
#define PIPNN_TOPK_CASE(K) \
  case K:                  \
    return launch<K>(p, rows, N, k, oi, ov, s);
    PIPNN_TOPK_CASE(1) PIPNN_TOPK_CASE(2) PIPNN_TOPK_CASE(3) PIPNN_TOPK_CASE(4)
    PIPNN_TOPK_CASE(5) PIPNN_TOPK_CASE(6) PIPNN_TOPK_CASE(7) PIPNN_TOPK_CASE(8)
    PIPNN_TOPK_CASE(9) PIPNN_TOPK_CASE(10) PIPNN_TOPK_CASE(11) PIPNN_TOPK_CASE(12)
    PIPNN_TOPK_CASE(13) PIPNN_TOPK_CASE(14) PIPNN_TOPK_CASE(15) PIPNN_TOPK_CASE(16)
#undef PIPNN_TOPK_CASE
    default:
      return cudaErrorInvalidValue;
  }
}
