// Row-wise k smallest entries of an existing [rows, N] float32 matrix.
//
// Replaces the Pallas kernel repro/kernels/topk.py::rowwise_topk, whose
// selection rule is repro/kernels/leaf_knn.py::_merge_topk: ascending by
// value, equal values to the lower column, and every slot whose value is
// not finite (+inf is the mask, and the padding past N) gets id -1.
//
// Bound: bytes, the matrix read once and the [rows, k] ids and values
// written once.  So the design keeps many bytes in flight and spends about
// one comparison on each column:
// - One warp takes one row, warp-synchronously, with no block barrier.  It
//   reads the row in chunks of 1024 columns, 32 a lane, all loads issued
//   before the first comparison: eight 16-byte loads a lane where N % 4 ==
//   0 and the matrix is 16-byte aligned, else 32 four-byte loads.
// - A warp-wide bar instead of 32 private lists.  Each lane's minimum value
//   is a value that one of its columns has; the k-th smallest of the 32
//   lane minima (a bitonic sort by shuffles, 15 compare-exchange steps), tau,
//   is then at or above the chunk's k-th smallest value, so only columns
//   with value <= tau can enter the row's top k.  They are also held to the
//   key of the running k-th entry.  On continuous rows that leaves about k
//   to 2k candidates a chunk.
// - Candidates are compacted into a per-warp buffer in shared memory (each
//   lane's count by popcount, offsets by a shuffle scan), after the running
//   list, and ranked exactly: an entry's rank is the number of entries whose
//   (value, column) key is lower.  Entries of rank r < k become slot r of the
//   running list (lane r holds slot r).  A buffer that cannot take every
//   candidate takes them in rounds; after each round the remaining ones are
//   held to the new k-th key, so equal values and rows whose small values
//   all sit in one lane stay exact.
// - k is a runtime argument, 1..32: one slot a lane.
// Every comparison is on the (value, column) pair with pipnn::lex_less
// (equal values to the lower column; -0.0 == +0.0 as in the ordered keys of
// the plain version), so the result does not depend on which lane saw which
// column.  +inf and NaN entries are never admitted.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;          // rows a block: one a warp
constexpr int CHUNK = 1024;       // columns a warp reads at a time: 32 a lane
constexpr int CAP = 256;          // entries of a warp's candidate buffer
constexpr unsigned FULL = 0xffffffffu;
constexpr int NO_COL = 0x7fffffff;

struct Entry {
  float v;
  int c;
};

// column of value j (0..31) of this lane in the chunk at col0: with 16-byte
// lanes a warp load covers 128 consecutive columns, else 32
template <int VEC>
__device__ __forceinline__ int column(int col0, int lane, int j) {
  if constexpr (VEC == 4)
    return col0 + 4 * (lane + 32 * (j / 4)) + j % 4;
  else
    return col0 + lane + 32 * j;
}

// this lane's 32 values of the chunk at col0, +inf past N; every load is
// issued before any value is used
template <int VEC>
__device__ __forceinline__ void load_chunk(float (&v)[32], const float* __restrict__ r,
                                           int col0, int N, int lane) {
  if constexpr (VEC == 4) {
    float4 q[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int c = column<4>(col0, lane, 4 * t);   // N % 4 == 0: c < N covers c + 3
      q[t] = c < N ? __ldcs(reinterpret_cast<const float4*>(r + c))
                   : make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, CUDART_INF_F);
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      v[4 * t] = q[t].x;
      v[4 * t + 1] = q[t].y;
      v[4 * t + 2] = q[t].z;
      v[4 * t + 3] = q[t].w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = column<1>(col0, lane, j);
      v[j] = c < N ? __ldcs(r + c) : CUDART_INF_F;
    }
  }
}

// ascending bitonic sort of one value a lane across the warp
__device__ __forceinline__ float warp_sort(float x, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size / 2; stride > 0; stride /= 2) {
      const float o = __shfl_xor_sync(FULL, x, stride);
      const bool keep_min = ((lane & stride) == 0) == ((lane & size) == 0);
      x = keep_min ? fminf(x, o) : fmaxf(x, o);
    }
  return x;
}

template <int VEC>
__global__ void __launch_bounds__(WARPS * 32, 4)
rowwise_topk_kernel(const float* __restrict__ d, long long rows, int N, int k,
                    int* __restrict__ out_ids, float* __restrict__ out_vals) {
  __shared__ Entry buf_s[WARPS][CAP];
  __shared__ Entry list_s[WARPS][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * WARPS + warp;
  if (row >= rows) return;   // the whole warp leaves together
  Entry* buf = buf_s[warp];
  Entry* nl = list_s[warp];
  const float* r = d + row * N;

  // the running list: lane s < k holds slot s, ascending; (+inf, NO_COL)
  // where empty.  (tv, tc) is slot k - 1, the key a new column must beat.
  float lv = CUDART_INF_F, tv = CUDART_INF_F;
  int lc = NO_COL, tc = NO_COL;
  for (int col0 = 0; col0 < N; col0 += CHUNK) {
    float v[32];
    load_chunk<VEC>(v, r, col0, N, lane);
    float m = CUDART_INF_F;   // fminf skips NaN
#pragma unroll
    for (int j = 0; j < 32; ++j) m = fminf(m, v[j]);
    const float tau = __shfl_sync(FULL, warp_sort(m, lane), k - 1);
    unsigned mask = 0;        // bit j: value j is a candidate
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const bool cand = v[j] <= tau && v[j] < CUDART_INF_F &&
                        pipnn::lex_less(v[j], column<VEC>(col0, lane, j), tv, tc);
      mask |= (unsigned)cand << j;
    }
    while (__any_sync(FULL, mask)) {
      // the buffer: the list's admitted slots (a prefix), then candidates
      const int n_list = __popc(__ballot_sync(FULL, lane < k && lv < CUDART_INF_F));
      if (lane < n_list) buf[lane] = {lv, lc};
      const int cnt = __popc(mask);
      int incl = cnt;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += o;
      }
      const int total = __shfl_sync(FULL, incl, 31);
      int pos = n_list + incl - cnt;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        if ((mask >> j) & 1u) {
          if (pos < CAP) {
            buf[pos] = {v[j], column<VEC>(col0, lane, j)};
            mask &= ~(1u << j);
          }
          ++pos;
        }
      }
      const int n = min(CAP, n_list + total);
      if (lane < k) nl[lane] = {CUDART_INF_F, NO_COL};
      __syncwarp();
      // exact ranks: every key in the buffer is distinct (distinct columns)
      for (int e = lane; e < n; e += 32) {
        const Entry x = buf[e];
        int rank = 0;
        for (int j = 0; j < n; ++j) {
          const Entry y = buf[j];
          rank += pipnn::lex_less(y.v, y.c, x.v, x.c);
        }
        if (rank < k) nl[rank] = x;
      }
      __syncwarp();
      if (lane < k) {
        lv = nl[lane].v;
        lc = nl[lane].c;
      }
      tv = __shfl_sync(FULL, lv, k - 1);
      tc = __shfl_sync(FULL, lc, k - 1);
      __syncwarp();   // the buffer and nl are read before the next round writes them
      if (__any_sync(FULL, mask)) {
        // the buffer was full: hold what is left to the new k-th key
#pragma unroll
        for (int j = 0; j < 32; ++j)
          if (((mask >> j) & 1u) && !pipnn::lex_less(v[j], column<VEC>(col0, lane, j), tv, tc))
            mask &= ~(1u << j);
      }
    }
  }
  if (lane < k) {
    out_ids[row * k + lane] = isfinite(lv) ? lc : -1;
    out_vals[row * k + lane] = lv;
  }
}

}  // namespace

// d [rows, N] f32 -> ids [rows, k] int32 (columns, -1 where the value is
// not finite), vals [rows, k] f32; 1 <= k <= 32
PIPNN_EXPORT int pipnn_rowwise_topk(const void* d, long long rows, int N, int k, void* ids,
                                    void* vals, void* stream) {
  if (k < 1 || k > 32 || N < 0) return cudaErrorInvalidValue;
  const long long blocks = (rows + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (blocks <= 0) return cudaGetLastError();
  const float* p = static_cast<const float*>(d);
  int* oi = static_cast<int*>(ids);
  float* ov = static_cast<float*>(vals);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte loads need every row to start on a 16-byte boundary
  if (N % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0)
    rowwise_topk_kernel<4><<<(unsigned)blocks, WARPS * 32, 0, s>>>(p, rows, N, k, oi, ov);
  else
    rowwise_topk_kernel<1><<<(unsigned)blocks, WARPS * 32, 0, s>>>(p, rows, N, k, oi, ov);
  return cudaGetLastError();
}
