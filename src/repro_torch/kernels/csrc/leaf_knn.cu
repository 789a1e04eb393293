// FlashKNN for Hopper: per leaf, all-pairs distances with a running top-k.
//
// Replaces the Pallas kernel repro/kernels/leaf_knn.py::leaf_topk.
// One block handles one (leaf, 64-row tile).  It gathers its own rows by
// id, so the [leaves, c_max, d] block is never materialised, and walks the
// leaf's 64-column tiles.  Each tile's product is staged through shared
// memory in 32-deep slices; every thread owns a 4x4 patch of the 64x64
// distance tile, accumulates it with f32 FMAs on the CUDA cores (no TF32:
// the result must match the plain float32 version) and folds its 16
// distances into per-row running top-k lists kept in registers.  The 16
// threads that share a row then merge their lists with warp shuffles.
// Ties go to the lower column everywhere: every comparison is on the
// (dist, column) pair.  Column tiles with no valid entry and row tiles with
// no valid row are skipped, so the work follows the leaves' true sizes.
//
// Bound: 2*C^2*d f32 FLOPs per leaf of C valid points, at the card's f32
// CUDA-core rate; the gathered rows are read from L2 many times over but
// from device memory about once.
#include "common.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int DK = 32;
constexpr int PAD = 4;
constexpr int THREADS = 256;

template <int K>
__device__ __forceinline__ void topk_insert(float (&bd)[K], int (&bi)[K], float dv, int ci) {
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
__global__ void __launch_bounds__(THREADS)
leaf_topk_kernel(const float* __restrict__ pts, const int* __restrict__ leaf_ids,
                 int n_leaves, int C, int d, int metric,
                 int* __restrict__ out_idx, float* __restrict__ out_dist) {
  __shared__ __align__(16) float As[DK][BM + PAD];
  __shared__ __align__(16) float Bs[DK][BN + PAD];
  __shared__ int a_id[BM];
  __shared__ int b_id[BN];
  __shared__ float a_norm[BM];
  __shared__ float b_norm[BN];

  const int tiles = (C + BM - 1) / BM;
  const int leaf = blockIdx.x / tiles;
  const int row0 = (blockIdx.x % tiles) * BM;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int* ids = leaf_ids + (size_t)leaf * C;

  if (tid < BM) {
    const int r = row0 + tid;
    a_id[tid] = r < C ? ids[r] : -1;
  }
  __syncthreads();
  const int any_row = __syncthreads_or(tid < BM && a_id[tid] >= 0);

  float bd[4][K];
  int bi[4][K];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j) {
      bd[i][j] = CUDART_INF_F;
      bi[i][j] = 0x7fffffff;
    }

  if (any_row) {
    for (int col0 = 0; col0 < C; col0 += BN) {
      __syncthreads();  // previous tile's readers are done with the ids
      if (tid < BN) {
        const int c = col0 + tid;
        b_id[tid] = c < C ? ids[c] : -1;
      }
      __syncthreads();
      if (!__syncthreads_or(tid < BN && b_id[tid] >= 0)) continue;

      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      float norm_part = 0.f;  // threads < 64: row norm; 64..127: column norm

      for (int k0 = 0; k0 < d; k0 += DK) {
        // stage the slice: a warp reads 32 consecutive floats of one row
        for (int e = tid; e < BM * DK; e += THREADS) {
          const int kk = e % DK, r = e / DK, gk = k0 + kk;
          const int ga = a_id[r], gb = b_id[r];
          As[kk][r] = (ga >= 0 && gk < d) ? pts[(size_t)ga * d + gk] : 0.f;
          Bs[kk][r] = (gb >= 0 && gk < d) ? pts[(size_t)gb * d + gk] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < DK; ++kk) {
          const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
          const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        if (tid < BM) {
          for (int kk = 0; kk < DK; ++kk) norm_part = fmaf(As[kk][tid], As[kk][tid], norm_part);
        } else if (tid < BM + BN) {
          const int c = tid - BM;
          for (int kk = 0; kk < DK; ++kk) norm_part = fmaf(Bs[kk][c], Bs[kk][c], norm_part);
        }
        __syncthreads();
      }
      if (tid < BM) a_norm[tid] = norm_part;
      else if (tid < BM + BN) b_norm[tid - BM] = norm_part;
      __syncthreads();

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        const bool row_ok = a_id[r] >= 0;
        const float a2 = a_norm[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx * 4 + j;
          const int col = col0 + c;
          if (!row_ok || b_id[c] < 0 || col == row0 + r) continue;
          const float ip = acc[i][j];
          float dv;
          if (metric == pipnn::kMips) {
            dv = -ip;
          } else if (metric == pipnn::kCosine) {
            dv = 1.f - ip / fmaxf(sqrtf(a2) * sqrtf(b_norm[c]), 1e-30f);
          } else {
            dv = pipnn::clamp_zero((a2 + b_norm[c]) - 2.f * ip);
          }
          if (dv < CUDART_INF_F) topk_insert<K>(bd[i], bi[i], dv, col);
        }
      }
    }
  }

  // merge the 16 per-thread lists of each row (lanes differing in tx)
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float od[K];
      int oi[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        od[j] = __shfl_xor_sync(0xffffffffu, bd[i][j], off);
        oi[j] = __shfl_xor_sync(0xffffffffu, bi[i][j], off);
      }
#pragma unroll
      for (int j = 0; j < K; ++j)
        if (od[j] < CUDART_INF_F) topk_insert<K>(bd[i], bi[i], od[j], oi[j]);
    }
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ty * 4 + i;
      if (r >= C) continue;
      const bool row_ok = a_id[ty * 4 + i] >= 0;
      const size_t o = ((size_t)leaf * C + r) * K;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const bool ok = row_ok && bd[i][j] < CUDART_INF_F;
        out_idx[o + j] = ok ? bi[i][j] : -1;
        out_dist[o + j] = ok ? bd[i][j] : CUDART_INF_F;
      }
    }
  }
}

template <int K>
cudaError_t launch(const float* pts, const int* leaf_ids, int n_leaves, int C, int d,
                   int metric, int* out_idx, float* out_dist, cudaStream_t stream) {
  const long long blocks = (long long)n_leaves * ((C + BM - 1) / BM);
  if (blocks > 0)
    leaf_topk_kernel<K><<<(unsigned)blocks, THREADS, 0, stream>>>(
        pts, leaf_ids, n_leaves, C, d, metric, out_idx, out_dist);
  return cudaGetLastError();
}

}  // namespace

// points [n, d] f32, leaf_ids [B, C] int32 (-1 = padding)
//   -> out_idx [B, C, k] int32 in-leaf positions, out_dist [B, C, k] f32
PIPNN_EXPORT int pipnn_leaf_topk(const void* pts, const void* leaf_ids, int n, int d,
                                 int n_leaves, int C, int k, int metric, void* out_idx,
                                 void* out_dist, void* stream) {
  (void)n;
  const float* p = static_cast<const float*>(pts);
  const int* ids = static_cast<const int*>(leaf_ids);
  int* oi = static_cast<int*>(out_idx);
  float* od = static_cast<float*>(out_dist);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch<1>(p, ids, n_leaves, C, d, metric, oi, od, s);
    case 2: return launch<2>(p, ids, n_leaves, C, d, metric, oi, od, s);
    case 3: return launch<3>(p, ids, n_leaves, C, d, metric, oi, od, s);
    case 4: return launch<4>(p, ids, n_leaves, C, d, metric, oi, od, s);
    case 5: return launch<5>(p, ids, n_leaves, C, d, metric, oi, od, s);
    case 6: return launch<6>(p, ids, n_leaves, C, d, metric, oi, od, s);
    case 7: return launch<7>(p, ids, n_leaves, C, d, metric, oi, od, s);
    case 8: return launch<8>(p, ids, n_leaves, C, d, metric, oi, od, s);
    default: return cudaErrorInvalidValue;
  }
}
