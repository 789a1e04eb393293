// Batched pairwise distance matrices, float32 and int8.
//
// pipnn_pairwise_distance replaces the Pallas kernel repro/kernels/
// distance.py::pairwise_distance: [B, M, D] x [B, N, D] -> [B, M, N] f32
// with the norm expansion fused.  One block computes one 64x64 output tile
// of one batch entry.  The two row panels are staged through shared memory
// in 32-deep slices; every thread owns a 4x4 patch of the tile and
// accumulates it with float32 FMAs on the CUDA cores (no TF32: on integer
// data below 2^24 the result is then exact, as the plain version's is).
// The row and column norms come from the same slices, so each input element
// is read from device memory once per tile.  The epilogue is that of
// core/leader_assign.py::leader_dists, one correctly rounded operation at a
// time (no FMA contraction):
//   l2:     max((|a|^2 + |b|^2) - 2 ip, 0)
//   cosine: 1 - ip / max(|a| |b|, 1e-30)
//   mips:   -ip
//
// pipnn_pairwise_distance_int8 replaces ::pairwise_distance_int8: exact
// squared L2 on int8 inputs, |a|^2 + |b|^2 - 2 ip in int32.  The same tile
// walk, with the rows staged as 32-bit words of four int8 values and every
// product summed with __dp4a.
//
// Bound: the f32 kernel, 2*B*M*N*D FLOPs at the f32 CUDA-core rate (or the
// output's bytes, where D is small); the int8 kernel, the int32 output's
// bytes.
#include "common.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int DK = 32;   // f32 elements, or int8 words, per slice
constexpr int PAD = 4;
constexpr int THREADS = 256;

struct Tile {
  int batch, row0, col0;
};

__device__ __forceinline__ Tile tile_of(int block, int tiles_m, int tiles_n) {
  const int per_batch = tiles_m * tiles_n;
  const int rem = block % per_batch;
  return {block / per_batch, (rem / tiles_n) * BM, (rem % tiles_n) * BN};
}

__global__ void __launch_bounds__(THREADS)
pairwise_distance_kernel(const float* __restrict__ a, const float* __restrict__ b, int M, int N,
                         int D, int metric, int tiles_m, int tiles_n, float* __restrict__ out) {
  __shared__ __align__(16) float As[DK][BM + PAD];
  __shared__ __align__(16) float Bs[DK][BN + PAD];
  __shared__ float a_norm[BM];
  __shared__ float b_norm[BN];

  const Tile t = tile_of(blockIdx.x, tiles_m, tiles_n);
  const float* A = a + (size_t)t.batch * M * D;
  const float* B = b + (size_t)t.batch * N * D;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float norm_part = 0.f;  // threads < 64: row norm; 64..127: column norm

  for (int k0 = 0; k0 < D; k0 += DK) {
    // stage the slice: a warp reads 32 consecutive floats of one row
    for (int e = tid; e < BM * DK; e += THREADS) {
      const int kk = e % DK, r = e / DK, gk = k0 + kk;
      const int ra = t.row0 + r, rb = t.col0 + r;
      As[kk][r] = (ra < M && gk < D) ? A[(size_t)ra * D + gk] : 0.f;
      Bs[kk][r] = (rb < N && gk < D) ? B[(size_t)rb * D + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < DK; ++kk) {
      const float4 av4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {av4.x, av4.y, av4.z, av4.w};
      const float bv[4] = {bv4.x, bv4.y, bv4.z, bv4.w};
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
    const int r = t.row0 + ty * 4 + i;
    if (r >= M) continue;
    const float a2 = a_norm[ty * 4 + i];
    float* orow = out + ((size_t)t.batch * M + r) * N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = t.col0 + tx * 4 + j;
      if (c >= N) continue;
      const float ip = acc[i][j];
      const float b2 = b_norm[tx * 4 + j];
      float dv;
      if (metric == pipnn::kMips) {
        dv = -ip;
      } else if (metric == pipnn::kCosine) {
        dv = __fsub_rn(1.f, __fdiv_rn(ip, fmaxf(__fmul_rn(sqrtf(a2), sqrtf(b2)), 1e-30f)));
      } else {
        dv = pipnn::clamp_zero(__fsub_rn(__fadd_rn(a2, b2), __fmul_rn(2.f, ip)));
      }
      orow[c] = dv;
    }
  }
}

// word w (int8 elements 4w..4w+3) of row r of a [rows, D] int8 matrix,
// zero past the end
__device__ __forceinline__ int load_word(const int8_t* m, int r, int w, int rows, int D,
                                         bool aligned) {
  if (r >= rows || 4 * w >= D) return 0;
  const int8_t* row = m + (size_t)r * D;
  if (aligned) return reinterpret_cast<const int*>(row)[w];
  unsigned v = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int e = 4 * w + k;
    if (e < D) v |= (unsigned)(uint8_t)row[e] << (8 * k);
  }
  return (int)v;
}

__global__ void __launch_bounds__(THREADS)
pairwise_distance_int8_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b, int M,
                              int N, int D, int tiles_m, int tiles_n, bool aligned,
                              int* __restrict__ out) {
  __shared__ __align__(16) int As[DK][BM + PAD];
  __shared__ __align__(16) int Bs[DK][BN + PAD];
  __shared__ int a_sq[BM];
  __shared__ int b_sq[BN];

  const Tile t = tile_of(blockIdx.x, tiles_m, tiles_n);
  const int8_t* A = a + (size_t)t.batch * M * D;
  const int8_t* B = b + (size_t)t.batch * N * D;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int words = (D + 3) / 4;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  int sq_part = 0;

  for (int w0 = 0; w0 < words; w0 += DK) {
    for (int e = tid; e < BM * DK; e += THREADS) {
      const int kw = e % DK, r = e / DK, gw = w0 + kw;
      As[kw][r] = gw < words ? load_word(A, t.row0 + r, gw, M, D, aligned) : 0;
      Bs[kw][r] = gw < words ? load_word(B, t.col0 + r, gw, N, D, aligned) : 0;
    }
    __syncthreads();
#pragma unroll 8
    for (int kw = 0; kw < DK; ++kw) {
      const int4 av4 = *reinterpret_cast<const int4*>(&As[kw][ty * 4]);
      const int4 bv4 = *reinterpret_cast<const int4*>(&Bs[kw][tx * 4]);
      const int av[4] = {av4.x, av4.y, av4.z, av4.w};
      const int bv[4] = {bv4.x, bv4.y, bv4.z, bv4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    if (tid < BM) {
      for (int kw = 0; kw < DK; ++kw) sq_part = __dp4a(As[kw][tid], As[kw][tid], sq_part);
    } else if (tid < BM + BN) {
      const int c = tid - BM;
      for (int kw = 0; kw < DK; ++kw) sq_part = __dp4a(Bs[kw][c], Bs[kw][c], sq_part);
    }
    __syncthreads();
  }
  if (tid < BM) a_sq[tid] = sq_part;
  else if (tid < BM + BN) b_sq[tid - BM] = sq_part;
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = t.row0 + ty * 4 + i;
    if (r >= M) continue;
    const int a2 = a_sq[ty * 4 + i];
    int* orow = out + ((size_t)t.batch * M + r) * N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = t.col0 + tx * 4 + j;
      if (c < N) orow[c] = a2 + b_sq[tx * 4 + j] - 2 * acc[i][j];
    }
  }
}

long long n_blocks(int B, int M, int N, int* tiles_m, int* tiles_n) {
  *tiles_m = (M + BM - 1) / BM;
  *tiles_n = (N + BN - 1) / BN;
  return (long long)B * *tiles_m * *tiles_n;
}

}  // namespace

// a [B, M, D] f32, b [B, N, D] f32 -> out [B, M, N] f32
PIPNN_EXPORT int pipnn_pairwise_distance(const void* a, const void* b, int B, int M, int N, int D,
                                         int metric, void* out, void* stream) {
  int tm, tn;
  const long long blocks = n_blocks(B, M, N, &tm, &tn);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (blocks > 0)
    pairwise_distance_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), M, N, D, metric, tm, tn,
        static_cast<float*>(out));
  return cudaGetLastError();
}

// a [B, M, D] int8, b [B, N, D] int8 -> out [B, M, N] int32
PIPNN_EXPORT int pipnn_pairwise_distance_int8(const void* a, const void* b, int B, int M, int N,
                                              int D, void* out, void* stream) {
  int tm, tn;
  const long long blocks = n_blocks(B, M, N, &tm, &tn);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  // 32-bit word loads need every row to start on a 4-byte boundary
  const bool aligned = D % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(b) % 4 == 0;
  if (blocks > 0)
    pairwise_distance_int8_kernel<<<(unsigned)blocks, THREADS, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), M, N, D, tm, tn, aligned,
        static_cast<int*>(out));
  return cudaGetLastError();
}
