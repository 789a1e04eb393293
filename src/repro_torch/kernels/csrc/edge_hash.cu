// Residual edge hashes for HashPrune, with the sketch gather fused.
//
// Replaces the Pallas kernel repro/kernels/edge_hash.py::edge_hashes (and the
// gather in repro/core/sketch.py::edge_hashes_from_ids that feeds it).  Each
// edge reads the two m-wide sketch rows of max(src, 0) and max(dst, 0) and
// packs bit i = (Sk(dst)[i] - Sk(src)[i] >= 0) with weight 2^i.  A single
// rounded subtraction per bit: bit-exact against the plain version, also
// where row 0 is not finite.
//
// Bound: bytes.  Each edge reads 8 bytes of ids and writes 4 bytes of hash;
// the [n, m] sketch matrix (48 MB at n = 1M, m = 12) is read through L2.
// Design:
// - A thread takes EPT = 4 consecutive edges: where src, dst and out start
//   on 16-byte boundaries, one 16-byte load of each id array and one 16-byte
//   store of hashes (a scalar tail for the last E % 4 edges, and scalar ids
//   for offset views, in the same kernel).
// - Where m % 4 == 0 and the sketches are 16-byte aligned, a sketch row is
//   m / 4 16-byte loads (3 at m = 12), written before the compares in
//   program order; otherwise 4-byte row loads, one edge at a time.
// - Occupancy over one thread's loads in flight: 128-thread blocks held to
//   64 registers, so 8 blocks fit an SM.  There ptxas cannot keep all 24
//   rows of a thread's four edges live at m = 12 and interleaves compares
//   with the later loads, yet it ran 7.5% faster than 256-thread blocks at
//   72 registers, which also could not (kernel_ab on phase 1's input, one
//   H100 SXM at 700 W: 0.4284 against 0.4630 ms).
// - A negative id (padding, most edges of a stream chunk) reads no global
//   memory: the block keeps row 0 in shared memory and such ids read it
//   there.
// - No cache hints: streaming the ids and hashes past the cache (ld/st .cs)
//   and keeping the sketch rows in L2 (evict_last) changed nothing
//   (kernel_ab on phase 1's input, one H100 SXM at 700 W: 0.4663 ms with
//   them, 0.4656 without).
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 8;   // blocks an SM: 64 registers a thread
constexpr int EPT = 4;          // edges a thread, a multiple of 4
constexpr int MAX_M = 16;       // hash bits

// Row loads are volatile asm: a load under a branch must not be hoisted
// above it (a negative id's row does not exist), and the loads keep their
// program order (with 256-thread blocks, plain loads that the compiler
// reorders were 1.5% slower on phase 1's input, kernel_ab on one H100 SXM
// at 700 W).
__device__ __forceinline__ float4 ld_row4(const float4* p) {
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0,%1,%2,%3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ float ld_row1(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ int bits4(float4 t, float4 s, int shift) {
  return (t.x - s.x >= 0.f ? 1 << shift : 0) | (t.y - s.y >= 0.f ? 2 << shift : 0) |
         (t.z - s.z >= 0.f ? 4 << shift : 0) | (t.w - s.w >= 0.f ? 8 << shift : 0);
}

// M4 > 0: rows of m = 4 * M4 floats as M4 16-byte loads; M4 = 0: any m,
// 4-byte loads.  vec_ids: src, dst and out are 16-byte aligned.
template <int M4>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
edge_hash_kernel(const float* __restrict__ sketches, const int* __restrict__ src,
                 const int* __restrict__ dst, long long n_edges, int m, bool vec_ids,
                 int* __restrict__ out) {
  __shared__ __align__(16) float row0[MAX_M];
  if ((int)threadIdx.x < m) row0[threadIdx.x] = ld_row1(sketches + threadIdx.x);
  __syncthreads();
  const long long e0 = ((long long)blockIdx.x * THREADS + threadIdx.x) * EPT;
  if (e0 >= n_edges) return;
  const bool full = vec_ids && e0 + EPT <= n_edges;

  int s[EPT], t[EPT];
  if (full) {
#pragma unroll
    for (int j = 0; j < EPT; j += 4) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(src + e0 + j));
      const int4 b = __ldg(reinterpret_cast<const int4*>(dst + e0 + j));
      s[j] = a.x; s[j + 1] = a.y; s[j + 2] = a.z; s[j + 3] = a.w;
      t[j] = b.x; t[j + 1] = b.y; t[j + 2] = b.z; t[j + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < EPT; ++j) {
      s[j] = t[j] = -1;
      if (e0 + j < n_edges) {
        s[j] = __ldg(src + e0 + j);
        t[j] = __ldg(dst + e0 + j);
      }
    }
  }

  int h[EPT];
  if constexpr (M4 > 0) {
    const float4* sk4 = reinterpret_cast<const float4*>(sketches);
    const float4* r04 = reinterpret_cast<const float4*>(row0);
    float4 vs[EPT][M4], vt[EPT][M4];
#pragma unroll
    for (int j = 0; j < EPT; ++j)
#pragma unroll
      for (int q = 0; q < M4; ++q) {
        vs[j][q] = vt[j][q] = r04[q];
        if (s[j] >= 0) vs[j][q] = ld_row4(sk4 + (size_t)s[j] * M4 + q);
        if (t[j] >= 0) vt[j][q] = ld_row4(sk4 + (size_t)t[j] * M4 + q);
      }
#pragma unroll
    for (int j = 0; j < EPT; ++j) {
      int v = 0;
#pragma unroll
      for (int q = 0; q < M4; ++q) v |= bits4(vt[j][q], vs[j][q], 4 * q);
      h[j] = v;
    }
  } else {
#pragma unroll
    for (int j = 0; j < EPT; ++j) {
      float a[MAX_M], b[MAX_M];
#pragma unroll
      for (int i = 0; i < MAX_M; ++i) {
        if (i < m) {
          a[i] = b[i] = row0[i];
          if (s[j] >= 0) a[i] = ld_row1(sketches + (size_t)s[j] * m + i);
          if (t[j] >= 0) b[i] = ld_row1(sketches + (size_t)t[j] * m + i);
        }
      }
      int v = 0;
#pragma unroll
      for (int i = 0; i < MAX_M; ++i)
        if (i < m) v |= (b[i] - a[i] >= 0.f ? 1 : 0) << i;
      h[j] = v;
    }
  }

  if (full) {
#pragma unroll
    for (int j = 0; j < EPT; j += 4)
      *reinterpret_cast<int4*>(out + e0 + j) = make_int4(h[j], h[j + 1], h[j + 2], h[j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < EPT; ++j)
      if (e0 + j < n_edges) out[e0 + j] = h[j];
  }
}

template <int M4>
cudaError_t launch(const float* sketches, const int* src, const int* dst, long long n_edges,
                   int m, bool vec_ids, int* out, cudaStream_t stream) {
  const long long blocks = (n_edges + (long long)THREADS * EPT - 1) / ((long long)THREADS * EPT);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (blocks > 0)
    edge_hash_kernel<M4><<<(unsigned)blocks, THREADS, 0, stream>>>(sketches, src, dst, n_edges,
                                                                   m, vec_ids, out);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// sketches [n, m] f32, src/dst [E] int32 -> out [E] int32
PIPNN_EXPORT int pipnn_edge_hashes(const void* sketches, const void* src, const void* dst,
                                   long long n_edges, int m, void* out, void* stream) {
  if (m < 1 || m > MAX_M) return cudaErrorInvalidValue;
  const float* sk = static_cast<const float*>(sketches);
  const int* s = static_cast<const int*>(src);
  const int* t = static_cast<const int*>(dst);
  int* o = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec_ids = aligned16(src) && aligned16(dst) && aligned16(out);
  if (m % 4 == 0 && aligned16(sketches)) {
    switch (m / 4) {
      case 1: return launch<1>(sk, s, t, n_edges, m, vec_ids, o, st);
      case 2: return launch<2>(sk, s, t, n_edges, m, vec_ids, o, st);
      case 3: return launch<3>(sk, s, t, n_edges, m, vec_ids, o, st);
      default: return launch<4>(sk, s, t, n_edges, m, vec_ids, o, st);
    }
  }
  return launch<0>(sk, s, t, n_edges, m, vec_ids, o, st);
}
