// Residual edge hashes for HashPrune, with the sketch gather fused.
//
// Replaces the Pallas kernel repro/kernels/edge_hash.py::edge_hashes (and the
// gather in repro/core/sketch.py::edge_hashes_from_ids that feeds it).  One
// thread per edge reads the two m-wide sketch rows of max(src, 0) and
// max(dst, 0) and packs bit i = (Sk(dst)[i] - Sk(src)[i] >= 0) with weight
// 2^i.  A single rounded subtraction per bit: bit-exact against the plain
// version.
//
// Bound: bytes.  Each edge reads 8 bytes of ids and writes 4 bytes of hash;
// the sketch rows (m*4 bytes each) mostly hit in L2, since the [n, m] sketch
// matrix (48 MB at n = 1M, m = 12) about fits the 50 MB cache.
#include "common.cuh"

namespace {

__global__ void edge_hash_kernel(const float* __restrict__ sketches, const int* __restrict__ src,
                                 const int* __restrict__ dst, long long n_edges, int m,
                                 int* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_edges) return;
  const int s = max(src[e], 0);
  const int t = max(dst[e], 0);
  const float* ss = sketches + (size_t)s * m;
  const float* ts = sketches + (size_t)t * m;
  int h = 0;
  for (int i = 0; i < m; ++i) h |= (ts[i] - ss[i] >= 0.f ? 1 : 0) << i;
  out[e] = h;
}

}  // namespace

// sketches [n, m] f32, src/dst [E] int32 -> out [E] int32
PIPNN_EXPORT int pipnn_edge_hashes(const void* sketches, const void* src, const void* dst,
                                   long long n_edges, int m, void* out, void* stream) {
  constexpr int threads = 256;
  const long long blocks = (n_edges + threads - 1) / threads;
  if (blocks > 0)
    edge_hash_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(sketches), static_cast<const int*>(src),
        static_cast<const int*>(dst), n_edges, m, static_cast<int*>(out));
  return cudaGetLastError();
}
