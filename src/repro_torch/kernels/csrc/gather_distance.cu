// Fused neighbour gather + distance block for the beam search.
//
// Replaces the Pallas kernels repro/kernels/gather_distance.py::
// gather_distance (points resident in VMEM) and ::gather_distance_hbm
// (points streamed from HBM): on the card there is one memory space to
// read from, so one kernel serves both.  One block of four warps handles
// one query: the query row sits in shared memory and its norm term is
// reduced once; each warp then takes neighbours in turn, reads the
// neighbour's row with coalesced 16-byte loads (a 128-float row is one load
// per lane), reduces the dot product across the warp with shuffles and
// fuses the norm expansion with the precomputed point norms:
//   l2:     max(|q|^2 + norm - 2 ip, 0)
//   cosine: 1 - ip / max(|q| * norm, 1e-30)
//   mips:   -ip
// Padding ids (-1) give +inf.  Four neighbours are in flight per warp to
// hide the latency of the random row reads.
//
// The rows are float32, or bfloat16 for a downcast serving copy (the
// reference's kernel upcasts the gathered rows the same way): one template,
// with rows read four elements at a time (16 or 8 bytes) and widened to
// float32 exactly, the query and the norms staying float32.
//
// Bound: bytes, Q*C*d*sizeof(row element) of randomly gathered rows (plus
// ids and output).
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int UNROLL = 4;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// elements 4i..4i+3 of a row, as float32
__device__ __forceinline__ float4 load4(const float* row, int i) {
  return reinterpret_cast<const float4*>(row)[i];
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* row, int i) {
  // two bf16 per 32-bit word, the lower address in the low half; a bf16
  // is the upper half of the float32 with the same value
  const uint2 u = reinterpret_cast<const uint2*>(row)[i];
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
gather_distance_kernel(const T* __restrict__ pts, const float* __restrict__ norms,
                       const float* __restrict__ queries, const int* __restrict__ ids,
                       int d, int C, int metric, float* __restrict__ out) {
  extern __shared__ __align__(16) float q_s[];
  __shared__ float q_term;
  const int q = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* qrow = queries + (size_t)q * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) q_s[i] = qrow[i];
  __syncthreads();
  if (warp == 0) {
    float s = 0.f;
    for (int i = lane; i < d; i += 32) s = fmaf(q_s[i], q_s[i], s);
    s = warp_sum(s);
    if (lane == 0) q_term = metric == pipnn::kCosine ? sqrtf(s) : s;
  }
  __syncthreads();
  const float qt = q_term;
  const int* qids = ids + (size_t)q * C;
  float* qout = out + (size_t)q * C;
  const bool vec4 = (d % 4) == 0;
  const int d4 = d / 4;

  for (int c0 = warp * UNROLL; c0 < C; c0 += WARPS * UNROLL) {
    int id[UNROLL];
    float ip[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      id[u] = c0 + u < C ? qids[c0 + u] : -1;
      ip[u] = 0.f;
    }
    if (vec4) {
      const float4* q4 = reinterpret_cast<const float4*>(q_s);
      for (int i = lane; i < d4; i += 32) {
        const float4 qv = q4[i];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (id[u] < 0) continue;
          const float4 p = load4(pts + (size_t)id[u] * d, i);
          ip[u] = fmaf(qv.x, p.x, ip[u]);
          ip[u] = fmaf(qv.y, p.y, ip[u]);
          ip[u] = fmaf(qv.z, p.z, ip[u]);
          ip[u] = fmaf(qv.w, p.w, ip[u]);
        }
      }
    } else {
      for (int i = lane; i < d; i += 32) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          if (id[u] >= 0) ip[u] = fmaf(q_s[i], to_f32(pts[(size_t)id[u] * d + i]), ip[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) ip[u] = warp_sum(ip[u]);
    if (lane < UNROLL && c0 + lane < C) {
      // lane u writes neighbour c0 + u
      float v = ip[0];
      int nid = id[0];
#pragma unroll
      for (int u = 1; u < UNROLL; ++u) {
        if (lane == u) {
          v = ip[u];
          nid = id[u];
        }
      }
      float dv;
      if (nid < 0) {
        dv = CUDART_INF_F;
      } else if (metric == pipnn::kMips) {
        dv = -v;
      } else if (metric == pipnn::kCosine) {
        dv = 1.f - v / fmaxf(qt * norms[nid], 1e-30f);
      } else {
        dv = pipnn::clamp_zero((qt + norms[nid]) - 2.f * v);
      }
      qout[c0 + lane] = dv;
    }
  }
}

template <typename T>
cudaError_t launch(const void* pts, const void* norms, const void* queries, const void* ids,
                   int d, int Q, int C, int metric, void* out, void* stream) {
  const size_t smem = (size_t)d * sizeof(float);
  if (Q > 0 && C > 0)
    gather_distance_kernel<T><<<Q, WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(pts), static_cast<const float*>(norms),
        static_cast<const float*>(queries), static_cast<const int*>(ids), d, C, metric,
        static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

// points [n, d] f32, norms [n] f32, queries [Q, d] f32, ids [Q, C] int32
//   -> out [Q, C] f32
PIPNN_EXPORT int pipnn_gather_distance(const void* pts, const void* norms, const void* queries,
                                       const void* ids, int n, int d, int Q, int C, int metric,
                                       void* out, void* stream) {
  (void)n;
  return launch<float>(pts, norms, queries, ids, d, Q, C, metric, out, stream);
}

// the same with points [n, d] bf16
PIPNN_EXPORT int pipnn_gather_distance_bf16(const void* pts, const void* norms,
                                            const void* queries, const void* ids, int n, int d,
                                            int Q, int C, int metric, void* out, void* stream) {
  (void)n;
  return launch<__nv_bfloat16>(pts, norms, queries, ids, d, Q, C, metric, out, stream);
}
