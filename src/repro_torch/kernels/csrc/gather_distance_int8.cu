// Fused neighbour gather + distance block for int8 (scalar-quantized)
// serving.
//
// Replaces the Pallas kernels repro/kernels/gather_distance.py::
// gather_distance_int8 (points resident in VMEM) and
// ::gather_distance_int8_hbm (points streamed from HBM): on the card there
// is one memory space to read from, so one kernel serves both.
//
// The points are the int8 packing of kernels/gather_distance_int8.py::
// quantize_symmetric with per-point float32 scales, beside the exact
// float32 norms.  One block of four warps handles one query.  It first
// quantizes its float32 query row with the same scheme, into shared memory:
//   scale = max(max|v|, 1e-12) * float32(1/127)   (a reciprocal multiply)
//   q8    = clip(rint(v / scale), -127, 127)       (correctly rounded /,
//                                                   round half to even)
// The quantization is row-local, so doing it here or once per batch gives
// the same bits.  Each warp then takes neighbours in turn: a lane reads 4
// bytes of the neighbour's row (a 128-byte row is one coalesced load per
// warp) and accumulates int8 x int8 -> int32 with __dp4a; the warp sums the
// lanes with shuffles, exactly.  The epilogue rescales and expands with the
// exact norms, one correctly rounded operation at a time in the
// reference's order, so nvcc cannot contract any of it into an FMA:
//   ipf    = float(ip) * (s_q * s_p)
//   l2:      max((|q|^2 + norm) - 2 ipf, 0)
//   cosine:  1 - ipf / max(|q| * norm, 1e-30)
//   mips:    -ipf
// Padding ids (-1) give +inf.  Four neighbours are in flight per warp.
//
// Bound: bytes, a d-byte row, a scale and a norm for each distinct valid id
// (plus ids, queries and output).
#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int UNROLL = 4;
constexpr float kInv127 = (float)(1.0 / 127.0);

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(WARPS * 32)
gather_distance_int8_kernel(const int8_t* __restrict__ pts, const float* __restrict__ scales,
                            const float* __restrict__ norms, const float* __restrict__ queries,
                            const float* __restrict__ q_norms, const int* __restrict__ ids,
                            int d, int C, int metric, float* __restrict__ out) {
  extern __shared__ __align__(16) int8_t q8[];   // d rounded up to 4 bytes
  __shared__ float part[WARPS];
  __shared__ float q_scale;
  const int q = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* qrow = queries + (size_t)q * d;

  // --- quantize the query row (quantize_symmetric) ---------------------
  float m = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) m = fmaxf(m, fabsf(qrow[i]));
  m = warp_max(m);
  if (lane == 0) part[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float mm = part[0];
    for (int w = 1; w < WARPS; ++w) mm = fmaxf(mm, part[w]);
    q_scale = __fmul_rn(fmaxf(mm, 1e-12f), kInv127);
  }
  __syncthreads();
  const float sq = q_scale;
  const int dw = (d + 3) / 4;
  for (int i = threadIdx.x; i < dw * 4; i += blockDim.x) {
    float r = 0.f;
    if (i < d) r = fminf(fmaxf(rintf(__fdiv_rn(qrow[i], sq)), -127.f), 127.f);
    q8[i] = static_cast<int8_t>(static_cast<int>(r));
  }
  __syncthreads();

  const float qa = q_norms[q];
  const int* qids = ids + (size_t)q * C;
  float* qout = out + (size_t)q * C;
  const bool words = (d % 4) == 0;
  const int* q32 = reinterpret_cast<const int*>(q8);

  for (int c0 = warp * UNROLL; c0 < C; c0 += WARPS * UNROLL) {
    int id[UNROLL];
    int ip[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      id[u] = c0 + u < C ? qids[c0 + u] : -1;
      ip[u] = 0;
    }
    if (words) {
      for (int i = lane; i < dw; i += 32) {
        const int qv = q32[i];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (id[u] < 0) continue;
          const int p = reinterpret_cast<const int*>(pts + (size_t)id[u] * d)[i];
          ip[u] = __dp4a(qv, p, ip[u]);
        }
      }
    } else {
      for (int i = lane; i < d; i += 32) {
        const int qv = q8[i];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          if (id[u] >= 0) ip[u] += qv * static_cast<int>(pts[(size_t)id[u] * d + i]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) ip[u] = warp_sum(ip[u]);
    if (lane < UNROLL && c0 + lane < C) {
      // lane u writes neighbour c0 + u
      int v = ip[0];
      int nid = id[0];
#pragma unroll
      for (int u = 1; u < UNROLL; ++u) {
        if (lane == u) {
          v = ip[u];
          nid = id[u];
        }
      }
      float dv = CUDART_INF_F;
      if (nid >= 0) {
        const float ipf = __fmul_rn(__int2float_rn(v), __fmul_rn(sq, scales[nid]));
        if (metric == pipnn::kMips) {
          dv = -ipf;
        } else if (metric == pipnn::kCosine) {
          dv = __fsub_rn(1.f, __fdiv_rn(ipf, fmaxf(__fmul_rn(qa, norms[nid]), 1e-30f)));
        } else {
          dv = pipnn::clamp_zero(__fsub_rn(__fadd_rn(qa, norms[nid]), __fmul_rn(2.f, ipf)));
        }
      }
      qout[c0 + lane] = dv;
    }
  }
}

}  // namespace

// points [n, d] int8, scales [n] f32, norms [n] f32, queries [Q, d] f32,
// q_norms [Q] f32, ids [Q, C] int32 -> out [Q, C] f32
PIPNN_EXPORT int pipnn_gather_distance_int8(const void* pts, const void* scales,
                                            const void* norms, const void* queries,
                                            const void* q_norms, const void* ids, int n, int d,
                                            int Q, int C, int metric, void* out,
                                            void* stream) {
  (void)n;
  const size_t smem = (size_t)((d + 3) / 4) * 4;
  if (Q > 0 && C > 0)
    gather_distance_int8_kernel<<<Q, WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(pts), static_cast<const float*>(scales),
        static_cast<const float*>(norms), static_cast<const float*>(queries),
        static_cast<const float*>(q_norms), static_cast<const int*>(ids), d, C, metric,
        static_cast<float*>(out));
  return cudaGetLastError();
}
