// Fused neighbour gather + distance block for the beam search.
//
// Replaces the Pallas kernels repro/kernels/gather_distance.py::
// gather_distance (points resident in VMEM, pallas_call at :179) and
// ::gather_distance_hbm (points streamed from HBM, :407): on the card there
// is one memory space to read from, so one kernel serves both.
//
// What bounds it: bytes, the randomly gathered rows (d * 4 bytes in
// float32, d * 2 in bfloat16) of the valid ids.  The rows are read where
// they lie, one 16-byte load per lane, so the kernel's aim is to keep
// enough of those loads in flight to cover the latency of random reads.
//
// Design: one warp takes 32 id slots of one query.
// - It reads the 32 ids with one coalesced load and compacts the valid ones
//   with __ballot_sync / __popc.  Padding (-1) slots are written +inf and
//   take no load.
// - Every row is read with 16-byte lanes: a float32 row of 128 is one warp
//   load (32 lanes x 4 floats); a bfloat16 row of 128 takes a 16-lane group
//   (16 lanes x 8 values), so one warp load brings two rows.  Each lane
//   keeps 8 loads in flight (8 float32 rows or 16 bfloat16 rows a warp).
// - The 8 partial sums of a lane are reduced within its lane group by a
//   reduce-scatter (4 + 2 + 1 shuffles, then the rest of the group's
//   bits), after which each row's dot product sits on known lanes; the lane
//   that owns the row's slot fetches it with one shuffle and applies the
//   norm expansion with its own precomputed point norm:
//     l2:     max(|q|^2 + norm - 2 ip, 0)
//     cosine: 1 - ip / max(|q| * norm, 1e-30)
//     mips:   -ip
//   so the 32 results are written with one coalesced store.
// - The query's norm term is summed by each warp for itself: no block
//   barrier.
// Rows whose d is not a multiple of the 16-byte vector (or unaligned
// arrays) take the same path with one element a lane per load.
//
// Why the result is the float32 one: bfloat16 rows are widened exactly
// (a bfloat16 is the upper half of the float32 with the same value) and
// every sum is an f32 FMA chain; only the summation order differs from the
// plain version, so integer data below 2^24 gives equal bits.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int LOADS = 8;   // 16-byte row loads in flight a lane
constexpr int LL = 3;      // log2(LOADS)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// chunk c (VEC elements) of a row, widened to float32
__device__ __forceinline__ void load_chunk(const float* row, int c, float (&v)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(row) + c);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void load_chunk(const __nv_bfloat16* row, int c, float (&v)[8]) {
  // two bf16 per 32-bit word, the lower address in the low half
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(row) + c);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load_chunk(const float* row, int c, float (&v)[1]) {
  v[0] = __ldg(row + c);
}

__device__ __forceinline__ void load_chunk(const __nv_bfloat16* row, int c, float (&v)[1]) {
  v[0] = __bfloat162float(row[c]);
}

// chunk c of the float32 query row
template <int VEC>
__device__ __forceinline__ void load_query(const float* q, int c, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = __ldg(q + c);
  } else {
#pragma unroll
    for (int h = 0; h < VEC / 4; ++h) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(q) + c * (VEC / 4) + h);
      v[4 * h] = x.x;
      v[4 * h + 1] = x.y;
      v[4 * h + 2] = x.z;
      v[4 * h + 3] = x.w;
    }
  }
}

// VEC elements a lane per load, GROUP lanes a row (LOADS * 32 / GROUP
// rows in flight a warp)
template <typename T, int VEC, int GROUP>
__global__ void __launch_bounds__(WARPS * 32, 8)   // <= 64 registers: 32 warps an SM
gather_distance_kernel(const T* __restrict__ pts, const float* __restrict__ norms,
                       const float* __restrict__ queries, const int* __restrict__ ids, int d,
                       int Q, int C, int metric, float* __restrict__ out) {
  constexpr int R = 32 / GROUP;        // rows a warp load brings
  constexpr int RB = LOADS * R;        // rows a batch brings
  constexpr int LG = GROUP == 32 ? 5 : 4;
  static_assert(GROUP == 32 || GROUP == 16, "lane groups of 16 or 32");
  const int lane = threadIdx.x & 31;
  const int chunks = (C + 31) / 32;
  const long long item = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (item >= (long long)Q * chunks) return;   // whole warps
  const int q = (int)(item / chunks);
  const int slot = (int)(item % chunks) * 32 + lane;
  const bool in = slot < C;
  const int id = in ? ids[(size_t)q * C + slot] : -1;
  const unsigned mask = __ballot_sync(0xffffffffu, id >= 0);
  const float nrm = id >= 0 ? norms[id] : 0.f;
  const float* qrow = queries + (size_t)q * d;

  float s = 0.f;
  for (int i = lane; i < d; i += 32) s = fmaf(qrow[i], qrow[i], s);
  s = warp_sum(s);
  const float qt = metric == pipnn::kCosine ? sqrtf(s) : s;

  const int gl = lane & (GROUP - 1);
  const int half = lane >> LG;         // which row of a warp load (0 when GROUP = 32)
  const int nchunk = d / VEC;
  const int nvalid = __popc(mask);
  const int rank = __popc(mask & ((1u << lane) - 1u));
  float result = CUDART_INF_F;
  unsigned rem = mask;

  for (int b = 0; b < nvalid; b += RB) {
    // batch row j = i * R + half is this lane's load i
    int rid[LOADS];
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      const int src = __ffs(rem) - 1;  // -1 past the last valid slot
      rem &= rem - 1u;
      const int v = __shfl_sync(0xffffffffu, id, src & 31);
      if (j % R == half) rid[j / R] = src >= 0 ? v : -1;
    }
    float part[LOADS];
#pragma unroll
    for (int i = 0; i < LOADS; ++i) part[i] = 0.f;
    for (int c = gl; c < nchunk; c += GROUP) {
      float qv[VEC];
      load_query<VEC>(qrow, c, qv);
      float pv[LOADS][VEC];
#pragma unroll
      for (int i = 0; i < LOADS; ++i) {
        if (rid[i] >= 0) {
          load_chunk(pts + (size_t)rid[i] * d, c, pv[i]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) pv[i][e] = 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < LOADS; ++i)
#pragma unroll
        for (int e = 0; e < VEC; ++e) part[i] = fmaf(qv[e], pv[i][e], part[i]);
    }
    // reduce-scatter over the group's top LL lane bits, halving the values
    // at each step; afterwards a lane holds load (gl >> (LG - LL)), then the
    // group's remaining bits are summed
#pragma unroll
    for (int n = LOADS / 2, off = GROUP / 2; n >= 1; n /= 2, off /= 2) {
      const bool up = lane & off;
#pragma unroll
      for (int i = 0; i < n; ++i) {
        const float keep = up ? part[i + n] : part[i];
        const float send = up ? part[i] : part[i + n];
        part[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
      }
    }
#pragma unroll
    for (int off = GROUP >> (LL + 1); off > 0; off >>= 1)
      part[0] += __shfl_xor_sync(0xffffffffu, part[0], off);
    // the slot's owner fetches its row's dot product
    const int j = rank - b;
    const bool mine = id >= 0 && j >= 0 && j < RB;
    const int jj = mine ? j : 0;
    const float ip = __shfl_sync(0xffffffffu, part[0], (jj % R) * GROUP + ((jj / R) << (LG - LL)));
    if (mine) {
      if (metric == pipnn::kMips) {
        result = -ip;
      } else if (metric == pipnn::kCosine) {
        result = 1.f - ip / fmaxf(qt * nrm, 1e-30f);
      } else {
        result = pipnn::clamp_zero((qt + nrm) - 2.f * ip);
      }
    }
  }
  if (in) out[(size_t)q * C + slot] = result;
}

template <typename T, int VEC, int GROUP>
cudaError_t launch_as(const void* pts, const void* norms, const void* queries, const void* ids,
                      int d, int Q, int C, int metric, void* out, cudaStream_t stream) {
  const long long items = (long long)Q * ((C + 31) / 32);
  const long long blocks = (items + WARPS - 1) / WARPS;
  gather_distance_kernel<T, VEC, GROUP><<<(unsigned)blocks, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(pts), static_cast<const float*>(norms),
      static_cast<const float*>(queries), static_cast<const int*>(ids), d, Q, C, metric,
      static_cast<float*>(out));
  return cudaGetLastError();
}

// VEC: elements in 16 bytes of T; GROUP: lanes that cover 128 of them
template <typename T, int VEC, int GROUP>
cudaError_t launch(const void* pts, const void* norms, const void* queries, const void* ids,
                   int d, int Q, int C, int metric, void* out, void* stream) {
  if (Q <= 0 || C <= 0) return cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = d % VEC == 0 && reinterpret_cast<uintptr_t>(pts) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(queries) % 16 == 0;
  if (vec) return launch_as<T, VEC, GROUP>(pts, norms, queries, ids, d, Q, C, metric, out, s);
  return launch_as<T, 1, 32>(pts, norms, queries, ids, d, Q, C, metric, out, s);
}

}  // namespace

// points [n, d] f32, norms [n] f32, queries [Q, d] f32, ids [Q, C] int32
//   -> out [Q, C] f32
PIPNN_EXPORT int pipnn_gather_distance(const void* pts, const void* norms, const void* queries,
                                       const void* ids, int n, int d, int Q, int C, int metric,
                                       void* out, void* stream) {
  (void)n;
  return launch<float, 4, 32>(pts, norms, queries, ids, d, Q, C, metric, out, stream);
}

// the same with points [n, d] bf16
PIPNN_EXPORT int pipnn_gather_distance_bf16(const void* pts, const void* norms,
                                            const void* queries, const void* ids, int n, int d,
                                            int Q, int C, int metric, void* out, void* stream) {
  (void)n;
  return launch<__nv_bfloat16, 8, 16>(pts, norms, queries, ids, d, Q, C, metric, out, stream);
}
