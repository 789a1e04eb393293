// Fused neighbour gather + distance block for int8 (scalar-quantized)
// serving.
//
// Replaces the Pallas kernels repro/kernels/gather_distance.py::
// gather_distance_int8 (points resident in VMEM, pallas_call at :275) and
// ::gather_distance_int8_hbm (points streamed from HBM, :499): on the card
// there is one memory space to read from, so one kernel serves both.
//
// The points are the int8 packing of kernels/gather_distance_int8.py::
// quantize_symmetric with per-point float32 scales, beside the exact
// float32 norms.
//
// What bounds it: bytes, the randomly gathered d-byte rows of the valid
// ids (with a scale and a norm each).  The rows are read where they lie,
// one 16-byte load per lane, so the kernel's aim is to keep enough of
// those loads in flight to cover the latency of random reads.
//
// Design (that of gather_distance.cu, for int8 rows): one warp takes 32 id
// slots of one query.
// - It reads the 32 ids with one coalesced load and compacts the valid ones
//   with __ballot_sync / __popc.  Padding (-1) slots are written +inf and
//   take no load; a warp with no valid slot loads nothing else.
// - A 128-byte row is an 8-lane group of 16-byte lanes, so one warp load
//   brings 4 rows.  Each lane keeps 8 loads in flight: all 32 slots of the
//   warp at once.  Each 16-byte lane does 4 __dp4a (int8 x int8 -> int32).
// - The 8 partial sums of a lane are reduced within its 8-lane group by a
//   reduce-scatter (4 + 2 + 1 shuffles, exact in int32), after which the
//   lane that owns a row's slot fetches its dot product with one shuffle,
//   and the 32 results are written with one coalesced store.
// - The query is quantized by each warp for itself, with no block barrier
//   and with the scheme of quantize_symmetric:
//     scale = max(max|v|, 1e-12) * float32(1/127)   (a reciprocal multiply)
//     q8    = clip(rint(v / scale), -127, 127)       (correctly rounded /,
//                                                     round half to even)
//   max|v| comes from the 16 values each lane multiplies, reduced across
//   its lane group by shuffles (a max is exact in any order), and each lane
//   quantizes only those 16 values: the same bits as quantizing once.
// - The epilogue rescales and expands with the exact norms, one correctly
//   rounded operation at a time in the reference's order, so nvcc cannot
//   contract any of it into an FMA:
//     ipf    = float(ip) * (s_q * s_p)
//     l2:      max((|q|^2 + norm) - 2 ipf, 0)
//     cosine:  1 - ipf / max(|q| * norm, 1e-30)
//     mips:    -ipf
// Rows whose d is not a multiple of 16, or points or queries that are not
// 16-byte aligned, take the same path with one byte a lane per load.
#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int LOADS = 8;   // 16-byte row loads in flight a lane
constexpr int LL = 3;      // log2(LOADS)
constexpr unsigned FULL = 0xffffffffu;
constexpr float kInv127 = (float)(1.0 / 127.0);

// VEC values of the float32 query row from chunk c
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

__device__ __forceinline__ int quantize(float v, float sq) {
  return static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(v, sq)), -127.f), 127.f));
}

// words a chunk occupies in registers: 4 packed int8 words, or one value
template <int VEC>
constexpr int kWords = VEC == 1 ? 1 : VEC / 4;

template <int VEC>
__device__ __forceinline__ void quantize_chunk(const float (&v)[VEC], float sq,
                                               int (&w)[kWords<VEC>]) {
  if constexpr (VEC == 1) {
    w[0] = quantize(v[0], sq);
  } else {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      // the lower address in the low byte, as the rows are laid out
      w[i] = (quantize(v[4 * i], sq) & 0xff) | (quantize(v[4 * i + 1], sq) & 0xff) << 8 |
             (quantize(v[4 * i + 2], sq) & 0xff) << 16 |
             static_cast<int>(static_cast<unsigned>(quantize(v[4 * i + 3], sq)) << 24);
    }
  }
}

template <int VEC>
__device__ __forceinline__ void load_row(const int8_t* row, int c, int (&p)[kWords<VEC>]) {
  if constexpr (VEC == 1) {
    p[0] = row[c];
  } else {
    const int4 u = __ldg(reinterpret_cast<const int4*>(row) + c);
    p[0] = u.x;
    p[1] = u.y;
    p[2] = u.z;
    p[3] = u.w;
  }
}

template <int VEC>
__device__ __forceinline__ int dot(const int (&q)[kWords<VEC>], const int (&p)[kWords<VEC>],
                                   int acc) {
  if constexpr (VEC == 1) {
    return acc + q[0] * p[0];
  } else {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) acc = __dp4a(q[i], p[i], acc);
    return acc;
  }
}

// VEC bytes a lane per load, GROUP lanes a row (LOADS * 32 / GROUP rows in
// flight a warp)
template <int VEC, int GROUP>
__global__ void __launch_bounds__(WARPS * 32, 8)   // <= 64 registers: 32 warps an SM
gather_distance_int8_kernel(const int8_t* __restrict__ pts, const float* __restrict__ scales,
                            const float* __restrict__ norms, const float* __restrict__ queries,
                            const float* __restrict__ q_norms, const int* __restrict__ ids,
                            int d, int Q, int C, int metric, float* __restrict__ out) {
  constexpr int NW = kWords<VEC>;
  constexpr int R = 32 / GROUP;        // rows a warp load brings
  constexpr int RB = LOADS * R;        // rows a batch brings
  constexpr int LG = GROUP == 32 ? 5 : 3;
  static_assert(GROUP == 32 || GROUP == 8, "lane groups of 8 or 32");
  const int lane = threadIdx.x & 31;
  const int chunks = (C + 31) / 32;
  const long long item = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (item >= (long long)Q * chunks) return;   // whole warps
  const int q = (int)(item / chunks);
  const int slot = (int)(item % chunks) * 32 + lane;
  const bool in = slot < C;
  const int id = in ? ids[(size_t)q * C + slot] : -1;
  const unsigned mask = __ballot_sync(FULL, id >= 0);
  float result = CUDART_INF_F;
  if (mask == 0u) {   // all padding
    if (in) out[(size_t)q * C + slot] = result;
    return;
  }
  const float nrm = id >= 0 ? norms[id] : 0.f;
  const float psc = id >= 0 ? scales[id] : 0.f;
  const float qa = q_norms[q];
  const float* qrow = queries + (size_t)q * d;
  const int gl = lane & (GROUP - 1);
  const int half = lane >> LG;         // which row of a warp load (0 when GROUP = 32)
  const int nchunk = d / VEC;

  // the query's scale from the values this lane's group multiplies; the
  // first chunk stays in registers for its quantization
  float qv0[VEC];
  float m = 0.f;
#pragma unroll
  for (int e = 0; e < VEC; ++e) qv0[e] = 0.f;
  if (gl < nchunk) load_query<VEC>(qrow, gl, qv0);
#pragma unroll
  for (int e = 0; e < VEC; ++e) m = fmaxf(m, fabsf(qv0[e]));
  for (int c = gl + GROUP; c < nchunk; c += GROUP) {
    float v[VEC];
    load_query<VEC>(qrow, c, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) m = fmaxf(m, fabsf(v[e]));
  }
#pragma unroll
  for (int off = GROUP / 2; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
  const float sq = __fmul_rn(fmaxf(m, 1e-12f), kInv127);
  int qw0[NW];
  quantize_chunk<VEC>(qv0, sq, qw0);

  const int nvalid = __popc(mask);
  const int rank = __popc(mask & ((1u << lane) - 1u));
  unsigned rem = mask;
  for (int b = 0; b < nvalid; b += RB) {
    // batch row j = i * R + half is this lane's load i
    int rid[LOADS];
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      const int src = __ffs(rem) - 1;  // -1 past the last valid slot
      rem &= rem - 1u;
      const int v = __shfl_sync(FULL, id, src & 31);
      if (j % R == half) rid[j / R] = src >= 0 ? v : -1;
    }
    int part[LOADS];
#pragma unroll
    for (int i = 0; i < LOADS; ++i) part[i] = 0;
    for (int c = gl; c < nchunk; c += GROUP) {
      int qw[NW];
      if (c == gl) {
#pragma unroll
        for (int w = 0; w < NW; ++w) qw[w] = qw0[w];
      } else {
        float v[VEC];
        load_query<VEC>(qrow, c, v);
        quantize_chunk<VEC>(v, sq, qw);
      }
      int pv[LOADS][NW];
#pragma unroll
      for (int i = 0; i < LOADS; ++i) {
        if (rid[i] >= 0) {
          load_row<VEC>(pts + (size_t)rid[i] * d, c, pv[i]);
        } else {
#pragma unroll
          for (int w = 0; w < NW; ++w) pv[i][w] = 0;
        }
      }
#pragma unroll
      for (int i = 0; i < LOADS; ++i) part[i] = dot<VEC>(qw, pv[i], part[i]);
    }
    // reduce-scatter over the group's top LL lane bits, halving the values
    // at each step; afterwards a lane holds load (gl >> (LG - LL)), then the
    // group's remaining bits are summed
#pragma unroll
    for (int n = LOADS / 2, off = GROUP / 2; n >= 1; n /= 2, off /= 2) {
      const bool up = lane & off;
#pragma unroll
      for (int i = 0; i < n; ++i) {
        const int keep = up ? part[i + n] : part[i];
        const int send = up ? part[i] : part[i + n];
        part[i] = keep + __shfl_xor_sync(FULL, send, off);
      }
    }
#pragma unroll
    for (int off = GROUP >> (LL + 1); off > 0; off >>= 1)
      part[0] += __shfl_xor_sync(FULL, part[0], off);
    // the slot's owner fetches its row's dot product
    const int j = rank - b;
    const bool mine = id >= 0 && j >= 0 && j < RB;
    const int jj = mine ? j : 0;
    const int ip = __shfl_sync(FULL, part[0], (jj % R) * GROUP + ((jj / R) << (LG - LL)));
    if (mine) {
      const float ipf = __fmul_rn(__int2float_rn(ip), __fmul_rn(sq, psc));
      if (metric == pipnn::kMips) {
        result = -ipf;
      } else if (metric == pipnn::kCosine) {
        result = __fsub_rn(1.f, __fdiv_rn(ipf, fmaxf(__fmul_rn(qa, nrm), 1e-30f)));
      } else {
        result = pipnn::clamp_zero(__fsub_rn(__fadd_rn(qa, nrm), __fmul_rn(2.f, ipf)));
      }
    }
  }
  if (in) out[(size_t)q * C + slot] = result;
}

template <int VEC, int GROUP>
cudaError_t launch_as(const void* pts, const void* scales, const void* norms,
                      const void* queries, const void* q_norms, const void* ids, int d, int Q,
                      int C, int metric, void* out, cudaStream_t stream) {
  const long long items = (long long)Q * ((C + 31) / 32);
  const long long blocks = (items + WARPS - 1) / WARPS;
  gather_distance_int8_kernel<VEC, GROUP><<<(unsigned)blocks, WARPS * 32, 0, stream>>>(
      static_cast<const int8_t*>(pts), static_cast<const float*>(scales),
      static_cast<const float*>(norms), static_cast<const float*>(queries),
      static_cast<const float*>(q_norms), static_cast<const int*>(ids), d, Q, C, metric,
      static_cast<float*>(out));
  return cudaGetLastError();
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
  if (Q <= 0 || C <= 0) return cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = d % 16 == 0 && reinterpret_cast<uintptr_t>(pts) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(queries) % 16 == 0;
  if (vec)
    return launch_as<16, 8>(pts, scales, norms, queries, q_norms, ids, d, Q, C, metric, out, s);
  return launch_as<1, 32>(pts, scales, norms, queries, q_norms, ids, d, Q, C, metric, out, s);
}
