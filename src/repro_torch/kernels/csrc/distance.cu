// Batched pairwise distance matrices, float32 and int8.
//
// pipnn_pairwise_distance replaces the Pallas kernel repro/kernels/
// distance.py::pairwise_distance: [B, M, D] x [B, N, D] -> [B, M, N] f32
// with the norm expansion fused.  Bound: operations.  The products run on
// the tensor cores, mma.sync m16n8k8 TF32 with three TF32 products per f32
// product (the 3xTF32 split of mma_tf32.cuh), so the bound is 3 * 2*B*M*N*D
// FLOPs at the TF32 peak (or the output's bytes, where D is small), with
// the f32 CUDA-core bound beside it.  Exactness: on integer data below 2048
// whose sums all stay below 2^24 every product is exact, so l2 and mips
// equal the plain version bit for bit (cosine within a few ulps of its
// rounded square roots); on other data the result is within a few ulps of
// float32's.  Design:
// - Persistent blocks of 8 warps, one per SM, walk 128x128 output tiles in
//   order (column tiles fastest, so the blocks at work share their row
//   panels in L2).  The warps split a tile 2 x 4; each keeps 4 x 4 MMA
//   accumulators and issues the three products as three sweeps over them.
// - Both 128-row panels stream in 64-deep slices through a 2-stage cp.async
//   ring (16-byte copies where D % 4 == 0 and both inputs are 16-byte
//   aligned, else 4-byte copies; zero past the edges), K-major at a pitch
//   of 4 mod 32 floats, so ldmatrix reads the fragments without bank
//   conflicts.  The ring runs on from one tile into the next, so the next
//   tile's slices load while a tile's epilogue runs.  64-deep slices halve
//   the block barriers of 32-deep ones (a 2-stage ring of them fills 137 KB).
// - Each 32 deep of a slice sums into a fresh accumulator that is added to
//   the tile's total in f32.
// - The place of a tile and the epilogue's metric are worked out once a
//   tile, not once a stage or an element.
// - The row and column norms are f32 FMA sums on the CUDA cores from the
//   same staged slices, in k order (one thread a row).
// - The epilogue is that of core/leader_assign.py::leader_dists, one
//   correctly rounded operation at a time (no FMA contraction):
//     l2:     max((|a|^2 + |b|^2) - 2 ip, 0)
//     cosine: 1 - ip / max(|a| |b|, 1e-30)
//     mips:   -ip
//   Each lane stores two adjacent columns (8 bytes; a quad covers a whole
//   32-byte sector) where N is even.
//
// pipnn_pairwise_distance_int8 replaces ::pairwise_distance_int8: exact
// squared L2 on int8 inputs, |a|^2 + |b|^2 - 2 ip in wrapping int32
// arithmetic.  Bound: the int32 output's bytes (4 GB for 1M x 1,000); the
// products (256 G int8 operations there) are cheap on the tensor cores, so
// the kernel is a store engine.  Design:
// - Products: mma.sync m16n8k32 s8 x s8 -> s32 without .satfinite (int32
//   wraps exactly as the plain version's).  a's rows are the A operand and
//   b's rows the column-major B operand as they lie; ldmatrix reads the int8
//   rows as b16 into the fragment layout.
// - Persistent blocks of 16 warps, one per SM, walk 256x128 output tiles
//   in order (column tiles fastest); the warps split a tile 4 x 4, 64 x 32
//   each.  The panels' loads through L2 were what held 128x128 tiles back
//   (a copy without stores took 1.38 of 1.84 ms); 256-row tiles load 48 KB
//   for 128 KB of output instead of 32 KB for 64 KB, and were 11% faster
//   (kernel_ab, one H100 SXM at 700 W).  Both panels stream in
//   128-byte-deep slices through a 2-stage
//   cp.async ring (16-byte copies where D % 16 == 0 and both inputs are
//   16-byte aligned, else 4-byte copies where D % 4 == 0, else byte loads;
//   zero past D and past the row edges), K-major at a pitch of 16 mod 128
//   bytes, so ldmatrix reads them without bank conflicts.  The ring runs on
//   into the next tile, whose panels load while a tile's stores drain.
// - Norms: a thread for each panel row sums it from each staged slice with
//   __dp4a (256 a rows and 128 b rows over the 512 threads).
// - Epilogue: each warp passes its accumulators through a small staging
//   buffer a 16-row slab at a time, so that 8 lanes write a row's 32
//   columns (128 bytes) as 16-byte streaming stores (st.global.cs: the
//   output does not push the panels out of L2); scalar stores where N % 4 != 0.
#include "common.cuh"
#include "mma_tf32.cuh"

namespace {

using namespace pipnn::mma_tf32;

// ---- float32: 3xTF32 on the tensor cores ----
constexpr int FM = 128;           // rows of an output tile (of a)
constexpr int FN = 128;           // columns of an output tile (rows of b)
constexpr int WARPS_M = 2;        // warps along the rows
constexpr int WARPS_N = 4;        // and along the columns
constexpr int MIN_BLOCKS = 1;     // blocks an SM (the register budget)
constexpr int KP = 32;            // depth summed into one fresh accumulator
constexpr int KS = 64;            // depth of one ring stage, a multiple of KP
constexpr int NST = 2;            // ring stages
constexpr int SB = KS + 4;        // slice pitch in floats (4 mod 32)
constexpr int F_THREADS = 32 * WARPS_M * WARPS_N;
constexpr int MT = FM / WARPS_M / 16;   // 16-row MMA tiles of a warp
constexpr int NT = FN / WARPS_N / 8;    // 8-column MMA tiles of a warp
constexpr size_t F_SMEM = 4 * ((size_t)NST * (FM + FN) * SB + FM + FN);
static_assert(F_THREADS >= FM + FN, "one thread for each row norm of the two panels");
static_assert(NT % 2 == 0, "ldmatrix loads 8-column tiles in pairs");
static_assert(KS % KP == 0 && KP % 8 == 0, "a stage holds whole fresh-accumulator depths");

struct F32Tile {
  int batch, row0, col0;
};

__device__ __forceinline__ F32Tile f32_tile(int t, int tiles_m, int tiles_n) {
  const int per_batch = tiles_m * tiles_n;
  const int rem = t % per_batch;
  return {t / per_batch, (rem / tiles_n) * FM, (rem % tiles_n) * FN};
}

// R rows of a [rows, D] matrix from row0, depth [k0, k0 + KS), into dst
// (pitch SB); zero past the last row and past D
template <int VEC, int R>
__device__ __forceinline__ void copy_slice(float* dst, const float* m, int rows, int row0, int D,
                                           int k0) {
  constexpr int PER_ROW = KS / VEC;
  for (int e = threadIdx.x; e < R * PER_ROW; e += F_THREADS) {
    const int r = e / PER_ROW;
    const int k = k0 + (e % PER_ROW) * VEC;
    const bool ok = row0 + r < rows && k < D;
    cp_async<VEC>(dst + r * SB + (k - k0), ok ? m + (size_t)(row0 + r) * D + k : m, ok);
  }
}

template <int METRIC>
__device__ __forceinline__ float f32_dist(float ip, float a2, float b2) {
  if constexpr (METRIC == pipnn::kMips)
    return -ip;
  else if constexpr (METRIC == pipnn::kCosine)
    return __fsub_rn(1.f, __fdiv_rn(ip, fmaxf(__fmul_rn(sqrtf(a2), sqrtf(b2)), 1e-30f)));
  else
    return pipnn::clamp_zero(__fsub_rn(__fadd_rn(a2, b2), __fmul_rn(2.f, ip)));
}

// the warp's share of a finished tile: two adjacent columns a lane, so
// each quad stores a whole 32-byte sector (8-byte stores where N is even)
template <int METRIC>
__device__ __forceinline__ void store_tile(const float (&acc)[MT][NT][4], const float* a_norm,
                                           const float* b_norm, float* out, F32Tile t, int M,
                                           int N, int wr, int wc) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const bool pairs = N % 2 == 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = wr + mt * 16 + g + 8 * h;
      const int r = t.row0 + rl;
      if (r >= M) continue;
      const float a2 = a_norm[rl];
      float* orow = out + ((size_t)t.batch * M + r) * N;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int cl = wc + nt * 8 + 2 * t4;
        const int c = t.col0 + cl;
        const float2 b2 = *reinterpret_cast<const float2*>(b_norm + cl);
        const float d0 = f32_dist<METRIC>(acc[mt][nt][2 * h], a2, b2.x);
        const float d1 = f32_dist<METRIC>(acc[mt][nt][2 * h + 1], a2, b2.y);
        if (pairs) {
          if (c < N) *reinterpret_cast<float2*>(orow + c) = make_float2(d0, d1);
        } else {
          if (c < N) orow[c] = d0;
          if (c + 1 < N) orow[c + 1] = d1;
        }
      }
    }
}

template <int VEC>
__global__ void __launch_bounds__(F_THREADS, MIN_BLOCKS)
pairwise_distance_kernel(const float* __restrict__ a, const float* __restrict__ b, int M, int N,
                         int D, int metric, int tiles_m, int tiles_n, int n_tiles,
                         float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                          // [NST][FM + FN][SB]: a's, then b's slice
  float* a_norm = ring + NST * (FM + FN) * SB; // [FM]
  float* b_norm = a_norm + FM;                 // [FN]
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wr = (warp / WARPS_N) * (FM / WARPS_M);   // the warp's rows of the tile
  const int wc = (warp % WARPS_N) * (FN / WARPS_N);   // and its columns
  const int S = D > 0 ? (D + KS - 1) / KS : 1; // stages a tile (D = 0: one of zeros)
  const int tiles = (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;   // this block's
  const long long units = (long long)tiles * S;

  // ring units are issued in order: stage si of tile ti (at it) into slot
  // slot_i; the tile's place is worked out once a tile
  int ti = blockIdx.x, si = 0, slot_i = 0;
  F32Tile it = f32_tile(ti, tiles_m, tiles_n);
  auto issue = [&]() {
    float* dst = ring + slot_i * (FM + FN) * SB;
    copy_slice<VEC, FM>(dst, a + (size_t)it.batch * M * D, M, it.row0, D, si * KS);
    copy_slice<VEC, FN>(dst + FM * SB, b + (size_t)it.batch * N * D, N, it.col0, D, si * KS);
    slot_i = slot_i == NST - 1 ? 0 : slot_i + 1;
    if (++si == S) {
      si = 0;
      ti += gridDim.x;
      if (ti < n_tiles) it = f32_tile(ti, tiles_m, tiles_n);
    }
  };
#pragma unroll
  for (int p = 0; p < NST - 1; ++p) {
    if (p < units) issue();
    cp_commit();
  }

  float acc[MT][NT][4];
  float nrm = 0.f;   // threads < FM: row tid of a's panel; < FM + FN: row tid - FM of b's
  int tc = blockIdx.x, s = 0, slot = 0;
  for (long long u = 0; u < units; ++u) {
    cp_wait<NST - 2>();
    __syncthreads();   // unit u landed; unit u-1's slot is free
    if (u + NST - 1 < units) issue();
    cp_commit();
    const float* As = ring + slot * (FM + FN) * SB;
    const float* Bs = As + FM * SB;

    // this slice's share of the norms: an FMA chain in k order
    if (s == 0) nrm = 0.f;
    if (tid < FM + FN) {
      const float4* nv = reinterpret_cast<const float4*>(As + tid * SB);   // Bs = As + FM * SB
#pragma unroll
      for (int j = 0; j < KS / 4; ++j) {
        const float4 x = nv[j];
        nrm = fmaf(x.x, x.x, nrm);
        nrm = fmaf(x.y, x.y, nrm);
        nrm = fmaf(x.z, x.z, nrm);
        nrm = fmaf(x.w, x.w, nrm);
      }
    }

#pragma unroll
    for (int kp = 0; kp < KS; kp += KP) {
      float part[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
#pragma unroll
      for (int k8 = kp; k8 < kp + KP; k8 += 8) {
        // A: matrices (rows 0-7 | 8-15) x (k 0-3 | 4-7); B: per pair of
        // 8-column tiles, (columns) x (k 0-3 | 4-7)
        const int m = lane >> 3, rr = lane & 7;
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t raw[4];
          ldmatrix_x4(raw, As + (wr + mt * 16 + rr + (m & 1) * 8) * SB + k8 + (m >> 1) * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) split(__uint_as_float(raw[i]), ah[mt][i], al[mt][i]);
        }
        uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t raw[4];
          ldmatrix_x4(raw, Bs + (wc + (2 * np + (m >> 1)) * 8 + rr) * SB + k8 + (m & 1) * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            split(__uint_as_float(raw[i]), bh[2 * np + (i >> 1)][i & 1],
                  bl[2 * np + (i >> 1)][i & 1]);
        }
        // three sweeps over the independent accumulators, so that no MMA
        // waits on the one before it
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma(part[mt][nt], al[mt], bh[nt][0], bh[nt][1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma(part[mt][nt], ah[mt], bl[nt][0], bl[nt][1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma(part[mt][nt], ah[mt], bh[nt][0], bh[nt][1]);
      }
      if (s == 0 && kp == 0) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] = part[mt][nt][e];
      } else {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
      }
    }

    if (s == S - 1) {
      // the tile is complete: norms to shared memory, then the epilogue
      if (tid < FM) a_norm[tid] = nrm;
      else if (tid < FM + FN) b_norm[tid - FM] = nrm;
      __syncthreads();
      const F32Tile t = f32_tile(tc, tiles_m, tiles_n);
      if (metric == pipnn::kMips)
        store_tile<pipnn::kMips>(acc, a_norm, b_norm, out, t, M, N, wr, wc);
      else if (metric == pipnn::kCosine)
        store_tile<pipnn::kCosine>(acc, a_norm, b_norm, out, t, M, N, wr, wc);
      else
        store_tile<pipnn::kL2>(acc, a_norm, b_norm, out, t, M, N, wr, wc);
      tc += gridDim.x;
    }
    slot = slot == NST - 1 ? 0 : slot + 1;
    s = s == S - 1 ? 0 : s + 1;
  }
}

// ---- int8: mma.sync m16n8k32 s8 on the tensor cores ----
namespace i8 {
constexpr int TM = 256;           // rows of an output tile (of a)
constexpr int TN = 128;           // columns of an output tile (rows of b)
constexpr int WARPS_M = 4;        // warps along the rows
constexpr int WARPS_N = 4;        // and along the columns
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int MIN_BLOCKS = 1;     // blocks an SM (the register budget)
constexpr int KS = 128;           // bytes of depth a ring stage
constexpr int NST = 2;            // ring stages
constexpr int SB = KS + 16;       // slice pitch in bytes (16 mod 128)
constexpr int MT = TM / WARPS_M / 16;   // 16-row MMA tiles of a warp
constexpr int NT = TN / WARPS_N / 8;    // 8-column MMA tiles of a warp
constexpr int WM = TM / WARPS_M;        // a warp's rows and columns
constexpr int WN = TN / WARPS_N;
constexpr int SP = WN + 8;        // staging pitch in words (8 mod 32)
constexpr size_t SMEM = (size_t)NST * (TM + TN) * SB + 4 * (TM + TN) +
                        4 * (size_t)(THREADS / 32) * 16 * SP;
static_assert(THREADS >= TM + TN, "a thread for each row norm of the two panels");
static_assert(NT % 2 == 0 && WN == 32, "ldmatrix pairs of 8-column tiles; 8 lanes a row");
static_assert(KS % 32 == 0, "a stage holds whole MMA depths");

// KS bytes from depth k0 of R rows of a [rows, D] int8 matrix from row0,
// into dst (pitch SB); zero past the last row and past D.  VEC: 16 or 4
// (cp.async of that many bytes; D a multiple of it, rows aligned to it), or
// 1 (byte loads, assembled into 4-byte words and stored synchronously)
template <int VEC, int R>
__device__ __forceinline__ void copy_slice(int8_t* dst, const int8_t* m, int rows, int row0,
                                           int D, int k0) {
  constexpr int U = VEC == 16 ? 16 : 4;   // bytes a copy
  constexpr int PER_ROW = KS / U;
  for (int e = threadIdx.x; e < R * PER_ROW; e += THREADS) {
    const int r = e / PER_ROW;
    const int k = k0 + (e % PER_ROW) * U;
    int8_t* d = dst + r * SB + (k - k0);
    const bool row_ok = row0 + r < rows;
    const int8_t* src = m + (size_t)(row0 + r) * D + k;
    if constexpr (VEC == 1) {
      uint32_t w = 0;
      if (row_ok) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k + j < D) w |= (uint32_t)(uint8_t)src[j] << (8 * j);
      }
      *reinterpret_cast<uint32_t*>(d) = w;
    } else {
      const bool ok = row_ok && k < D;
      // cp_async counts floats: U / 4 of them are U bytes
      pipnn::mma_tf32::cp_async<U / 4>(reinterpret_cast<float*>(d),
                                       reinterpret_cast<const float*>(ok ? src : m), ok);
    }
  }
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// |a|^2 + |b|^2 - 2 ip in wrapping int32 arithmetic, as the plain version's
__device__ __forceinline__ int l2_s32(int a2, int b2, int ip) {
  return (int)((uint32_t)a2 + (uint32_t)b2 - 2u * (uint32_t)ip);
}

struct Tile {
  int batch, row0, col0;
};

__device__ __forceinline__ Tile tile_of(int t, int tiles_m, int tiles_n) {
  const int per_batch = tiles_m * tiles_n;
  const int rem = t % per_batch;
  return {t / per_batch, (rem / tiles_n) * i8::TM, (rem % tiles_n) * i8::TN};
}

// a [B, M, D] and b [B, N, D] int8 -> out [B, M, N] int32.  vec_out: N % 4
// == 0 and out 16-byte aligned (16-byte stores)
template <int VEC>
__global__ void __launch_bounds__(i8::THREADS, i8::MIN_BLOCKS)
pairwise_distance_int8_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b, int M,
                              int N, int D, int tiles_m, int tiles_n, int n_tiles, bool vec_out,
                              int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_i8[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem_i8);                 // [NST][TM + TN][SB]
  int* a_norm = reinterpret_cast<int*>(smem_i8 + NST * (TM + TN) * SB);   // [TM]
  int* b_norm = a_norm + TM;                                           // [TN]
  int* stage = b_norm + TN;                                            // [warps][16][SP]
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = (warp / WARPS_N) * WM;      // the warp's rows of the tile
  const int wc = (warp % WARPS_N) * WN;      // and its columns
  int* stg = stage + warp * 16 * SP;
  const int S = D > 0 ? (D + KS - 1) / KS : 1;   // stages a tile (D = 0: one of zeros)
  const int tiles = (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;   // this block's
  const long long units = (long long)tiles * S;

  // ring units are issued in order: stage si of tile ti (at it) into slot slot_i
  int ti = blockIdx.x, si = 0, slot_i = 0;
  Tile it = tile_of(ti, tiles_m, tiles_n);
  auto issue = [&]() {
    int8_t* dst = ring + slot_i * (TM + TN) * SB;
    copy_slice<VEC, TM>(dst, a + (size_t)it.batch * M * D, M, it.row0, D, si * KS);
    copy_slice<VEC, TN>(dst + TM * SB, b + (size_t)it.batch * N * D, N, it.col0, D, si * KS);
    slot_i = slot_i == NST - 1 ? 0 : slot_i + 1;
    if (++si == S) {
      si = 0;
      ti += gridDim.x;
      if (ti < n_tiles) it = tile_of(ti, tiles_m, tiles_n);
    }
  };
#pragma unroll
  for (int p = 0; p < NST - 1; ++p) {
    if (p < units) issue();
    pipnn::mma_tf32::cp_commit();
  }

  int acc[MT][NT][4];
  int nrm = 0;   // threads < TM: row tid of a's panel; < TM + TN: row tid - TM of b's
  int tc = blockIdx.x, s = 0, slot = 0;
  for (long long u = 0; u < units; ++u) {
    pipnn::mma_tf32::cp_wait<NST - 2>();
    __syncthreads();   // unit u landed; unit u-1's slot is free
    if (u + NST - 1 < units) issue();
    pipnn::mma_tf32::cp_commit();
    const int8_t* As = ring + slot * (TM + TN) * SB;
    const int8_t* Bs = As + TM * SB;

    // this slice's share of the norms: thread tid sums its panel row
    if (s == 0) nrm = 0;
    if (tid < TM + TN) {
      const int4* nv = reinterpret_cast<const int4*>(As + tid * SB);   // Bs = As + TM * SB
#pragma unroll
      for (int j = 0; j < KS / 16; ++j) {
        const int4 x = nv[j];
        nrm = __dp4a(x.x, x.x, nrm);
        nrm = __dp4a(x.y, x.y, nrm);
        nrm = __dp4a(x.z, x.z, nrm);
        nrm = __dp4a(x.w, x.w, nrm);
      }
    }
    if (s == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
    }
#pragma unroll
    for (int k32 = 0; k32 < KS; k32 += 32) {
      // A: matrices (rows 0-7 | 8-15) x (bytes 0-15 | 16-31); B: per pair of
      // 8-column tiles, (columns) x (bytes 0-15 | 16-31).  ldmatrix reads
      // the int8 rows as b16: lane (g, t) gets bytes 4t..4t+3 of row g of
      // each matrix, the s8 MMA's fragment layout.
      const int m = lane >> 3, rr = lane & 7;
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        pipnn::mma_tf32::ldmatrix_x4(af[mt], reinterpret_cast<const float*>(
            As + (wr + mt * 16 + rr + (m & 1) * 8) * SB + k32 + (m >> 1) * 16));
      uint32_t bf[NT][2];
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t raw[4];
        pipnn::mma_tf32::ldmatrix_x4(raw, reinterpret_cast<const float*>(
            Bs + (wc + (2 * np + (m >> 1)) * 8 + rr) * SB + k32 + (m & 1) * 16));
#pragma unroll
        for (int i = 0; i < 4; ++i) bf[2 * np + (i >> 1)][i & 1] = raw[i];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }

    if (s == S - 1) {
      // the tile is complete: norms to shared memory, then the epilogue
      if (tid < TM) a_norm[tid] = nrm;
      else if (tid < TM + TN) b_norm[tid - TM] = nrm;
      __syncthreads();
      const Tile t = tile_of(tc, tiles_m, tiles_n);
      // each warp passes its 16-row slabs through its staging buffer, so
      // that 8 lanes store a row's 32 columns as 16-byte streaming stores
      const int rs = lane >> 3, cs = (lane & 7) * 4;
      const int c = t.col0 + wc + cs;
      const int4 b2 = *reinterpret_cast<const int4*>(b_norm + wc + cs);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        __syncwarp();   // the slab before is read
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<int2*>(stg + (g + 8 * h) * SP + nt * 8 + 2 * t4) =
                make_int2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        __syncwarp();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int rl = j * 4 + rs;
          const int r = t.row0 + wr + mt * 16 + rl;
          if (r >= M) continue;
          const int4 ip = *reinterpret_cast<const int4*>(stg + rl * SP + cs);
          const int a2 = a_norm[wr + mt * 16 + rl];
          const int4 d = make_int4(l2_s32(a2, b2.x, ip.x), l2_s32(a2, b2.y, ip.y),
                                   l2_s32(a2, b2.z, ip.z), l2_s32(a2, b2.w, ip.w));
          int* o = out + ((size_t)t.batch * M + r) * N + c;
          if (vec_out && c + 3 < N) {
            __stcs(reinterpret_cast<int4*>(o), d);
          } else {
            if (c < N) __stcs(o, d.x);
            if (c + 1 < N) __stcs(o + 1, d.y);
            if (c + 2 < N) __stcs(o + 2, d.z);
            if (c + 3 < N) __stcs(o + 3, d.w);
          }
        }
      }
      tc += gridDim.x;
    }
    slot = slot == NST - 1 ? 0 : slot + 1;
    s = s == S - 1 ? 0 : s + 1;
  }
}

}  // namespace i8

template <int VEC>
cudaError_t launch_f32(const float* a, const float* b, int B, int M, int N, int D, int metric,
                       float* out, cudaStream_t stream) {
  auto kernel = pairwise_distance_kernel<VEC>;
  // once per device: allow the ring's shared memory and size the
  // persistent grid (the blocks that fit on every SM at once)
  static int grid[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (grid[dev] == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F_SMEM);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, F_THREADS, F_SMEM);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    grid[dev] = sms * per_sm;
  }
  const int tiles_m = (M + FM - 1) / FM, tiles_n = (N + FN - 1) / FN;
  const long long n_tiles = (long long)B * tiles_m * tiles_n;
  if (n_tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const long long blocks = n_tiles < grid[dev] ? n_tiles : grid[dev];
  if (blocks > 0)
    kernel<<<(unsigned)blocks, F_THREADS, F_SMEM, stream>>>(a, b, M, N, D, metric, tiles_m,
                                                            tiles_n, (int)n_tiles, out);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t launch_int8(const void* a, const void* b, int B, int M, int N, int D, void* out,
                        void* stream) {
  auto kernel = i8::pairwise_distance_int8_kernel<VEC>;
  // once per device: allow the ring's shared memory and size the
  // persistent grid (the blocks that fit on every SM at once)
  static int grid[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (grid[dev] == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)i8::SMEM);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, i8::THREADS, i8::SMEM);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    grid[dev] = sms * per_sm;
  }
  const int tiles_m = (M + i8::TM - 1) / i8::TM, tiles_n = (N + i8::TN - 1) / i8::TN;
  const long long n_tiles = (long long)B * tiles_m * tiles_n;
  if (n_tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const long long blocks = n_tiles < grid[dev] ? n_tiles : grid[dev];
  const bool vec_out = N % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (blocks > 0)
    kernel<<<(unsigned)blocks, i8::THREADS, i8::SMEM, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), M, N, D, tiles_m, tiles_n,
        (int)n_tiles, vec_out, static_cast<int*>(out));
  return cudaGetLastError();
}

}  // namespace

// The dynamic shared memory a launch of each kernel requests (the ring,
// the same at every shape).  For the contract checker
// (repro_torch.analysis.contracts); launches nothing.
PIPNN_EXPORT int pipnn_pairwise_distance_plan(long long* smem) {
  *smem = (long long)F_SMEM;
  return cudaSuccess;
}

PIPNN_EXPORT int pipnn_pairwise_distance_int8_plan(long long* smem) {
  *smem = (long long)i8::SMEM;
  return cudaSuccess;
}

// a [B, M, D] f32, b [B, N, D] f32 -> out [B, M, N] f32
PIPNN_EXPORT int pipnn_pairwise_distance(const void* a, const void* b, int B, int M, int N, int D,
                                         int metric, void* out, void* stream) {
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(b);
  float* po = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte copies need every row of both inputs to start on a 16-byte boundary
  if (D % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(b) % 16 == 0)
    return launch_f32<4>(pa, pb, B, M, N, D, metric, po, s);
  return launch_f32<1>(pa, pb, B, M, N, D, metric, po, s);
}

// a [B, M, D] int8, b [B, N, D] int8 -> out [B, M, N] int32
PIPNN_EXPORT int pipnn_pairwise_distance_int8(const void* a, const void* b, int B, int M, int N,
                                              int D, void* out, void* stream) {
  const uintptr_t pa = reinterpret_cast<uintptr_t>(a), pb = reinterpret_cast<uintptr_t>(b);
  // 16- and 4-byte copies need every row of both inputs to start on such a boundary
  if (D % 16 == 0 && pa % 16 == 0 && pb % 16 == 0)
    return launch_int8<16>(a, b, B, M, N, D, out, stream);
  if (D % 4 == 0 && pa % 4 == 0 && pb % 4 == 0)
    return launch_int8<4>(a, b, B, M, N, D, out, stream);
  return launch_int8<1>(a, b, B, M, N, D, out, stream);
}
