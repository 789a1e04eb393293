// FlashKNN for Hopper: per leaf, all-pairs distances with a running top-k.
//
// Replaces the Pallas kernel repro/kernels/leaf_knn.py::leaf_topk
// (pallas_call at :114).
//
// What bounds it: operations.  A leaf of C valid points needs C*(C-1)*d
// FLOPs of products (one d-long product per unordered pair: the distances
// are symmetric); its rows are a few hundred KB and come from L2 after the
// first touch.  The products run on the tensor cores (mma.sync m16n8k8
// TF32, three per f32 product: mma_tf32.cuh), so the bound is three TF32
// products at the TF32 peak, not the f32 CUDA-core peak.  The kernel forms
// every ordered pair, twice that work, which keeps each row's top-k within
// its own block.
//
// Why the result is still the float32 one: the 3xTF32 split, each 32-deep
// stage summed into a fresh accumulator.  On integer data below 2048
// (SIFT's [0, 255]) every partial sum is an integer below 2^24, so the
// distances are exact in any order and equal the plain version's bit for
// bit.  Norms are f32 sums on the CUDA cores.
//
// Design:
// - A block of 4 warps takes one leaf and every GROUPS-th 64-row tile of
//   it (GROUPS blocks per leaf, so a large leaf is spread over several
//   SMs).  It loads the leaf's ids once, finds the last valid position and
//   which 64-wide tiles hold a valid id, and skips everything else: row
//   tiles without a valid row only write (-1, +inf) (a block with no such
//   row tile stops before reading the rest of the leaf), column tiles
//   without a valid column are not loaded, and a warp whose 32 rows or 32
//   columns all lie past the last valid position issues no MMA.
// - The warps split the 64x64 tile 2 x 2; each keeps 2 x 4 MMA accumulators
//   and issues the three products as three sweeps over them with no branch
//   in between, so no MMA waits on the one before it.
// - The row tile (64 rows x d) stays in shared memory for the whole column
//   walk.  Column tiles stream through a 3-stage ring of 64 x 32 slices
//   with cp.async 16-byte copies of the gathered rows (Hopper's TMA has no
//   row gather), so the next slices load while the tensor cores work.
//   Both keep rows K-major with a pitch of 4 mod 32 floats, so every
//   fragment load is free of bank conflicts.  Ragged d is zero-filled up to
//   the stage depth; zeros add nothing.  70 KB of shared memory at d = 128
//   and three blocks an SM: occupancy, not shared-memory bandwidth, is what
//   keeps the tensor pipe fed here.
// - A row tile too deep for shared memory (d > 736 at C = 1024) is split
//   into the fewest equal depth chunks that fit; the walk then reloads each
//   chunk (from L2) as the column tile reaches its depth.  Up to that d the
//   row tile is one chunk, loaded once.
// - Norms: a row's squared norm is summed once, chunk by chunk on the first
//   column walk; column norms are summed on the block's first column walk
//   and kept in shared memory for its later row tiles.  Both sum the same
//   slices in the same order.
// - Top-k epilogue on the accumulator fragments: each thread forms the 8
//   distances of each of its 4 rows in a tile and tests their minimum
//   against the row's running k-th once; only then are they folded into the
//   running (dist, column) lists.  At the end the four lanes that share a
//   row merge their lists with shuffles, then the two warps that share it
//   through shared memory.  Every comparison is pipnn::lex_less, so ties go
//   to the lower column.
// - k = 1..8 instantiate K = k with those lists in registers.  k = 9..32 run
//   K = 16 or 32, whose lists would not fit in registers: each row's sorted
//   list of K (dist, column) lives in shared memory, owned by one thread of
//   the first two warps.  After each column tile the warps write their
//   distances into a column-major [64 x 64] buffer, and each owner folds its
//   row's 64 candidates into its list (one test against the K-th, a sorted
//   insert for the few that pass).  Only the first k slots are written: the
//   first k of the top-K under the (dist, column) order are the top-k.
#include "common.cuh"
#include "mma_tf32.cuh"

namespace {

using namespace pipnn::mma_tf32;

constexpr int BM = 64;            // rows of a row tile: 2 warps x 32
constexpr int BN = 64;            // columns of a column tile: 2 warps x 32
constexpr int KS = 32;            // depth of one ring stage
constexpr int NST = 3;            // ring stages
constexpr int SB = KS + 4;        // stage pitch in floats (4 mod 32)
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int GROUPS = 4;         // blocks per leaf
constexpr int MAX_SMEM = 232448 - 64;  // dynamic shared memory a block may use,
                                       // less the static words

// 64 gathered rows, depth [k0, k0 + len), into dst (pitch ld): row r is
// leaf position pos0 + r; padding, positions past C and depth past d are 0
template <int VEC>
__device__ __forceinline__ void copy_rows(float* dst, int ld, const float* pts,
                                          const int* ids_s, int pos0, int C, int d, int k0,
                                          int len) {
  const int per_row = len / VEC;
  for (int e = threadIdx.x; e < BM * per_row; e += THREADS) {
    const int r = e / per_row;
    const int k = k0 + (e - r * per_row) * VEC;
    const int p = pos0 + r;
    const int id = p < C ? ids_s[p] : -1;
    const bool ok = id >= 0 && k < d;
    cp_async<VEC>(dst + r * ld + (k - k0), ok ? pts + (size_t)id * d + k : pts, ok);
  }
}

// s + v[0]^2 + ... + v[15]^2 as an FMA chain, read as four 16-byte words
// (with lanes 2c and 2c+1 on the two halves of row c and a pitch of 4 mod
// 32 floats, a quarter-warp's words fall in distinct banks)
__device__ __forceinline__ float sum_squares16(const float* v, float s) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 x = reinterpret_cast<const float4*>(v)[j];
    s = fmaf(x.x, x.x, s);
    s = fmaf(x.y, x.y, s);
    s = fmaf(x.z, x.z, s);
    s = fmaf(x.w, x.w, s);
  }
  return s;
}

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

// the distances of one row's 8 candidates in a 64x64 tile (the thread's
// columns c0 + nt * 8 + cc), +inf where (r, c) is not a valid pair; returns
// their minimum.  l2 takes norms that are +inf for invalid rows and columns
// (which make the distance +inf), so only the diagonal needs a test.
template <int METRIC>
__device__ __forceinline__ float row_dists(float (&dv)[4][2], const float (&acc)[4][4], int h,
                                           float a2, const float (&b2)[4][2],
                                           const bool (&cok)[4][2], bool rok, int r, int c0) {
  float best = CUDART_INF_F;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int c = c0 + nt * 8 + cc;
      const float ip = acc[nt][2 * h + cc];
      float v;
      if constexpr (METRIC == pipnn::kL2) {
        v = pipnn::clamp_zero((a2 + b2[nt][cc]) - 2.f * ip);
        v = c == r ? CUDART_INF_F : v;
      } else {
        if constexpr (METRIC == pipnn::kMips)
          v = -ip;
        else
          v = 1.f - ip / fmaxf(sqrtf(a2) * sqrtf(b2[nt][cc]), 1e-30f);
        v = rok && cok[nt][cc] && c != r ? v : CUDART_INF_F;
      }
      dv[nt][cc] = v;
      best = fminf(best, v);
    }
  return best;
}

// (-1, +inf) for every row of the row tile at row0 (a tile without a valid
// row); ko slots a row
__device__ __forceinline__ void write_empty_rows(int* out_idx, float* out_dist, int leaf,
                                                 int row0, int C, int ko) {
  const int nr = min(BM, C - row0);
  for (int e = threadIdx.x; e < nr * ko; e += THREADS) {
    const size_t o = ((size_t)leaf * C + row0) * ko + e;
    out_idx[o] = -1;
    out_dist[o] = CUDART_INF_F;
  }
}

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

constexpr int MAX_REG_K = 8;      // K up to this keeps its lists in registers
constexpr int CBP = BM + 4;       // pitch of the wide path's column-major candidate buffer

// words of the wide path's lists ([BM][K + 1] dists and columns) and
// candidate buffer ([BN][CBP]); none for K <= MAX_REG_K
__host__ __device__ constexpr int wide_words(int K) {
  return K > MAX_REG_K ? 2 * BM * (K + 1) + BN * CBP : 0;
}

// shared memory: row tile of resident depth da, ring, row norms and their
// halves, column norms, ids, valid column tiles, per-tile flags, and the
// wide path's lists and candidates
inline size_t smem_bytes(int C, int da, int K) {
  const int tiles = (C + BM - 1) / BM;
  return 4 * ((size_t)BM * (da + 4) + (size_t)NST * BN * SB + BM + THREADS + 2 * (size_t)C +
              2 * (size_t)tiles + wide_words(K));
}

// the row tile's resident depth: all of d when it fits, else the depth cut
// into the fewest equal chunks (multiples of KS) that fit; 0 if none does
inline int resident_depth(int C, int d, int K) {
  const int dp = round_up(d, KS);
  for (int n = 1; n <= dp / KS; ++n) {
    const int da = round_up((dp + n - 1) / n, KS);
    if (smem_bytes(C, da, K) <= (size_t)MAX_SMEM) return da;
  }
  return 0;
}

// K: the list length; ko (<= K) slots a row are written, k = ko.  For
// K <= MAX_REG_K, ko == K.
template <int K, int VEC>
__global__ void __launch_bounds__(THREADS, 3)
leaf_topk_kernel(const float* __restrict__ pts, const int* __restrict__ leaf_ids, int C, int d,
                 int DA, int metric, int ko, int* __restrict__ out_idx,
                 float* __restrict__ out_dist) {
  constexpr bool WIDE = K > MAX_REG_K;
  constexpr int KR = WIDE ? 1 : K;            // register list length
  const int KO = WIDE ? ko : K;               // slots a row in the output
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_width, s_nvt;
  const int DP = round_up(d, KS);
  const int SA = DA + 4;                      // DA: resident depth of the row tile
  const int S = DP / KS;                      // ring stages per column tile
  const int SC = DA / KS;                     // of which one row-tile chunk spans
  const int tiles = (C + BM - 1) / BM;
  float* As = smem;                           // [BM][SA] row tile (one depth chunk)
  float* Bs = As + BM * SA;                   // [NST][BN][SB] ring of column slices
  float* a_norm = Bs + NST * BN * SB;         // [BM]
  float* a_half = a_norm + BM;                // [THREADS] half-row norm partials
  float* c_norm = a_half + THREADS;           // [C], filled on the first walk
  int* ids_s = reinterpret_cast<int*>(c_norm + C);   // [C]
  int* vt = ids_s + C;                        // [tiles] column tiles to walk
  int* tflag = vt + tiles;                    // [tiles] tile holds a valid id
  float* wd = reinterpret_cast<float*>(tflag + tiles);   // wide: [BM][K + 1] list dists
  int* wi = reinterpret_cast<int*>(wd + BM * (K + 1));   // wide: [BM][K + 1] list columns
  float* cb = reinterpret_cast<float*>(wi + BM * (K + 1));   // wide: [BN][CBP] candidates

  const int leaf = blockIdx.x / GROUPS;
  const int grp = blockIdx.x % GROUPS;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = (warp >> 1) * 32;            // the warp's 32 rows of the tile
  const int wc = (warp & 1) * 32;             // and its 32 columns
  const int* ids_g = leaf_ids + (size_t)leaf * C;

  // a block whose row tiles hold no valid id writes their (-1, +inf) rows
  // and stops before reading the rest of the leaf
  bool mine = false;
  for (int it = grp; it < tiles; it += GROUPS)
    for (int p = it * BM + tid; p < min(C, (it + 1) * BM); p += THREADS) mine |= ids_g[p] >= 0;
  if (!__syncthreads_or(mine)) {
    for (int it = grp; it < tiles; it += GROUPS)
      write_empty_rows(out_idx, out_dist, leaf, it * BM, C, KO);
    return;
  }
  if (tid == 0) s_width = 0;
  for (int t = tid; t < tiles; t += THREADS) tflag[t] = 0;
  __syncthreads();
  for (int base = warp * 32; base < C; base += THREADS) {
    const int p = base + lane;
    const int id = p < C ? ids_g[p] : -1;
    if (p < C) ids_s[p] = id;
    const unsigned m = __ballot_sync(0xffffffffu, id >= 0);
    if (lane == 0 && m) {
      atomicMax(&s_width, base + 32 - __clz(m));
      tflag[base / BM] = 1;
    }
  }
  __syncthreads();
  if (tid == 0) {
    int nv = 0;
    for (int t = 0; t < tiles; ++t)
      if (tflag[t]) vt[nv++] = t;
    s_nvt = nv;
  }
  __syncthreads();
  const int width = s_width;
  const int U = s_nvt * S;                    // ring units of one column walk
  bool first = true;                          // block-uniform

  for (int it = grp; it < tiles; it += GROUPS) {
    const int row0 = it * BM;
    if (!tflag[it]) {
      write_empty_rows(out_idx, out_dist, leaf, row0, C, KO);
      continue;
    }
    __syncthreads();   // the previous row tile's readers are done with As, the ring, a_norm
    // ring units are issued in order; unit (column tile ict, stage is) is
    // next.  Counters, not divisions by the runtime S, track every position.
    int ict = 0, is = 0, slot = 0;
    auto issue = [&]() {
      copy_rows<VEC>(Bs + slot * BN * SB, SB, pts, ids_s, vt[ict] * BN, C, d, is * KS, KS);
      slot = slot == NST - 1 ? 0 : slot + 1;
      if (++is == S) {
        is = 0;
        ++ict;
      }
    };
    copy_rows<VEC>(As, SA, pts, ids_s, row0, C, d, 0, DA);   // joins unit 0's group
#pragma unroll
    for (int p = 0; p < NST - 1; ++p) {
      if (p < U) issue();
      cp_commit();
    }

    // m-tiles (16 rows) of the warp that hold a row below the width
    const int mact = min(2, max(0, (width - row0 - wr + 15) / 16));
    bool rv[2][2] = {{false, false}, {false, false}};
    float a2[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    float bd[4][KR];                          // lists of rows (mt, h) at 2 * mt + h
    int bi[4][KR];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int j = 0; j < KR; ++j) {
        bd[q][j] = CUDART_INF_F;
        bi[q][j] = 0x7fffffff;
      }
    if constexpr (WIDE) {
      if (tid < BM) {                         // the owner of row tid's list
        for (int j = 0; j < K; ++j) {
          wd[tid * (K + 1) + j] = CUDART_INF_F;
          wi[tid * (K + 1) + j] = 0x7fffffff;
        }
      }
    }
    float acc[2][4][4];
    float cn = 0.f;                           // column-norm partial (first walk)

    // unit u is stage s of column tile ct, in ring slot us, and stage sc of
    // the row tile's depth chunk
    int s = -1, ct = 0, sc = 0, us = NST - 1;
    for (int u = 0; u < U; ++u) {
      if (++s == S) {
        s = 0;
        ++ct;
      }
      sc = s == 0 || sc == SC - 1 ? 0 : sc + 1;
      us = us == NST - 1 ? 0 : us + 1;
      cp_wait<NST - 2>();
      __syncthreads();                        // unit u landed; unit u-1's slot is free
      if (u + NST - 1 < U) issue();
      cp_commit();
      if (sc == 0) {
        const int len = min(DA, DP - s * KS);
        if (DA < DP && u > 0) {
          // a deep row tile: load the chunk this column tile has reached
          copy_rows<VEC>(As, SA, pts, ids_s, row0, C, d, s * KS, len);
          cp_commit();
          cp_wait<0>();
          __syncthreads();
        }
        if (u < S) {
          // the chunk's share of the row norms, once: each thread takes half
          // of a row, slice by slice in the order of the column norms, and
          // keeps its partial in shared memory (no register across the walk)
          const float* ar = As + (tid >> 1) * SA + (tid & 1) * 16;
          float an = s == 0 ? 0.f : a_half[tid];
          for (int k0 = 0; k0 < len; k0 += KS) an = sum_squares16(ar + k0, an);
          a_half[tid] = an;
        }
      }
      const int col0 = vt[ct] * BN;
      const float* B = Bs + us * BN * SB;
      if (first) {
        cn = sum_squares16(B + (tid >> 1) * SB + (tid & 1) * 16, cn);
      }
      if (s == 0) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
      }
      // 8-column tiles of the warp that hold a column below the width; a
      // warp with no row or no column below it skips the tile
      const int nact = min(4, max(0, (width - col0 - wc + 7) / 8));
      if (mact > 0 && nact > 0) {
        float part[2][4][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS / 8; ++ks) {
          const int k0 = sc * KS + ks * 8;    // depth within the row-tile chunk
          // A fragments: matrices (rows 0-7 | 8-15) x (k 0-3 | 4-7); B: per
          // pair of 8-column tiles, (columns) x (k 0-3 | 4-7)
          const int m = lane >> 3, rr = lane & 7;
          uint32_t ah[2][4], al[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            uint32_t raw[4];
            ldmatrix_x4(raw, As + (wr + mt * 16 + rr + (m & 1) * 8) * SA + k0 + (m >> 1) * 4);
#pragma unroll
            for (int i = 0; i < 4; ++i) split(__uint_as_float(raw[i]), ah[mt][i], al[mt][i]);
          }
          uint32_t bh[4][2], bl[4][2];
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t raw[4];
            ldmatrix_x4(raw, B + (wc + (2 * np + (m >> 1)) * 8 + rr) * SB + ks * 8 + (m & 1) * 4);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              split(__uint_as_float(raw[i]), bh[2 * np + (i >> 1)][i & 1], bl[2 * np + (i >> 1)][i & 1]);
          }
          // three sweeps over the 8 independent accumulators, so that no MMA
          // waits on the one before it; no branch inside, so the compiler
          // can interleave them
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) mma(part[mt][nt], al[mt], bh[nt][0], bh[nt][1]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) mma(part[mt][nt], ah[mt], bl[nt][0], bl[nt][1]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) mma(part[mt][nt], ah[mt], bh[nt][0], bh[nt][1]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
      }
      if (s != S - 1) continue;

      // the column tile is complete
      if (first || u == S - 1) {
        if (first) {
          const float tot = cn + __shfl_xor_sync(0xffffffffu, cn, 1);
          const int c = col0 + (tid >> 1);
          if ((tid & 1) == 0 && c < C) c_norm[c] = tot;
          cn = 0.f;
        }
        if (u == S - 1) {
          __syncwarp();                       // the partner lane's half is written
          const float an = a_half[tid] + a_half[tid ^ 1];
          if ((tid & 1) == 0) a_norm[tid >> 1] = an;
        }
        __syncthreads();
        if (u == S - 1) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int rl = wr + mt * 16 + g + 8 * h;
              rv[mt][h] = row0 + rl < C && ids_s[row0 + rl] >= 0;
              a2[mt][h] = a_norm[rl];
            }
        }
      }
      const bool l2 = metric == pipnn::kL2;
      float b2v[4][2];
      bool cok[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int c = col0 + wc + nt * 8 + 2 * t4 + cc;
          cok[nt][cc] = nt < nact && c < width && ids_s[c] >= 0;
          b2v[nt][cc] = cok[nt][cc] ? c_norm[c] : (l2 ? CUDART_INF_F : 0.f);
        }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = 2 * mt + h;
          const int r = row0 + wr + mt * 16 + g + 8 * h;
          const bool rok = mt < mact && rv[mt][h];
          const int c0 = col0 + wc + 2 * t4;
          float dv[4][2];
          float best;
          if (l2)
            best = row_dists<pipnn::kL2>(dv, acc[mt], h, rok ? a2[mt][h] : CUDART_INF_F, b2v,
                                         cok, rok, r, c0);
          else if (metric == pipnn::kMips)
            best = row_dists<pipnn::kMips>(dv, acc[mt], h, a2[mt][h], b2v, cok, rok, r, c0);
          else
            best = row_dists<pipnn::kCosine>(dv, acc[mt], h, a2[mt][h], b2v, cok, rok, r, c0);
          if constexpr (WIDE) {
            // every candidate of the row to the buffer, +inf where none
            const int rl = wr + mt * 16 + g + 8 * h;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int cc = 0; cc < 2; ++cc)
                cb[(wc + nt * 8 + 2 * t4 + cc) * CBP + rl] = dv[nt][cc];
          } else if (best <= bd[q][KR - 1] && best < CUDART_INF_F) {
            // one test for the row's 8 candidates; most tiles stop here
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int cc = 0; cc < 2; ++cc) {
                const int c = col0 + wc + nt * 8 + 2 * t4 + cc;
                if (dv[nt][cc] < CUDART_INF_F &&
                    pipnn::lex_less(dv[nt][cc], c, bd[q][KR - 1], bi[q][KR - 1]))
                  topk_insert<KR>(bd[q], bi[q], dv[nt][cc], c);
              }
          }
        }
      if constexpr (WIDE) {
        // each owner folds its row's 64 candidates, in column order, into
        // its sorted list; the next writes to cb follow the next unit's
        // barrier
        __syncthreads();
        if (tid < BM) {
          float* ld = wd + tid * (K + 1);
          int* li = wi + tid * (K + 1);
          float td = ld[K - 1];
          int ti = li[K - 1];
          for (int c = 0; c < BN; ++c) {
            const float v = cb[c * CBP + tid];
            const int col = col0 + c;
            if (v < CUDART_INF_F && pipnn::lex_less(v, col, td, ti)) {
              int j = K - 1;
              for (; j > 0 && pipnn::lex_less(v, col, ld[j - 1], li[j - 1]); --j) {
                ld[j] = ld[j - 1];
                li[j] = li[j - 1];
              }
              ld[j] = v;
              li[j] = col;
              td = ld[K - 1];
              ti = li[K - 1];
            }
          }
        }
      }
    }
    first = false;

    if constexpr (WIDE) {
      // each owner writes the first ko slots of its row's list
      const int r = row0 + tid;
      if (tid < BM && r < C) {
        const bool rok = ids_s[r] >= 0;
        const size_t o = ((size_t)leaf * C + r) * KO;
        for (int j = 0; j < KO; ++j) {
          const float dj = wd[tid * (K + 1) + j];
          const bool ok = rok && dj < CUDART_INF_F;
          out_idx[o + j] = ok ? wi[tid * (K + 1) + j] : -1;
          out_dist[o + j] = ok ? dj : CUDART_INF_F;
        }
      }
    } else {
      // merge the lists of each row: the four lanes that differ in t4, then
      // the two warps that share the rows (through the free ring)
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float od[KR];
          int oi[KR];
#pragma unroll
          for (int j = 0; j < KR; ++j) {
            od[j] = __shfl_xor_sync(0xffffffffu, bd[q][j], off);
            oi[j] = __shfl_xor_sync(0xffffffffu, bi[q][j], off);
          }
#pragma unroll
          for (int j = 0; j < KR; ++j)
            if (od[j] < CUDART_INF_F) topk_insert<KR>(bd[q], bi[q], od[j], oi[j]);
        }
      }
      __syncthreads();                          // every warp is done with the ring
      float* md = Bs;                           // [BM][KR] lists of the column-half-1 warps
      int* mi = reinterpret_cast<int*>(Bs + BM * KR);
      if (wc != 0 && t4 == 0) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int rl = wr + (q >> 1) * 16 + g + 8 * (q & 1);
#pragma unroll
          for (int j = 0; j < KR; ++j) {
            md[rl * KR + j] = bd[q][j];
            mi[rl * KR + j] = bi[q][j];
          }
        }
      }
      __syncthreads();
      if (wc == 0 && t4 == 0) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int mt = q >> 1, h = q & 1;
          const int rl = wr + mt * 16 + g + 8 * h;
          const int r = row0 + rl;
          if (r >= C) continue;
#pragma unroll
          for (int j = 0; j < KR; ++j)
            if (md[rl * KR + j] < CUDART_INF_F)
              topk_insert<KR>(bd[q], bi[q], md[rl * KR + j], mi[rl * KR + j]);
          const size_t o = ((size_t)leaf * C + r) * KR;
#pragma unroll
          for (int j = 0; j < KR; ++j) {
            const bool ok = rv[mt][h] && bd[q][j] < CUDART_INF_F;
            out_idx[o + j] = ok ? bi[q][j] : -1;
            out_dist[o + j] = ok ? bd[q][j] : CUDART_INF_F;
          }
        }
      }
    }
  }
}

template <int K, int VEC>
cudaError_t launch_vec(const float* pts, const int* leaf_ids, int n_leaves, int C, int d, int da,
                       int metric, int ko, int* out_idx, float* out_dist, cudaStream_t stream) {
  auto kernel = leaf_topk_kernel<K, VEC>;
  // allow the most shared memory once per device, at the kernel's first
  // launch there
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !allowed[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    if (dev < 64) allowed[dev] = true;
  }
  kernel<<<(unsigned)((long long)n_leaves * GROUPS), THREADS, smem_bytes(C, da, K), stream>>>(
      pts, leaf_ids, C, d, da, metric, ko, out_idx, out_dist);
  return cudaGetLastError();
}

// the list length K that serves k: k itself up to MAX_REG_K, else the next
// wide length (16 or 32); 0 outside 1..32
__host__ __device__ constexpr int list_len(int k) {
  return k < 1 || k > 32 ? 0 : k <= MAX_REG_K ? k : k <= 16 ? 16 : 32;
}

// k slots a row from the top-K lists (k == K up to MAX_REG_K)
template <int K>
cudaError_t launch(const float* pts, const int* leaf_ids, int n_leaves, int C, int d, int metric,
                   int k, int* out_idx, float* out_dist, cudaStream_t stream) {
  if (n_leaves <= 0 || C <= 0) return cudaGetLastError();
  const int da = resident_depth(C, d, K);
  if (da == 0) return cudaErrorInvalidValue;   // C too large for the ids and norms
  // 16-byte copies need 16-byte aligned rows
  if (d % 4 == 0 && reinterpret_cast<uintptr_t>(pts) % 16 == 0)
    return launch_vec<K, 4>(pts, leaf_ids, n_leaves, C, d, da, metric, k, out_idx, out_dist,
                            stream);
  return launch_vec<K, 1>(pts, leaf_ids, n_leaves, C, d, da, metric, k, out_idx, out_dist,
                          stream);
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
    case 1: return launch<1>(p, ids, n_leaves, C, d, metric, k, oi, od, s);
    case 2: return launch<2>(p, ids, n_leaves, C, d, metric, k, oi, od, s);
    case 3: return launch<3>(p, ids, n_leaves, C, d, metric, k, oi, od, s);
    case 4: return launch<4>(p, ids, n_leaves, C, d, metric, k, oi, od, s);
    case 5: return launch<5>(p, ids, n_leaves, C, d, metric, k, oi, od, s);
    case 6: return launch<6>(p, ids, n_leaves, C, d, metric, k, oi, od, s);
    case 7: return launch<7>(p, ids, n_leaves, C, d, metric, k, oi, od, s);
    case 8: return launch<8>(p, ids, n_leaves, C, d, metric, k, oi, od, s);
    default:
      // k = 9..32 run the next wide list length and write its first k slots
      if (list_len(k) == 16) return launch<16>(p, ids, n_leaves, C, d, metric, k, oi, od, s);
      if (list_len(k) == 32) return launch<32>(p, ids, n_leaves, C, d, metric, k, oi, od, s);
      return cudaErrorInvalidValue;
  }
}

// The launch's plan at (C, d, k), from the functions the launch uses: its
// list length K (the kernel instantiation's first template argument) and
// the dynamic shared memory it requests.  For the contract checker
// (repro_torch.analysis.contracts); launches nothing.
PIPNN_EXPORT int pipnn_leaf_topk_plan(int C, int d, int k, long long* smem, int* K) {
  const int kk = list_len(k);
  if (kk == 0) return cudaErrorInvalidValue;
  *K = kk;
  *smem = 0;
  if (C <= 0) return cudaSuccess;
  const int da = resident_depth(C, d, kk);
  if (da == 0) return cudaErrorInvalidValue;
  *smem = (long long)smem_bytes(C, da, kk);
  return cudaSuccess;
}
