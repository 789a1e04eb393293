// Bounded per-row merge of two sorted HashPrune reservoirs: R(A u B).
//
// Replaces the Pallas kernel repro/kernels/segmented_merge.py::
// merge_sorted_reservoirs (pallas_call at :104).  Both inputs are [n, l]
// reservoirs whose live slots (id != -1) are a prefix sorted by (dist, id);
// every slot past the live prefix holds the padding (id -1, hash 0, dist
// +inf).  Every producer keeps this invariant (reservoir_init,
// hashprune_flat and this kernel itself), and the kernel relies on it: it
// reads and writes only the live prefixes.
//
// What bounds it: bytes.  The rows hold few live slots (about 8 a row on
// the 1M build's early chunks, more late in the stream), so a row's work
// and bytes follow its live slots, not l: each id row is read up to the
// first 32-slot word that holds a -1 to count its live slots, then only
// the live prefix of hashes and dists is read and only slots
// [0, max(n_out, nA)) are written.  The kernel runs at several times that
// byte time: each row is a few short dependent rounds (ids, live slots,
// sweep, placement) that the resident warps only partly hide.
//
// Design: one warp merges one row, without a sort.
// - Live counts nA, nB: a ballot on id != -1 over each id row (coalesced
//   4-byte lanes, a 32-slot word at a time), stopping at the first word
//   with a -1.  A row whose B side is empty is already R(A) and is left
//   as it is.
// - Slots in registers: lane s holds slots s and s + 32 of a 64-slot
//   segment of each side.  Rows with l > 64 loop over segments with the
//   same code (one segment for l <= 64).
// - Dedup and cross counts in one sweep over the side with fewer live
//   slots in the segment pair (S): its slot j comes to every lane by
//   __shfl_sync, and each lane tests its slots of the other side (G)
//   against it.  Of a pair, the slot placed first is the one with the
//   smaller (dist, id) key, A on an exact tie; of a same-hash pair the
//   first one stays (an A slot dies if a B slot of its bucket has a
//   strictly smaller key, a B slot if an A slot's key is no larger).  A G
//   slot counts the S slots placed before it; S slot j gets its count of
//   earlier G slots, and its death, by two ballots.  Both sides are
//   sorted, so a slot's earlier slots of the other side are a prefix.
// - Rank placement: a survivor's slot is its own side's survivor rank plus
//   the other side's survivors in that prefix, both popcounts of the
//   survivor masks (ballots kept per warp in shared memory).  Survivors
//   are scattered into the warp's staging rows in shared memory; slots
//   past l are dropped.
// - Writes, in place over A: slots [0, n_out) from the staging rows,
//   [n_out, nA) as padding; slots past max(n_out, nA) already hold it.
//   The warp reads every slot of its row it needs (ids, hashes and dists,
//   also the re-reads of the placement step) before the first write, with
//   a __syncwarp between, and rows are independent, so writing over A is
//   safe: the reference's fused step donates the reservoir the same way.
// Blocks of 8 warps, at most 32 registers a thread: 64 warps an SM, which
// measured faster than 40 warps at 56 registers (the rows are short and
// latency-bound) and than persistent warps (which spilled).
// Only comparisons and copies: bit-exact against the plain version.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int DIE = 1 << 30;   // slot state: the low bits count, this bit kills
constexpr unsigned FULL = 0xffffffffu;

// slots seg0 + lane and seg0 + 32 + lane of one side; padding past `live`
struct Seg {
  int id[2], h[2];
  float d[2];
};

__device__ __forceinline__ void load_seg(const int* ids, const int* hs, const float* ds,
                                         size_t base, int seg0, int live, int lane, Seg& s) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int slot = seg0 + 32 * k + lane;
    const bool in = slot < live;
    s.id[k] = in ? ids[base + slot] : -1;
    s.h[k] = in ? hs[base + slot] : 0;
    s.d[k] = in ? ds[base + slot] : CUDART_INF_F;
  }
}

// One segment pair: the smaller side S (cs live slots) is broadcast slot
// by slot; each lane tests its slots of the larger side G against it.  A
// pair's "first" slot is the one placed first in the output (the smaller
// key; A on an exact tie), and of a same-hash pair the first one stays.
// G's slots count the S slots placed before them and die in place; S slot
// j gets its count of earlier G slots, and its death, by ballot.
template <bool S_IS_A>
__device__ __forceinline__ void sweep(const Seg& s, const Seg& g, int (&st_s)[2], int (&st_g)[2],
                                      int cs, int cg, int lane) {
  for (int j = 0; j < cs; ++j) {
    const bool hi = j >= 32;   // uniform: which register holds slot j
    const int src = j & 31;
    const int si = __shfl_sync(FULL, hi ? s.id[1] : s.id[0], src);
    const int sh = __shfl_sync(FULL, hi ? s.h[1] : s.h[0], src);
    const float sd = __shfl_sync(FULL, hi ? s.d[1] : s.d[0], src);
    int before = 0;
    unsigned kill = 0u;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (k == 1 && cg <= 32) break;
      const bool valid = 32 * k + lane < cg;
      const bool s_first = S_IS_A ? !pipnn::lex_less(g.d[k], g.id[k], sd, si)
                                  : pipnn::lex_less(sd, si, g.d[k], g.id[k]);
      const bool same = g.h[k] == sh;
      if (valid) {
        st_g[k] += s_first;
        if (s_first && same) st_g[k] |= DIE;
      }
      const bool g_first = valid && !s_first;
      before += __popc(__ballot_sync(FULL, g_first));
      kill |= __ballot_sync(FULL, g_first && same);
    }
    if (lane == src) {
      int& st = hi ? st_s[1] : st_s[0];
      st += before;
      if (kill) st |= DIE;
    }
  }
}

// shared 4-byte words a warp uses: slot states of both sides, the staging
// rows (ids, hashes, dists), and survivor masks with their prefix counts
__host__ __device__ constexpr size_t warp_words(int l) {
  return 5 * (size_t)l + 4 * ((size_t)(l + 31) / 32 + 1);
}

// R(A u B) of one row, by one warp, over A in place; `ws` is the warp's
// shared workspace of warp_words(l)
__device__ __forceinline__ void merge_row(int* a_ids, int* a_h, float* a_d,
                                          const int* __restrict__ b_ids,
                                          const int* __restrict__ b_h,
                                          const float* __restrict__ b_d, long long row, int l,
                                          int* ws, int lane) {
  const int nw = (l + 31) / 32;
  int* st_a = ws;
  int* st_b = st_a + l;
  int* o_id = st_b + l;
  int* o_h = o_id + l;
  float* o_d = reinterpret_cast<float*>(o_h + l);
  unsigned* m_a = reinterpret_cast<unsigned*>(o_d + l);
  unsigned* m_b = m_a + nw + 1;
  int* p_a = reinterpret_cast<int*>(m_b + nw + 1);
  int* p_b = p_a + nw + 1;
  const size_t base = (size_t)row * l;

  // live counts: each id row up to the first 32-slot word holding a -1
  // (the live slots are a prefix)
  int na = 0, nb = 0;
  bool more_a = true, more_b = true;
  for (int s0 = 0; s0 < l && (more_a || more_b); s0 += 32) {
    const int s = s0 + lane;
    const int ia = more_a && s < l ? a_ids[base + s] : -1;
    const int ib = more_b && s < l ? __ldg(b_ids + base + s) : -1;
    const unsigned ma = __ballot_sync(FULL, ia != -1);
    const unsigned mb = __ballot_sync(FULL, ib != -1);
    na += __popc(ma);
    nb += __popc(mb);
    more_a = ma == FULL;
    more_b = mb == FULL;
  }
  if (nb == 0) return;   // R(A u {}) = A: nothing to write

  // dedup and cross counts, segment by segment; A's states stay in
  // registers over the B loop, B's are carried across A segments in
  // shared memory (each slot's state lives on lane slot % 32 throughout)
  const int sega = (na + 63) / 64, segb = (nb + 63) / 64;
  for (int s = lane; s < nb; s += 32) st_b[s] = 0;
  for (int sa = 0; sa < sega; ++sa) {
    Seg a;
    load_seg(a_ids, a_h, a_d, base, 64 * sa, na, lane, a);
    const int ca = min(64, na - 64 * sa);
    int sta[2] = {0, 0};
    for (int sb = 0; sb < segb; ++sb) {
      Seg b;
      load_seg(b_ids, b_h, b_d, base, 64 * sb, nb, lane, b);
      const int cb = min(64, nb - 64 * sb);
      int stb[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int slot = 64 * sb + 32 * k + lane;
        stb[k] = slot < nb ? st_b[slot] : 0;
      }
      if (ca <= cb) {
        sweep<true>(a, b, sta, stb, ca, cb, lane);
      } else {
        sweep<false>(b, a, stb, sta, cb, ca, lane);
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int slot = 64 * sb + 32 * k + lane;
        if (slot < nb) st_b[slot] = stb[k];
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int slot = 64 * sa + 32 * k + lane;
      if (slot < na) st_a[slot] = sta[k];
    }
  }

  // survivor masks of 32 slots and the survivors before each (lane 0
  // writes them; word wl closes both lists for counts that reach the end)
  const int wl = (max(na, nb) + 31) / 32;
  int surv_a = 0, surv_b = 0;
  for (int w = 0; w < wl; ++w) {
    const int s = 32 * w + lane;
    const unsigned ma = __ballot_sync(FULL, s < na && !(st_a[s] & DIE));
    const unsigned mb = __ballot_sync(FULL, s < nb && !(st_b[s] & DIE));
    if (lane == 0) {
      m_a[w] = ma;
      p_a[w] = surv_a;
      m_b[w] = mb;
      p_b[w] = surv_b;
    }
    surv_a += __popc(ma);
    surv_b += __popc(mb);
  }
  if (lane == 0) {
    m_a[wl] = 0u;
    p_a[wl] = surv_a;
    m_b[wl] = 0u;
    p_b[wl] = surv_b;
  }
  __syncwarp();

  // rank placement into the staging rows
  const unsigned lt_mask = (1u << lane) - 1u;
  for (int s = lane; s < na; s += 32) {
    const int st = st_a[s];
    if (st & DIE) continue;
    const int t = st & (DIE - 1);   // live B slots before it
    const int pos = p_a[s >> 5] + __popc(m_a[s >> 5] & lt_mask) + p_b[t >> 5] +
                    __popc(m_b[t >> 5] & ((1u << (t & 31)) - 1u));
    if (pos < l) {
      o_id[pos] = a_ids[base + s];
      o_h[pos] = a_h[base + s];
      o_d[pos] = a_d[base + s];
    }
  }
  for (int s = lane; s < nb; s += 32) {
    const int st = st_b[s];
    if (st & DIE) continue;
    const int t = st & (DIE - 1);   // live A slots before it
    const int pos = p_b[s >> 5] + __popc(m_b[s >> 5] & lt_mask) + p_a[t >> 5] +
                    __popc(m_a[t >> 5] & ((1u << (t & 31)) - 1u));
    if (pos < l) {
      o_id[pos] = __ldg(b_ids + base + s);
      o_h[pos] = __ldg(b_h + base + s);
      o_d[pos] = __ldg(b_d + base + s);
    }
  }
  __syncwarp();

  // write over A: the merged prefix, then padding over A's leftover slots
  const int n_out = min(l, surv_a + surv_b);
  const int n_write = max(n_out, na);
  for (int s = lane; s < n_write; s += 32) {
    const bool v = s < n_out;
    a_ids[base + s] = v ? o_id[s] : -1;
    a_h[base + s] = v ? o_h[s] : 0;
    a_d[base + s] = v ? o_d[s] : CUDART_INF_F;
  }
}

__global__ void __launch_bounds__(WARPS * 32, 8)   // <= 32 registers: 64 warps an SM
merge_kernel(int* a_ids, int* a_h, float* a_d, const int* __restrict__ b_ids,
             const int* __restrict__ b_h, const float* __restrict__ b_d, long long n, int l) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * WARPS + warp;
  if (row < n)   // whole warps
    merge_row(a_ids, a_h, a_d, b_ids, b_h, b_d, row, l, smem + (size_t)warp * warp_words(l),
              threadIdx.x & 31);
}

// a block's dynamic shared memory at reservoir width l: each warp's workspace
size_t block_smem(int l) { return WARPS * warp_words(l) * sizeof(int); }

}  // namespace

// The dynamic shared memory a launch at reservoir width l requests, from the
// function the launch uses.  For the contract checker
// (repro_torch.analysis.contracts); launches nothing.
PIPNN_EXPORT int pipnn_merge_sorted_reservoirs_plan(int l, long long* smem) {
  *smem = l <= 0 ? 0 : (long long)block_smem(l);
  return cudaSuccess;
}

// a_* [n, l] (merged in place), b_* [n, l]; ids/hashes int32, dists f32
PIPNN_EXPORT int pipnn_merge_sorted_reservoirs(void* a_ids, void* a_h, void* a_d, const void* b_ids,
                                               const void* b_h, const void* b_d, long long n, int l,
                                               void* stream) {
  if (n <= 0 || l <= 0) return cudaGetLastError();
  const size_t smem = block_smem(l);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const long long blocks = (n + WARPS - 1) / WARPS;
  merge_kernel<<<(unsigned)blocks, WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(a_ids), static_cast<int*>(a_h), static_cast<float*>(a_d),
      static_cast<const int*>(b_ids), static_cast<const int*>(b_h),
      static_cast<const float*>(b_d), n, l);
  return cudaGetLastError();
}
