"""HashPrune (counterpart of ``repro/core/hashprune.py``), the paper's
history-independent pruning reservoir.

Per point a reservoir holds at most ``l_max`` candidates, one per residual
hash bucket.  Theorem 3.1's closed form is what every function here
evaluates: R(C) = the l_max nearest of the per-bucket minima of C, ordered
by (dist, id).  Mergeability, R(R(C1) u C2) = R(C1 u C2), lets the build
fold its candidate edges in chunks while holding only the [n, l_max]
reservoir.

The reference's multi-key ``lax.sort`` calls become chains of stable sorts
from the least significant key up, on composite int64 keys
(``kernels.topk.lex_key``); a stable sort keeps the reference's order for
entries whose keys tie, so the reservoirs are bit-identical.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.segmented_merge import merge_sorted_reservoirs
from repro_torch.kernels.topk import lex_key, ordered, stable_argsort

INVALID_ID = -1
_HASH_PAD = 0x7FFFFFFF


class Reservoir(NamedTuple):
    """Batched HashPrune state for n points.  All tensors [n, l_max]."""

    ids: torch.Tensor     # int32, -1 marks an empty slot
    hashes: torch.Tensor  # int32 packed residual hash (< 2^16)
    dists: torch.Tensor   # float32, +inf marks an empty slot

    @property
    def l_max(self) -> int:
        return self.ids.shape[-1]


def reservoir_init(n: int, l_max: int, device="cpu") -> Reservoir:
    return Reservoir(
        ids=torch.full((n, l_max), INVALID_ID, dtype=torch.int32, device=device),
        hashes=torch.zeros((n, l_max), dtype=torch.int32, device=device),
        dists=torch.full((n, l_max), float("inf"), dtype=torch.float32, device=device),
    )


def _inf(t: torch.Tensor) -> torch.Tensor:
    return torch.full((), float("inf"), dtype=torch.float32, device=t.device)


def _dedup_bucket_min(hashes, dists, ids):
    """Sort each row by (hash, dist, id) and keep only each hash run's head;
    the rest become (+inf, -1, 0x7FFFFFFF)."""
    p = stable_argsort(lex_key(ordered(dists), ids))
    p = torch.gather(p, -1, stable_argsort(torch.gather(hashes, -1, p)))
    s_hash = torch.gather(hashes, -1, p)
    s_dist = torch.gather(dists, -1, p)
    s_id = torch.gather(ids, -1, p)
    first = torch.ones_like(s_hash, dtype=torch.bool)
    first[..., 1:] = s_hash[..., 1:] != s_hash[..., :-1]
    keep = first & (s_id != INVALID_ID)
    return (torch.where(keep, s_dist, _inf(s_dist)),
            torch.where(keep, s_id, INVALID_ID),
            torch.where(keep, s_hash, _HASH_PAD))


def hashprune_batch(cand_ids, cand_hashes, cand_dists, *, l_max: int) -> Reservoir:
    """HashPrune's closed form on padded per-point candidate lists
    [n, n_cand] (-1 / +inf padding); returns the [n, l_max] reservoir."""
    d, i, h = _dedup_bucket_min(cand_hashes, cand_dists, cand_ids)
    q = stable_argsort(lex_key(ordered(d), i))
    s_d, s_i, s_h = (torch.gather(t, -1, q) for t in (d, i, h))
    n_cand = cand_ids.shape[-1]
    if n_cand >= l_max:
        s_d, s_i, s_h = s_d[..., :l_max], s_i[..., :l_max], s_h[..., :l_max]
    else:
        pad = l_max - n_cand
        pf = torch.nn.functional.pad
        s_d = pf(s_d, (0, pad), value=float("inf"))
        s_i = pf(s_i, (0, pad), value=INVALID_ID)
        s_h = pf(s_h, (0, pad), value=0)
    s_h = torch.where(s_i == INVALID_ID, 0, s_h)
    return Reservoir(ids=s_i, hashes=s_h, dists=s_d)


def hashprune_flat(src, dst, hashes, dists, *, n_points: int, l_max: int) -> Reservoir:
    """HashPrune over a flat edge list [(src -> dst, hash, dist)].

    Padding edges use ``src == n_points`` (dropped).  One sort of all edges
    by (src, hash, dist, dst) finds the bucket heads, a second by
    (src, dist, dst) ranks them per source, and ranks below ``l_max`` are
    scattered into the reservoir."""
    n = n_points
    out = reservoir_init(n, l_max, src.device)
    e = src.shape[0]
    if e == 0:
        return out
    # (1) bucket minima: heads of (src, hash) runs in (src, hash, dist, dst) order
    p = stable_argsort(lex_key(ordered(dists), dst))
    p = p[stable_argsort(lex_key(src[p], hashes[p]))]
    s_src, s_hash, s_dist, s_dst = src[p], hashes[p], dists[p], dst[p]
    del p
    same = torch.zeros(e, dtype=torch.bool, device=src.device)
    same[1:] = (s_src[1:] == s_src[:-1]) & (s_hash[1:] == s_hash[:-1])
    keep = ~same & (s_src < n) & (s_dst != INVALID_ID)
    del same
    m_dist = torch.where(keep, s_dist, _inf(s_dist))
    m_src = torch.where(keep, s_src, n)
    del keep, s_src, s_dist
    # (2) per-source ranks in (src, dist, dst) order
    q = stable_argsort(lex_key(ordered(m_dist), s_dst))
    q = q[stable_argsort(m_src[q])]
    f_src, f_dist, f_dst, f_hash = m_src[q], m_dist[q], s_dst[q], s_hash[q]
    del q, m_src, m_dist, s_dst, s_hash
    # rank within the source's run: f_src is sorted, so the run starts at
    # the first position of its value (the reference takes a cummax of the
    # run starts; a binary search is the same number, and far cheaper here)
    rank = torch.arange(e, device=src.device) - torch.searchsorted(f_src, f_src)
    ok = (rank < l_max) & (f_src < n) & torch.isfinite(f_dist)
    row, col = f_src[ok].long(), rank[ok]
    out.ids[row, col] = f_dst[ok]
    out.hashes[row, col] = f_hash[ok]
    out.dists[row, col] = f_dist[ok]
    return out


def merge_segmented_edges(res_ids, res_hashes, res_dists,
                          src, dst, hashes, dists) -> Reservoir:
    """Segmented fold of a flat candidate-edge chunk into a reservoir: the
    chunk alone is reduced to its own [n, l_max] reservoir by
    ``hashprune_flat``, then merged row by row with the persistent one
    (``kernels.segmented_merge``; on the card the merge is written into
    ``res_*`` in place)."""
    n, l_max = res_ids.shape
    chunk = hashprune_flat(src, dst, hashes, dists, n_points=n, l_max=l_max)
    return Reservoir(*merge_sorted_reservoirs(
        res_ids, res_hashes, res_dists, chunk.ids, chunk.hashes, chunk.dists))
