"""HashPrune (counterpart of ``repro/core/hashprune.py``), the paper's
history-independent pruning reservoir.

Per point a reservoir holds at most ``l_max`` candidates, one per residual
hash bucket.  Theorem 3.1's closed form is what every function here
evaluates: R(C) = the l_max nearest of the per-bucket minima of C, ordered
by (dist, id).  Mergeability, R(R(C1) u C2) = R(C1 u C2), lets the build
fold its candidate edges in chunks while holding only the [n, l_max]
reservoir.

Two folds of a candidate chunk into the persistent reservoir:
``merge_segmented_edges`` (the build's default: the chunk alone is reduced
by ``hashprune_flat``, then merged row by row by
``kernels.segmented_merge``) and ``merge_flat_edges`` (the oracle: the
reservoir is re-expressed as edges by ``reservoir_as_edges`` and re-sorted
with the chunk).  ``hashprune_stream`` is the sequential Algorithm 3 for
one point, the oracle of the closed form.

The reference's multi-key ``lax.sort`` calls become chains of stable sorts
from the least significant key up, on composite int64 keys
(``kernels.topk.lex_key``); a stable sort keeps the reference's order for
entries whose keys tie, so the reservoirs are bit-identical.  The
reference donates the reservoir to its jitted folds; here
``merge_segmented_edges`` and ``hashprune_merge_segmented`` write into the
reservoir's tensors in place on the card (the merge kernel) and return new
ones on the CPU, and every other function leaves its inputs as they are.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.device import resolve_device
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


def reservoir_init(n: int, l_max: int, device=None) -> Reservoir:
    """An empty [n, l_max] reservoir on ``device`` (default: the card,
    raising without one): ids -1, hashes 0, dists +inf."""
    device = resolve_device(device)
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


def hashprune_merge(res: Reservoir, batch: Reservoir | None = None, cand_ids=None,
                    cand_hashes=None, cand_dists=None) -> Reservoir:
    """Merge a candidate batch ([n, m] padded lists, or a second reservoir
    ``batch``) into ``res``: the closed form on the union, by the
    mergeability lemma.  ``res`` is left as it is."""
    if batch is not None:
        cand_ids, cand_hashes, cand_dists = batch.ids, batch.hashes, batch.dists
    return hashprune_batch(torch.cat([res.ids, cand_ids], dim=-1),
                           torch.cat([res.hashes, cand_hashes], dim=-1),
                           torch.cat([res.dists, cand_dists], dim=-1), l_max=res.l_max)


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


def reservoir_as_edges(ids, hashes, dists):
    """Flatten a reservoir [n, l_max] into a flat edge list (src, dst, hash,
    dist), empty slots as padding edges (src == n), so it can be re-pruned
    together with a fresh chunk: the mergeability lemma's R(C1) u C2."""
    n, l_max = ids.shape
    row = torch.arange(n, dtype=torch.int32, device=ids.device)[:, None].expand(n, l_max)
    flat_ids = ids.reshape(-1)
    src = torch.where(flat_ids == INVALID_ID, n, row.reshape(-1))
    return src, flat_ids, hashes.reshape(-1), dists.reshape(-1)


def merge_flat_edges(res_ids, res_hashes, res_dists, src, dst, hashes, dists) -> Reservoir:
    """Flat fold of a candidate-edge chunk into a reservoir: the reservoir
    as edges and the chunk in one ``hashprune_flat``.  Bit-identical to
    ``hashprune_flat`` over every edge ever folded in; the reservoir is
    left as it is (the result is new)."""
    n, l_max = res_ids.shape
    r_src, r_dst, r_h, r_d = reservoir_as_edges(res_ids, res_hashes, res_dists)
    return hashprune_flat(torch.cat([r_src, src]), torch.cat([r_dst, dst]),
                          torch.cat([r_h, hashes]), torch.cat([r_d, dists]),
                          n_points=n, l_max=l_max)


def hashprune_merge_flat(res: Reservoir, src, dst, hashes, dists) -> Reservoir:
    """``merge_flat_edges`` on a ``Reservoir``.  Padding edges use the
    ``hashprune_flat`` convention (src == n, dst == -1, dist == +inf)."""
    return merge_flat_edges(res.ids, res.hashes, res.dists, src, dst, hashes, dists)


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


def hashprune_merge_segmented(res: Reservoir, src, dst, hashes, dists) -> Reservoir:
    """``merge_segmented_edges`` on a ``Reservoir``: same result as
    ``hashprune_merge_flat``, with the global sort over the chunk's edges
    only.  On the card ``res``'s tensors are written in place."""
    return merge_segmented_edges(res.ids, res.hashes, res.dists, src, dst, hashes, dists)


# ---------------------------------------------------------------------------
# Workspace models (checked by ``analysis.memory_audit``, PIPM004)
# ---------------------------------------------------------------------------

# bytes an entry of one stable argsort of an int64 key holds at its peak:
# the key, the sorted keys, the index iota and the sorted indices (8 each),
# and up to another 16 of radix-sort scratch
SORT_BYTES = 48


def merge_segmented_workspace_bytes(n: int, l_max: int, e: int) -> int:
    """Modeled device temp bytes of one ``merge_segmented_edges`` fold of an
    ``e``-edge chunk on the card: ``hashprune_flat``'s [n, l_max] chunk
    reservoir (12 B a slot) and, at its peak (the (src, dist, dst) sort),
    four permuted edge columns beside one ``SORT_BYTES`` argsort; the row
    merge writes into the reservoir in place and allocates nothing.  Only
    the chunk and the reservoir appear, never the total edge count."""
    return n * l_max * 12 + e * (16 + SORT_BYTES)


def merge_flat_workspace_bytes(n: int, l_max: int, e: int) -> int:
    """Modeled device temp bytes of one ``merge_flat_edges`` fold: the
    reservoir as ``n * l_max`` edges (a source column, 4 B a slot), their
    concatenation with the chunk (16 B an edge) and ``hashprune_flat``'s
    sort over all of them; its new reservoir is output, not temp."""
    entries = n * l_max + e
    return n * l_max * 4 + entries * 16 + entries * (16 + SORT_BYTES)


def _less(d1: float, i1: int, d2: float, i2: int) -> bool:
    """(dist, id) lexicographic strict less-than."""
    return d1 < d2 or (d1 == d2 and i1 < i2)


def _first_max(vals: list) -> int:
    best = 0
    for i, v in enumerate(vals):
        if v > vals[best]:
            best = i
    return best


def _insert_one(ids: list, hashes: list, dists: list, cid: int, chash: int,
                cdist: float) -> None:
    """Algorithm 3's insertion of one candidate into a reservoir held as
    lists, in place; the reference's ``_insert_one`` slot for slot."""
    l_max = len(ids)
    occupied = [i != INVALID_ID for i in ids]
    if cid == INVALID_ID:
        return
    match = [o and h == chash for o, h in zip(occupied, hashes)]
    any_match = any(match)
    mpos = match.index(True) if any_match else 0
    has_room = sum(occupied) < l_max
    epos = occupied.index(False) if not all(occupied) else 0
    # the farthest occupied slot by (dist, id): the max dist, ties to the
    # larger id (the first of equal ids)
    far = [d if o else float("-inf") for o, d in zip(occupied, dists)]
    zpos = _first_max(far)
    fz = far[zpos]
    is_max = [o and d == fz and math.isfinite(fz) for o, d in zip(occupied, dists)]
    if any(is_max):
        zpos = _first_max([i if m else -2 for m, i in zip(is_max, ids)])
    if any_match:
        write, pos = _less(cdist, cid, dists[mpos], ids[mpos]), mpos
    else:
        write = has_room or _less(cdist, cid, dists[zpos], ids[zpos])
        pos = epos if has_room else zpos
    if write:
        ids[pos], hashes[pos], dists[pos] = cid, chash, cdist


def hashprune_stream(cand_ids, cand_hashes, cand_dists, *, l_max: int) -> Reservoir:
    """Sequential Algorithm 3 for ONE point (candidates [n_cand]), on the
    host: O(n_cand * l_max), the reference semantics.  Returns a [1, l_max]
    reservoir on the candidates' device, slots in insertion order."""
    ids, hashes, dists = [INVALID_ID] * l_max, [0] * l_max, [float("inf")] * l_max
    for cid, ch, cd in zip(cand_ids.tolist(), cand_hashes.tolist(), cand_dists.tolist()):
        _insert_one(ids, hashes, dists, cid, ch, cd)
    dev = cand_ids.device
    return Reservoir(ids=torch.tensor([ids], dtype=torch.int32, device=dev),
                     hashes=torch.tensor([hashes], dtype=torch.int32, device=dev),
                     dists=torch.tensor([dists], dtype=torch.float32, device=dev))


def canonicalize(res: Reservoir) -> Reservoir:
    """Sort reservoir slots by (dist, id) so representations compare equal."""
    p = stable_argsort(lex_key(ordered(res.dists), res.ids))
    d, i, h = (torch.gather(t, -1, p) for t in (res.dists, res.ids, res.hashes))
    return Reservoir(ids=i, hashes=torch.where(i == INVALID_ID, 0, h), dists=d)
