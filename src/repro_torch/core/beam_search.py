"""Beam search over a navigation graph (counterpart of
``repro/core/beam_search.py``): the numpy oracle ``beam_search_np``, the
legacy single-expansion engine ``beam_search_single`` and the
multi-expansion serving engine.

Each engine step expands the E best unvisited beam entries of every query
at once, scores their E*R neighbours as one [Q, E*R] block
(``kernels.gather_distance`` on float32 or bfloat16 points,
``kernels.gather_distance_int8`` on the int8 packing) and folds the block
into the sorted beam
with rank-based merges (``merge_block``), one per expanded row.  The loop
stops when no query has a live unvisited entry, with ``iters`` as the
backstop; checking that costs one host sync per step.  Per-query ``hops``,
``dist_comps`` and ``converged`` telemetry match the reference.

``kernel_path`` keeps the reference's names ("vmem" | "hbm" | "xla") so
its callers and fault schedules run unchanged.  On the card "vmem" and
"hbm" are the same gather kernel (there is one memory to read rows from)
and report "hbm"; "xla" runs the plain PyTorch versions of the gather, and
only when the caller names it.  CPU tensors always take the plain versions
and report "xla".
"""
from __future__ import annotations

import heapq

import numpy as np
import torch

from repro_torch.core.metrics import check_metric, pairwise, point_norms
from repro_torch.kernels.gather_distance import gather_distance, gather_distance_plain
from repro_torch.kernels.gather_distance_int8 import (gather_distance_int8,
                                                      gather_distance_int8_plain)
from repro_torch.kernels.topk import lex_key, ordered, stable_argsort, topf


KERNEL_PATHS = ("vmem", "hbm", "xla")


def resolve_kernel_path(points: torch.Tensor, kernel_path: str | None = None) -> str:
    """The gather path a search over ``points`` runs: "hbm" (the CUDA
    kernel) on the card unless ``kernel_path="xla"`` asks for the plain
    version; "xla" on the CPU.  Any other name raises ``ValueError``."""
    if kernel_path is not None and kernel_path not in KERNEL_PATHS:
        raise ValueError(f"kernel_path must be one of {KERNEL_PATHS}, got {kernel_path!r}")
    if points.device.type == "cpu" or kernel_path == "xla":
        return "xla"
    return "hbm"


def default_iters(beam: int) -> int:
    """Backstop iteration cap of the serving engine: ``beam + 4``."""
    return beam + 4


def medoid(x: np.ndarray, sample: int = 4096, seed: int = 0) -> int:
    """Approximate medoid: the sample point nearest the dataset mean."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    idx = rng.choice(n, size=min(sample, n), replace=False)
    mean = x.mean(axis=0, keepdims=True)
    d = np.sum((x[idx] - mean) ** 2, axis=1)
    return int(idx[np.argmin(d)])


def _dist_np(q: np.ndarray, pts: np.ndarray, metric: str) -> np.ndarray:
    if metric == "mips":
        return -(pts @ q)
    if metric == "cosine":
        return 1.0 - (pts @ q) / np.maximum(
            np.linalg.norm(pts, axis=1) * np.linalg.norm(q), 1e-30)
    diff = pts - q[None, :]
    return np.sum(diff * diff, axis=1)


def beam_search_np(graph: np.ndarray, x: np.ndarray, q: np.ndarray, *,
                   start: int, beam: int, metric: str = "l2",
                   max_visits: int | None = None):
    """Algorithm 1, one query, pointer chasing on the host (the oracle).
    Returns (beam ids sorted by dist, dists, n_dist_comps)."""
    d0 = float(_dist_np(q, x[start: start + 1], metric)[0])
    frontier = [(d0, start)]
    in_beam = {start: d0}
    visited: set[int] = set()
    comps = 1
    limit = max_visits or 10 * beam
    while frontier and len(visited) < limit:
        d, p = heapq.heappop(frontier)
        if p in visited or p not in in_beam:
            continue
        visited.add(p)
        nbrs = graph[p]
        nbrs = nbrs[nbrs >= 0]
        new = [v for v in nbrs if v not in in_beam and v not in visited]
        if new:
            nd = _dist_np(q, x[new], metric)
            comps += len(new)
            for v, dv in zip(new, nd):
                in_beam[v] = float(dv)
                heapq.heappush(frontier, (float(dv), v))
        if len(in_beam) > beam:
            items = sorted(in_beam.items(), key=lambda kv: (kv[1], kv[0]))[:beam]
            in_beam = dict(items)
    items = sorted(in_beam.items(), key=lambda kv: (kv[1], kv[0]))
    ids = np.asarray([v for v, _ in items], dtype=np.int64)
    ds = np.asarray([dv for _, dv in items], dtype=np.float32)
    return ids, ds, comps


def beam_search_single(graph: torch.Tensor, x: torch.Tensor, queries: torch.Tensor, *,
                       start: int, beam: int, iters: int, metric: str = "l2"):
    """Single-expansion fixed-iteration beam search (the legacy engine, the
    baseline the serving engine is measured against), batched over the
    queries on their device with torch operations.

    Each of ``iters`` steps expands the best unvisited beam slot of every
    query, scores its R neighbours, and folds them in with two sorts of the
    beam + R entries: by (id, dist, not visited) to drop repeated ids
    (empty neighbour slots carry id -1, sort first and are masked), then by
    (dist, id) to keep the best ``beam``.  No convergence check.  Returns
    (ids int32, dists float32), [Q, beam] each."""
    check_metric(metric)
    nq = queries.shape[0]
    r = graph.shape[1]
    dev = queries.device
    inf = torch.full((), float("inf"), device=dev)
    q = queries.to(torch.float32)
    rows = torch.arange(nq, device=dev)
    ids = torch.full((nq, beam), -1, dtype=torch.int32, device=dev)
    ids[:, 0] = int(start)
    ds = torch.full((nq, beam), float("inf"), dtype=torch.float32, device=dev)
    ds[:, 0] = pairwise(q[:, None, :], x[int(start)][None, None, :], metric)[:, 0, 0]
    vis = torch.zeros((nq, beam), dtype=torch.bool, device=dev)
    not_vis_new = torch.ones((nq, r), dtype=torch.int32, device=dev)
    for _ in range(iters):
        cand = torch.where(vis | (ids < 0), inf, ds)
        j = torch.argmin(cand, dim=1)
        done = ~torch.isfinite(cand[rows, j])
        p = ids[rows, j].clamp_min(0).long()
        vis[rows, j] = True
        nbr = graph[p]                                          # [Q, R]
        ok = (nbr >= 0) & ~done[:, None]
        nv = x[nbr.clamp_min(0).long()]                         # [Q, R, d]
        nd = torch.where(ok, pairwise(q[:, None, :], nv, metric)[:, 0], inf)
        all_ids = torch.cat([ids, torch.where(ok, nbr, -1)], dim=1)
        all_ds = torch.cat([ds, nd], dim=1)
        all_nvis = torch.cat([(~vis).to(torch.int32), not_vis_new], dim=1)
        # (id, dist, not visited): a repeated id keeps its first copy, the
        # nearest, visited before unvisited
        o = stable_argsort(lex_key(ordered(all_ds), all_nvis))
        o = torch.gather(o, 1, stable_argsort(torch.gather(all_ids, 1, o)))
        o_id, o_ds, o_nvis = (torch.gather(t, 1, o) for t in (all_ids, all_ds, all_nvis))
        dup = torch.zeros_like(o_id, dtype=torch.bool)
        dup[:, 1:] = o_id[:, 1:] == o_id[:, :-1]
        o_ds = torch.where(dup | (o_id < 0), inf, o_ds)
        # the best `beam` by (dist, id)
        t = stable_argsort(lex_key(ordered(o_ds), o_id))[:, :beam]
        ids, ds = torch.gather(o_id, 1, t), torch.gather(o_ds, 1, t)
        vis = torch.gather(o_nvis, 1, t) == 0
        ids = torch.where(torch.isfinite(ds), ids, -1)
    return ids, ds


def _lt(d1, i1, d2, i2):
    return (d1 < d2) | ((d1 == d2) & (i1 < i2))


def _id_order(bids):
    """A stable sort of each row of the block by id: (the [Q, M] bool mask
    of the entries whose id occurs at a lower index of their row, the
    sort's order).  Stability keeps each id's first entry first."""
    sid, order = torch.sort(bids, dim=1, stable=True)
    rep = torch.nn.functional.pad(sid[:, 1:] == sid[:, :-1], (1, 0))
    return torch.empty_like(rep).scatter_(1, order, rep), order


def _block_rank(bds, vb, order):
    """[Q, M] int64: each valid entry's rank among its row's valid entries
    by (dist, id): its place in a stable sort by dist of the block in id
    ``order``, where the invalid entries sort last at +inf (-0.0 made
    +0.0 first, so it ties with +0.0 as in the comparisons)."""
    inf = torch.full((), float("inf"), device=bds.device)
    key = (torch.where(vb, bds, inf) + 0.0).gather(1, order)
    perm = order.gather(1, torch.sort(key, dim=1, stable=True).indices)
    iota = torch.arange(perm.shape[1], device=perm.device).expand_as(perm)
    return torch.empty_like(perm).scatter_(1, perm, iota)


def merge_block(ids, ds, vis, bids, bds):
    """Fold one [Q, M] candidate block into a sorted [Q, L] beam.

    Candidates already in the beam, repeated in the block or padding are
    dropped; then every valid entry's output slot is its rank on its own
    side plus the count of smaller (dist, id) keys on the other side
    (the beam's own rank is its slot index).  Slots past L fall off.
    Visited flags ride along on the beam side; new entries are
    unvisited.  The placement is a scatter instead of the reference's
    one-hot sums, and the block's repeats and own ranks come from sorts
    instead of its [M, M] comparisons, with the same result: the device
    bytes grow as M L, never as M^2."""
    nq, beam = ids.shape
    dev = ids.device
    inf = torch.full((), float("inf"), device=dev)
    beam_ids = torch.where(ids >= 0, ids, -2)
    member = torch.any(bids[:, :, None] == beam_ids[:, None, :], dim=2)
    rep, order = _id_order(bids)
    bds = torch.where(rep | member | (bids < 0), inf, bds)
    del member, rep
    va = torch.isfinite(ds)
    vb = torch.isfinite(bds)
    rank_b = _block_rank(bds, vb, order)
    del order
    b_lt_a = _lt(bds[:, None, :], bids[:, None, :], ds[:, :, None], ids[:, :, None])
    iota_l = torch.arange(beam, device=dev)
    pos_a = torch.where(va, iota_l + torch.sum(vb[:, None, :] & b_lt_a, dim=2,
                                               dtype=torch.int64), beam)
    pos_b = torch.where(vb, rank_b + torch.sum(va[:, :, None] & ~b_lt_a, dim=1,
                                               dtype=torch.int64), beam)
    pos_a, pos_b = pos_a.clamp_max(beam), pos_b.clamp_max(beam)
    # one spare column takes everything that falls off the end
    new_ids = torch.full((nq, beam + 1), -1, dtype=ids.dtype, device=dev)
    new_ds = torch.full((nq, beam + 1), float("inf"), dtype=ds.dtype, device=dev)
    new_vis = torch.zeros((nq, beam + 1), dtype=torch.bool, device=dev)
    new_ids.scatter_(1, pos_a, ids)
    new_ds.scatter_(1, pos_a, ds)
    new_vis.scatter_(1, pos_a, vis)
    new_ids.scatter_(1, pos_b, bids)
    new_ds.scatter_(1, pos_b, bds)
    return new_ids[:, :beam], new_ds[:, :beam], new_vis[:, :beam]


def _live(ids, ds, vis):
    return ~vis & (ids >= 0) & torch.isfinite(ds)


def _beam_search_multi(graph, x, norms, queries, start: int, *, beam: int,
                       iters: int, metric: str, expansions: int, early_exit: bool,
                       scales=None, plain: bool = False):
    """Batched multi-expansion beam search core.  Returns (ids [Q, beam],
    dists [Q, beam], hops [Q], dist_comps [Q], converged [Q]).  With
    ``scales`` the points are the int8 packing and every distance block
    comes from the int8 kernel.  ``plain`` takes the gathers' plain
    versions on any device (the "xla" path)."""
    n, r = graph.shape
    nq = queries.shape[0]
    dev = queries.device
    e = max(1, min(int(expansions), beam))
    c = e * r
    q32 = queries.to(torch.float32).contiguous()
    if scales is not None:
        # the query norm terms are computed once per batch and passed to
        # every step as data, as in the reference
        q_norms = point_norms(q32, metric)

        gather8 = gather_distance_int8_plain if plain else gather_distance_int8

        def dist(ids):
            return gather8(x, scales, norms, q32, q_norms, ids, metric)
    else:
        gather = gather_distance_plain if plain else gather_distance

        def dist(ids):
            return gather(x, norms, q32, ids, metric)
    start_ids = torch.full((nq, 1), int(start), dtype=torch.int32, device=dev)
    d0 = dist(start_ids)[:, 0]
    ids = torch.full((nq, beam), -1, dtype=torch.int32, device=dev)
    ids[:, 0] = int(start)
    ds = torch.full((nq, beam), float("inf"), dtype=torch.float32, device=dev)
    ds[:, 0] = d0
    vis = torch.zeros((nq, beam), dtype=torch.bool, device=dev)
    hops = torch.zeros(nq, dtype=torch.int32, device=dev)
    comps = torch.ones(nq, dtype=torch.int32, device=dev)
    rows = torch.arange(nq, device=dev)[:, None]
    inf = torch.full((), float("inf"), device=dev)
    for _ in range(iters):
        if early_exit and not bool(_live(ids, ds, vis).any()):
            break
        # the E best unvisited beam slots; picks at +inf are marked visited
        # too, as in the reference
        masked = torch.where(vis | (ids < 0), inf, ds)
        pos = topf(masked, e).long()
        valid_e = torch.isfinite(torch.gather(masked, 1, pos))
        vis[rows, pos] = True
        p = torch.gather(ids, 1, pos)
        nbr = graph[torch.where(valid_e, p, -1).clamp_min(0).long()]   # [Q, E, R]
        ok = (nbr >= 0) & valid_e[:, :, None]
        cids = torch.where(ok, nbr, -1).reshape(nq, c)
        cds = dist(cids)
        hops += valid_e.sum(dim=1, dtype=torch.int32)
        comps += (cids >= 0).sum(dim=1, dtype=torch.int32)
        for j in range(e):
            sl = slice(j * r, (j + 1) * r)
            ids, ds, vis = merge_block(ids, ds, vis, cids[:, sl], cds[:, sl])
    converged = ~torch.any(_live(ids, ds, vis), dim=1)
    return ids, ds, hops, comps, converged


def beam_search_batch(graph, x, queries, *, start: int, beam: int,
                      iters: int | None = None, metric: str = "l2",
                      expansions: int = 4, norms=None, scales=None,
                      early_exit: bool = True, with_stats: bool = False,
                      kernel_path: str | None = None):
    """Batched multi-expansion beam search over tensors on one device.
    Returns (ids, dists) [Q, beam], or with ``with_stats`` also
    (hops, dist_comps, converged).  ``kernel_path`` as in
    ``resolve_kernel_path``.

    ``scales`` switches on int8 serving: ``x`` must then be the int8
    packing (``kernels.gather_distance_int8.quantize_symmetric``) with
    ``scales`` its [n] float32 per-point scales, and ``norms`` the exact
    float32 norms computed before quantization (required: the int8 copy
    cannot give them back)."""
    check_metric(metric)
    if scales is not None:
        if x.dtype != torch.int8:
            raise TypeError(
                "scales given but points are not int8; pack them with "
                "kernels.gather_distance_int8.quantize_symmetric")
        if norms is None:
            raise ValueError(
                "int8 serving needs the exact float32 point norms computed "
                "before quantization (metrics.point_norms on the float32 "
                "points); they cannot be recovered from the int8 copy")
    if iters is None:
        iters = default_iters(beam)
    if norms is None:
        norms = point_norms(x, metric)
    ids, ds, hops, comps, converged = _beam_search_multi(
        graph, x, norms, queries, start, beam=beam, iters=int(iters),
        metric=metric, expansions=int(expansions), early_exit=bool(early_exit),
        scales=scales, plain=resolve_kernel_path(x, kernel_path) == "xla")
    if with_stats:
        return ids, ds, hops, comps, converged
    return ids, ds


def pad_ids(ids: np.ndarray, k: int) -> np.ndarray:
    """Truncate / -1-pad a [Q, *] id matrix to exactly [Q, k]."""
    ids = np.asarray(ids)[:, :k]
    if ids.shape[1] < k:
        ids = np.pad(ids, ((0, 0), (0, k - ids.shape[1])), constant_values=-1)
    return ids


def recall_at_k(found: np.ndarray, truth: np.ndarray, k: int = 10) -> float:
    """Mean k@k recall over queries (set semantics: a found id scores once)."""
    f = np.asarray(found)[:, :k]
    t = np.asarray(truth)[:, :k]
    kf = f.shape[1]
    earlier = np.tril(np.ones((kf, kf), dtype=bool), -1)
    dup = np.any((f[:, :, None] == f[:, None, :]) & earlier[None], axis=2)
    in_t = np.any(f[:, :, None] == t[:, None, :], axis=2)
    hits = int(np.sum(in_t & ~dup))
    return hits / (len(found) * k)


def brute_force_knn(x: torch.Tensor, queries: torch.Tensor, k: int,
                    metric: str = "l2", chunk: int = 1024) -> np.ndarray:
    """Exact k-NN ground truth [Q, k] (int64, on the host) by chunked GEMM
    on the device holding ``x``; ties go to the lower id."""
    out = np.empty((queries.shape[0], k), dtype=np.int64)
    for s in range(0, queries.shape[0], chunk):
        d = pairwise(queries[s: s + chunk], x, metric)
        out[s: s + chunk] = topf(d, k).cpu().numpy()
    return out
