"""HNSW baseline (Malkov & Yashunin 2018) — hierarchical incremental build
(counterpart of ``repro/core/baselines/hnsw.py``).

Level assignment is geometric (mult = 1/ln(M)); insertion descends with a
greedy ef=1 search to the node's level, then runs an efConstruction beam at
each level it joins, selecting M neighbors by the simple-closest heuristic
(plus the RNG 'select-neighbors-heuristic' option).  Exhibits the same
search bottleneck as Vamana.  It runs on the host (numpy) on any
``device``; the same seed gives the reference's graph.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np

from repro_torch.core.baselines.vamana import _dist, _greedy_search_visited
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class HNSWParams:
    m: int = 16                 # out-degree per layer (layer0 gets 2M)
    ef_construction: int = 64
    heuristic: bool = True      # RNG neighbor-selection heuristic
    metric: str = "l2"
    seed: int = 0


def _select_neighbors(
    x: np.ndarray, q_i: int, cand: list[int], m: int, metric: str,
    heuristic: bool,
) -> list[int]:
    cand = [c for c in dict.fromkeys(cand) if c != q_i]
    if not cand:
        return []
    d = _dist(x[q_i], x[cand], metric)
    order = np.argsort(d, kind="stable")
    if not heuristic:
        return [cand[o] for o in order[:m]]
    kept: list[int] = []
    for o in order:
        c = cand[o]
        dc = d[o]
        ok = True
        for kpt in kept:
            if _dist(x[c], x[kpt : kpt + 1], metric)[0] < dc:
                ok = False
                break
        if ok:
            kept.append(c)
            if len(kept) >= m:
                break
    # backfill with closest if heuristic kept too few
    if len(kept) < m:
        for o in order:
            if cand[o] not in kept:
                kept.append(cand[o])
                if len(kept) >= m:
                    break
    return kept


def build_hnsw(
    x: np.ndarray, params: HNSWParams | None = None, *, device=None
) -> tuple[np.ndarray, int, dict]:
    """Returns (layer-0 adjacency [n, 2M] int32 -1 padded, entry, stats).

    Querying uses the layer-0 graph from the top entry point, matching how
    the benchmarks evaluate all methods with one shared beam-search engine.
    ``device`` is resolved as every entry point's (default the card,
    raising without one); the build runs on the host whatever it names.
    """
    resolve_device(device)
    params = params or HNSWParams()
    x = np.ascontiguousarray(x, dtype=np.float32)
    n = x.shape[0]
    rng = np.random.default_rng(params.seed)
    m = params.m
    mult = 1.0 / math.log(m)
    levels = np.minimum(
        (-np.log(np.maximum(rng.random(n), 1e-12)) * mult).astype(np.int64), 8
    )
    max_level = int(levels.max())
    # adjacency per level: lists of lists
    adj: list[list[list[int]]] = [
        [[] for _ in range(n)] for _ in range(max_level + 1)
    ]
    entry = 0
    entry_level = int(levels[0])
    t0 = time.perf_counter()
    comps = 0
    for i in range(1, n):
        li = int(levels[i])
        ep = entry
        # greedy descend from the top
        for lev in range(entry_level, li, -1):
            improved = True
            while improved:
                improved = False
                nbrs = adj[lev][ep]
                if nbrs:
                    d = _dist(x[i], x[nbrs], params.metric)
                    comps += len(nbrs)
                    j = int(np.argmin(d))
                    if d[j] < _dist(x[i], x[ep : ep + 1], params.metric)[0]:
                        ep = nbrs[j]
                        improved = True
        # ef search + connect at each level from min(li, entry_level) down
        for lev in range(min(li, entry_level), -1, -1):
            adj_lists = [np.asarray(a, dtype=np.int64) for a in adj[lev]]
            visited, c = _greedy_search_visited(
                adj_lists, x, x[i], ep, params.ef_construction, params.metric
            )
            comps += c
            mm = m if lev > 0 else 2 * m
            nbrs = _select_neighbors(
                x, i, visited, mm, params.metric, params.heuristic
            )
            adj[lev][i] = list(nbrs)
            for v in nbrs:
                lst = adj[lev][v]
                if i not in lst:
                    lst.append(i)
                    if len(lst) > mm:
                        adj[lev][v] = _select_neighbors(
                            x, v, lst, mm, params.metric, params.heuristic
                        )
            if nbrs:
                ep = nbrs[0]
        if li > entry_level:
            entry, entry_level = i, li
    build_time = time.perf_counter() - t0

    width = 2 * m
    graph = np.full((n, width), -1, dtype=np.int32)
    for i in range(n):
        row = adj[0][i][:width]
        graph[i, : len(row)] = row
    stats = {
        "build_time": build_time,
        "dist_comps": comps,
        "avg_degree": float((graph >= 0).sum() / n),
        "max_level": max_level,
    }
    return graph, entry, stats
