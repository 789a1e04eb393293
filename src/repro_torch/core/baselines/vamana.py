"""Vamana (DiskANN) baseline — incremental beam-search construction
(counterpart of ``repro/core/baselines/vamana.py``).

Faithful to Jayaram Subramanya et al. (2019) / ParlayANN's batched variant:
points are inserted in exponentially growing batches; each insertion runs a
beam search on the current graph from the medoid, RobustPrunes the visited
set to pick out-neighbors, then adds reverse edges (pruning any overfull
adjacency list).  Standard two-pass schedule: pass 1 with alpha=1, pass 2
with the target alpha.

This code deliberately exhibits the paper's *search bottleneck*: every
insert is a serial, latency-bound walk over the partial graph.  It runs on
the host (numpy) on any ``device``; the same seed gives the reference's
graph.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core.beam_search import medoid as _medoid
from repro_torch.core.robust_prune import robust_prune_np
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class VamanaParams:
    max_deg: int = 32          # R
    beam: int = 64             # L (construction beam width)
    alpha: float = 1.2         # on true distance; squared internally for l2
    passes: int = 1            # 1-pass or 2-pass (Sec. 5.2 comparisons)
    metric: str = "l2"
    seed: int = 0

    def effective_alpha(self) -> float:
        if self.metric == "l2":
            return self.alpha ** 2
        if self.metric == "mips":
            return 1.0
        return self.alpha


def _dist(q: np.ndarray, pts: np.ndarray, metric: str) -> np.ndarray:
    if metric == "mips":
        return -(pts @ q)
    if metric == "cosine":
        return 1.0 - (pts @ q) / np.maximum(
            np.linalg.norm(pts, axis=1) * np.linalg.norm(q), 1e-30
        )
    diff = pts - q[None, :]
    return np.sum(diff * diff, axis=1)


def _greedy_search_visited(
    adj: list[np.ndarray], x: np.ndarray, q: np.ndarray, start: int,
    beam: int, metric: str,
) -> tuple[list[int], int]:
    """Beam search returning the VISITED set (Vamana's candidate pool)."""
    import heapq

    d0 = float(_dist(q, x[start : start + 1], metric)[0])
    frontier = [(d0, start)]
    in_beam = {start: d0}
    visited: dict[int, float] = {}
    comps = 1
    while frontier:
        d, p = heapq.heappop(frontier)
        if p in visited or p not in in_beam:
            continue
        visited[p] = d
        nbrs = adj[p]
        new = [v for v in nbrs if v not in in_beam and v not in visited]
        if len(new):
            nd = _dist(q, x[new], metric)
            comps += len(new)
            for v, dv in zip(new, nd):
                in_beam[v] = float(dv)
                heapq.heappush(frontier, (float(dv), v))
        if len(in_beam) > beam:
            items = sorted(in_beam.items(), key=lambda kv: (kv[1], kv[0]))[:beam]
            in_beam = dict(items)
    return list(visited.keys()), comps


def build_vamana(
    x: np.ndarray, params: VamanaParams | None = None, *, device=None
) -> tuple[np.ndarray, int, dict]:
    """Returns (adjacency [n, R] int32 -1-padded, medoid, stats).
    ``device`` is resolved as every entry point's (default the card,
    raising without one); the build runs on the host whatever it names."""
    resolve_device(device)
    params = params or VamanaParams()
    x = np.ascontiguousarray(x, dtype=np.float32)
    n = x.shape[0]
    rng = np.random.default_rng(params.seed)
    r = params.max_deg
    alpha_final = params.effective_alpha()
    start = _medoid(x, seed=params.seed)

    # random initial graph (DiskANN init): R/2 random out-edges
    adj: list[np.ndarray] = [
        rng.choice(n, size=min(r // 2, n - 1), replace=False) for _ in range(n)
    ]
    for i in range(n):
        adj[i] = adj[i][adj[i] != i]

    total_comps = 0
    t0 = time.perf_counter()
    order = rng.permutation(n)
    for p_i, alpha in enumerate(
        [1.0] * (params.passes - 1) + [alpha_final]
    ):
        for i in order:
            visited, comps = _greedy_search_visited(
                adj, x, x[i], start, params.beam, params.metric
            )
            total_comps += comps
            cand = np.asarray(
                [v for v in visited if v != i] + adj[i].tolist(), dtype=np.int64
            )
            kept = robust_prune_np(
                x[i], cand, x, alpha=alpha, r=r, metric=params.metric
            )
            adj[i] = kept
            # reverse edges
            for v in kept:
                if i in adj[v]:
                    continue
                lst = np.append(adj[v], i)
                if len(lst) > r:
                    lst = robust_prune_np(
                        x[v], lst, x, alpha=alpha, r=r, metric=params.metric
                    )
                adj[v] = lst
    build_time = time.perf_counter() - t0

    graph = np.full((n, r), -1, dtype=np.int32)
    for i in range(n):
        graph[i, : len(adj[i])] = adj[i][:r]
    stats = {
        "build_time": build_time,
        "dist_comps": total_comps,
        "avg_degree": float((graph >= 0).sum() / n),
    }
    return graph, start, stats
