"""HCNNG baseline (Munoz et al. 2019) — binary partitioning + leaf MSTs
(counterpart of ``repro/core/baselines/hcnng.py``).

The partitioning-based predecessor PiPNN improves on: many replications of
disjoint binary partitioning, a degree-capped MST per leaf, union of all
edges.  No pruning — which is exactly the paper's critique (dense,
directionally-redundant adjacency lists; memory grows with replicas).
Reuses the port's partitioner and MST leaf method: the leaf distance
matrices on ``device``, Kruskal on the host.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.beam_search import medoid as _medoid
from repro_torch.core.leaf import LeafParams, build_leaf_edges
from repro_torch.core.rbc import binary_partition, leaves_to_padded
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class HCNNGParams:
    c_max: int = 1024
    replicas: int = 10          # paper notes HCNNG often needs ~30
    max_deg: int = 90           # the paper's HCNNG setting
    mst_degree_cap: int = 3
    metric: str = "l2"
    seed: int = 0


def _union(src: np.ndarray, dst: np.ndarray, dist: np.ndarray, n: int,
           max_deg: int) -> np.ndarray:
    """The reference's edge union: edges sorted by (src, dist, dst), an
    edge equal to the one before it skipped, each source's first
    ``max_deg`` kept.  Returns [n, max_deg] int32, -1 padded."""
    order = np.lexsort((dst, dist, src))
    src, dst = src[order], dst[order]
    keep = np.ones(len(src), dtype=bool)
    keep[1:] = (src[1:] != src[:-1]) | (dst[1:] != dst[:-1])
    src, dst = src[keep], dst[keep]
    # rank of each kept edge within its source's run
    first = np.searchsorted(src, src, side="left")
    rank = np.arange(len(src)) - first
    ok = rank < max_deg
    graph = np.full((n, max_deg), -1, dtype=np.int32)
    graph[src[ok], rank[ok]] = dst[ok]
    return graph


def build_hcnng(x: np.ndarray, params: HCNNGParams | None = None, *,
                device=None) -> tuple[np.ndarray, int, dict]:
    """Returns (adjacency [n, max_deg] int32 -1 padded, medoid, stats).
    ``device`` (default the card, raising without one) holds the leaf
    distance matrices."""
    dev = resolve_device(device)
    params = params or HCNNGParams()
    x = np.ascontiguousarray(x, dtype=np.float32)
    n = x.shape[0]
    t0 = time.perf_counter()
    leaves = binary_partition(
        x, c_max=params.c_max, replicas=params.replicas,
        metric=params.metric, seed=params.seed,
    )
    padded = leaves_to_padded(leaves, params.c_max)
    edges = build_leaf_edges(
        torch.from_numpy(x).to(dev), padded,
        LeafParams(method="mst", metric=params.metric,
                   mst_degree_cap=params.mst_degree_cap),
    )
    v = edges.valid()
    graph = _union(edges.src[v].cpu().numpy(), edges.dst[v].cpu().numpy(),
                   edges.dist[v].cpu().numpy(), n, params.max_deg)
    build_time = time.perf_counter() - t0
    stats = {
        "build_time": build_time,
        "avg_degree": float((graph >= 0).sum() / n),
        "n_leaves": len(leaves),
    }
    return graph, _medoid(x, seed=params.seed), stats
