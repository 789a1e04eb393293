"""Downstream task (Sec. 5.2, Fig. 6): approximate k-NN graph construction
(counterpart of ``repro/core/knn_graph.py``).

Build a PiPNN index, then query it with every dataset point; the target is
>= 95% recall of the true k-NN edges.  Index build time counts toward the
end-to-end metric.  On the card the build runs the leaf, hash and merge
kernels and the search the gather kernel.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import pipnn as _pipnn
from repro_torch.core.beam_search import brute_force_knn, recall_at_k
from repro_torch.device import resolve_device, synchronize


def _drop_self(found: np.ndarray, rows: np.ndarray, k: int) -> np.ndarray:
    """Each row of ``found`` without its own id ``rows[i]``, in order, cut
    or -1-padded to ``k``."""
    keep = found != rows[:, None]
    order = np.argsort(~keep, axis=1, kind="stable")
    out = np.take_along_axis(found, order, axis=1)
    out = np.where(np.arange(found.shape[1])[None] < keep.sum(1)[:, None], out, -1)
    if out.shape[1] < k:
        out = np.pad(out, ((0, 0), (0, k - out.shape[1])), constant_values=-1)
    return out[:, :k].astype(np.int64)


def knn_graph_pipnn(x: np.ndarray, *, k: int = 10, beam: int = 32,
                    params: "_pipnn.PiPNNParams | None" = None,
                    device=None) -> tuple[np.ndarray, dict[str, float]]:
    """Returns ([n, k] neighbour ids excluding self, int64; timing dict
    with "build", "query" and "total" seconds).  ``device`` defaults to
    the card and raises without one."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    index = _pipnn.build(x, params, device=dev)
    synchronize(dev)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    # query with k+1 then drop self hits
    found = _pipnn.search(index, x, x, k=k + 1, beam=max(beam, k + 1), device=dev)
    t_query = time.perf_counter() - t0
    out = _drop_self(np.asarray(found), np.arange(x.shape[0]), k)
    return out, {"build": t_build, "query": t_query, "total": t_build + t_query}


def knn_graph_recall(x: np.ndarray, knn: np.ndarray, k: int = 10, metric: str = "l2",
                     sample: int = 2000, seed: int = 0, device=None) -> float:
    """Recall of the k-NN graph against exact ground truth on a point
    sample (the exact k + 1 nearest by brute force on ``device``, self
    dropped)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    idx = rng.choice(n, size=min(sample, n), replace=False)
    xt = torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32), device=dev)
    truth = brute_force_knn(xt, xt[torch.as_tensor(idx, device=dev)], k + 1, metric=metric)
    return recall_at_k(np.asarray(knn)[idx], _drop_self(truth, idx, k), k=k)
