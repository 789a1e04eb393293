"""Leaf building (counterpart of ``repro/core/leaf.py``, the streaming
k-NN half): per leaf of the partition, each point's k nearest co-leaf
points, emitted as bidirected candidate edges.

Leaves are rows of a dense [L, c_max] id matrix with -1 padding.  The leaf
k-NN runs on the leaf ids directly (``kernels.leaf_knn.leaf_topk``
gathers its own rows), which is the ``leaf_knn_jax`` contract applied to
``points[ids]``.  Only the paper's default method, ``bidirected`` k-NN, is
ported, so ``LeafParams`` has no method field yet.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.leaf_knn import leaf_topk


@dataclasses.dataclass(frozen=True)
class LeafParams:
    k: int = 2                  # leaf k-NN parameter (paper default 2)


def iter_leaf_id_chunks(leaves_padded: torch.Tensor, chunk: int):
    """Yield fixed-shape [chunk, c_max] int32 blocks of ``leaves_padded``;
    the last block is -1-padded."""
    nleaves, c = leaves_padded.shape
    chunk = max(1, chunk)
    for s in range(0, nleaves, chunk):
        ids = leaves_padded[s: s + chunk]
        short = chunk - ids.shape[0]
        if short:
            pad = torch.full((short, c), -1, dtype=torch.int32, device=ids.device)
            ids = torch.cat([ids, pad])
        yield ids


def check_k(k: int) -> None:
    """Raise ``ValueError`` unless the leaf k-NN parameter is at least 1 (the
    reference fails on k < 1 too; k = 0 would build an edgeless graph)."""
    if k < 1:
        raise ValueError(f"LeafParams.k must be at least 1, got {k}")


def leaf_knn(points: torch.Tensor, leaf_ids: torch.Tensor, *, k: int,
             metric: str = "l2"):
    """Per leaf, the k nearest co-leaf neighbours of every point (k >= 1; on
    the card k <= ``kernels.leaf_knn.MAX_K``).

    Returns (in-leaf positions [B, C, k], dists [B, C, k]); padding rows and
    missing neighbours are (-1, +inf), ties go to the lower position."""
    check_k(k)
    return leaf_topk(points, leaf_ids, k, metric)


def emit_knn_edges(leaf_ids: torch.Tensor, nbr_idx: torch.Tensor,
                   nbr_dist: torch.Tensor):
    """Flat bidirected candidate edges (src, dst, dist), each [2*B*C*k];
    invalid slots are (-1, -1, +inf).  No self loops."""
    b, c, k = nbr_idx.shape
    rows = leaf_ids[:, :, None].expand(b, c, k)
    cols = torch.gather(leaf_ids, 1,
                        nbr_idx.clamp_min(0).long().reshape(b, c * k)).reshape(b, c, k)
    ok = (nbr_idx >= 0) & (rows >= 0) & (rows != cols)
    src = torch.where(ok, rows, -1).reshape(-1)
    dst = torch.where(ok, cols, -1).reshape(-1)
    dist = torch.where(ok, nbr_dist, torch.full((), float("inf"),
                                                device=nbr_dist.device)).reshape(-1)
    return torch.cat([src, dst]), torch.cat([dst, src]), torch.cat([dist, dist])
