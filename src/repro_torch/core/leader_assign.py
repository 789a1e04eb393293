"""Leader assignment, the Stage-1 inner step (counterpart of
``repro/core/leader_assign.py``).

The dissimilarity matrix between a block of points and the leaders is one
GEMM with the same term order as the reference, and the top-f selection
keeps ``lax.top_k``'s tie rule (equal distances go to the lower leader
index).  The GEMM stays ``torch.matmul``: the reference leaves it to XLA.

``use_kernels=True`` is the counterpart of the reference's
``use_pallas=True``: the matrix comes from the ``pairwise_distance`` kernel
and the selection from the ``rowwise_topk`` kernel, whose ids are -1 where
a row has fewer than ``f`` finite entries.  The static Stage-1 carve
(``rbc.ball_carve_device``) and the distributed build
(``launch.build_index``) take it at both levels; the worklist carve keeps
the ``topf`` route.
"""
from __future__ import annotations

import torch

from repro_torch.core.metrics import pairwise
from repro_torch.kernels.distance import pairwise_distance
from repro_torch.kernels.topk import rowwise_topk, topf

__all__ = ["leader_dists", "leader_assign", "topf"]


def leader_dists(points: torch.Tensor, leaders: torch.Tensor,
                 *, metric: str = "l2") -> torch.Tensor:
    """Dissimilarity matrix [..., n, l] between ``points`` [..., n, d] and
    ``leaders`` [..., l, d]."""
    return pairwise(points, leaders, metric)


def leader_assign(points: torch.Tensor, leaders: torch.Tensor, f: int, *,
                  metric: str = "l2", point_valid: torch.Tensor | None = None,
                  leader_valid: torch.Tensor | None = None,
                  use_kernels: bool = False) -> torch.Tensor:
    """Indices [..., n, f] (int32) of each point's f nearest leaders,
    ascending by dissimilarity, ties to the lower leader index.  Invalid
    leaders are masked to +inf; invalid points see an all-inf row.

    ``use_kernels`` routes the matrix through ``kernels.distance.
    pairwise_distance`` and the selection through ``kernels.topk.
    rowwise_topk`` (2-D inputs run as a batch of one); the ids are then -1
    where fewer than ``f`` entries of a row are finite."""
    if use_kernels:
        pb = points.reshape((-1,) + points.shape[-2:])
        lb = leaders.reshape((-1,) + leaders.shape[-2:])
        d = pairwise_distance(pb.contiguous(), lb.contiguous(), metric)
        d = d.reshape(points.shape[:-1] + (leaders.shape[-2],))
    else:
        d = leader_dists(points, leaders, metric=metric)
    inf = torch.full((), float("inf"), device=d.device)
    if leader_valid is not None:
        d = torch.where(leader_valid[..., None, :], d, inf)
    if point_valid is not None:
        d = torch.where(point_valid[..., :, None], d, inf)
    if use_kernels:
        ids, _ = rowwise_topk(d.reshape((-1,) + d.shape[-2:]).contiguous(), f)
        return ids.reshape(d.shape[:-1] + (f,))
    return topf(d, f)
