"""Leader assignment, the Stage-1 inner step (counterpart of
``repro/core/leader_assign.py`` on its ``use_pallas=False`` path).

The dissimilarity matrix between a block of points and the leaders is one
GEMM with the same term order as the reference, and the top-f selection
keeps ``lax.top_k``'s tie rule (equal distances go to the lower leader
index).  The GEMM stays ``torch.matmul``: the reference leaves it to XLA.
"""
from __future__ import annotations

import torch

from repro_torch.core.metrics import pairwise
from repro_torch.kernels.topk import topf

__all__ = ["leader_dists", "leader_assign", "topf"]


def leader_dists(points: torch.Tensor, leaders: torch.Tensor,
                 *, metric: str = "l2") -> torch.Tensor:
    """Dissimilarity matrix [..., n, l] between ``points`` [..., n, d] and
    ``leaders`` [..., l, d]."""
    return pairwise(points, leaders, metric)


def leader_assign(points: torch.Tensor, leaders: torch.Tensor, f: int, *,
                  metric: str = "l2", point_valid: torch.Tensor | None = None,
                  leader_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Indices [..., n, f] (int32) of each point's f nearest leaders,
    ascending by dissimilarity, ties to the lower leader index.  Invalid
    leaders are masked to +inf; invalid points see an all-inf row."""
    d = leader_dists(points, leaders, metric=metric)
    inf = torch.full((), float("inf"), device=d.device)
    if leader_valid is not None:
        d = torch.where(leader_valid[..., None, :], d, inf)
    if point_valid is not None:
        d = torch.where(point_valid[..., :, None], d, inf)
    return topf(d, f)
