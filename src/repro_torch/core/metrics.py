"""Dissimilarity measures (counterpart of ``repro/core/metrics.py``).

All measures are dissimilarities: smaller is closer.  Squared L2 is used
internally and is computed through the GEMM expansion
``|a|^2 + |b|^2 - 2 a.b`` with the same term order as the reference, so
integer-valued data below 2^24 gives bit-identical results on any device.
"""
from __future__ import annotations

import torch

VALID_METRICS = ("l2", "mips", "cosine")


def check_metric(metric: str) -> None:
    if metric not in VALID_METRICS:
        raise ValueError(
            f"unknown metric {metric!r}; expected one of {VALID_METRICS}")


def clamp_zero(d: torch.Tensor) -> torch.Tensor:
    """``max(d, 0)`` that returns +0.0 (never -0.0), like ``jnp.maximum``."""
    return torch.where(d > 0, d, torch.zeros((), dtype=d.dtype, device=d.device))


def pairwise(a: torch.Tensor, b: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """Dissimilarity matrix [..., n, m] between rows of ``a`` [..., n, d] and
    ``b`` [..., m, d] (batched over leading dims)."""
    check_metric(metric)
    ip = a @ b.transpose(-1, -2)
    if metric == "mips":
        return -ip
    if metric == "cosine":
        an = torch.linalg.vector_norm(a, dim=-1)[..., :, None]
        bn = torch.linalg.vector_norm(b, dim=-1)[..., None, :]
        return 1.0 - ip / torch.clamp_min(an * bn, 1e-30)
    a2 = torch.sum(a * a, dim=-1)[..., :, None]
    b2 = torch.sum(b * b, dim=-1)[..., None, :]
    return clamp_zero(a2 + b2 - 2.0 * ip)


def point_norms(x: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """Per-point norm terms for the gather-distance path: squared norms for
    ``l2``, norms for ``cosine``, zeros for ``mips``.  Always float32."""
    check_metric(metric)
    x32 = x.to(torch.float32)
    if metric == "cosine":
        return torch.linalg.vector_norm(x32, dim=-1)
    if metric == "l2":
        return torch.sum(x32 * x32, dim=-1)
    return torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
