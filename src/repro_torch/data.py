"""Synthetic vectors for PiPNN (copies of ``make_vectors`` and
``make_queries`` from ``repro/data/pipeline.py``), plus the SIFT-like
integer transform and dyadic hyperplanes used for exact cross-device
checks.

With ``sift_like`` data (integers in [0, 255]) at d = 128, every norm, dot
product and squared distance is an integer below 2^24, so it is exact in
float32 in any summation order; with ``dyadic_hyperplanes`` (multiples of
1/16) every sketch is exact too.  Builds on the card and on the CPU then
agree bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class VectorPipelineConfig:
    n: int
    dim: int
    n_clusters: int = 32
    cluster_scale: float = 2.0
    seed: int = 0


def make_vectors(cfg: VectorPipelineConfig) -> np.ndarray:
    """Gaussian-mixture embedding-like vectors (the ANN benchmark data)."""
    rng = np.random.default_rng(cfg.seed)
    centers = rng.standard_normal((cfg.n_clusters, cfg.dim)) * cfg.cluster_scale
    assign = rng.integers(0, cfg.n_clusters, cfg.n)
    x = centers[assign] + rng.standard_normal((cfg.n, cfg.dim))
    return x.astype(np.float32)


def make_queries(cfg: VectorPipelineConfig, n_queries: int) -> np.ndarray:
    rng = np.random.default_rng(cfg.seed + 1)
    centers = np.random.default_rng(cfg.seed).standard_normal(
        (cfg.n_clusters, cfg.dim)) * cfg.cluster_scale
    assign = rng.integers(0, cfg.n_clusters, n_queries)
    q = centers[assign] + rng.standard_normal((n_queries, cfg.dim))
    return q.astype(np.float32)


def sift_like(v: np.ndarray) -> np.ndarray:
    """Map Gaussian-mixture vectors onto SIFT's integer range [0, 255]."""
    return np.clip(np.round(v * 16 + 128), 0, 255).astype(np.float32)


def dyadic_hyperplanes(seed: int, m: int, d: int) -> np.ndarray:
    """Seeded Gaussian hyperplanes [m, d] rounded to multiples of 1/16."""
    g = np.random.default_rng(seed).standard_normal((m, d))
    return (np.round(g * 16) / 16).astype(np.float32)
