"""Synthetic data (copies from ``repro/data/pipeline.py``): the LM token
pipeline (``TokenPipeline``) and the vectors for PiPNN (``make_vectors``,
``make_queries``), plus the SIFT-like integer transform and dyadic
hyperplanes used for exact cross-device checks.

Token batches are counter-based: batch ``i`` is a pure function of (seed,
i, shard), so a restart resumes from the step counter alone and each
data-parallel shard makes only its rows.  They follow a Zipfian unigram
distribution with a planted "grammar" (every 4th token repeats the token
two before it), so an LM's loss falls in a few steps.

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
class TokenPipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.1


def _zipf_probs(vocab: int, alpha: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** -alpha
    return (p / p.sum()).astype(np.float64)


class TokenPipeline:
    """``batch(step) -> {tokens, labels}`` (int32 [B / n_shards, T] numpy);
    pure in (seed, step, shard)."""

    def __init__(self, cfg: TokenPipelineConfig, shard: tuple[int, int] = (0, 1)):
        self.cfg = cfg
        self.shard_idx, self.n_shards = shard
        if cfg.global_batch % self.n_shards:
            raise ValueError(f"global batch {cfg.global_batch} % shards {self.n_shards}")
        self.local_batch = cfg.global_batch // self.n_shards
        self._probs = _zipf_probs(cfg.vocab, cfg.zipf_alpha)
        self._cum = np.cumsum(self._probs)

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence(entropy=cfg.seed, spawn_key=(step, self.shard_idx)))
        u = rng.random((self.local_batch, cfg.seq_len + 1))
        toks = np.searchsorted(self._cum, u).astype(np.int32)
        toks = np.minimum(toks, cfg.vocab - 1)
        # plant learnable structure: every 4th token repeats (t-2)'s token
        toks[:, 4::4] = toks[:, 2:-2:4]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


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
