"""Residualized LSH sketches (counterpart of ``repro/core/sketch.py``).

HashPrune's residual hash of candidate ``c`` for point ``p`` is the packed
sign pattern of ``H (c - p)``.  With sketches ``Sketch(v) = v @ H.T``
precomputed once, ``H_i.(c - p) = Sketch(c)[i] - Sketch(p)[i]``.

The reference draws its hyperplanes from ``jax.random``, whose bits the
port cannot reproduce; ``make_hyperplanes`` draws from a seeded numpy
generator on the host instead, so the card and the CPU get the same
planes from one seed.  ``pipnn.build`` also takes hyperplanes as data.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.edge_hash import edge_hashes

MAX_BITS = 16


def make_hyperplanes(seed: int, m: int, d: int) -> np.ndarray:
    """``m`` Gaussian hyperplane normals [m, d] float32, from a numpy
    generator seeded with ``seed``."""
    if not 1 <= m <= MAX_BITS:
        raise ValueError(f"m must be in [1, {MAX_BITS}], got {m}")
    return np.random.default_rng(seed).standard_normal((m, d)).astype(np.float32)


def sketch(x: torch.Tensor, hyperplanes: torch.Tensor) -> torch.Tensor:
    """Project points [..., d] onto hyperplanes [m, d] -> sketches [..., m]."""
    return x @ hyperplanes.T


def hash_from_sketches(cand_sketch: torch.Tensor,
                       point_sketch: torch.Tensor) -> torch.Tensor:
    """Packed residual hash [...] int32: bit i is ``cand[i] - point[i] >= 0``."""
    bits = (cand_sketch - point_sketch) >= 0.0
    m = bits.shape[-1]
    pow2 = 2 ** torch.arange(m, dtype=torch.int32, device=bits.device)
    return torch.sum(bits.to(torch.int32) * pow2, dim=-1, dtype=torch.int32)


def edge_hashes_from_ids(sketches: torch.Tensor, src: torch.Tensor,
                         dst: torch.Tensor) -> torch.Tensor:
    """Residual hashes h_src(dst) [E] int32 for a flat edge list (padding
    ids read row 0).  On the card this is the fused gather + hash kernel."""
    return edge_hashes(sketches, src, dst)
