"""Overlapping partitioning by Randomized Ball Carving (counterpart of
``repro/core/rbc.py``, the ``execution="device"`` carve).

Each subproblem samples ``l = clip(round(p_samp * |P|), 2, leader_cap)``
leaders, assigns every point to its ``fanout(depth)`` nearest leaders,
merges buckets smaller than ``c_min`` and recurses on buckets larger than
``c_max``.  The host keeps only the variable-size worklist and the numpy
RNG stream; the leader GEMM, the top-f selection and the bucket grouping
(stable sort + searchsorted) run as tensor operations on the device.  The
RNG is consumed in the reference's order (``rng.choice``, then
``_merge_small``'s permutation, then the force-split permutation), so for
a fixed seed the leaves equal the reference's whenever the distances do:
on integer-valued data below 2^24 they do on every device.

Eager PyTorch needs no fixed shapes, so the subproblem is not padded to a
power of two as the reference's jitted step is.  The static two-level
carve and the ablation partitioners are not part of the port yet.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.leader_assign import leader_assign
from repro_torch.kernels.topk import stable_argsort

_ASSIGN_ROWS = 4096   # rows per leader-GEMM sub-batch


@dataclasses.dataclass(frozen=True)
class RBCParams:
    c_max: int = 1024          # max leaf size (paper: 1024-2048)
    c_min: int = 64            # min leaf size before merging
    p_samp: float = 0.01       # leader fraction per subproblem
    leader_cap: int = 1000     # hard cap on leaders per subproblem
    fanout: Sequence[int] = (10, 3)  # fanout(depth); 1 past the schedule
    metric: str = "l2"
    seed: int = 0

    def fanout_at(self, depth: int) -> int:
        return self.fanout[depth] if depth < len(self.fanout) else 1


def _merge_small(buckets: list[np.ndarray], c_min: int, c_max: int,
                 rng: np.random.Generator) -> list[np.ndarray]:
    """Randomly merge buckets smaller than c_min, never exceeding c_max."""
    small = [b for b in buckets if len(b) < c_min]
    keep = [b for b in buckets if len(b) >= c_min]
    if not small:
        return keep
    order = rng.permutation(len(small))
    cur: list[np.ndarray] = []
    cur_len = 0
    for j in order:
        b = small[j]
        if cur_len + len(b) > c_max and cur:
            # dedupe: fanout may place a point in several merged buckets
            keep.append(np.unique(np.concatenate(cur)))
            cur, cur_len = [], 0
        cur.append(b)
        cur_len += len(b)
    if cur:
        keep.append(np.unique(np.concatenate(cur)))
    return keep


def _assign_device(xt: torch.Tensor, idx: np.ndarray, leader_pos: np.ndarray,
                   f: int, metric: str) -> tuple[np.ndarray, np.ndarray]:
    """One subproblem: positions into the row-major [m, f] assignment table
    stably sorted by leader id (``order``) and the per-leader group bounds
    (``starts``, [n_leaders + 1]).  Bucket l is
    ``idx[order[starts[l]:starts[l+1]] // f]``."""
    dev = xt.device
    idx_t = torch.from_numpy(idx).to(dev)
    leaders = xt[idx_t[torch.from_numpy(leader_pos).to(dev)]]
    a = torch.cat([leader_assign(xt[idx_t[s:s + _ASSIGN_ROWS]], leaders, f, metric=metric)
                   for s in range(0, len(idx), _ASSIGN_ROWS)])
    key = a.reshape(-1)
    order = stable_argsort(key)
    starts = torch.searchsorted(
        key[order], torch.arange(len(leader_pos) + 1, dtype=key.dtype, device=dev))
    return order.cpu().numpy(), starts.cpu().numpy()


def ball_carve(xt: torch.Tensor, params: RBCParams) -> list[np.ndarray]:
    """Algorithm 5 on the device holding ``xt`` [n, d]; returns the leaves
    as int64 arrays of point indices (overlapping)."""
    rng = np.random.default_rng(params.seed)
    n = xt.shape[0]
    leaves: list[np.ndarray] = []
    stack: list[tuple[np.ndarray, int]] = [(np.arange(n, dtype=np.int64), 0)]
    while stack:
        idx, depth = stack.pop()
        if len(idx) <= params.c_max:
            leaves.append(idx)
            continue
        n_leaders = int(np.clip(round(params.p_samp * len(idx)), 2, params.leader_cap))
        leader_pos = rng.choice(len(idx), size=n_leaders, replace=False)
        f = min(params.fanout_at(depth), n_leaders)
        order, starts = _assign_device(xt, idx, leader_pos, f, params.metric)
        buckets: list[np.ndarray] = []
        for s, e in zip(starts[:-1], starts[1:]):
            if e > s:
                buckets.append(idx[order[s:e] // f])
        buckets = _merge_small(buckets, params.c_min, params.c_max, rng)
        for b in buckets:
            if len(b) <= params.c_max:
                leaves.append(b)
            elif len(b) == len(idx):
                # no progress (duplicate-heavy data): force-split by
                # permutation halves
                perm = rng.permutation(len(b))
                half = len(b) // 2
                stack.append((b[perm[:half]], depth + 1))
                stack.append((b[perm[half:]], depth + 1))
            else:
                stack.append((b, depth + 1))
    return leaves


def leaves_to_padded(leaves: list[np.ndarray], c_max: int) -> np.ndarray:
    """Stack leaves into a dense [L, c_max] int32 matrix, -1 padded."""
    out = np.full((len(leaves), c_max), -1, dtype=np.int32)
    for i, b in enumerate(leaves):
        if len(b) > c_max:
            raise ValueError(f"leaf {i} larger than c_max ({len(b)} > {c_max})")
        out[i, : len(b)] = b
    return out


def padded_coverage(padded: np.ndarray, n: int) -> int:
    """Number of the ``n`` points that appear in at least one padded leaf."""
    seen = np.zeros(n, dtype=bool)
    seen[padded[padded >= 0]] = True
    return int(seen.sum())


def partition_padded(xt: torch.Tensor, params: RBCParams) -> np.ndarray:
    """Stage-1 entry point: the dense [L, c_max] padded leaf matrix (RBC,
    the only ported partitioner)."""
    return leaves_to_padded(ball_carve(xt, params), params.c_max)
