"""RobustPrune (counterpart of ``repro/core/robust_prune.py``): the
sequential numpy oracle ``robust_prune_np``, the batch-vectorised greedy
over candidate ranks, and PiPNN's final pass (Sec. 4.3) that prunes every
point's HashPrune reservoir (``final_prune``, and its host-looped oracle
``final_prune_host``).

The reference's ``lax.scan`` over candidate ranks is a Python loop over
the ranks here, each step one set of tensor operations over all rows at
once.  Rows are independent, so the chunk size of ``final_prune`` changes
no result; each ``final_prune_step`` writes its rows into preallocated
[n, max_deg] tensors in place.  ``final_prune_workspace_bytes`` models a
step's device bytes (``analysis.memory_audit``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hashprune import INVALID_ID, Reservoir
from repro_torch.core.metrics import pairwise
from repro_torch.kernels.topk import lex_key, ordered, stable_argsort


def robust_prune_np(p: np.ndarray, cand_ids: np.ndarray, x: np.ndarray, *,
                    alpha: float = 1.2, r: int = 64, metric: str = "l2") -> np.ndarray:
    """Sequential Algorithm 2 on the host (numpy).  Returns the kept
    candidate ids (<= r), int64."""
    cand_ids = np.unique(cand_ids[cand_ids >= 0])
    if cand_ids.size == 0:
        return cand_ids
    c = x[cand_ids]
    if metric == "mips":
        d_pc = -(c @ p)
    elif metric == "cosine":
        d_pc = 1.0 - (c @ p) / np.maximum(
            np.linalg.norm(c, axis=1) * np.linalg.norm(p), 1e-30)
    else:
        diff = c - p[None, :]
        d_pc = np.sum(diff * diff, axis=1)
    order = np.lexsort((cand_ids, d_pc))  # (dist, id)
    kept: list[int] = []
    alive = np.ones(len(cand_ids), dtype=bool)
    for oi in order:
        if not alive[oi]:
            continue
        kept.append(cand_ids[oi])
        if len(kept) >= r:
            break
        # prune candidates dominated by the newly kept point
        if metric == "mips":
            d_jc = -(c @ c[oi])
        elif metric == "cosine":
            d_jc = 1.0 - (c @ c[oi]) / np.maximum(
                np.linalg.norm(c, axis=1) * np.linalg.norm(c[oi]), 1e-30)
        else:
            diff = c - c[oi][None, :]
            d_jc = np.sum(diff * diff, axis=1)
        alive &= ~(alpha * d_jc <= d_pc)
    return np.asarray(kept, dtype=np.int64)


def robust_prune_mask(d_pc: torch.Tensor, d_cc: torch.Tensor,
                      cand_ids: torch.Tensor, *, alpha: float = 1.2,
                      max_deg: int = 64, cc_rows: torch.Tensor | None = None) -> torch.Tensor:
    """Vectorised RobustPrune.  ``d_pc`` [B, C] point->candidate (+inf
    invalid), ``d_cc`` [B, C, C] candidate->candidate, ``cand_ids`` [B, C]
    for the (dist, id) order.  Returns the keep mask [B, C].

    With ``cc_rows`` ([B] int64), row b reads the candidate matrix
    ``d_cc[cc_rows[b]]`` instead (the leaf form: every point of a leaf
    shares its leaf's matrix, so ``d_cc`` is [leaves, C, C])."""
    bsz, c = d_pc.shape
    dev = d_pc.device
    big = torch.where(cand_ids == INVALID_ID, 2 ** 30, cand_ids)
    order = stable_argsort(lex_key(ordered(d_pc), big))
    finite_sorted = torch.isfinite(torch.gather(d_pc, 1, order))
    alpha_t = torch.tensor(alpha, dtype=torch.float32, device=dev)
    alive = torch.isfinite(d_pc)
    keep = torch.zeros_like(alive)
    count = torch.zeros(bsz, dtype=torch.int32, device=dev)
    b = torch.arange(bsz, device=dev)
    m = b if cc_rows is None else cc_rows
    for r in range(c):
        j = order[:, r]
        valid = finite_sorted[:, r] & alive[b, j] & (count < max_deg)
        keep[b, j] |= valid
        count += valid.to(torch.int32)
        # dominance: alpha * d(j, c) <= d(p, c), on the stored dissimilarity
        dom = alpha_t * d_cc[m, j, :] <= d_pc
        alive &= ~(dom & valid[:, None])
    return keep


def prune_reservoir_block(ids: torch.Tensor, dists: torch.Tensor,
                          d_cc: torch.Tensor, *, alpha: float, max_deg: int):
    """RobustPrune a reservoir block [B, L]; returns ([B, max_deg] ids with
    -1 padding, [B, max_deg] dists with +inf padding), rows sorted by
    (dist, id)."""
    inf = torch.full((), float("inf"), device=dists.device)
    d_pc = torch.where(ids == INVALID_ID, inf, dists)
    keep = robust_prune_mask(d_pc, d_cc, ids, alpha=alpha, max_deg=max_deg)
    k_d = torch.where(keep, d_pc, inf)
    q = stable_argsort(lex_key(ordered(k_d), ids))
    s_d, s_i = torch.gather(k_d, 1, q), torch.gather(ids, 1, q)
    l = ids.shape[-1]
    if l >= max_deg:
        s_d, s_i = s_d[:, :max_deg], s_i[:, :max_deg]
    else:
        pf = torch.nn.functional.pad
        s_d = pf(s_d, (0, max_deg - l), value=float("inf"))
        s_i = pf(s_i, (0, max_deg - l), value=INVALID_ID)
    return torch.where(torch.isfinite(s_d), s_i, INVALID_ID), s_d


def final_prune_step(x: torch.Tensor, res_ids: torch.Tensor, res_dists: torch.Tensor,
                     out_ids: torch.Tensor, out_d: torch.Tensor, start: int, *,
                     alpha: float, max_deg: int, metric: str, chunk: int):
    """One step of ``final_prune``: reservoir rows ``[start, start + chunk)``
    pruned and written into ``out_ids`` / ``out_d`` in place (the
    reference's donated buffers); returns them."""
    ids = res_ids[start:start + chunk]
    cvecs = x[ids.clamp_min(0).long()]                       # [chunk, L, d]
    d_cc = pairwise(cvecs, cvecs, metric)
    del cvecs
    out_ids[start:start + chunk], out_d[start:start + chunk] = prune_reservoir_block(
        ids, res_dists[start:start + chunk], d_cc, alpha=alpha, max_deg=max_deg)
    return out_ids, out_d


def final_prune_workspace_bytes(chunk: int, l_max: int, d: int, max_deg: int) -> int:
    """Modeled device temp bytes of one ``final_prune_step`` (B = ``chunk``
    rows, L = ``l_max``): the gathered [B, L, d] candidate vectors and the
    four [B, L, L] float32 buffers ``metrics.pairwise`` holds at once
    (the products, the norm sum, their doubled copy and the difference),
    then the greedy's keys, masks and its two sorts (96 B a candidate) and
    the [B, max_deg] rows before they are written out.  Chunk-shaped only:
    the [n, max_deg] outputs are written in place."""
    gathered = chunk * l_max * d * 4
    d_cc = 4 * chunk * l_max * l_max * 4
    greedy = chunk * l_max * 96 + chunk * max_deg * 12
    return gathered + d_cc + greedy


def final_prune(x: torch.Tensor, res: Reservoir, *, alpha: float = 1.2,
                max_deg: int = 64, metric: str = "l2", chunk: int = 16384):
    """Sec. 4.3 final pass: RobustPrune every reservoir, ``chunk`` rows at a
    time (``final_prune_step``), into [n, max_deg] (int32 adjacency with -1
    padding, float32 dists with +inf padding) on ``x``'s device."""
    n = res.ids.shape[0]
    chunk = max(1, min(chunk, n))
    out_ids = torch.full((n, max_deg), INVALID_ID, dtype=torch.int32, device=x.device)
    out_d = torch.full((n, max_deg), float("inf"), dtype=torch.float32, device=x.device)
    for s in range(0, n, chunk):
        final_prune_step(x, res.ids, res.dists, out_ids, out_d, s, alpha=alpha,
                         max_deg=max_deg, metric=metric, chunk=chunk)
    return out_ids, out_d


def final_prune_host(x: torch.Tensor, res: Reservoir, *, alpha: float = 1.2,
                     max_deg: int = 64, metric: str = "l2", chunk: int = 2048):
    """Host-looped final pass (the reference's pre-streaming oracle): each
    ``chunk`` of reservoir rows is pruned on ``x``'s device and copied to
    the host at once.  Returns numpy ([n, max_deg] int32 ids with -1
    padding, [n, max_deg] float32 dists with +inf padding), equal to
    ``final_prune``'s."""
    n, l = res.ids.shape
    out_ids = np.full((n, max_deg), INVALID_ID, dtype=np.int32)
    out_d = np.full((n, max_deg), np.inf, dtype=np.float32)
    inf = torch.full((), float("inf"), device=x.device)
    w = min(max_deg, l)
    for s in range(0, n, chunk):
        ids = res.ids[s:s + chunk]
        cvecs = x[ids.clamp_min(0).long()]
        d_cc = pairwise(cvecs, cvecs, metric)
        d_pc = torch.where(ids == INVALID_ID, inf, res.dists[s:s + chunk])
        keep = robust_prune_mask(d_pc, d_cc, ids, alpha=alpha, max_deg=max_deg)
        # compact kept entries to the front: sort by (dist-if-kept, id)
        k_d = torch.where(keep, d_pc, inf)
        q = stable_argsort(lex_key(ordered(k_d), ids))
        out_ids[s:s + chunk, :w] = torch.gather(ids, 1, q)[:, :w].cpu().numpy()
        out_d[s:s + chunk, :w] = torch.gather(k_d, 1, q)[:, :w].cpu().numpy()
    out_ids[~np.isfinite(out_d)] = INVALID_ID
    return out_ids, out_d
