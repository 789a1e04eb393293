"""Overlapping partitioning (counterpart of ``repro/core/rbc.py``): Randomized
Ball Carving with multi-level fanout, and the Appendix A.1 ablation
partitioners.

Each RBC subproblem samples ``l = clip(round(p_samp * |P|), 2, leader_cap)``
leaders, assigns every point to its ``fanout(depth)`` nearest leaders,
merges buckets smaller than ``c_min`` and recurses on buckets larger than
``c_max``.  Stage-1 strategies, selected by ``RBCParams.execution``:

  * ``"host"`` — the numpy oracle: the recursion with every step in numpy.
  * ``"device"`` — the same worklist on the host, with the leader GEMM,
    the top-f selection and the bucket grouping (stable sort +
    searchsorted) as tensor operations on the device holding the points.
    The RNG is consumed in the oracle's order (``rng.choice``, then
    ``_merge_small``'s permutation, then the force-split permutation), so
    for a fixed seed the leaves equal the oracle's whenever the distances
    do: on integer-valued data below 2^24 they do on every device.
  * ``"static"`` — ``ball_carve_device``: a two-level carve with no host
    recursion.  Level 0 assigns every point to its ``f0`` nearest of
    ``l0`` leaders plus ``bucket_spill`` next-nearest, groups the
    placements into ``[l0, cap_b]`` buckets by capacity (primaries claim
    capacity before spills), picks ``l1`` strided leaders in each bucket,
    assigns each bucket's points to their ``f1`` nearest and groups the
    placements into ``[l0 * l1, c_max]`` leaves by capacity.  Both levels
    go through ``leader_assign(use_kernels=True)``: the ``pairwise_distance``
    and ``rowwise_topk`` kernels on the card, their plain versions on the
    CPU.  The host samples the level-0 leaders, copies the finished matrix
    back once and appends salvage leaves for points that lost every
    replica.  The matrix equals the reference's for a fixed seed whenever
    the distances do.
  * ``"auto"`` — ``"device"`` for points on a CUDA device, ``"host"`` for
    points on the CPU (the reference decides by the jax backend).

Eager PyTorch needs no fixed shapes, so the worklist's subproblems are not
padded to powers of two as the reference's jitted step is, and the static
carve takes blocks of its own size (``_BLOCK_ROWS``) where the reference
takes ``carve_chunks``'s: the assignment is row-independent, so the block
size changes no result.  The static carve keeps ``carve_chunks``'s padded
point count, because the Weyl order of the capacity routing depends on
the number of entries.

The ablation partitioners (binary, hierarchical k-means, sorting-LSH) run
in numpy on the host, as in the reference.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Literal, Sequence

import numpy as np
import torch

from repro_torch.core.leader_assign import leader_assign
from repro_torch.distributed.routing import group_by_capacity, weyl_order
from repro_torch.kernels.topk import stable_argsort

# points gathered per leader-assignment block of the static carve: 2 GiB of
# float32 distances against 1,000 leaders, 256 MiB of rows at d = 128
_BLOCK_ROWS = 1 << 19


@dataclasses.dataclass(frozen=True)
class RBCParams:
    c_max: int = 1024          # max leaf size (paper: 1024-2048)
    c_min: int = 64            # min leaf size before merging
    p_samp: float = 0.01       # leader fraction per subproblem
    leader_cap: int = 1000     # hard cap on leaders per subproblem
    fanout: Sequence[int] = (10, 3)  # fanout(depth); 1 past the schedule
    replicas: int = 1          # independent RBC runs (quality knob, Sec. 5.2)
    metric: str = "l2"
    seed: int = 0
    execution: str = "auto"    # "auto" | "host" | "device" | "static"
    assign_rows: int = 4096    # device worklist: leader-GEMM sub-batch rows
    bucket_slack: float = 1.5  # static: level-0 bucket capacity slack
    bucket_spill: int = 2      # static: next-nearest leaders each point also
    #                            routes to; their replicas only claim capacity
    #                            the primaries left
    leaf_fill: float = 0.55    # static: target mean leaf fill (sizes l1)

    def fanout_at(self, depth: int) -> int:
        return self.fanout[depth] if depth < len(self.fanout) else 1


def resolve_execution(params: RBCParams, device) -> str:
    """``params.execution``, with ``"auto"`` resolved by the device that
    holds the points: ``"device"`` on CUDA, ``"host"`` on the CPU."""
    if params.execution != "auto":
        return params.execution
    return "device" if torch.device(device).type == "cuda" else "host"


def _host_f32(xt: torch.Tensor) -> np.ndarray:
    return xt.detach().to("cpu", torch.float32).numpy()


# ---------------------------------------------------------------------------
# The recursive carve: host oracle and device assignment
# ---------------------------------------------------------------------------

def _pairwise_np(a: np.ndarray, b: np.ndarray, metric: str) -> np.ndarray:
    """Host GEMM-expansion distance matrix (numpy mirror of metrics.pairwise)."""
    ip = a @ b.T
    if metric == "mips":
        return -ip
    if metric == "cosine":
        an = np.linalg.norm(a, axis=-1, keepdims=True)
        bn = np.linalg.norm(b, axis=-1, keepdims=True)
        return 1.0 - ip / np.maximum(an * bn.T, 1e-30)
    a2 = np.sum(a * a, axis=-1)[:, None]
    b2 = np.sum(b * b, axis=-1)[None, :]
    return np.maximum(a2 + b2 - 2.0 * ip, 0.0)


def _nearest_leaders(x: np.ndarray, leaders: np.ndarray, k: int, metric: str) -> np.ndarray:
    """Indices [n, k] of the k nearest leaders of each row of x, ascending,
    ties to the lower leader index (``lax.top_k``'s order)."""
    d = _pairwise_np(x, leaders, metric)
    k = min(k, leaders.shape[0])
    return np.argsort(d, axis=1, kind="stable")[:, :k]


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


# Both assignment backends take one subproblem (idx, leader_pos, f) and
# return positions into the row-major [m, f] assignment table stably sorted
# by leader id (``order``) and the per-leader group bounds (``starts``,
# [n_leaders + 1]): bucket l is ``idx[order[starts[l]:starts[l+1]] // f]``.

def _assign_host(x: np.ndarray, idx: np.ndarray, leader_pos: np.ndarray, f: int, *,
                 metric: str) -> tuple[np.ndarray, np.ndarray]:
    assign = _nearest_leaders(x[idx], x[idx[leader_pos]], f, metric)   # [m, f]
    flat = assign.reshape(-1)
    order = np.argsort(flat, kind="stable")
    starts = np.searchsorted(flat[order], np.arange(len(leader_pos) + 1))
    return order, starts


def _assign_device(xt: torch.Tensor, idx: np.ndarray, leader_pos: np.ndarray, f: int, *,
                   metric: str, rows: int) -> tuple[np.ndarray, np.ndarray]:
    dev = xt.device
    idx_t = torch.from_numpy(idx).to(dev)
    leaders = xt[idx_t[torch.from_numpy(leader_pos).to(dev)]]
    a = torch.cat([leader_assign(xt[idx_t[s:s + rows]], leaders, f, metric=metric)
                   for s in range(0, len(idx), rows)])
    key = a.reshape(-1)
    order = stable_argsort(key)
    starts = torch.searchsorted(
        key[order], torch.arange(len(leader_pos) + 1, dtype=key.dtype, device=dev))
    return order.cpu().numpy(), starts.cpu().numpy()


def _carve_worklist(n: int, params: RBCParams, seed: int | None,
                    assign: Callable) -> list[np.ndarray]:
    """Algorithm 5's recursion as an explicit worklist, shared by the host
    and device backends (the same RNG stream, so the same leaves whenever
    the assignments agree)."""
    rng = np.random.default_rng(params.seed if seed is None else seed)
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
        order, starts = assign(idx, leader_pos, f)
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


def ball_carve(xt: torch.Tensor, params: RBCParams, *, seed: int | None = None,
               execution: str | None = None) -> list[np.ndarray]:
    """Algorithm 5 over the points ``xt`` [n, d]; returns the leaves as
    int64 arrays of point indices (overlapping).  ``execution`` overrides
    ``params.execution`` (see the module docstring); ``"static"`` returns
    the rows of ``ball_carve_device``'s matrix."""
    mode = execution if execution is not None else resolve_execution(params, xt.device)
    if mode == "static":
        padded = ball_carve_device(xt, params, seed=seed)
        return [row[row >= 0].astype(np.int64) for row in padded]
    if mode == "device":
        assign = functools.partial(_assign_device, xt, metric=params.metric,
                                   rows=params.assign_rows)
    else:
        assign = functools.partial(_assign_host, _host_f32(xt), metric=params.metric)
    return _carve_worklist(xt.shape[0], params, seed, assign)


def ball_carve_replicated(xt: torch.Tensor, params: RBCParams) -> list[np.ndarray]:
    """``params.replicas`` independent RBC runs; union of leaves (Sec. 5.2)."""
    leaves: list[np.ndarray] = []
    for r in range(params.replicas):
        leaves.extend(ball_carve(xt, params, seed=params.seed + 7919 * r))
    return leaves


# ---------------------------------------------------------------------------
# The static two-level carve
# ---------------------------------------------------------------------------

def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _next_pow2(v: int) -> int:
    return 1 << max(0, int(v - 1).bit_length())


def _static_shapes(n: int, params: RBCParams) -> dict[str, int]:
    """The static carve's sizes for ``n`` points (the reference's)."""
    l0 = int(np.clip(round(params.p_samp * n), 2, min(params.leader_cap, n)))
    if _round_up(l0, 8) <= n:
        l0 = _round_up(l0, 8)
    f0 = min(params.fanout_at(0), l0)
    f0r = min(f0 + max(params.bucket_spill, 0), l0)
    cap_b = _round_up(int(n * f0 / l0 * params.bucket_slack) + 1, 8)
    f1 = params.fanout_at(1)
    # per-bucket leaf capacity l1 * c_max holds cap_b * f1 placements at
    # about leaf_fill mean fill
    l1 = -(-int(cap_b * f1) // max(int(params.c_max * params.leaf_fill), 1))
    l1 = int(np.clip(l1, 2, min(params.leader_cap, cap_b)))
    f1 = min(f1, l1)
    return dict(l0=l0, f0=f0, f0r=f0r, cap_b=cap_b, l1=l1, f1=f1)


def carve_chunks(n: int, params: RBCParams) -> dict:
    """The reference's static chunking for ``n`` points: ``_static_shapes``
    plus its level-0 row sub-batch ``sub``, the padded point count
    ``n_pad`` and its level-1 ``bucket_chunk`` and ``cap_chunk``.  The
    port keeps ``n_pad`` (the routing's Weyl order depends on it) and
    blocks the assignments by ``_BLOCK_ROWS`` instead."""
    sh = _static_shapes(n, params)
    sub = min(_next_pow2(params.assign_rows), _next_pow2(max(n, 8)))
    bucket_chunk = next(c for c in (8, 4, 2, 1) if sh["l0"] % c == 0)
    cap_target = min(sh["cap_b"], max(8, params.assign_rows // max(bucket_chunk, 1)))
    cap_chunk = next(c for c in range(cap_target, 0, -1) if sh["cap_b"] % c == 0)
    return dict(sh, sub=sub, n_pad=_round_up(n, sub), bucket_chunk=bucket_chunk,
                cap_chunk=cap_chunk)


def static_leaders(n: int, params: RBCParams, seed: int | None = None) -> np.ndarray:
    """The static carve's level-0 leaders: ``l0`` distinct point ids from
    the seeded numpy generator, as the reference draws them."""
    rng = np.random.default_rng(params.seed if seed is None else seed)
    return rng.choice(n, size=carve_chunks(n, params)["l0"], replace=False).astype(np.int32)


def static_level0(xt: torch.Tensor, lead0: torch.Tensor, sh: dict, metric: str):
    """Level 0: each point's ``f0r`` nearest leaders, grouped by capacity
    into buckets ``bpid`` [l0, cap_b] (point ids, -1 padded) with their
    validity ``bval``.  Each segment (primaries, then spills) is put in
    the Weyl order first, so primaries claim capacity before spills."""
    n, dev = xt.shape[0], xt.device
    n_pad, f0, f0r = sh["n_pad"], sh["f0"], sh["f0r"]
    leaders = xt[lead0.long()]
    a0 = torch.zeros((n_pad, f0r), dtype=torch.int32, device=dev)
    for s in range(0, n, _BLOCK_ROWS):
        e = min(s + _BLOCK_ROWS, n)
        a0[s:e] = leader_assign(xt[s:e], leaders, f0r, metric=metric, use_kernels=True)
    pid = torch.arange(n_pad, dtype=torch.int32, device=dev)
    # padding rows (and the -1 of a non-finite distance) are not placed
    ok = (pid < n)[:, None] & (a0 >= 0)
    keys, oks, pids = [], [], []
    for lo, hi in ((0, f0), (f0, f0r)):
        if hi == lo:
            continue
        perm = weyl_order(n_pad * (hi - lo), dev)
        keys.append(a0[:, lo:hi].reshape(-1)[perm])
        oks.append(ok[:, lo:hi].reshape(-1)[perm])
        pids.append(pid[:, None].expand(n_pad, hi - lo).reshape(-1)[perm])
    (bpid,), bval = group_by_capacity(torch.cat(keys), torch.cat(oks), sh["l0"], sh["cap_b"],
                                      [torch.cat(pids)])
    return bpid, bval


def static_level1_leaders(bpid: torch.Tensor, bval: torch.Tensor, sh: dict):
    """Level-1 leaders: strided picks from each bucket's slots, [l0, l1]
    point ids and their validity."""
    stride = max(sh["cap_b"] // sh["l1"], 1)
    return bpid[:, ::stride][:, :sh["l1"]], bval[:, ::stride][:, :sh["l1"]]


def static_level1_block_buckets(sh: dict) -> int:
    """Buckets a level-1 assignment block takes (``_BLOCK_ROWS`` points)."""
    return max(1, _BLOCK_ROWS // sh["cap_b"])


def static_level1(xt: torch.Tensor, bpid, bval, lead1, lead1_ok, sh: dict, metric: str):
    """Level 1: each bucket's points against its leaders, ``f1`` nearest
    each, [l0, cap_b, f1]; -1 where the point is invalid or fewer than f1
    of the bucket's leaders are valid (the distance is +inf there)."""
    l0, cap_b, f1 = sh["l0"], sh["cap_b"], sh["f1"]
    a1 = torch.empty((l0, cap_b, f1), dtype=torch.int32, device=xt.device)
    step = static_level1_block_buckets(sh)
    for s in range(0, l0, step):
        e = slice(s, s + step)
        a1[e] = leader_assign(xt[bpid[e].clamp_min(0).long()], xt[lead1[e].clamp_min(0).long()],
                              f1, metric=metric, point_valid=bval[e],
                              leader_valid=lead1_ok[e], use_kernels=True)
    return a1


def static_leaf_routing(a1: torch.Tensor, bpid: torch.Tensor, sh: dict,
                        c_max: int) -> torch.Tensor:
    """Group the level-1 placements into leaves by capacity (in the Weyl
    order): leaf ``b * l1 + a1`` of bucket b, [l0 * l1, c_max] point ids,
    -1 padded."""
    l0, l1, f1 = sh["l0"], sh["l1"], sh["f1"]
    leaf_key = (torch.arange(l0, dtype=torch.int32, device=a1.device)[:, None, None] * l1
                + a1).reshape(-1)
    # a1 >= 0 is the reference's bval & a1_ok: an invalid point or leader
    # leaves +inf, where rowwise_topk gives -1
    (leaf_ids,), _ = group_by_capacity(
        leaf_key, (a1 >= 0).reshape(-1), l0 * l1, c_max,
        [bpid[:, :, None].expand(l0, sh["cap_b"], f1).reshape(-1)], shuffle=True)
    return leaf_ids


def static_leaf_ids(xt: torch.Tensor, params: RBCParams, *,
                    seed: int | None = None) -> torch.Tensor:
    """The static carve's leaf matrix [l0 * l1, c_max] int32 (-1 padded) on
    the device holding ``xt``, before the empty-leaf filter and the
    salvage leaves; needs ``n > c_max``."""
    n = xt.shape[0]
    sh = carve_chunks(n, params)
    lead0 = torch.from_numpy(static_leaders(n, params, seed)).to(xt.device)
    bpid, bval = static_level0(xt, lead0, sh, params.metric)
    lead1, lead1_ok = static_level1_leaders(bpid, bval, sh)
    a1 = static_level1(xt, bpid, bval, lead1, lead1_ok, sh, params.metric)
    return static_leaf_routing(a1, bpid, sh, params.c_max)


def carve_workspace_bytes(n: int, d: int, params: RBCParams) -> int:
    """Modeled device temp bytes of ``static_leaf_ids`` over ``n`` points of
    width ``d`` on the card: the largest of its four phases' live bytes,
    from its shapes (``carve_chunks``; B = the rows a level-0 block takes,
    S the buckets a level-1 block takes), its [l0 * l1, c_max] output not
    counted:

      * level 0's assignment: the [n_pad, f0r] ids, the leaders, a block's
        [B, l0] distances and its top-k ids and values;
      * level 0's grouping of E0 = n_pad * f0r placements: the ids and
        their mask, the segments and their concatenation (9 B each), and
        ``group_by_capacity``'s sorted keys, order, ranks, row and column
        and gathered payload (49 B an entry) beside its [l0, cap_b] ids and
        mask;
      * level 1's assignment: the buckets' ids and mask, the [l0, cap_b,
        f1] ids, and a block's gathered points and leaders, its two
        [S, cap_b, l1] distance copies and its top-k;
      * the leaf routing of E1 = l0 * cap_b * f1 placements: the level-1
        ids, the leaf keys, mask and point payload, the Weyl permutation,
        the shuffled copies and ``group_by_capacity``'s buffers (79 B an
        entry) beside the buckets and the leaves' validity mask."""
    sh = carve_chunks(n, params)
    n_pad, l0, f0r, cap_b = sh["n_pad"], sh["l0"], sh["f0r"], sh["cap_b"]
    l1, f1 = sh["l1"], sh["f1"]
    rows = min(_BLOCK_ROWS, n)
    step = min(static_level1_block_buckets(sh), l0)
    e0, e1 = n_pad * f0r, l0 * cap_b * f1
    buckets = 5 * l0 * cap_b
    level0 = 4 * e0 + 4 * l0 * d + 4 * rows * l0 + 8 * rows * f0r
    group0 = (4 + 1 + 9 + 9 + 49) * e0 + 4 * n_pad + buckets
    level1 = (buckets + 4 * e1 + step * cap_b * (4 * d + 12) + step * l1 * (4 * d + 12)
              + 8 * step * cap_b * l1 + 8 * step * cap_b * f1)
    routing = 79 * e1 + buckets + l0 * l1 * params.c_max
    return max(level0, group0, level1, routing)


def ball_carve_device(xt: torch.Tensor, params: RBCParams, *,
                      seed: int | None = None) -> np.ndarray:
    """The static two-level carve: the padded [L, c_max] int32 leaf matrix,
    empty leaves filtered on the device.  Capacity routing drops overflow
    replicas under skew; a point that loses every replica (duplicate-heavy
    clusters can overflow every ball they reach) goes into salvage leaves
    appended on the host, ``c_max`` lost points each, so every point is in
    some leaf."""
    n = xt.shape[0]
    if n <= params.c_max:
        return leaves_to_padded([np.arange(n, dtype=np.int64)], params.c_max)
    leaf_ids = static_leaf_ids(xt, params, seed=seed)
    return salvage(leaf_ids[(leaf_ids >= 0).any(dim=1)], n, params.c_max)


def salvage(leaf_ids: torch.Tensor, n: int, c_max: int) -> np.ndarray:
    """The leaf matrix ``leaf_ids`` copied to the host, with salvage leaves
    appended for the points of [0, n) that no leaf holds, ``c_max`` a leaf
    in ascending order.  The points held are found on the matrix's
    device; only the lost ones come to the host beside the matrix."""
    seen = torch.zeros(n, dtype=torch.bool, device=leaf_ids.device)
    seen[leaf_ids[leaf_ids >= 0].long()] = True
    lost = torch.nonzero(~seen).flatten().cpu().numpy()
    out = leaf_ids.cpu().numpy()
    if len(lost):
        extra = [lost[s: s + c_max] for s in range(0, len(lost), c_max)]
        out = np.concatenate([out, leaves_to_padded(extra, c_max)])
    return out


# ---------------------------------------------------------------------------
# Ablation partitioners (Appendix A.1), numpy on the host
# ---------------------------------------------------------------------------

def binary_partition(x: np.ndarray, *, c_max: int = 1024, replicas: int = 1,
                     metric: str = "l2", seed: int = 0) -> list[np.ndarray]:
    """HCNNG's recursive 2-leader partitioning (A.1.1). Disjoint per replica."""
    leaves: list[np.ndarray] = []
    for r in range(replicas):
        rng = np.random.default_rng(seed + 104729 * r)
        stack = [np.arange(x.shape[0], dtype=np.int64)]
        while stack:
            idx = stack.pop()
            if len(idx) <= c_max:
                leaves.append(idx)
                continue
            two = rng.choice(len(idx), size=2, replace=False)
            d = _pairwise_np(x[idx], x[idx[two]], metric)
            left = d[:, 0] <= d[:, 1]
            if left.all() or (~left).all():
                # degenerate split (duplicate points): permutation halves
                perm = rng.permutation(len(idx))
                half = len(idx) // 2
                stack.append(idx[perm[:half]])
                stack.append(idx[perm[half:]])
                continue
            stack.append(idx[left])
            stack.append(idx[~left])
    return leaves


def _lloyd(x: np.ndarray, k: int, iters: int, rng, metric: str) -> np.ndarray:
    centers = x[rng.choice(x.shape[0], size=k, replace=False)].copy()
    for _ in range(iters):
        a = np.argmin(_pairwise_np(x, centers, metric), axis=1)
        for j in range(k):
            m = a == j
            if m.any():
                centers[j] = x[m].mean(axis=0)
    return centers


def kmeans_carve(x: np.ndarray, params: RBCParams, *, lloyd_iters: int = 3,
                 seed: int | None = None) -> list[np.ndarray]:
    """Hierarchical k-means (A.1.2): RBC but leaders are Lloyd centroids."""
    rng = np.random.default_rng(params.seed if seed is None else seed)
    leaves: list[np.ndarray] = []
    stack: list[tuple[np.ndarray, int]] = [(np.arange(x.shape[0], dtype=np.int64), 0)]
    while stack:
        idx, depth = stack.pop()
        if len(idx) <= params.c_max:
            leaves.append(idx)
            continue
        n_leaders = int(np.clip(round(params.p_samp * len(idx)), 2, params.leader_cap))
        centers = _lloyd(x[idx], n_leaders, lloyd_iters, rng, params.metric)
        f = min(params.fanout_at(depth), n_leaders)
        flat = _nearest_leaders(x[idx], centers, f, params.metric).reshape(-1)
        src = np.repeat(idx, f)
        order = np.argsort(flat, kind="stable")
        flat_sorted, src_sorted = flat[order], src[order]
        starts = np.searchsorted(flat_sorted, np.arange(n_leaders))
        ends = np.searchsorted(flat_sorted, np.arange(n_leaders) + 1)
        buckets = [src_sorted[s:e] for s, e in zip(starts, ends) if e > s]
        buckets = _merge_small(buckets, params.c_min, params.c_max, rng)
        for b in buckets:
            if len(b) <= params.c_max:
                leaves.append(b)
            elif len(b) == len(idx):
                # duplicate-heavy data: the same forced split as ball_carve
                perm = rng.permutation(len(b))
                half = len(b) // 2
                stack.append((b[perm[:half]], depth + 1))
                stack.append((b[perm[half:]], depth + 1))
            else:
                stack.append((b, depth + 1))
    return leaves


def bit_lex_order(bits: np.ndarray) -> np.ndarray:
    """Stable lexicographic argsort of boolean rows (column 0 most
    significant), the bits packed into big-endian uint64 words so that any
    number of bits keeps full precision."""
    n, n_bits = bits.shape
    words = []
    for w0 in range(0, n_bits, 64):
        chunk = bits[:, w0:w0 + 64]
        word = np.zeros(n, dtype=np.uint64)
        for i in range(chunk.shape[1]):
            word = (word << np.uint64(1)) | chunk[:, i].astype(np.uint64)
        words.append(word)
    # lexsort's last key is primary: reverse so word 0 dominates
    return np.lexsort(tuple(reversed(words)))


def sorting_lsh_partition(x: np.ndarray, *, c_max: int = 1024, n_bits: int = 24,
                          replicas: int = 1, seed: int = 0) -> list[np.ndarray]:
    """Sorting-LSH (A.1.3): lexicographic sort on concatenated hyperplane
    bits, consecutive groups of <= c_max.  Overlap via replication only."""
    leaves: list[np.ndarray] = []
    n, d = x.shape
    for r in range(replicas):
        rng = np.random.default_rng(seed + 15485863 * r)
        h = rng.standard_normal((n_bits, d)).astype(x.dtype)
        order = bit_lex_order((x @ h.T) >= 0.0)
        for s in range(0, n, c_max):
            leaves.append(order[s: s + c_max].astype(np.int64))
    return leaves


PARTITIONERS: dict[str, Callable] = {
    "rbc": lambda x, p: ball_carve_replicated(x, p),
    "binary": lambda x, p: binary_partition(
        _host_f32(x), c_max=p.c_max, replicas=max(p.replicas, 1), metric=p.metric,
        seed=p.seed),
    "kmeans": lambda x, p: kmeans_carve(_host_f32(x), p),
    "sorting_lsh": lambda x, p: sorting_lsh_partition(
        _host_f32(x), c_max=p.c_max, replicas=max(p.replicas, 1), seed=p.seed),
}


def partition(xt: torch.Tensor, params: RBCParams,
              method: Literal["rbc", "binary", "kmeans", "sorting_lsh"] = "rbc"
              ) -> list[np.ndarray]:
    return PARTITIONERS[method](xt, params)


# ---------------------------------------------------------------------------
# The padded leaf matrix
# ---------------------------------------------------------------------------

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


def partition_padded(xt: torch.Tensor, params: RBCParams,
                     method: Literal["rbc", "binary", "kmeans", "sorting_lsh"] = "rbc"
                     ) -> np.ndarray:
    """Stage-1 entry point: the dense [L, c_max] padded leaf matrix.  RBC
    with the static strategy takes the matrices straight from
    ``ball_carve_device`` (replicas concatenated); every other
    configuration goes through the list of leaves."""
    if method == "rbc" and resolve_execution(params, xt.device) == "static":
        mats = [ball_carve_device(xt, params, seed=params.seed + 7919 * r)
                for r in range(max(params.replicas, 1))]
        return mats[0] if len(mats) == 1 else np.concatenate(mats, axis=0)
    return leaves_to_padded(partition(xt, params, method), params.c_max)
