"""Leaf building (counterpart of ``repro/core/leaf.py``): per leaf of the
partition, pick candidate edges among the leaf's points.

Leaves are rows of a dense [L, c_max] id matrix with -1 padding.  The leaf
k-NN runs on the leaf ids directly (``kernels.leaf_knn.leaf_topk`` gathers
its own rows), which is the ``leaf_knn_jax`` contract applied to
``points[ids]``.

Methods (the paper's A.3 ablation space, ``LeafParams.method``):

  * ``bidirected`` k-NN (the default): edges to and from each point's k
    nearest co-leaf points;
  * ``directed`` k-NN: edges to the k nearest only;
  * ``inverted`` k-NN: edges from the k nearest only;
  * ``mst``: a degree-capped Kruskal MST over the l-NN sparsified leaf
    graph (HCNNG's leaf method), host numpy as in the reference;
  * ``robust_prune``: all-to-all RobustPrune of every leaf point against
    its leaf.

The streaming build emits each chunk's edges as fixed-shape device tensors
(``emit_knn_edges`` / ``emit_robust_prune_edges``); ``build_leaf_edges``
is the flat path's whole candidate list (``EdgeList``), in the
reference's order.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

from repro_torch.core.metrics import pairwise
from repro_torch.core.robust_prune import robust_prune_mask
from repro_torch.kernels.leaf_knn import leaf_topk

LeafMethod = Literal["bidirected", "directed", "inverted", "mst", "robust_prune"]
KNN_METHODS = ("bidirected", "directed", "inverted")
METHODS = KNN_METHODS + ("mst", "robust_prune")
# candidate entries (one direction) a flat-path group of leaves may emit:
# the leaf kernel runs on this many leaves a call, not on ``leaf_chunk``
# (the reference's VMEM granularity; rows are independent, so the result is
# the same), and each entry index stays below 2^31
_GROUP_ENTRIES = 1 << 28
# float32 entries of a group's [B, C, C] leaf matrix (robust_prune, mst)
_GROUP_MATRIX = 1 << 27


@dataclasses.dataclass(frozen=True)
class LeafParams:
    method: LeafMethod = "bidirected"
    k: int = 2                 # leaf k-NN parameter (paper default 2)
    metric: str = "l2"         # build() overwrites it with PiPNNParams.metric
    alpha: float = 1.2         # robust_prune leaf method only
    max_deg: int = 64          # robust_prune leaf method only
    mst_degree_cap: int = 3
    mst_sparsify: int = 10     # l-NN sparsification before Kruskal (A.3.1)
    leaf_chunk: int = 8        # stream chunks are a multiple of it
    stream_chunk: int | None = None  # leaves per streaming merge step; None =
    #                            auto-size so one chunk's candidate edges are
    #                            about the [n, l_max] reservoir


@dataclasses.dataclass
class EdgeList:
    """Flat candidate edges on the build's device.  Padding entries have
    src == -1 (and dst -1, dist +inf)."""

    src: torch.Tensor    # int32 [E]
    dst: torch.Tensor    # int32 [E]
    dist: torch.Tensor   # float32 [E]

    def valid(self) -> torch.Tensor:
        return self.src >= 0


def _cat(pieces: list[EdgeList], device) -> EdgeList:
    if not pieces:
        return EdgeList(torch.empty(0, dtype=torch.int32, device=device),
                        torch.empty(0, dtype=torch.int32, device=device),
                        torch.empty(0, dtype=torch.float32, device=device))
    if len(pieces) == 1:
        return pieces[0]
    return EdgeList(torch.cat([p.src for p in pieces]), torch.cat([p.dst for p in pieces]),
                    torch.cat([p.dist for p in pieces]))


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


def check_method(method: str) -> None:
    if method not in METHODS:
        raise ValueError(f"unknown leaf method {method!r}; expected one of {METHODS}")


def leaf_knn(points: torch.Tensor, leaf_ids: torch.Tensor, *, k: int,
             metric: str = "l2"):
    """Per leaf, the k nearest co-leaf neighbours of every point (k >= 1; on
    the card k <= ``kernels.leaf_knn.MAX_K``).

    Returns (in-leaf positions [B, C, k], dists [B, C, k]); padding rows and
    missing neighbours are (-1, +inf), ties go to the lower position."""
    check_k(k)
    return leaf_topk(points, leaf_ids, k, metric)


def _inf(t: torch.Tensor) -> torch.Tensor:
    return torch.full((), float("inf"), dtype=torch.float32, device=t.device)


def emit_knn_edges(leaf_ids: torch.Tensor, nbr_idx: torch.Tensor, nbr_dist: torch.Tensor,
                   direction: str = "bidirected"):
    """Flat candidate edges (src, dst, dist) of a leaf k-NN: [B*C*k] for
    ``directed`` (point -> neighbour) and ``inverted`` (neighbour ->
    point), [2*B*C*k] for ``bidirected`` (the directed edges, then the
    inverted ones).  Invalid slots are (-1, -1, +inf).  No self loops."""
    b, c, k = nbr_idx.shape
    rows = leaf_ids[:, :, None].expand(b, c, k)
    cols = torch.gather(leaf_ids, 1,
                        nbr_idx.clamp_min(0).long().reshape(b, c * k)).reshape(b, c, k)
    ok = (nbr_idx >= 0) & (rows >= 0) & (rows != cols)
    src = torch.where(ok, rows, -1).reshape(-1)
    dst = torch.where(ok, cols, -1).reshape(-1)
    dist = torch.where(ok, nbr_dist, _inf(nbr_dist)).reshape(-1)
    if direction == "directed":
        return src, dst, dist
    if direction == "inverted":
        return dst, src, dist
    if direction != "bidirected":
        raise ValueError(f"unknown direction {direction!r}")
    return torch.cat([src, dst]), torch.cat([dst, src]), torch.cat([dist, dist])


def emit_robust_prune_edges(leaf_ids: torch.Tensor, keep: torch.Tensor, d: torch.Tensor):
    """Flat candidate edges [B*C*C] of the ``robust_prune`` leaf method:
    (leaf_ids[b, i] -> leaf_ids[b, j], d[b, i, j]) where ``keep[b, i, j]``;
    every other slot is (-1, -1, +inf)."""
    b, c, _ = keep.shape
    rows = leaf_ids[:, :, None].expand(b, c, c)
    cols = leaf_ids[:, None, :].expand(b, c, c)
    ok = keep & (rows >= 0) & (cols >= 0)
    return (torch.where(ok, rows, -1).reshape(-1), torch.where(ok, cols, -1).reshape(-1),
            torch.where(ok, d, _inf(d)).reshape(-1))


def leaf_matrix(points: torch.Tensor, leaf_ids: torch.Tensor, metric: str) -> torch.Tensor:
    """The unmasked [B, C, C] dissimilarity matrix of each leaf's gathered
    points (padding slots read row 0)."""
    pts = points[leaf_ids.clamp_min(0).long()]
    return pairwise(pts, pts, metric)


def _mask_leaf_matrix(d: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    c = d.shape[-1]
    eye = torch.eye(c, dtype=torch.bool, device=d.device)
    mask = valid[:, None, :] & valid[:, :, None] & ~eye
    return torch.where(mask, d, _inf(d))


def _leaf_robust_prune(pts: torch.Tensor, valid: torch.Tensor, *, metric: str,
                       alpha: float, max_deg: int):
    """All-to-all RobustPrune inside each leaf: ``pts`` [B, C, d] gathered
    leaf points, ``valid`` [B, C].  Returns (keep [B, C, C], the masked
    leaf matrix [B, C, C]).

    Every leaf point is one row of the flattened [B*C] batch; its
    candidate->candidate matrix is its leaf's, which the mask reads as
    ``d[r // C]`` instead of broadcasting it to [B*C, C, C].  Ties break on
    in-leaf positions."""
    b, c, _ = pts.shape
    d = _mask_leaf_matrix(pairwise(pts, pts, metric), valid)
    ids = torch.arange(c, dtype=torch.int32, device=d.device).expand(b * c, c)
    leaf_of_row = torch.arange(b, device=d.device).repeat_interleave(c)
    keep = robust_prune_mask(d.reshape(b * c, c), d, ids, alpha=alpha, max_deg=max_deg,
                             cc_rows=leaf_of_row)
    return keep.reshape(b, c, c), d


def leaf_robust_prune(points: torch.Tensor, leaf_ids: torch.Tensor, *, metric: str,
                      alpha: float, max_deg: int):
    """``_leaf_robust_prune`` on the leaves ``leaf_ids`` [B, C] of
    ``points``."""
    return _leaf_robust_prune(points[leaf_ids.clamp_min(0).long()], leaf_ids >= 0,
                              metric=metric, alpha=alpha, max_deg=max_deg)


def _mst_edges(leaf_ids: np.ndarray, d: np.ndarray, valid: np.ndarray, cap: int,
               sparsify: int, device="cpu") -> EdgeList:
    """Degree-capped Kruskal per leaf over the l-NN sparsified graph, on the
    host (numpy, as the reference; the leaves' valid ids are a prefix).
    The edges go to ``device``."""
    srcs, dsts, dists = [], [], []
    b = leaf_ids.shape[0]
    for li in range(b):
        v = valid[li]
        n = int(v.sum())
        if n < 2:
            continue
        dm = d[li][:n, :n].copy()
        np.fill_diagonal(dm, np.inf)
        l = min(sparsify, n - 1)
        nbr = np.argpartition(dm, l - 1, axis=1)[:, :l]
        rows = np.repeat(np.arange(n), l)
        cols = nbr.reshape(-1)
        w = dm[rows, cols]
        order = np.argsort(w, kind="stable")
        parent = np.arange(n)

        def find(a):
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        deg = np.zeros(n, dtype=np.int32)
        gids = leaf_ids[li][:n]
        for e in order:
            a, bb = rows[e], cols[e]
            if deg[a] >= cap or deg[bb] >= cap:
                continue
            ra, rb = find(a), find(bb)
            if ra == rb:
                continue
            parent[ra] = rb
            deg[a] += 1
            deg[bb] += 1
            srcs += [gids[a], gids[bb]]
            dsts += [gids[bb], gids[a]]
            dists += [w[e], w[e]]
    return EdgeList(torch.as_tensor(np.asarray(srcs, dtype=np.int32), device=device),
                    torch.as_tensor(np.asarray(dsts, dtype=np.int32), device=device),
                    torch.as_tensor(np.asarray(dists, dtype=np.float32), device=device))


def _interleave(a: torch.Tensor, b: torch.Tensor, groups: int) -> torch.Tensor:
    """[a_0, b_0, a_1, b_1, ...] of the ``groups`` equal parts of each."""
    return torch.stack([a.reshape(groups, -1), b.reshape(groups, -1)], dim=1).reshape(-1)


def build_leaf_edges(x: torch.Tensor, leaves_padded, params: LeafParams,
                     knn_fn=None) -> EdgeList:
    """Run the configured leaf method over all leaves; return the candidate
    edges on ``x``'s device, entry for entry as the reference's
    ``build_leaf_edges`` (the leaves padded with -1 rows to a multiple of
    ``leaf_chunk``; the k-NN methods keep every padded slot, ``mst`` and
    ``robust_prune`` only the edges).

    The leaves run in groups of as many as memory allows, not
    ``leaf_chunk`` at a time.  ``knn_fn(points, leaf_ids) -> (in-leaf idx
    [B, C, k], dist [B, C, k])`` replaces the leaf k-NN (default
    ``leaf_knn``); unlike the reference's ``(pts, valid)`` it takes the
    leaf ids, as the port's leaf kernel gathers its own rows."""
    check_method(params.method)
    dev = x.device
    leaves = torch.as_tensor(leaves_padded, dtype=torch.int32, device=dev)
    lc = max(1, params.leaf_chunk)
    nleaves, c = leaves.shape
    short = -nleaves % lc
    if short:
        leaves = torch.cat([leaves, torch.full((short, c), -1, dtype=torch.int32, device=dev)])
    if params.method in KNN_METHODS:
        check_k(params.k)
        knn = knn_fn or (lambda pts, ids: leaf_knn(pts, ids, k=params.k, metric=params.metric))
        per_leaf = c * params.k
    else:
        per_leaf = c * c
    budget = _GROUP_ENTRIES if params.method in KNN_METHODS else _GROUP_MATRIX
    group = max(lc, budget // max(1, per_leaf) // lc * lc)
    pieces: list[EdgeList] = []
    for s in range(0, leaves.shape[0], group):
        ids = leaves[s: s + group]
        if params.method in KNN_METHODS:
            ni, nd = knn(x, ids)
            src, dst, dist = emit_knn_edges(ids, ni, nd, "directed")
            del ni, nd
            if params.method == "inverted":
                src, dst = dst, src
            elif params.method == "bidirected":
                # the reference concatenates leaf_chunk pieces, each its
                # directed edges followed by their inverses
                g = ids.shape[0] // lc
                src, dst, dist = (_interleave(src, dst, g), _interleave(dst, src, g),
                                  _interleave(dist, dist, g))
            pieces.append(EdgeList(src, dst, dist))
        elif params.method == "mst":
            d = leaf_matrix(x, ids, params.metric).cpu().numpy()
            ids_h = ids.cpu().numpy()
            pieces.append(_mst_edges(ids_h, d, ids_h >= 0, params.mst_degree_cap,
                                     params.mst_sparsify, device=dev))
        else:
            keep, d = leaf_robust_prune(x, ids, metric=params.metric, alpha=params.alpha,
                                        max_deg=params.max_deg)
            li, ri, ci = torch.nonzero(keep, as_tuple=True)
            src, dst = ids[li, ri], ids[li, ci]
            ok = (src >= 0) & (dst >= 0)
            pieces.append(EdgeList(src[ok], dst[ok], d[li, ri, ci][ok]))
    return _cat(pieces, dev)
