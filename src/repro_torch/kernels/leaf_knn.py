"""Leaf k-NN with a running top-k (FlashKNN), with its own row gather.

Replaces the Pallas kernel ``repro/kernels/leaf_knn.py::leaf_topk``
(``pallas_call`` at ``:114``), which computes the default leaf k-NN
contract of ``repro/core/leaf.py::leaf_knn_jax``.  The CUDA kernel
(``csrc/leaf_knn.cu``) takes the leaves as ids and gathers its own rows,
fusing the reference step's ``xj[ids]`` gather: at n = 1M a stream chunk's
gathered [chunk, c_max, d] block would be about 8 GB.

Bound on the card: operations, C*(C-1)*d FLOPs per leaf of C valid points
(one product per unordered pair; the kernel forms both orders).
The products run on the tensor cores in TF32, three per float32 product
(3xTF32): each operand is split into ``hi = tf32(x)`` (round to nearest,
ties away) and ``lo = x - hi``, of which the MMA reads the top 19 bits, and
``lo*hi + hi*lo + hi*hi`` is summed in float32, which keeps the float32
result (exact on integer data below 2048, where ``lo = 0``; within
``1e-5 |d| + 32 eps max|x|^2`` of the plain version otherwise).  So the
bound is three TF32 products at the TF32 peak.  The row tile stays in
shared memory for the whole column walk (in depth chunks, reloaded for each
column tile, when d is too deep to fit: past 736 at c_max = 1024), column
tiles stream in through a ``cp.async`` ring, norms are summed once per row,
and only the tiles that hold valid points are computed.  The [C, C] matrix
is never written; each 64x64 tile is folded into per-row running top-k
lists: in registers for k <= 8 (one instantiation per k), in shared memory
for 9 <= k <= ``MAX_K`` (lists of 16 or 32, of which the first k slots are
written; the first k of the top-16 or top-32 under the (dist, position)
order are the top-k).  A larger k raises ``ValueError`` on the card; the
plain version takes any k.
"""
from __future__ import annotations

import torch

from repro_torch.core.metrics import pairwise
from repro_torch.kernels import _build
from repro_torch.kernels.topk import topf

METRIC_CODES = {"l2": 0, "mips": 1, "cosine": 2}
MAX_K = 32   # the card kernel's largest k (the plain version takes any)

launches = 0   # kernel launches since the last reset


def leaf_topk_plain(points: torch.Tensor, leaf_ids: torch.Tensor, k: int,
                    metric: str = "l2", *, block: int = 8):
    """Plain PyTorch version of ``leaf_topk``; runs on any device.

    Works ``block`` leaves at a time and crops each block to its last
    valid column (columns past it are all padding, so the result is the
    same)."""
    nb, c = leaf_ids.shape
    dev = points.device
    out_idx = torch.full((nb, c, k), -1, dtype=torch.int32, device=dev)
    out_dist = torch.full((nb, c, k), float("inf"), dtype=torch.float32, device=dev)
    col = torch.arange(c, device=dev)
    for s in range(0, nb, block):
        ids = leaf_ids[s:s + block]
        valid = ids >= 0
        width = int(torch.max(torch.where(valid, col + 1, 0)).item()) if ids.numel() else 0
        if width == 0:
            continue
        ids, valid = ids[:, :width], valid[:, :width]
        pts = points[ids.clamp_min(0).long()]
        d = pairwise(pts, pts, metric)
        eye = torch.eye(width, dtype=torch.bool, device=dev)
        mask = valid[:, None, :] & valid[:, :, None] & ~eye
        d = torch.where(mask, d, torch.full((), float("inf"), device=dev))
        kk = min(k, width)
        idx = topf(d, kk)
        nd = torch.gather(d, 2, idx.long())
        ok = torch.isfinite(nd)
        out_idx[s:s + block, :width, :kk] = torch.where(ok, idx, -1)
        out_dist[s:s + block, :width, :kk] = torch.where(
            ok, nd, torch.full((), float("inf"), device=dev))
    return out_idx, out_dist


def leaf_topk(points: torch.Tensor, leaf_ids: torch.Tensor, k: int,
              metric: str = "l2"):
    """Per leaf, each point's k nearest co-leaf points.

    ``points`` [n, d] float32, ``leaf_ids`` [B, C] int32 with -1 padding.
    Returns (in-leaf positions [B, C, k] int32, dists [B, C, k] float32),
    (-1, +inf) where a row has no valid neighbour left; ties go to the
    lower position.  CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    global launches
    if metric not in METRIC_CODES:
        raise ValueError(f"unknown metric {metric!r}")
    if points.device.type == "cpu":
        return leaf_topk_plain(points, leaf_ids, k, metric)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"leaf_topk supports 1 <= k <= {MAX_K}, got {k}")
    if points.dtype != torch.float32 or leaf_ids.dtype != torch.int32:
        raise TypeError("leaf_topk takes float32 points and int32 leaf ids")
    _build.require_cuda("leaf_topk", points, leaf_ids)
    nb, c = leaf_ids.shape
    n, d = points.shape
    out_idx = torch.empty((nb, c, k), dtype=torch.int32, device=points.device)
    out_dist = torch.empty((nb, c, k), dtype=torch.float32, device=points.device)
    rc = _build.library().pipnn_leaf_topk(
        points.data_ptr(), leaf_ids.data_ptr(), n, d, nb, c, k,
        METRIC_CODES[metric], out_idx.data_ptr(), out_dist.data_ptr(),
        _build.stream_ptr(points))
    _build.check(rc, "leaf_topk")
    launches += 1
    return out_idx, out_dist


def launch_plan(c: int, d: int, k: int) -> dict:
    """The kernel's launch plan for leaves of ``c`` slots, depth ``d`` and
    ``k``, from the C function the launch itself uses
    (``pipnn_leaf_topk_plan``): the list length ``K`` (the instantiation's
    first template argument) and the dynamic shared memory in bytes.
    Launches nothing; needs the built library."""
    smem, kk = _build.plan_value("pipnn_leaf_topk_plan", c, d, k)
    return {"smem": smem, "K": kk}


def work(points: torch.Tensor, leaf_ids: torch.Tensor, k: int, metric: str = "l2") -> dict:
    """The least work of ``leaf_topk`` on these leaves: one d-long product
    (2d operations) for each unordered pair of distinct valid points of a
    leaf, as the distances are symmetric, at three TF32 products each
    (3xTF32); each distinct point row read once, the ids read and the
    outputs written once."""
    d = points.shape[1]
    sizes = (leaf_ids >= 0).sum(dim=1, dtype=torch.int64)
    products = d * int((sizes * (sizes - 1)).sum())
    rows = torch.unique(leaf_ids[leaf_ids >= 0]).numel()
    nb, c = leaf_ids.shape
    return {"ops": {"tf32": 3.0 * products},
            "bytes": float(leaf_ids.numel() * 4 + rows * d * 4 + nb * c * k * 8)}
