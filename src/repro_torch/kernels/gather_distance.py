"""Fused neighbour gather + distance block for the beam search.

Replaces both Pallas kernels ``repro/kernels/gather_distance.py::
gather_distance`` (points resident in VMEM, ``pallas_call`` at ``:179``)
and ``::gather_distance_hbm`` (points streamed from HBM, ``:407``).  The
card has one memory to read the rows from, so the VMEM-vs-HBM split and its
budget have no counterpart: one CUDA kernel (``csrc/gather_distance.cu``)
serves both.  The points are float32, or bfloat16 for a downcast serving
copy: the kernel is a template over the row type and widens each gathered
element to float32 exactly, as the reference's kernel upcasts its gathered
rows, so the result is the float32 one up to summation order (equal bits
on integer data).

Bound on the card: bytes, a randomly gathered row (d*4 bytes, or d*2 in
bfloat16) for each distinct valid id (padding reads nothing).  One warp
takes 32 id slots of a query: one coalesced id load, valid ids compacted
with a ballot (padding is written +inf and loads nothing), every row read
with 16-byte lanes (a float32 row of 128 is one warp load, a bfloat16 row
half of one), 8 loads in flight per lane, the dot products reduced within
each row's lane group and the 32 results stored in one coalesced write.
The norm expansion uses the precomputed point norms
(``core.metrics.point_norms``).  The plain version is the oracle
``repro/kernels/ref.py::gather_distance_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.core.metrics import check_metric, clamp_zero
from repro_torch.kernels import _build

METRIC_CODES = {"l2": 0, "mips": 1, "cosine": 2}
# C entry point by row type
_ENTRY = {torch.float32: "pipnn_gather_distance", torch.bfloat16: "pipnn_gather_distance_bf16"}

launches = 0   # kernel launches since the last reset


def gather_distance_plain(points, norms, queries, nbr_ids, metric: str = "l2"):
    """Plain PyTorch version of ``gather_distance``; runs on any device."""
    check_metric(metric)
    q32 = queries.to(torch.float32)
    safe = nbr_ids.clamp_min(0).long()
    g = points[safe].to(torch.float32)                      # [Q, C, d]
    ip = torch.sum(q32[:, None, :] * g, dim=-1)
    if metric == "mips":
        d = -ip
    elif metric == "cosine":
        qn = torch.linalg.vector_norm(q32, dim=-1)
        d = 1.0 - ip / torch.clamp_min(qn[:, None] * norms[safe], 1e-30)
    else:
        q2 = torch.sum(q32 * q32, dim=-1)
        d = clamp_zero(q2[:, None] + norms[safe] - 2.0 * ip)
    return torch.where(nbr_ids >= 0, d, torch.full((), float("inf"), device=d.device))


def gather_distance(points, norms, queries, nbr_ids, metric: str = "l2"):
    """Distance block [Q, C] float32 between ``queries`` [Q, d] and the rows
    ``points[nbr_ids]`` ([n, d] float32 or bfloat16, ids [Q, C] int32, -1 =
    padding -> +inf), with ``norms`` [n] float32 from ``point_norms`` of the
    float32 points.  CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    global launches
    check_metric(metric)
    if points.device.type == "cpu":
        return gather_distance_plain(points, norms, queries, nbr_ids, metric)
    if (points.dtype not in _ENTRY or norms.dtype != torch.float32
            or queries.dtype != torch.float32 or nbr_ids.dtype != torch.int32):
        raise TypeError("gather_distance takes float32 or bfloat16 points, float32 "
                        "norms/queries, int32 ids")
    nq, c = nbr_ids.shape
    n, d = points.shape
    if queries.shape != (nq, d) or norms.shape != (n,):
        raise ValueError("gather_distance: shapes of queries/norms do not match")
    _build.require_cuda("gather_distance", points, norms, queries, nbr_ids)
    out = torch.empty((nq, c), dtype=torch.float32, device=points.device)
    rc = getattr(_build.library(), _ENTRY[points.dtype])(
        points.data_ptr(), norms.data_ptr(), queries.data_ptr(), nbr_ids.data_ptr(),
        n, d, nq, c, METRIC_CODES[metric], out.data_ptr(), _build.stream_ptr(points))
    _build.check(rc, "gather_distance")
    launches += 1
    return out
