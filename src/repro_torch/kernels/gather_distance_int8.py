"""Fused neighbour gather + distance block for int8 (scalar-quantized)
serving, and the repo's quantization scheme.

Replaces both Pallas kernels ``repro/kernels/gather_distance.py::
gather_distance_int8`` (points resident in VMEM, ``pallas_call`` at
``:275``) and ``::gather_distance_int8_hbm`` (points streamed from HBM,
``:499``) with one CUDA kernel (``csrc/gather_distance_int8.cu``), as
``gather_distance`` replaces the float32 pair.  One warp takes 32 id
slots of one query: it compacts the valid ids by ballot (padding reads
nothing), quantizes the query with ``quantize_symmetric``'s operations
(each lane the 16 values it multiplies; the max across its lane group),
reads each 128-byte row as 8 lanes of 16 bytes with 8 loads in flight a
lane, sums int8 x int8 -> int32 with ``__dp4a`` and reduces within the lane
group, and rescales and expands with the exact float32 norms in the
reference's order, one correctly rounded operation at a time.  The kernel
is therefore bit-exact against the plain version on any data.  Rows whose
d is not a multiple of 16, or points or queries not 16-byte aligned, are
read one byte a lane by the same kernel, so any alignment is taken.

Bound on the card: bytes, a d-byte row plus its scale and norm for each
distinct valid id (padding reads nothing), the ids, queries and output.

The plain versions are copies of the oracles ``repro/kernels/ref.py::
quantize_symmetric``, ``gather_distance_int8_core`` and
``gather_distance_int8_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.core.metrics import check_metric, clamp_zero
from repro_torch.kernels import _build

METRIC_CODES = {"l2": 0, "mips": 1, "cosine": 2}
_EPS = 1e-12

launches = 0   # kernel launches since the last reset


def quantize_symmetric(v: torch.Tensor, eps: float = _EPS):
    """Per-row symmetric int8 quantization over the last axis: returns
    (q int8 [..., d], scale float32 [...]).

    ``scale = max(max|v|, eps) * float32(1/127)``, a reciprocal multiply
    (not a division, which rounds differently), and ``q = clip(round(v /
    scale), -127, 127)`` with a correctly rounded division and round half
    to even.  Zero rows quantize to zeros."""
    v32 = v.to(torch.float32)
    inv127 = torch.tensor(1.0 / 127.0, dtype=torch.float32, device=v32.device)
    scale = torch.clamp_min(torch.amax(torch.abs(v32), dim=-1), eps) * inv127
    q = torch.clamp(torch.round(v32 / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def gather_distance_int8_core(points, scales, norms, q8, sq, q_norms, nbr_ids,
                              metric: str = "l2"):
    """Quantized gather + distance on pre-quantized queries ``q8`` [Q, d]
    int8 with scales ``sq`` [Q]: [Q, C] float32, +inf at padding ids."""
    check_metric(metric)
    safe = nbr_ids.clamp_min(0).long()
    g = points[safe].to(torch.int32)                         # [Q, C, d]
    sg = scales[safe]
    ip = torch.sum(q8.to(torch.int32)[:, None, :] * g, dim=-1, dtype=torch.int32)
    ipf = ip.to(torch.float32) * (sq[:, None] * sg)
    if metric == "mips":
        d = -ipf
    elif metric == "cosine":
        d = 1.0 - ipf / torch.clamp_min(q_norms[:, None] * norms[safe], 1e-30)
    else:
        d = clamp_zero(q_norms[:, None] + norms[safe] - 2.0 * ipf)
    return torch.where(nbr_ids >= 0, d, torch.full((), float("inf"), device=d.device))


def gather_distance_int8_plain(points, scales, norms, queries, q_norms, nbr_ids,
                               metric: str = "l2"):
    """Plain PyTorch version of ``gather_distance_int8``; runs on any device."""
    q8, sq = quantize_symmetric(queries)
    return gather_distance_int8_core(points, scales, norms, q8, sq, q_norms, nbr_ids, metric)


def gather_distance_int8(points, scales, norms, queries, q_norms, nbr_ids,
                         metric: str = "l2"):
    """Distance block [Q, C] float32 between float32 ``queries`` [Q, d] and
    the int8 rows ``points[nbr_ids]`` ([n, d] int8 with per-point float32
    ``scales`` [n], ids [Q, C] int32, -1 = padding -> +inf).  ``norms`` [n]
    are the exact norms of the float32 points and ``q_norms`` [Q] those of
    the queries (``core.metrics.point_norms``).  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    global launches
    check_metric(metric)
    if points.device.type == "cpu":
        return gather_distance_int8_plain(points, scales, norms, queries, q_norms, nbr_ids,
                                          metric)
    if (points.dtype != torch.int8 or nbr_ids.dtype != torch.int32
            or any(t.dtype != torch.float32 for t in (scales, norms, queries, q_norms))):
        raise TypeError("gather_distance_int8 takes int8 points, float32 scales/norms/"
                        "queries/q_norms, int32 ids")
    nq, c = nbr_ids.shape
    n, d = points.shape
    if (queries.shape != (nq, d) or norms.shape != (n,) or scales.shape != (n,)
            or q_norms.shape != (nq,)):
        raise ValueError("gather_distance_int8: shapes of queries/scales/norms do not match")
    _build.require_cuda("gather_distance_int8", points, scales, norms, queries, q_norms,
                        nbr_ids)
    out = torch.empty((nq, c), dtype=torch.float32, device=points.device)
    rc = _build.library().pipnn_gather_distance_int8(
        points.data_ptr(), scales.data_ptr(), norms.data_ptr(), queries.data_ptr(),
        q_norms.data_ptr(), nbr_ids.data_ptr(), n, d, nq, c, METRIC_CODES[metric],
        out.data_ptr(), _build.stream_ptr(points))
    _build.check(rc, "gather_distance_int8")
    launches += 1
    return out


def work(points, scales, norms, queries, q_norms, nbr_ids, metric: str = "l2") -> dict:
    """The least work of ``gather_distance_int8`` on these ids: a d-byte row,
    its scale and norm read once for each distinct valid id, every id and
    output slot, the queries and their norm terms; the d-long int8 product
    of each valid slot (2d operations)."""
    nq, c = nbr_ids.shape
    d = points.shape[1]
    valid = int((nbr_ids >= 0).sum())
    rows = torch.unique(nbr_ids[nbr_ids >= 0]).numel()
    common = nbr_ids.numel() * 8 + nq * d * 4
    return {"ops": {"int8": 2.0 * valid * d},
            "bytes": float(rows * (d + 8) + common + nq * 4)}
