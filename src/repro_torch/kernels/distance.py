"""Batched pairwise distance matrices, float32 and int8.

``pairwise_distance`` replaces the Pallas kernel ``repro/kernels/
distance.py::pairwise_distance`` (``_dist_kernel``, ``pallas_call`` at
``:91``): [B, M, D] x [B, N, D] -> [B, M, N] float32 with the norm
expansion fused.  The CUDA kernel (``csrc/distance.cu``) forms the products
on the tensor cores with three TF32 products per float32 product (3xTF32):
persistent blocks walk 128x128 output tiles, both row panels stream in
64-deep slices through a 2-stage ``cp.async`` ring (each 32 deep summed
into a fresh accumulator), and the row and column norms are float32 FMA
sums on the CUDA cores from the same slices.  Its epilogue is that of
``core.leader_assign.leader_dists``, one correctly rounded operation at a
time.  On integer data below 2048 (with every sum below
2^24) l2 and mips are exact and equal the plain version bit for bit;
otherwise the result is within a few float32 ulps.  Bound on the card:
operations, 3 * 2*B*M*N*D TF32 FLOPs at the tensor-core rate (or the
output's bytes, where D is small).

``pairwise_distance_int8`` replaces ``::pairwise_distance_int8``
(``_dist_kernel_int8``, ``pallas_call`` at ``:123``): exact squared L2 on
int8 inputs, ``|a|^2 + |b|^2 - 2 a.b`` in wrapping int32 arithmetic, any
D (D = 0 writes zeros).  The products run on the int8 tensor cores
(``mma.sync`` m16n8k32, exact in int32); persistent blocks walk 256x128
output tiles with both panels in a 2-stage ``cp.async`` ring, the norms
are ``__dp4a`` sums of the same slices, and the epilogue writes 16-byte
streaming stores, a row's 32 columns by 8 lanes, while the ring loads the
next tile.  Bound: bytes, the int32 output written once.  The distributed
build's quantized route (``launch.build_index``, ``route_dtype="int8"``)
takes its leaf products from it, where the reference forms them with an
int32 ``einsum``; its launches are counted apart (``launches_int8``).
"""
from __future__ import annotations

import torch

from repro_torch.core.metrics import check_metric, pairwise
from repro_torch.kernels import _build

METRIC_CODES = {"l2": 0, "mips": 1, "cosine": 2}

launches = 0        # pairwise_distance kernel launches since the last reset
launches_int8 = 0   # pairwise_distance_int8 kernel launches since the last reset


def _check_shapes(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] or a.shape[2] != b.shape[2]:
        raise ValueError(f"{name} takes a [B, M, D] and b [B, N, D], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")


def pairwise_distance_plain(a: torch.Tensor, b: torch.Tensor, metric: str = "l2"):
    """Plain PyTorch version of ``pairwise_distance``; runs on any device."""
    return pairwise(a.to(torch.float32), b.to(torch.float32), metric)


def pairwise_distance(a: torch.Tensor, b: torch.Tensor, metric: str = "l2"):
    """Batched dissimilarity matrix [B, M, N] float32 between the rows of
    ``a`` [B, M, D] and ``b`` [B, N, D] (float32).  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    global launches
    check_metric(metric)
    _check_shapes("pairwise_distance", a, b)
    if a.device.type == "cpu":
        return pairwise_distance_plain(a, b, metric)
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("pairwise_distance takes float32 inputs")
    _build.require_cuda("pairwise_distance", a, b)
    bsz, m, d = a.shape
    n = b.shape[1]
    out = torch.empty((bsz, m, n), dtype=torch.float32, device=a.device)
    rc = _build.library().pipnn_pairwise_distance(
        a.data_ptr(), b.data_ptr(), bsz, m, n, d, METRIC_CODES[metric], out.data_ptr(),
        _build.stream_ptr(a))
    _build.check(rc, "pairwise_distance")
    launches += 1
    return out


def pairwise_distance_int8_plain(a: torch.Tensor, b: torch.Tensor):
    """Plain PyTorch version of ``pairwise_distance_int8``; runs on any
    device.  The inner products go through a float64 product: every
    partial sum is an integer far below 2^53, so it is exact."""
    a32, b32 = a.to(torch.int32), b.to(torch.int32)
    a2 = torch.sum(a32 * a32, dim=-1, dtype=torch.int32)[:, :, None]
    b2 = torch.sum(b32 * b32, dim=-1, dtype=torch.int32)[:, None, :]
    ip = (a.to(torch.float64) @ b.to(torch.float64).transpose(1, 2)).to(torch.int32)
    return a2 + b2 - 2 * ip


def pairwise_distance_int8(a: torch.Tensor, b: torch.Tensor):
    """Exact squared L2 [B, M, N] int32 between the int8 rows of ``a``
    [B, M, D] and ``b`` [B, N, D].  CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    global launches_int8
    _check_shapes("pairwise_distance_int8", a, b)
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError("pairwise_distance_int8 expects int8 inputs")
    if a.device.type == "cpu":
        return pairwise_distance_int8_plain(a, b)
    _build.require_cuda("pairwise_distance_int8", a, b)
    bsz, m, d = a.shape
    n = b.shape[1]
    out = torch.empty((bsz, m, n), dtype=torch.int32, device=a.device)
    rc = _build.library().pipnn_pairwise_distance_int8(
        a.data_ptr(), b.data_ptr(), bsz, m, n, d, out.data_ptr(), _build.stream_ptr(a))
    _build.check(rc, "pairwise_distance_int8")
    launches_int8 += 1
    return out


def launch_plan() -> dict:
    """``pairwise_distance``'s launch plan (``pipnn_pairwise_distance_plan``):
    the dynamic shared memory of its ring, the same at every shape."""
    return {"smem": _build.plan_value("pipnn_pairwise_distance_plan")[0]}


def launch_plan_int8() -> dict:
    """``pairwise_distance_int8``'s launch plan
    (``pipnn_pairwise_distance_int8_plan``), as ``launch_plan``."""
    return {"smem": _build.plan_value("pipnn_pairwise_distance_int8_plan")[0]}


def work(a: torch.Tensor, b: torch.Tensor, metric: str = "l2") -> dict:
    """The least work of ``pairwise_distance``: 2*B*M*N*D products at three
    TF32 products each (3xTF32); both inputs read and the output written
    once, float32."""
    bsz, m, d = a.shape
    n = b.shape[1]
    return {"ops": {"tf32": 3.0 * 2.0 * bsz * m * n * d},
            "bytes": 4.0 * (bsz * m * d + bsz * n * d + bsz * m * n)}


def work_int8(a: torch.Tensor, b: torch.Tensor) -> dict:
    """The least work of ``pairwise_distance_int8``: 2*B*M*N*D int8
    operations; the int8 inputs read and the int32 output written once."""
    bsz, m, d = a.shape
    n = b.shape[1]
    return {"ops": {"int8": 2.0 * bsz * m * n * d},
            "bytes": float(bsz * (m + n) * d + 4.0 * bsz * m * n)}
