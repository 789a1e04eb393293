"""Top-f selection with ``lax.top_k``'s tie rule, the sort keys that carry
the reference's multi-key ``lax.sort`` orders over to PyTorch, and the
row-wise top-k kernel.

``torch.topk`` does not break ties toward the lower index, so every
selection here runs on a composite int64 key ``(ordered(value), index)``:
the keys are unique, so any correct top-k or sort of them gives the one
order a stable sort of the values gives.  ``ordered`` maps float32 to an
int32 that sorts like the float (``-0.0`` folded onto ``+0.0``, as XLA's
sort comparator does).

``rowwise_topk`` replaces the Pallas kernel ``repro/kernels/topk.py::
rowwise_topk`` (``_topk_kernel``, ``pallas_call`` at ``:70``; its selection
rule is ``repro/kernels/leaf_knn.py::_merge_topk``): the k smallest entries
of each row of an existing [B, M, N] matrix, ascending, ties to the lower
column, and id -1 in every slot whose value is not finite.  The CUDA kernel
(``csrc/topk.cu``) gives each row one warp, which reads it in 1024-column
chunks with all loads in flight (16-byte lanes where rows are 16-byte
aligned), bounds each chunk's top k by the k-th smallest of its 32 lane
minima, and ranks the few columns under that bar exactly, together with
the running list, in a per-warp shared-memory buffer (in rounds where they
overflow it).  k is a runtime argument up to 32, one slot a lane.  Bound
on the card: bytes, the matrix read once.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_SIGN_FLIP = 0x7FFFFFFF
_LO = 1 << 31
_HI = 1 << 32
MAX_K = 32    # largest k the rowwise_topk kernel takes: one slot a lane

launches = 0   # rowwise_topk kernel launches since the last reset


def ordered(v: torch.Tensor) -> torch.Tensor:
    """int32 view of float32 ``v`` whose integer order is the float order
    (``-0.0 == +0.0``; +inf above every finite value)."""
    v = torch.where(v == 0, torch.zeros((), dtype=v.dtype, device=v.device), v)
    bits = v.contiguous().view(torch.int32)
    return torch.where(bits >= 0, bits, bits ^ _SIGN_FLIP)


def lex_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int64 key ordering lexicographically by (hi, lo), both int32."""
    return hi.to(torch.int64) * _HI + (lo.to(torch.int64) + _LO)


def stable_argsort(key: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.sort(key, dim=dim, stable=True).indices


def topf(dists: torch.Tensor, f: int) -> torch.Tensor:
    """Indices [..., f] (int32) of the f smallest entries along the last
    axis, ascending; equal values go to the lower index.

    f passes of ``argmin`` (which returns the first of equal minima) over
    the ``ordered`` keys; a picked entry is raised to INT32_MAX, above
    every float key including +inf, so each pass picks a new index even
    among +inf entries, as ``lax.top_k`` does."""
    key = ordered(dists).clone()
    out = torch.empty(dists.shape[:-1] + (f,), dtype=torch.int32, device=dists.device)
    for j in range(f):
        idx = torch.argmin(key, dim=-1, keepdim=True)
        out[..., j] = idx[..., 0]
        key.scatter_(-1, idx, _SIGN_FLIP)
    return out


def rowwise_topk_plain(d: torch.Tensor, k: int):
    """Plain PyTorch version of ``rowwise_topk``; runs on any device."""
    n = d.shape[-1]
    if k > n:   # the reference pads the columns with +inf
        d = torch.cat([d, d.new_full(d.shape[:-1] + (k - n,), float("inf"))], dim=-1)
    idx = topf(d, k)
    vals = torch.gather(d, -1, idx.long())
    return torch.where(torch.isfinite(vals), idx, -1), vals


def rowwise_topk(d: torch.Tensor, k: int):
    """Row-wise k smallest entries of ``d`` [B, M, N] float32 (+inf =
    masked): returns ``(ids, values)``, [B, M, k] each, in that order.
    Ascending by value, equal values to the lower column; a slot whose
    value is not finite gets id -1 (so rows with fewer than k finite
    entries end in -1).  CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    global launches
    if d.dim() != 3:
        raise ValueError(f"rowwise_topk takes a [B, M, N] matrix, got {tuple(d.shape)}")
    if k < 1:
        raise ValueError(f"rowwise_topk needs k >= 1, got {k}")
    if d.device.type == "cpu":
        return rowwise_topk_plain(d, k)
    if k > MAX_K:
        raise ValueError(f"the rowwise_topk kernel supports k <= {MAX_K}, got {k}")
    if d.dtype != torch.float32:
        raise TypeError("rowwise_topk takes a float32 matrix")
    _build.require_cuda("rowwise_topk", d)
    bsz, m, n = d.shape
    ids = torch.empty((bsz, m, k), dtype=torch.int32, device=d.device)
    vals = torch.empty((bsz, m, k), dtype=torch.float32, device=d.device)
    rc = _build.library().pipnn_rowwise_topk(
        d.data_ptr(), bsz * m, n, k, ids.data_ptr(), vals.data_ptr(), _build.stream_ptr(d))
    _build.check(rc, "rowwise_topk")
    launches += 1
    return ids, vals
