"""Top-f selection with ``lax.top_k``'s tie rule, and the sort keys that
carry the reference's multi-key ``lax.sort`` orders over to PyTorch.

``torch.topk`` does not break ties toward the lower index, so every
selection here runs on a composite int64 key ``(ordered(value), index)``:
the keys are unique, so any correct top-k or sort of them gives the one
order a stable sort of the values gives.  ``ordered`` maps float32 to an
int32 that sorts like the float (``-0.0`` folded onto ``+0.0``, as XLA's
sort comparator does).
"""
from __future__ import annotations

import torch

_SIGN_FLIP = 0x7FFFFFFF
_LO = 1 << 31
_HI = 1 << 32


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
