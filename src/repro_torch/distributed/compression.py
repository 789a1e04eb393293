"""Gradient compression for the data-axis all-reduce (counterpart of
``repro/distributed/compression.py``).

Across pods the data-parallel gradient all-reduce crosses the slow
interconnect; compressing its payload to bfloat16 halves the wire bytes,
to int8 with a per-tensor scale quarters them.  Error feedback keeps each
step's quantization residual and adds it back the next step.

``compressed_psum`` takes one gradient tree a local shard of an
``launch.mesh.LMMesh`` and means it over each shard's line of ``axis``
(the reference runs it inside ``shard_map`` over that axis).  Nothing in
the port calls it, as nothing in the reference does: the train step sums
its gradients in float32 (``sharding.reduce_replicated``).  The
rounding is the reference's: ``torch.round`` rounds half to even as
``jnp.round`` does, and int8 divides by the scale before it clips.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten


class ErrorFeedbackState(NamedTuple):
    residual: Any  # float32 trees matching the gradients


def ef_init(grads_like: Any) -> ErrorFeedbackState:
    """Zero float32 residuals beside every leaf of ``grads_like``."""
    return ErrorFeedbackState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads_like))


def compress_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16)


def decompress_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.float()


def compress_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, float32 scale): the scale is the largest magnitude
    over 127 (at least 1e-12 / 127)."""
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@torch.no_grad()
def compressed_psum(grads: list, ef: ErrorFeedbackState, mesh, axis: str = "data",
                    method: str = "bf16") -> tuple[list, ErrorFeedbackState]:
    """The mean of ``grads`` (one tree a local shard) over each shard's
    line of ``axis``, sent compressed with error feedback (``ef.residual``:
    one float32 tree a local shard, ``ef_init(grads)``).  ``method``
    "none" (the plain mean, the residual untouched), "bf16" or "int8".
    Returns (the mean trees, each leaf in its gradient's dtype, and the
    new error-feedback state)."""
    if method not in ("none", "bf16", "int8"):
        raise ValueError(f"unknown compression {method!r}")
    n = mesh.shape.shape[axis]
    flat = [tree_flatten(g)[1] for g in grads]
    if method == "none":
        cols = [[t / n for t in mesh.psum([f[i] for f in flat], axis)]
                for i in range(len(flat[0]))]
        return [tree_unflatten(g, [c[j] for c in cols]) for j, g in enumerate(grads)], ef
    res = [tree_leaves(r) for r in ef.residual]
    means, errs = [], []
    for i in range(len(flat[0])):
        sent, err = [], []
        for f, r in zip(flat, res):
            g32 = f[i].float() + r[i]
            if method == "bf16":
                deq = decompress_bf16(compress_bf16(g32))
            else:
                deq = decompress_int8(*compress_int8(g32))
            sent.append(deq)
            err.append(g32 - deq)
        means.append([(t / n).to(f[i].dtype) for t, f in zip(mesh.psum(sent, axis), flat)])
        errs.append(err)
    out = [tree_unflatten(g, [m[j] for m in means]) for j, g in enumerate(grads)]
    new = [tree_unflatten(r, [e[j] for e in errs]) for j, r in enumerate(ef.residual)]
    return out, ErrorFeedbackState(residual=new)


def wire_bytes(grads: Any, method: str) -> int:
    """Bytes one shard puts on the wire a round for ``grads`` (one tree):
    4, 2 or 1 an element for "none", "bf16", "int8" (the int8 scales
    aside, as the reference counts)."""
    per = {"none": 4, "bf16": 2, "int8": 1}[method]
    return sum(t.numel() * per for t in tree_leaves(grads))
