"""AdamW with configurable moment dtypes, a cosine schedule, clipping and
microbatched gradient accumulation (counterpart of
``repro/optim/adamw.py``).

Memory knobs, as in the reference: ``moment_dtype`` float32 (the default)
or bfloat16 moments (half the optimizer's memory); the parameters stay in
their own dtype and every update is computed in float32, in the
reference's order of operations.

``update`` writes the new parameters and moments into the given tensors
(the reference's train step donates its state; here the buffers are
reused in place), so one set of each is live.  ``accumulate_grads`` runs
one backward a microbatch where the reference scans over them.  The
reference's ``constraint_fn`` (a GSPMD sharding pin of each split) has no
counterpart on one card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    moment_dtype: torch.dtype = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 scalar, on the parameters' device
    m: Any               # first moments, the parameters' tree in moment_dtype
    v: Any               # second moments


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_frac``, float32, on
    ``step``'s device (an int32 tensor, or an int taken to the CPU)."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init(cfg: AdamWConfig, params: Any) -> AdamWState:
    """Zero moments in ``moment_dtype`` beside each parameter, step 0."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")

    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)

    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree: Any) -> torch.Tensor:
    """The float32 L2 norm over every leaf of ``tree``."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


def _moment(buf: torch.Tensor, decay: float, inc: torch.Tensor) -> torch.Tensor:
    """``decay * buf + inc`` in float32, written back into ``buf`` (in its
    dtype); returns the float32 value."""
    if buf.dtype == torch.float32:
        return buf.mul_(decay).add_(inc)
    new = buf.float().mul_(decay).add_(inc)
    buf.copy_(new)
    return new


@torch.no_grad()
def update(cfg: AdamWConfig, grads: Any, state: AdamWState, params: Any):
    """One AdamW step.  Returns (params, state, metrics {"grad_norm",
    "lr"}): the parameters and moments are written in place (each
    parameter cast back to its dtype, each moment to ``moment_dtype``),
    ``grads`` are left as they are, and the step is a new tensor."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state.m),
                          tree_leaves(state.v)):
        g = g.float() * scale
        m32 = _moment(m, cfg.b1, g * (1 - cfg.b1))
        v32 = _moment(v, cfg.b2, (1 - cfg.b2) * g * g)
        del g
        delta = m32 / b1c                                  # mh
        denom = (v32 / b2c).sqrt_().add_(cfg.eps)          # sqrt(vh) + eps
        delta.div_(denom).add_(cfg.weight_decay * p.float())
        del denom
        delta.mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_(p.float() - delta)
    return params, AdamWState(step=step, m=state.m, v=state.v), {"grad_norm": gnorm, "lr": lr}


def split_batch(batch: dict, n_micro: int) -> list[dict]:
    """The ``n_micro`` microbatches of ``batch``, each a slice of every
    leaf along its batch axis (axis 1 for the VLM's ``positions`` [3, B, T],
    else 0), in order."""
    out = [{} for _ in range(n_micro)]
    for key, x in batch.items():
        axis = 1 if key == "positions" else 0
        b = x.shape[axis]
        if b % n_micro:
            raise ValueError(f"batch {b} % micro {n_micro}")
        for i, part in enumerate(torch.chunk(x, n_micro, dim=axis)):
            out[i][key] = part
    return out


def value_and_grad(loss_fn: Callable, params: Any, batch: dict):
    """(loss, grads) of ``loss_fn(params, batch)``: each parameter taken as
    a leaf of the graph (a detached alias; ``params`` keep their flags), an
    unused one's gradient zeros."""
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss = loss_fn(tree_unflatten(params, live), batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
    return loss.detach(), tree_unflatten(params, list(grads))


def accumulate_grads(loss_fn: Callable, params: Any, batch: dict, n_micro: int):
    """Mean loss and mean grads over ``n_micro`` microbatches (one backward
    each, so only one microbatch's activations are live), the grads summed
    in float32.  With ``n_micro`` 1 the grads keep the parameters' dtype,
    as the reference's."""
    if n_micro == 1:
        return value_and_grad(loss_fn, params, batch)
    tot_loss, acc = torch.zeros((), dtype=torch.float32), None
    for mb in split_batch(batch, n_micro):
        loss, grads = value_and_grad(loss_fn, params, mb)
        tot_loss = tot_loss.to(loss.device) + loss
        flat = tree_leaves(grads)
        del grads
        if acc is None:
            acc = [g.float() for g in flat]
        else:
            for a, g in zip(acc, flat):
                a.add_(g)
        del flat
    inv = 1.0 / n_micro
    return tot_loss * inv, tree_unflatten(params, [a.mul_(inv) for a in acc])
