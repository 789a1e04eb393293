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
one backward a microbatch where the reference scans over them; its
``constraint_fn`` hook lays each microbatch's leaves out on a mesh
(``launch.steps.microbatch_constraint``).

On an LM mesh the parameters are ``sharding.MeshParams``: the moments are
``MeshParams`` of the same blocks, made once for a tensor the local shards
share; the clip reads the logical tree's norm (``sharding.global_norm``);
and each distinct block tensor takes one step, so a replicated leaf that
every local shard refers to is not stepped once a shard.  The step count
is one tensor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import Laid, MeshParams
from repro_torch.tree import tree_leaves, tree_unflatten


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


def _leaves(params: Any):
    """(the distinct parameter tensors, ``rebuild(tensors)`` -> the tree of
    ``params``' structure holding them): a tree's leaves, or a
    ``MeshParams``' distinct blocks."""
    if isinstance(params, MeshParams):
        return sharding.distinct_leaves(params)
    return tree_leaves(params), lambda leaves: tree_unflatten(params, leaves)


def init(cfg: AdamWConfig, params: Any) -> AdamWState:
    """Zero moments in ``moment_dtype`` beside each parameter (each
    distinct block of a ``MeshParams``), step 0."""
    leaves, rebuild = _leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")

    def zeros():
        return rebuild([torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)
                        for p in leaves])

    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev), m=zeros(), v=zeros())


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
    ``grads`` are left as they are, and the step is a new tensor.  On a
    mesh ``grads`` hold the logical gradient of every block
    (``sharding.reduce_replicated``)."""
    if isinstance(params, MeshParams):
        gnorm = sharding.global_norm(grads.shards, grads.specs, params.mesh)
        slots = _distinct_slots(params, grads, state.m, state.v)
    else:
        gnorm = global_norm(grads)
        slots = zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state.m),
                    tree_leaves(state.v))
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    for p, g, m, v in slots:
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


def _distinct_slots(params: MeshParams, *trees: MeshParams):
    """(parameter, and its block in each of ``trees``) for each distinct
    parameter tensor of the local shards, once."""
    seen = set()
    for j, tree in enumerate(params.shards):
        for slot in zip(tree_leaves(tree), *(tree_leaves(t.shards[j]) for t in trees)):
            if id(slot[0]) not in seen:
                seen.add(id(slot[0]))
                yield slot


def stack_micro(key: str, x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """A batch leaf as [n_micro, B / n_micro, ...] (the VLM's ``positions``
    [3, B, T] as [n_micro, 3, B / n_micro, T]), microbatch i holding rows
    [i B / n_micro, (i + 1) B / n_micro), as the reference splits it."""
    axis = 1 if key == "positions" else 0
    b = x.shape[axis]
    if b % n_micro:
        raise ValueError(f"batch {b} % micro {n_micro}")
    return x.reshape(x.shape[:axis] + (n_micro, b // n_micro) + x.shape[axis + 1:]).movedim(axis, 0)


def _value_and_flat_grad(loss_fn: Callable, params: Any, batch: dict):
    leaves, rebuild = _leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    loss = loss_fn(rebuild(live), batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
    return loss.detach(), list(grads), rebuild


def value_and_grad(loss_fn: Callable, params: Any, batch: dict):
    """(loss, grads) of ``loss_fn(params, batch)``: each parameter taken as
    a leaf of the graph (a detached alias; ``params`` keep their flags), an
    unused one's gradient zeros.  On a mesh each distinct block is one
    leaf of the graph, so a block the local shards share has one
    gradient: its uses on every local shard summed."""
    loss, grads, rebuild = _value_and_flat_grad(loss_fn, params, batch)
    return loss, rebuild(grads)


def accumulate_grads(loss_fn: Callable, params: Any, batch: dict, n_micro: int,
                     constraint_fn: Callable | None = None):
    """Mean loss and mean grads over ``n_micro`` microbatches (one backward
    each, so only one microbatch's activations are live), the grads summed
    in float32.  With ``n_micro`` 1 the grads keep the parameters' dtype,
    as the reference's.  ``constraint_fn(key, x)`` takes each leaf stacked
    [n_micro, B / n_micro, ...] (``stack_micro``) and returns it, or a
    ``sharding.Laid`` of it cut onto a mesh, microbatch i of which is
    ``Laid.micro(i)``."""
    if n_micro == 1:
        return value_and_grad(loss_fn, params, batch)
    micro = {k: stack_micro(k, x, n_micro) for k, x in batch.items()}
    if constraint_fn is not None:
        micro = {k: constraint_fn(k, x) for k, x in micro.items()}
    tot_loss, acc, rebuild = torch.zeros((), dtype=torch.float32), None, None
    for i in range(n_micro):
        mb = {k: x.micro(i) if isinstance(x, Laid) else x[i] for k, x in micro.items()}
        loss, flat, rebuild = _value_and_flat_grad(loss_fn, params, mb)
        tot_loss = tot_loss.to(loss.device) + loss
        if acc is None:
            acc = [g.float() for g in flat]
        else:
            for a, g in zip(acc, flat):
                a.add_(g)
        del flat
    inv = 1.0 / n_micro
    return tot_loss * inv, rebuild([a.mul_(inv) for a in acc])
