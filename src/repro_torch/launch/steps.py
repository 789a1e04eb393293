"""Step builders (counterpart of ``repro/launch/steps.py``): the model of
an architecture, which ``launch/serve.py::Server`` serves and
``launch/train.py`` trains, and the train step.

The reference's prefill and decode step builders wrap ``Model.prefill``
and ``Model.decode_step`` to be jitted; eager PyTorch calls them directly.
``build_model(..., mesh=)`` builds the model on an LM mesh
(``launch.mesh.LMMesh``) under the arch's policy.  On a mesh the train
step (``make_train_step(..., mesh=, policy=)``) lays each microbatch out
(``microbatch_constraint``), sums each block's gradient over the axes it
is replicated on (``sharding.reduce_replicated``) and steps each distinct
block once; ``train_state_shardings`` gives the state's specs,
``shard_train_state`` cuts a one-card state onto the mesh and
``sharding.logical_tree`` puts it back.  The cell programs,
``abstract_train_state`` and ``act_sharding_for`` are jax lowering
machinery with no counterpart (a state on the ``meta`` device stands in
for the abstract one).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding
from repro_torch.models import model_zoo
from repro_torch.optim import adamw


def build_model(arch: ArchConfig, *, smoke: bool = False, moe_impl: str | None = None,
                mesh=None) -> model_zoo.Model:
    """The full-size model of ``arch``, or its smoke model; ``moe_impl``
    replaces the config's MoE dispatch where it has one; on ``mesh`` (an
    ``LMMesh``) under ``arch.parallelism``."""
    cfg = arch.smoke_model if smoke else arch.model
    if moe_impl is not None and hasattr(cfg, "moe_impl"):
        cfg = dataclasses.replace(cfg, moe_impl=moe_impl)
    return model_zoo.build(cfg, arch.family, mesh=mesh, policy=arch.parallelism)


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState


def init_train_state(model: model_zoo.Model, opt_cfg: adamw.AdamWConfig, generator,
                     device=None) -> TrainState:
    """Parameters made on ``device`` from ``generator`` (``Model.init``)
    and AdamW's zero state beside them.  A model built on a mesh cuts each
    layer as ``transformer.init_parts`` draws it (the one-card parameters'
    blocks) and makes the moments beside the blocks."""
    params = model.init(generator, device)
    return TrainState(params=params, opt=adamw.init(opt_cfg, params))


def train_state_shardings(state: TrainState, mesh, family: str,
                          policy: str = "fsdp_tp") -> TrainState:
    """The specs of a one-card train state's leaves on ``mesh``: the
    parameters and both moments ``sharding.param_specs``, the step
    replicated."""
    specs = sharding.param_specs(state.params, mesh.shape, family, policy)
    return TrainState(params=specs, opt=adamw.AdamWState(step=(), m=specs, v=specs))


def shard_train_state(state: TrainState, mesh, family: str, policy: str) -> TrainState:
    """A one-card train state cut onto ``mesh``: the parameters and the
    moments ``sharding.shard_params`` (a leaf whose spec splits nothing one
    tensor every local shard shares), the step as it is."""
    def cut(tree):
        return sharding.shard_params(tree, mesh, family, policy)
    return TrainState(params=cut(state.params),
                      opt=adamw.AdamWState(step=state.opt.step, m=cut(state.opt.m),
                                           v=cut(state.opt.v)))


def microbatch_constraint(mesh, policy: str = "fsdp_tp") -> Callable:
    """``constrain(key, x)``: a microbatch-stacked leaf [n_micro, B / m, ...]
    (the VLM's positions [n_micro, 3, B / m, T]: batch dimension 2) cut
    onto ``mesh`` as a ``sharding.Laid``, its batch dimension over every
    axis (``fsdp``, ``ep_dp``) or the data axes (``fsdp_tp``) where they
    divide it, else the data axes, else replicated (the reference's
    ``microbatch_constraint``)."""
    shape = mesh.shape
    da = sharding.all_axes(shape) if policy in ("fsdp", "ep_dp") else sharding.data_axes(shape)
    da2 = sharding.data_axes(shape)

    def constrain(key: str, x) -> sharding.Laid:
        bdim = 2 if key == "positions" else 1
        axes = da if sharding._dim_ok(x.shape[bdim], shape, da) else \
            (da2 if sharding._dim_ok(x.shape[bdim], shape, da2) else None)
        spec = (None,) * bdim + (axes,) + (None,) * (x.dim() - bdim - 1)
        return sharding.Laid([sharding.shard(x, spec, shape, c) for c in mesh.local], spec)

    return constrain


def make_train_step(model: model_zoo.Model, opt_cfg: adamw.AdamWConfig, n_micro: int = 1,
                    mesh=None, policy: str = "fsdp_tp") -> Callable:
    """``train_step(state, batch) -> (state, metrics {"grad_norm", "lr",
    "loss"})``: the mean loss and grads over ``n_micro`` microbatches, then
    one AdamW update, which writes the state's tensors in place (the
    reference donates its state).  With ``mesh`` (the model built on it,
    the state's parameters ``MeshParams``) each microbatch is laid out by
    ``microbatch_constraint(mesh, policy)`` and each block's gradient is
    summed over the axes it is replicated on before the update."""
    constraint = microbatch_constraint(mesh, policy) if mesh is not None else None

    def train_step(state: TrainState, batch: dict):
        loss, grads = adamw.accumulate_grads(model.loss_fn, state.params, batch, n_micro,
                                             constraint_fn=constraint)
        if mesh is not None:
            grads = grads._replace(
                shards=sharding.reduce_replicated(grads.shards, mesh, grads.specs))
        params, opt, metrics = adamw.update(opt_cfg, grads, state.opt, state.params)
        metrics["loss"] = loss
        return TrainState(params, opt), metrics

    return train_step
