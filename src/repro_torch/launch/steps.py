"""Step builders (counterpart of ``repro/launch/steps.py``): the model of
an architecture, which ``launch/serve.py::Server`` serves and
``launch/train.py`` trains, and the train step.

The reference's prefill and decode step builders wrap ``Model.prefill``
and ``Model.decode_step`` to be jitted; eager PyTorch calls them directly.
``build_model(..., mesh=)`` builds the model on an LM mesh
(``launch.mesh.LMMesh``) under the arch's policy, for serving.  The train
step's mesh arguments (``make_train_step``'s, ``microbatch_constraint``,
``train_state_shardings``) are not ported yet (ROADMAP.md section 1); the
cell programs, ``abstract_train_state`` and ``act_sharding_for`` are jax
lowering machinery with no counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

from repro_torch.configs.base import ArchConfig
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
    and AdamW's zero state beside them."""
    params = model.init(generator, device)
    return TrainState(params=params, opt=adamw.init(opt_cfg, params))


def make_train_step(model: model_zoo.Model, opt_cfg: adamw.AdamWConfig,
                    n_micro: int = 1) -> Callable:
    """``train_step(state, batch) -> (state, metrics {"grad_norm", "lr",
    "loss"})``: the mean loss and grads over ``n_micro`` microbatches, then
    one AdamW update, which writes the state's tensors in place (the
    reference donates its state)."""

    def train_step(state: TrainState, batch: dict):
        loss, grads = adamw.accumulate_grads(model.loss_fn, state.params, batch, n_micro)
        params, opt, metrics = adamw.update(opt_cfg, grads, state.opt, state.params)
        metrics["loss"] = loss
        return TrainState(params, opt), metrics

    return train_step
