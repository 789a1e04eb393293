"""One model interface over the families (counterpart of
``repro/models/model_zoo.py``).

``build(config, family)`` returns a ``Model`` with the interface the
server and the tests use:

  * ``init(generator, device=None) -> params``
  * ``forward(params, batch) -> hidden [B, T, D]`` after the final norm
    (``encdec``: ``encode`` of the frames, then ``decode_train``)
  * ``loss_fn(params, batch) -> scalar`` (the train step's loss; ``batch``
    also holds ``labels`` [B, T])
  * ``prefill(params, batch, max_len) -> (logits [B, V], cache)``
  * ``decode_step(params, token, cache) -> (logits [B, V], cache)``
  * ``train_batch_spec(b, t) -> {name: (shape, dtype)}``, the train
    step's batch

``batch`` holds ``tokens`` [B, T]; for the ``vlm`` family also M-RoPE
``positions`` [3, B, T], and for ``encdec`` the encoder's ``frames``
[B, S, D].  The families: ``dense``, ``moe`` and ``vlm``
(``transformer``), ``encdec``, ``ssm`` (``ssm_lm``) and ``hybrid``; every
family builds on an LM mesh too (``build(mesh=, policy=)``: the modules'
``mesh_*`` functions, the parameters ``sharding.MeshParams``), where
``mesh_full_cache`` puts an ssm, hybrid or encdec mesh cache back
together.  The mesh paths of
the ssm, hybrid and encdec families are held against the JAX package on
the CPU by ``PYTHONPATH=src python -m pytest -q
tests/test_torch_lm_families_mesh.py`` and run at full width on the card
by phase 18 of ``python3 chip_smoke.py``.  The
reference's other ``*_spec`` functions (abstract inputs for JAX's
ahead-of-time lowering of prefill and decode) are not here.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.distributed import sharding
from repro_torch.models import encdec, hybrid, ssm_lm, transformer

TRANSFORMER_FAMILIES = ("dense", "moe", "vlm")


class Model(NamedTuple):
    family: str
    config: Any
    init: Callable
    forward: Callable
    loss_fn: Callable
    prefill: Callable
    decode_step: Callable
    train_batch_spec: Callable


def _train_spec(family: str, d_model: int, b: int, t: int) -> dict:
    """The train batch's leaves as (shape, dtype): int32 tokens and labels
    [B, T]; the VLM's M-RoPE positions [3, B, T]; the encoder's bfloat16
    frames [B, T, D]."""
    spec = {"tokens": ((b, t), torch.int32), "labels": ((b, t), torch.int32)}
    if family == "vlm":
        spec["positions"] = ((3, b, t), torch.int32)
    if family == "encdec":
        spec = {"frames": ((b, t, d_model), torch.bfloat16), **spec}
    return spec


def _build_on_mesh(cfg: Any, family: str, mesh, policy: str) -> Model:
    if policy not in sharding.POLICIES:
        raise ValueError(f"unknown policy {policy!r}; one of {sharding.POLICIES}")
    if family in TRANSFORMER_FAMILIES:
        def init(generator, device=None):
            dev = mesh.device if device is None else device
            return sharding.shard_parts(transformer.init_parts(cfg, generator, dev), mesh,
                                        family, policy, cfg.n_layers)

        def forward(params, batch):
            return transformer.mesh_forward(params, cfg, batch["tokens"],
                                            positions=batch.get("positions"))[0]

        def prefill(params, batch, max_len):
            return transformer.mesh_prefill(params, cfg, batch["tokens"], max_len,
                                            positions=batch.get("positions"))
        module = transformer
    elif family == "encdec":
        def forward(params, batch):
            return encdec.mesh_decode_train(params, cfg, batch["tokens"], batch["frames"])

        def prefill(params, batch, max_len):
            return encdec.mesh_prefill(params, cfg, batch["frames"], batch["tokens"], max_len)
        module = encdec
    elif family in ("ssm", "hybrid"):
        module = ssm_lm if family == "ssm" else hybrid

        def forward(params, batch):
            return module.mesh_forward(params, cfg, batch["tokens"])

        def prefill(params, batch, max_len):
            return module.mesh_prefill(params, cfg, batch["tokens"], max_len)
    else:
        raise ValueError(f"unknown family {family!r}")
    if family not in TRANSFORMER_FAMILIES:
        def init(generator, device=None):
            # the one-card parameters drawn from the seed, then cut
            dev = mesh.device if device is None else device
            return sharding.shard_params(module.init(cfg, generator, device=dev), mesh, family,
                                         policy)

    def decode(params, token, cache):
        return module.mesh_decode_step(params, cfg, token, cache)

    def loss(params, batch):
        return module.mesh_loss_fn(params, cfg, batch)

    return Model(family=family, config=cfg, init=init, forward=forward, loss_fn=loss,
                 prefill=prefill, decode_step=decode,
                 train_batch_spec=lambda b, t: _train_spec(family, cfg.d_model, b, t))


def mesh_full_cache(model: Model, params, cache, batch: int):
    """A mesh cache of ``batch`` rows of the ssm, hybrid or encdec family
    put back together as the one-card cache (float32 tensors), each entry
    checked alike on every shard that holds it."""
    module = {"encdec": encdec, "ssm": ssm_lm, "hybrid": hybrid}[model.family]
    return module.mesh_full_cache(params, model.config, cache, batch)


def build(cfg: Any, family: str, *, mesh=None, policy: str = "fsdp_tp") -> Model:
    """The model of ``cfg`` (of ``family``); on ``mesh`` (an ``LMMesh``)
    under ``policy`` where one is given."""
    if mesh is not None:
        return _build_on_mesh(cfg, family, mesh, policy)
    if family in TRANSFORMER_FAMILIES:
        def forward(params, batch):
            return transformer.forward(params, cfg, batch["tokens"],
                                       positions=batch.get("positions"))[0]

        def prefill(params, batch, max_len):
            return transformer.prefill(params, cfg, batch["tokens"], max_len,
                                       positions=batch.get("positions"))
        module = transformer
    elif family == "encdec":
        def forward(params, batch):
            memory = encdec.encode(params, cfg, batch["frames"])
            return encdec.decode_train(params, cfg, batch["tokens"], memory)

        def prefill(params, batch, max_len):
            return encdec.prefill(params, cfg, batch["frames"], batch["tokens"], max_len)
        module = encdec
    elif family in ("ssm", "hybrid"):
        module = ssm_lm if family == "ssm" else hybrid

        def forward(params, batch):
            return module.forward(params, cfg, batch["tokens"])

        def prefill(params, batch, max_len):
            return module.prefill(params, cfg, batch["tokens"], max_len)
    else:
        raise ValueError(f"unknown family {family!r}")

    def init(generator, device=None):
        return module.init(cfg, generator, device=device)

    def decode(params, token, cache):
        return module.decode_step(params, cfg, token, cache)

    def loss(params, batch):
        return module.loss_fn(params, cfg, batch)

    def train_spec(b, t):
        return _train_spec(family, cfg.d_model, b, t)

    return Model(family=family, config=cfg, init=init, forward=forward, loss_fn=loss,
                 prefill=prefill, decode_step=decode, train_batch_spec=train_spec)
