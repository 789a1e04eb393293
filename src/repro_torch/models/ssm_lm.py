"""Attention-free SSM language model, mamba2-130m (counterpart of
``repro/models/ssm_lm.py``).

Parameters: ``{"embed": {"table"}, "blocks": [{"ln", "mamba"} a layer],
"final_norm"}``; the reference stacks the blocks on a leading [L, ...]
axis and scans, the port loops over a list.  Activations are float32 (the
reference casts nothing after the embedding).  The decode state is O(1) in
the context: the cache holds each layer's conv window and SSM state, and
no ``max_len`` bounds it.  ``forward`` and ``loss_fn`` record autograd
graphs, each layer checkpointed with ``remat``; ``prefill`` and
``decode_step`` build none.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.layers import Params
from repro_torch.models.mamba2 import (
    Mamba2Config,
    Mamba2State,
    mamba2_decode_step,
    mamba2_forward,
    mamba2_init,
    mamba2_prefill_state,
)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    name: str
    n_layers: int
    d_model: int
    vocab: int
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk: int = 128
    norm_eps: float = 1e-5
    param_dtype: Any = torch.float32
    remat: bool = True         # activation checkpointing of each layer in training
    z_loss: float = 1e-4       # the loss's z-loss

    def mamba_config(self) -> Mamba2Config:
        return Mamba2Config(d_model=self.d_model, d_state=self.d_state,
                            head_dim=self.head_dim, expand=self.expand, chunk=self.chunk,
                            norm_eps=self.norm_eps)


class SSMCache(NamedTuple):
    conv: torch.Tensor   # [L, B, W-1, conv_dim] float32
    ssm: torch.Tensor    # [L, B, H, P, N] float32
    index: int           # tokens seen


def init(cfg: SSMConfig, generator: torch.Generator, *, device=None) -> Params:
    """Random parameters made on ``device`` (default: the card, which must
    be present) from ``generator``, a ``torch.Generator`` of that device."""
    dev = resolve_device(device)
    mcfg = cfg.mamba_config()
    with torch.no_grad():
        embed = L.embedding_init(cfg.vocab, cfg.d_model, generator, dev, cfg.param_dtype)
        blocks = [{"ln": L.rmsnorm_init(cfg.d_model, cfg.param_dtype, dev),
                   "mamba": mamba2_init(mcfg, generator, dev, cfg.param_dtype)}
                  for _ in range(cfg.n_layers)]
        return {"embed": embed, "blocks": blocks,
                "final_norm": L.rmsnorm_init(cfg.d_model, cfg.param_dtype, dev)}


def forward(params: Params, cfg: SSMConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Hidden states [B, T, D] after the final norm."""
    x = L.embed(params["embed"], tokens)
    mcfg = cfg.mamba_config()

    def layer(x, blk):
        return x + mamba2_forward(blk["mamba"], mcfg, L.rmsnorm(blk["ln"], x, cfg.norm_eps))

    for blk in params["blocks"]:
        x = L.remat_call(cfg.remat, layer, x, blk)
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def loss_fn(params: Params, cfg: SSMConfig, batch: dict) -> torch.Tensor:
    """LM cross entropy (with z-loss) of ``batch`` {tokens, labels}."""
    logits = L.unembed(params["embed"], forward(params, cfg, batch["tokens"]))
    return L.cross_entropy(logits, batch["labels"], z_loss=cfg.z_loss)


@torch.no_grad()
def prefill(params: Params, cfg: SSMConfig, tokens: torch.Tensor, max_len: int):
    """Returns (last-token logits [B, V], SSMCache).  ``max_len`` is unused:
    the decode state is O(1) in the context length."""
    mcfg = cfg.mamba_config()
    x = L.embed(params["embed"], tokens)
    convs, ssms = [], []
    for blk in params["blocks"]:
        h = L.rmsnorm(blk["ln"], x, cfg.norm_eps)
        y = mamba2_forward(blk["mamba"], mcfg, h)
        st = mamba2_prefill_state(blk["mamba"], mcfg, h)
        x = x + y
        convs.append(st.conv)
        ssms.append(st.ssm)
    h = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], h[:, -1:])[:, 0]
    return logits, SSMCache(conv=torch.stack(convs), ssm=torch.stack(ssms),
                            index=tokens.shape[1])


@torch.no_grad()
def decode_step(params: Params, cfg: SSMConfig, token: torch.Tensor, cache: SSMCache):
    """One decode step. token: [B, 1].  Returns (logits [B, V], the cache
    one token on; the states are written in place)."""
    mcfg = cfg.mamba_config()
    x = L.embed(params["embed"], token)
    for i, blk in enumerate(params["blocks"]):
        h = L.rmsnorm(blk["ln"], x, cfg.norm_eps)
        y, st = mamba2_decode_step(blk["mamba"], mcfg, h,
                                   Mamba2State(conv=cache.conv[i], ssm=cache.ssm[i]))
        x = x + y
        cache.conv[i] = st.conv
        cache.ssm[i] = st.ssm
    h = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], h)[:, 0]
    return logits, cache._replace(index=cache.index + 1)
