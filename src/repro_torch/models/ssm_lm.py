"""Attention-free SSM language model, mamba2-130m (counterpart of
``repro/models/ssm_lm.py``).

Parameters: ``{"embed": {"table"}, "blocks": [{"ln", "mamba"} a layer],
"final_norm"}``; the reference stacks the blocks on a leading [L, ...]
axis and scans, the port loops over a list.  Activations are float32 (the
reference casts nothing after the embedding).  The decode state is O(1) in
the context: the cache holds each layer's conv window and SSM state, and
no ``max_len`` bounds it.  ``forward`` and ``loss_fn`` record autograd
graphs, each layer checkpointed with ``remat``; ``prefill`` and
``decode_step`` build none.  ``mesh_forward``, ``mesh_loss_fn``,
``mesh_prefill`` and ``mesh_decode_step`` run the model on an LM mesh:
each layer's weights gathered inside the layer (inside its checkpoint in
training) and run by ``mamba2.mesh_mamba2``; the embedding, the tied
unembedding and the loss as ``transformer``'s on the mesh.  The mesh cache
is an ``SSMCache`` of lists, one tensor a local shard (``mamba2``'s mesh
section says what each holds); ``mesh_full_cache`` puts it back together.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import MeshParams, gather
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.layers import Params
from repro_torch.models.mamba2 import (
    Mamba2Config,
    Mamba2State,
    mamba2_decode_step,
    mamba2_forward,
    mamba2_init,
    mamba2_prefill_state,
    mesh_layout,
    mesh_mamba2,
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


# ---------------------------------------------------------------------------
# On an LM mesh (``launch.mesh.LMMesh``)
# ---------------------------------------------------------------------------

def mesh_layer(mp: MeshParams, cfg, i: int, xs: list, mode: str, cache=None) -> tuple:
    """Mamba2 layer ``i`` (``{"ln", "mamba"}`` of ``mp``'s ``blocks``) on
    each local shard, its weights gathered here: (each shard's activations
    after it, each shard's decode state in "prefill" and "decode")."""
    blk, rest = T._layer_weights(mp, "blocks", i)
    hs = [L.rmsnorm(b["ln"], x, cfg.norm_eps) for b, x in zip(blk, xs)]
    states = None if cache is None else [Mamba2State(conv=c[i], ssm=s[i])
                                         for c, s in zip(cache.conv, cache.ssm)]
    ys, sts = mesh_mamba2(mp.mesh, cfg.mamba_config(), [b["mamba"] for b in blk],
                          rest["mamba"], hs, mode, states)
    return [x + y for x, y in zip(xs, ys)], sts


def _collect(into: dict, sts: list) -> None:
    """Each shard's prefill state appended to ``into``'s per-shard lists."""
    for j, st in enumerate(sts):
        into.setdefault("conv", [[] for _ in sts])[j].append(st.conv)
        into.setdefault("ssm", [[] for _ in sts])[j].append(st.ssm)


def _write(cache, i: int, sts: list) -> None:
    """Each shard's decode state after the token written into layer ``i``."""
    for c, s, st in zip(cache.conv, cache.ssm, sts):
        c[i] = st.conv
        s[i] = st.ssm


def _mesh_hidden(mp: MeshParams, cfg: SSMConfig, batch: dict):
    """(the batch's parts, each shard's hidden states after the final
    norm), each layer checkpointed with its gather inside."""
    _, parts = T._shard_batch(mp, batch)

    def layer(i, xs):
        return mesh_layer(mp, cfg, i, xs, "forward")[0]

    xs = T.mesh_embed(mp, parts["tokens"])
    for i in range(cfg.n_layers):
        xs = L.remat_call(cfg.remat, layer, i, xs)
    return parts, [L.rmsnorm(s["final_norm"], x, cfg.norm_eps) for s, x in zip(mp.shards, xs)]


def mesh_forward(mp: MeshParams, cfg: SSMConfig, tokens: torch.Tensor) -> torch.Tensor:
    """``forward`` on a mesh, with an autograd graph: hidden [B, T, D]
    after the final norm, gathered on every rank."""
    _, hs = _mesh_hidden(mp, cfg, {"tokens": tokens})
    return gather(mp.mesh, hs, (T.batch_axis(mp, tokens.shape[0]), None, None))[0]


def mesh_loss_fn(mp: MeshParams, cfg: SSMConfig, batch: dict) -> torch.Tensor:
    """``loss_fn`` on a mesh, each token counted once
    (``transformer.mesh_cross_entropy``): the whole loss, autograd from
    this rank's part."""
    parts, hs = _mesh_hidden(mp, cfg, batch)
    return T.mesh_cross_entropy(mp, hs, parts["labels"], cfg.z_loss)


@torch.no_grad()
def mesh_prefill(mp: MeshParams, cfg: SSMConfig, tokens: torch.Tensor, max_len: int):
    """``prefill`` on a mesh (``tokens`` the whole batch, the same on every
    rank): (``MeshLogits``, the ``SSMCache`` of lists)."""
    b_ax, parts = T._shard_batch(mp, {"tokens": tokens})
    xs = T.mesh_embed(mp, parts["tokens"])
    got = {}
    for i in range(cfg.n_layers):
        xs, sts = mesh_layer(mp, cfg, i, xs, "prefill")
        _collect(got, sts)
    return T._last_logits(mp, cfg, xs, b_ax), SSMCache(
        conv=[torch.stack(c) for c in got["conv"]], ssm=[torch.stack(s) for s in got["ssm"]],
        index=tokens.shape[1])


@torch.no_grad()
def mesh_decode_step(mp: MeshParams, cfg: SSMConfig, token: torch.Tensor, cache: SSMCache):
    """``decode_step`` on a mesh: (``MeshLogits``, the cache one token on;
    each shard's states written in place)."""
    b_ax, parts = T._shard_batch(mp, {"tokens": token})
    xs = T.mesh_embed(mp, parts["tokens"])
    for i in range(cfg.n_layers):
        xs, sts = mesh_layer(mp, cfg, i, xs, "decode", cache)
        _write(cache, i, sts)
    return T._last_logits(mp, cfg, xs, b_ax), cache._replace(index=cache.index + 1)


def full_states(mp: MeshParams, mcfg: Mamba2Config, conv: list, ssm: list, batch: int):
    """The whole [L, B, W-1, conv_dim] conv windows and [L, B, H, P, N]
    SSM states (float32) from each local shard's."""
    _, shards = mesh_layout(mp.mesh, mcfg, T.layer_rest(mp, "blocks", 0)["mamba"])
    rows = T.batch_rows(mp, batch)
    n = conv[0].shape[0]
    every = slice(None)
    return (T.put_back(conv, rows, [every if s.ch is None else s.ch for s in shards],
                       (n, batch, mcfg.conv_width - 1, mcfg.conv_dim), 1, 3),
            T.put_back(ssm, rows, [s.heads for s in shards],
                       (n, batch, mcfg.n_heads, mcfg.head_dim, mcfg.d_state), 1, 2))


def mesh_full_cache(mp: MeshParams, cfg: SSMConfig, cache: SSMCache, batch: int) -> SSMCache:
    """The one-card ``SSMCache`` (float32) put back together from a mesh
    cache of ``batch`` rows."""
    conv, ssm = full_states(mp, cfg.mamba_config(), cache.conv, cache.ssm, batch)
    return SSMCache(conv=conv, ssm=ssm, index=cache.index)
