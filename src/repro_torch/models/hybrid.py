"""Hybrid SSM + shared-attention LM, zamba2-2.7b (counterpart of
``repro/models/hybrid.py``).

A deep Mamba2 backbone with ONE shared transformer block (MHA + SwiGLU
MLP) applied after every ``attn_every`` Mamba2 layers: the same
parameters, ``params["shared"]``, serve each of the ``n_apps`` uses (the
reference's simplification of the released checkpoints: no LoRA deltas a
use, no embedding concatenation).  The reference reshapes its stacked
blocks to [n_apps, attn_every] and scans; the port loops.

Decode state: each Mamba2 layer's conv window and SSM state, and one KV
cache a use of the shared block ([n_apps, B, S, KV, hd], bfloat16 by
default), written in place.  Activations are float32.  ``forward`` and
``loss_fn`` record autograd graphs, each Mamba2 layer checkpointed with
``remat`` (the shared block is not, as in the reference); the shared
block's gradient sums over its uses.  ``prefill`` and ``decode_step``
build no graph.

``mesh_forward``, ``mesh_loss_fn``, ``mesh_prefill`` and
``mesh_decode_step`` run the model on an LM mesh: the Mamba2 layers as
``ssm_lm.mesh_layer``; the shared block, a top-level unstacked entry, is
gathered at each of its uses and run by ``transformer``'s mesh attention
and FFN (tensor parallel under ``fsdp_tp``), so its gradient is the sum
over its uses in one process and over a process group alike.  The mesh
cache is a ``HybridCache`` of lists, one tensor a local shard: the Mamba2
states as ``ssm_lm``'s, and one KV cache a use holding the shard's rows
and the KV heads its q heads read; ``mesh_full_cache`` puts it back
together.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import MeshParams, gather
from repro_torch.models import layers as L
from repro_torch.models import ssm_lm
from repro_torch.models import transformer as T
from repro_torch.models.layers import AttnConfig, Params
from repro_torch.models.mamba2 import (
    Mamba2Config,
    Mamba2State,
    mamba2_decode_step,
    mamba2_forward,
    mamba2_init,
    mamba2_prefill_state,
)


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    name: str
    n_layers: int              # mamba2 layers
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    attn_every: int = 18       # the shared block follows every N mamba layers
    d_state: int = 64
    ssm_head_dim: int = 64
    expand: int = 2
    chunk: int = 128
    head_dim: int | None = None
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    q_chunk: int = 512
    param_dtype: Any = torch.float32
    remat: bool = True         # activation checkpointing of each Mamba2 layer in training
    z_loss: float = 1e-4       # the loss's z-loss

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_apps(self) -> int:
        if self.n_layers % self.attn_every:
            raise ValueError(f"n_layers {self.n_layers} is not a multiple of attn_every "
                             f"{self.attn_every}")
        return self.n_layers // self.attn_every

    def attn_config(self) -> AttnConfig:
        return AttnConfig(d_model=self.d_model, n_heads=self.n_heads,
                          n_kv_heads=self.n_kv_heads, head_dim=self.hd,
                          rope_theta=self.rope_theta, q_chunk=self.q_chunk,
                          norm_eps=self.norm_eps)

    def mamba_config(self) -> Mamba2Config:
        return Mamba2Config(d_model=self.d_model, d_state=self.d_state,
                            head_dim=self.ssm_head_dim, expand=self.expand, chunk=self.chunk,
                            norm_eps=self.norm_eps)


class HybridCache(NamedTuple):
    conv: torch.Tensor   # [L, B, W-1, conv_dim] float32
    ssm: torch.Tensor    # [L, B, H, P, N] float32
    k: torch.Tensor      # [n_apps, B, S, KV, hd]
    v: torch.Tensor
    index: int           # next write position


def init(cfg: HybridConfig, generator: torch.Generator, *, device=None) -> Params:
    """Random parameters made on ``device`` (default: the card, which must
    be present) from ``generator``, a ``torch.Generator`` of that device."""
    dev = resolve_device(device)
    dt = cfg.param_dtype
    mcfg = cfg.mamba_config()
    with torch.no_grad():
        embed = L.embedding_init(cfg.vocab, cfg.d_model, generator, dev, dt)
        blocks = [{"ln": L.rmsnorm_init(cfg.d_model, dt, dev),
                   "mamba": mamba2_init(mcfg, generator, dev, dt)}
                  for _ in range(cfg.n_layers)]
        shared = {"ln1": L.rmsnorm_init(cfg.d_model, dt, dev),
                  "ln2": L.rmsnorm_init(cfg.d_model, dt, dev),
                  "attn": L.attn_init(cfg.attn_config(), generator, dev, dt),
                  "mlp": L.mlp_init(cfg.d_model, cfg.d_ff, generator, dev, dtype=dt)}
        return {"embed": embed, "blocks": blocks, "shared": shared,
                "final_norm": L.rmsnorm_init(cfg.d_model, dt, dev)}


def _segments(params: Params, cfg: HybridConfig):
    """The Mamba2 blocks in runs of ``attn_every``, one run a use of the
    shared block, with each block's layer index."""
    per = cfg.attn_every
    blocks = list(enumerate(params["blocks"]))
    return [blocks[a * per:(a + 1) * per] for a in range(cfg.n_apps)]


def forward(params: Params, cfg: HybridConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Hidden states [B, T, D] after the final norm."""
    x = L.embed(params["embed"], tokens)
    pos = L.token_positions(*tokens.shape, x.device)
    mcfg, acfg, sh = cfg.mamba_config(), cfg.attn_config(), params["shared"]

    def mamba_layer(x, blk):
        return x + mamba2_forward(blk["mamba"], mcfg, L.rmsnorm(blk["ln"], x, cfg.norm_eps))

    for seg in _segments(params, cfg):
        for _, blk in seg:
            x = L.remat_call(cfg.remat, mamba_layer, x, blk)
        x = x + L.attention(sh["attn"], acfg, L.rmsnorm(sh["ln1"], x, cfg.norm_eps), pos)
        x = x + L.mlp(sh["mlp"], L.rmsnorm(sh["ln2"], x, cfg.norm_eps))
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def loss_fn(params: Params, cfg: HybridConfig, batch: dict) -> torch.Tensor:
    """LM cross entropy (with z-loss) of ``batch`` {tokens, labels}."""
    logits = L.unembed(params["embed"], forward(params, cfg, batch["tokens"]))
    return L.cross_entropy(logits, batch["labels"], z_loss=cfg.z_loss)


@torch.no_grad()
def prefill(params: Params, cfg: HybridConfig, tokens: torch.Tensor, max_len: int,
            cache_dtype=torch.bfloat16):
    """Returns (last-token logits [B, V], HybridCache with KV caches of
    ``max_len`` slots in ``cache_dtype``)."""
    x = L.embed(params["embed"], tokens)
    b, t = tokens.shape
    pos = L.token_positions(b, t, x.device)
    mcfg, acfg, sh = cfg.mamba_config(), cfg.attn_config(), params["shared"]
    convs, ssms, ks, vs = [], [], [], []
    for seg in _segments(params, cfg):
        for _, blk in seg:
            h = L.rmsnorm(blk["ln"], x, cfg.norm_eps)
            y = mamba2_forward(blk["mamba"], mcfg, h)
            st = mamba2_prefill_state(blk["mamba"], mcfg, h)
            x = x + y
            convs.append(st.conv)
            ssms.append(st.ssm)
        y, (kc, vc) = L.attention_prefill(sh["attn"], acfg, L.rmsnorm(sh["ln1"], x, cfg.norm_eps),
                                          pos, max_len)
        x = x + y
        x = x + L.mlp(sh["mlp"], L.rmsnorm(sh["ln2"], x, cfg.norm_eps))
        ks.append(kc.to(cache_dtype))
        vs.append(vc.to(cache_dtype))
    h = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], h[:, -1:])[:, 0]
    return logits, HybridCache(conv=torch.stack(convs), ssm=torch.stack(ssms),
                               k=torch.stack(ks), v=torch.stack(vs), index=t)


@torch.no_grad()
def decode_step(params: Params, cfg: HybridConfig, token: torch.Tensor, cache: HybridCache):
    """One decode step. token: [B, 1], at position ``cache.index``.
    Returns (logits [B, V], the cache one token on; states and KV caches
    written in place)."""
    x = L.embed(params["embed"], token)
    mcfg, acfg, sh = cfg.mamba_config(), cfg.attn_config(), params["shared"]
    for a, seg in enumerate(_segments(params, cfg)):
        for i, blk in seg:
            h = L.rmsnorm(blk["ln"], x, cfg.norm_eps)
            y, st = mamba2_decode_step(blk["mamba"], mcfg, h,
                                       Mamba2State(conv=cache.conv[i], ssm=cache.ssm[i]))
            x = x + y
            cache.conv[i] = st.conv
            cache.ssm[i] = st.ssm
        y, _ = L.attention_decode(sh["attn"], acfg, L.rmsnorm(sh["ln1"], x, cfg.norm_eps),
                                  cache.index, (cache.k[a], cache.v[a]), cache.index)
        x = x + y
        x = x + L.mlp(sh["mlp"], L.rmsnorm(sh["ln2"], x, cfg.norm_eps))
    h = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], h)[:, 0]
    return logits, cache._replace(index=cache.index + 1)


# ---------------------------------------------------------------------------
# On an LM mesh (``launch.mesh.LMMesh``)
# ---------------------------------------------------------------------------

def _mesh_shared(mp: MeshParams, cfg: HybridConfig, xs: list, pos: list, mode: str,
                 kv=None, index: int = 0, max_len: int = 0):
    """One use of the shared block on each local shard, its weights
    gathered here: (each shard's activations after it, each shard's (k, v)
    in "prefill")."""
    blk, rest = T._layer_weights(mp, "shared")
    hs = [L.rmsnorm(b["ln1"], x, cfg.norm_eps) for b, x in zip(blk, xs)]
    ys, kvs = T._mesh_attention(mp.mesh, cfg.attn_config(), [b["attn"] for b in blk],
                                rest["attn"], hs, pos, mode, kv, index, max_len)
    xs = [x + y for x, y in zip(xs, ys)]
    hs = [L.rmsnorm(b["ln2"], x, cfg.norm_eps) for b, x in zip(blk, xs)]
    ys, _ = T._mesh_ffn(mp.mesh, None, blk, rest, hs)
    return [x + y for x, y in zip(xs, ys)], kvs


def _mesh_hidden(mp: MeshParams, cfg: HybridConfig, batch: dict):
    """(the batch's parts, each shard's hidden states after the final
    norm), each Mamba2 layer checkpointed with its gather inside; the
    shared block is not checkpointed, as in the reference."""
    _, parts = T._shard_batch(mp, batch)

    def layer(i, xs):
        return ssm_lm.mesh_layer(mp, cfg, i, xs, "forward")[0]

    xs = T.mesh_embed(mp, parts["tokens"])
    for a in range(cfg.n_apps):
        for i in range(a * cfg.attn_every, (a + 1) * cfg.attn_every):
            xs = L.remat_call(cfg.remat, layer, i, xs)
        xs, _ = _mesh_shared(mp, cfg, xs, parts["positions"], "forward")
    return parts, [L.rmsnorm(s["final_norm"], x, cfg.norm_eps) for s, x in zip(mp.shards, xs)]


def mesh_forward(mp: MeshParams, cfg: HybridConfig, tokens: torch.Tensor) -> torch.Tensor:
    """``forward`` on a mesh, with an autograd graph: hidden [B, T, D]
    after the final norm, gathered on every rank."""
    _, hs = _mesh_hidden(mp, cfg, {"tokens": tokens})
    return gather(mp.mesh, hs, (T.batch_axis(mp, tokens.shape[0]), None, None))[0]


def mesh_loss_fn(mp: MeshParams, cfg: HybridConfig, batch: dict) -> torch.Tensor:
    """``loss_fn`` on a mesh, each token counted once
    (``transformer.mesh_cross_entropy``): the whole loss, autograd from
    this rank's part."""
    parts, hs = _mesh_hidden(mp, cfg, batch)
    return T.mesh_cross_entropy(mp, hs, parts["labels"], cfg.z_loss)


@torch.no_grad()
def mesh_prefill(mp: MeshParams, cfg: HybridConfig, tokens: torch.Tensor, max_len: int,
                 cache_dtype=torch.bfloat16):
    """``prefill`` on a mesh (``tokens`` the whole batch, the same on every
    rank): (``MeshLogits``, the ``HybridCache`` of lists)."""
    b_ax, parts = T._shard_batch(mp, {"tokens": tokens})
    xs = T.mesh_embed(mp, parts["tokens"])
    got = {}
    ks, vs = [[] for _ in xs], [[] for _ in xs]
    for a in range(cfg.n_apps):
        for i in range(a * cfg.attn_every, (a + 1) * cfg.attn_every):
            xs, sts = ssm_lm.mesh_layer(mp, cfg, i, xs, "prefill")
            ssm_lm._collect(got, sts)
        xs, kvs = _mesh_shared(mp, cfg, xs, parts["positions"], "prefill", max_len=max_len)
        for j, (k, v) in enumerate(kvs):
            ks[j].append(k.to(cache_dtype))
            vs[j].append(v.to(cache_dtype))
    logits = T._last_logits(mp, cfg, xs, b_ax)
    return logits, HybridCache(conv=[torch.stack(c) for c in got["conv"]],
                               ssm=[torch.stack(s) for s in got["ssm"]],
                               k=[torch.stack(k) for k in ks], v=[torch.stack(v) for v in vs],
                               index=tokens.shape[1])


@torch.no_grad()
def mesh_decode_step(mp: MeshParams, cfg: HybridConfig, token: torch.Tensor,
                     cache: HybridCache):
    """``decode_step`` on a mesh, at position ``cache.index``: (``MeshLogits``,
    the cache one token on; each shard's states and KV caches written in
    place)."""
    b_ax, parts = T._shard_batch(mp, {"tokens": token})
    xs = T.mesh_embed(mp, parts["tokens"])
    for a in range(cfg.n_apps):
        for i in range(a * cfg.attn_every, (a + 1) * cfg.attn_every):
            xs, sts = ssm_lm.mesh_layer(mp, cfg, i, xs, "decode", cache)
            ssm_lm._write(cache, i, sts)
        xs, _ = _mesh_shared(mp, cfg, xs, None, "decode",
                             [(k[a], v[a]) for k, v in zip(cache.k, cache.v)], cache.index)
    return T._last_logits(mp, cfg, xs, b_ax), cache._replace(index=cache.index + 1)


def mesh_full_cache(mp: MeshParams, cfg: HybridConfig, cache: HybridCache,
                    batch: int) -> HybridCache:
    """The one-card ``HybridCache`` (float32) put back together from a mesh
    cache of ``batch`` rows."""
    conv, ssm = ssm_lm.full_states(mp, cfg.mamba_config(), cache.conv, cache.ssm, batch)
    rest = T.layer_rest(mp, "shared")["attn"]
    return HybridCache(conv=conv, ssm=ssm,
                       k=T.full_kv(mp, cfg.attn_config(), rest, cache.k, batch),
                       v=T.full_kv(mp, cfg.attn_config(), rest, cache.v, batch),
                       index=cache.index)
