"""Decoder-only transformer LM (counterpart of
``repro/models/transformer.py``): the dense (llama3, internlm2, qwen2,
qwen3), MoE (granite, grok) and VLM-backbone (qwen2-vl) architectures.

Parameters are a tree of dicts: ``{"embed": {"table"}, "blocks": [one dict
a layer], "final_norm": {"scale"}}``.  The reference stacks its blocks on a
leading [L, ...] axis and scans over them; here the blocks are a list and
the model loops over it.  The KV cache keeps the reference's stacked
[L, B, S, KV, hd] layout, and ``decode_step`` writes into it in place.
``forward`` and ``loss_fn`` record autograd graphs; with ``remat`` they
checkpoint each layer (or each group of ``remat_group`` layers) while
autograd records, as the reference's ``jax.checkpoint``.  ``prefill`` and
``decode_step`` build no graph.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.layers import AttnConfig, Params
from repro_torch.models.moe import moe_apply, moe_init


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The reference's ``TransformerConfig`` with torch dtypes, every field
    but the three that select its GSPMD code paths (``act_sharding``,
    ``moe_impl``, ``attn_impl``)."""
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 500000.0
    mrope_sections: tuple[int, int, int] | None = None
    moe: MoESpec | None = None
    norm_eps: float = 1e-6
    q_chunk: int = 512
    k_chunk: int = 1024
    param_dtype: Any = torch.float32
    act_dtype: Any = torch.float32   # residual-stream dtype; norms, softmax and
    #                                  the unembedding stay float32
    remat: bool = True         # activation checkpointing of each layer in training
    remat_group: int = 0       # g > 1 (dividing n_layers): checkpoint every g layers
    z_loss: float = 1e-4       # the loss's z-loss
    aux_coef: float = 1e-2     # MoE load-balance coefficient

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def attn_config(self) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads, n_kv_heads=self.n_kv_heads,
            head_dim=self.hd, qkv_bias=self.qkv_bias, qk_norm=self.qk_norm,
            rope_theta=self.rope_theta, mrope_sections=self.mrope_sections,
            q_chunk=self.q_chunk, k_chunk=self.k_chunk, norm_eps=self.norm_eps,
        )


class KVCache(NamedTuple):
    k: torch.Tensor    # [L, B, S, KV, hd]
    v: torch.Tensor    # [L, B, S, KV, hd]
    index: int         # next write position


def _block_init(cfg: TransformerConfig, generator: torch.Generator, device) -> Params:
    dt = cfg.param_dtype
    p = {
        "ln1": L.rmsnorm_init(cfg.d_model, dt, device),
        "ln2": L.rmsnorm_init(cfg.d_model, dt, device),
        "attn": L.attn_init(cfg.attn_config(), generator, device, dt),
    }
    if cfg.moe is not None:
        p["moe"] = moe_init(cfg.d_model, cfg.d_ff, cfg.moe.n_experts, generator, device,
                            dtype=dt)
    else:
        p["mlp"] = L.mlp_init(cfg.d_model, cfg.d_ff, generator, device, dtype=dt)
    return p


def init(cfg: TransformerConfig, generator: torch.Generator, *, device=None) -> Params:
    """Random parameters made on ``device`` (default: the card, which must
    be present) from ``generator``, a ``torch.Generator`` of that device:
    each weight normal times d_in**-0.5, the embedding normal times 0.02,
    norm scales 1, biases 0."""
    dev = resolve_device(device)
    with torch.no_grad():
        return {
            "embed": L.embedding_init(cfg.vocab, cfg.d_model, generator, dev, cfg.param_dtype),
            "blocks": [_block_init(cfg, generator, dev) for _ in range(cfg.n_layers)],
            "final_norm": L.rmsnorm_init(cfg.d_model, cfg.param_dtype, dev),
        }


def _ffn(cfg: TransformerConfig, blk: Params, h: torch.Tensor):
    if cfg.moe is not None:
        return moe_apply(blk["moe"], h, top_k=cfg.moe.top_k, n_experts=cfg.moe.n_experts,
                         capacity_factor=cfg.moe.capacity_factor)
    return L.mlp(blk["mlp"], h), torch.zeros((), device=h.device)


def _positions(positions, b: int, t: int, device) -> torch.Tensor:
    return L.token_positions(b, t, device) if positions is None else positions


def _layer(cfg: TransformerConfig, acfg: AttnConfig, x, positions, blk):
    x = x + L.attention(blk["attn"], acfg, L.rmsnorm(blk["ln1"], x, cfg.norm_eps), positions)
    y, a = _ffn(cfg, blk, L.rmsnorm(blk["ln2"], x, cfg.norm_eps))
    return x + y, a


def _remat_groups(cfg: TransformerConfig, blocks: list) -> list[list]:
    """The layers in the runs that one checkpoint covers: ``remat_group``
    layers where it is above 1 and divides the depth (sqrt-remat), else
    one."""
    g = cfg.remat_group
    if cfg.remat and g > 1 and len(blocks) % g == 0:
        return [blocks[i:i + g] for i in range(0, len(blocks), g)]
    return [[blk] for blk in blocks]


def forward(params: Params, cfg: TransformerConfig, tokens: torch.Tensor,
            positions: torch.Tensor | None = None):
    """Full forward. Returns (hidden [B, T, D], aux loss).  (The reference's
    ``inputs_embeds``, which no caller passes, is left out.)"""
    x = L.embed(params["embed"], tokens).to(cfg.act_dtype)
    positions = _positions(positions, x.shape[0], x.shape[1], x.device)
    acfg = cfg.attn_config()

    def run(group, x, aux):
        for blk in group:
            x, a = _layer(cfg, acfg, x, positions, blk)
            aux = aux + a
        return x, aux

    aux = torch.zeros((), device=x.device)
    for group in _remat_groups(cfg, params["blocks"]):
        x, aux = L.remat_call(cfg.remat, run, group, x, aux)
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def loss_fn(params: Params, cfg: TransformerConfig, batch: dict) -> torch.Tensor:
    """Causal LM loss: cross entropy (with z-loss) plus ``aux_coef`` times
    the MoE aux loss.  batch: tokens [B, T], labels [B, T] (+ positions)."""
    h, aux = forward(params, cfg, batch["tokens"], positions=batch.get("positions"))
    logits = L.unembed(params["embed"], h)
    ce = L.cross_entropy(logits, batch["labels"], z_loss=cfg.z_loss)
    return ce + cfg.aux_coef * aux


def init_cache(cfg: TransformerConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> KVCache:
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev), index=0)


@torch.no_grad()
def prefill(params: Params, cfg: TransformerConfig, tokens: torch.Tensor, max_len: int,
            positions: torch.Tensor | None = None, cache_dtype=torch.bfloat16):
    """Process the prompt; returns (last-token logits [B, V], KVCache).
    The cache is bfloat16 by default whatever the activation dtype."""
    x = L.embed(params["embed"], tokens).to(cfg.act_dtype)
    b, t = tokens.shape
    positions = _positions(positions, b, t, x.device)
    acfg = cfg.attn_config()
    cache = init_cache(cfg, b, max_len, cache_dtype, x.device)
    for i, blk in enumerate(params["blocks"]):
        y, (kc, vc) = L.attention_prefill(blk["attn"], acfg,
                                          L.rmsnorm(blk["ln1"], x, cfg.norm_eps), positions,
                                          max_len)
        x = x + y
        y2, _ = _ffn(cfg, blk, L.rmsnorm(blk["ln2"], x, cfg.norm_eps))
        x = x + y2
        cache.k[i] = kc
        cache.v[i] = vc
    h = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], h[:, -1:])[:, 0]
    return logits, cache._replace(index=t)


@torch.no_grad()
def decode_step(params: Params, cfg: TransformerConfig, token: torch.Tensor, cache: KVCache):
    """One decode step. token: [B, 1], at position ``cache.index`` (every
    M-RoPE component too).  Writes the step's keys and values into
    ``cache`` at its index and returns (logits [B, V], the cache with
    index + 1)."""
    x = L.embed(params["embed"], token).to(cfg.act_dtype)
    acfg = cfg.attn_config()
    for i, blk in enumerate(params["blocks"]):
        y, _ = L.attention_decode(blk["attn"], acfg, L.rmsnorm(blk["ln1"], x, cfg.norm_eps),
                                  cache.index, (cache.k[i], cache.v[i]), cache.index)
        x = x + y
        y2, _ = _ffn(cfg, blk, L.rmsnorm(blk["ln2"], x, cfg.norm_eps))
        x = x + y2
    h = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], h)[:, 0]
    return logits, cache._replace(index=cache.index + 1)
