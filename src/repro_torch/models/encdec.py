"""Encoder-decoder transformer backbone, whisper-tiny (counterpart of
``repro/models/encdec.py``).

The audio frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings [B, S, D].  Whisper's details kept:
LayerNorm (not RMSNorm), non-gated GELU MLPs, attention with biases,
sinusoidal absolute positions (no RoPE), a causal decoder with
cross-attention into the encoder memory.  The decoder's activations are
float32 (the reference casts nothing after the embedding); the encoder
runs in the frames' dtype (bfloat16 under ``Server`` and in training).
``encode``, ``decode_train`` and ``loss_fn`` record autograd graphs, each
layer of both stacks checkpointed with ``remat``; ``prefill`` and
``decode_step`` build none.  The reference's ``attn_impl`` is not here
(every config runs ``layers._sdpa_flash``).

``mesh_encode``, ``mesh_decode_train``, ``mesh_loss_fn``, ``mesh_prefill``
and ``mesh_decode_step`` run the model on an LM mesh, each layer of both
stacks gathered inside the layer (inside its checkpoint in training) and
run by ``transformer``'s mesh attention and FFN; the frames are cut by
rows with the tokens, so the cross-attention memory and its cached
``cross_k`` / ``cross_v`` are each shard's rows (and the KV heads its q
heads read).  whisper-tiny's ``fsdp`` gathers every weight and splits
the batch over every axis that divides it; under ``fsdp_tp`` heads that
``model`` does not divide run whole on every shard while d_ff and the
vocabulary split.  The mesh cache is an ``EncDecCache`` of lists, one
tensor a local shard; ``mesh_full_cache`` puts it back together.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import MeshParams, gather
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.layers import AttnConfig, Params


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str
    n_layers: int              # a stack (encoder and decoder)
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    norm_eps: float = 1e-5
    q_chunk: int = 512
    k_chunk: int = 1024
    param_dtype: Any = torch.float32
    remat: bool = True         # activation checkpointing of each layer in training
    z_loss: float = 1e-4       # the loss's z-loss

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def attn_config(self, causal: bool) -> AttnConfig:
        return AttnConfig(d_model=self.d_model, n_heads=self.n_heads,
                          n_kv_heads=self.n_kv_heads, head_dim=self.hd, qkv_bias=True,
                          rope_theta=0.0, causal=causal, q_chunk=self.q_chunk,
                          k_chunk=self.k_chunk, norm_eps=self.norm_eps)


class EncDecCache(NamedTuple):
    k: torch.Tensor        # [L, B, S, KV, hd] decoder self-attention keys
    v: torch.Tensor
    cross_k: torch.Tensor  # [L, B, S_enc, KV, hd] the memory's keys
    cross_v: torch.Tensor
    index: int             # next write position


def _angles(pos: torch.Tensor, d: int) -> torch.Tensor:
    """[sin | cos] of ``pos`` [..., 1] (float32) over ``d`` / 2 frequencies."""
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=pos.device)
    ang = pos / torch.pow(10000.0, dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal(t: int, d: int, device=None) -> torch.Tensor:
    """Positions 0..t-1 as [1, t, d] float32."""
    return _angles(torch.arange(t, dtype=torch.float32, device=device)[:, None], d)[None]


def _enc_block_init(cfg: EncDecConfig, generator, device) -> Params:
    dt = cfg.param_dtype
    return {"ln1": L.layernorm_init(cfg.d_model, dt, device),
            "ln2": L.layernorm_init(cfg.d_model, dt, device),
            "attn": L.attn_init(cfg.attn_config(False), generator, device, dt),
            "mlp": L.mlp_init(cfg.d_model, cfg.d_ff, generator, device, gated=False, dtype=dt)}


def _dec_block_init(cfg: EncDecConfig, generator, device) -> Params:
    dt = cfg.param_dtype
    return {"ln1": L.layernorm_init(cfg.d_model, dt, device),
            "ln2": L.layernorm_init(cfg.d_model, dt, device),
            "ln3": L.layernorm_init(cfg.d_model, dt, device),
            "attn": L.attn_init(cfg.attn_config(True), generator, device, dt),
            "cross": L.attn_init(cfg.attn_config(False), generator, device, dt),
            "mlp": L.mlp_init(cfg.d_model, cfg.d_ff, generator, device, gated=False, dtype=dt)}


def init(cfg: EncDecConfig, generator: torch.Generator, *, device=None) -> Params:
    """Random parameters made on ``device`` (default: the card, which must
    be present) from ``generator``, a ``torch.Generator`` of that device."""
    dev = resolve_device(device)
    dt = cfg.param_dtype
    with torch.no_grad():
        return {
            "embed": L.embedding_init(cfg.vocab, cfg.d_model, generator, dev, dt),
            "enc_blocks": [_enc_block_init(cfg, generator, dev) for _ in range(cfg.n_layers)],
            "dec_blocks": [_dec_block_init(cfg, generator, dev) for _ in range(cfg.n_layers)],
            "enc_norm": L.layernorm_init(cfg.d_model, dt, dev),
            "dec_norm": L.layernorm_init(cfg.d_model, dt, dev),
        }


def encode(params: Params, cfg: EncDecConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames: [B, S, D] precomputed frame embeddings (the frontend stub);
    returns the memory [B, S, D] in the frames' dtype."""
    b, s, d = frames.shape
    x = frames + sinusoidal(s, d, frames.device).to(frames.dtype)
    pos = L.token_positions(b, s, frames.device)
    acfg = cfg.attn_config(False)

    def layer(x, blk):
        x = x + L.attention(blk["attn"], acfg, L.layernorm(blk["ln1"], x, cfg.norm_eps), pos)
        return x + L.mlp(blk["mlp"], L.layernorm(blk["ln2"], x, cfg.norm_eps))

    for blk in params["enc_blocks"]:
        x = L.remat_call(cfg.remat, layer, x, blk)
    return L.layernorm(params["enc_norm"], x, cfg.norm_eps)


def _cross_kv(blk: Params, cfg: EncDecConfig, memory: torch.Tensor):
    b, s, _ = memory.shape
    k = L.dense(blk["cross"]["wk"], memory).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    v = L.dense(blk["cross"]["wv"], memory).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    return k, v


def decode_train(params: Params, cfg: EncDecConfig, tokens: torch.Tensor,
                 memory: torch.Tensor) -> torch.Tensor:
    """The decoder over whole sequences (teacher forcing): hidden states
    [B, T, D] after the final norm."""
    b, t = tokens.shape
    x = L.embed(params["embed"], tokens)
    x = x + sinusoidal(t, cfg.d_model, x.device).to(x.dtype)
    pos = L.token_positions(b, t, x.device)
    self_cfg, cross_cfg = cfg.attn_config(True), cfg.attn_config(False)

    def layer(x, blk, memory):
        x = x + L.attention(blk["attn"], self_cfg, L.layernorm(blk["ln1"], x, cfg.norm_eps), pos)
        x = x + L.attention(blk["cross"], cross_cfg, L.layernorm(blk["ln2"], x, cfg.norm_eps),
                            pos, kv=_cross_kv(blk, cfg, memory))
        return x + L.mlp(blk["mlp"], L.layernorm(blk["ln3"], x, cfg.norm_eps))

    for blk in params["dec_blocks"]:
        x = L.remat_call(cfg.remat, layer, x, blk, memory)
    return L.layernorm(params["dec_norm"], x, cfg.norm_eps)


def loss_fn(params: Params, cfg: EncDecConfig, batch: dict) -> torch.Tensor:
    """LM cross entropy (with z-loss) of the decoder over ``batch``
    {frames [B, S, D], tokens [B, T], labels [B, T]}."""
    memory = encode(params, cfg, batch["frames"])
    h = decode_train(params, cfg, batch["tokens"], memory)
    logits = L.unembed(params["embed"], h)
    return L.cross_entropy(logits, batch["labels"], z_loss=cfg.z_loss)


@torch.no_grad()
def prefill(params: Params, cfg: EncDecConfig, frames: torch.Tensor, tokens: torch.Tensor,
            max_len: int, cache_dtype=torch.bfloat16):
    """Encode and decoder prefill.  Returns (last logits [B, V],
    EncDecCache).  The prompt's cross-attention reads the memory's keys
    and values as computed; the cache keeps their ``cache_dtype`` copy,
    which the decode steps read (as the reference does)."""
    memory = encode(params, cfg, frames)
    b, t = tokens.shape
    x = L.embed(params["embed"], tokens)
    x = x + sinusoidal(t, cfg.d_model, x.device).to(x.dtype)
    pos = L.token_positions(b, t, x.device)
    self_cfg, cross_cfg = cfg.attn_config(True), cfg.attn_config(False)
    ks, vs, cks, cvs = [], [], [], []
    for blk in params["dec_blocks"]:
        y, (kc, vc) = L.attention_prefill(blk["attn"], self_cfg,
                                          L.layernorm(blk["ln1"], x, cfg.norm_eps), pos, max_len)
        x = x + y
        ck, cv = _cross_kv(blk, cfg, memory)
        x = x + L.attention(blk["cross"], cross_cfg, L.layernorm(blk["ln2"], x, cfg.norm_eps),
                            pos, kv=(ck, cv))
        x = x + L.mlp(blk["mlp"], L.layernorm(blk["ln3"], x, cfg.norm_eps))
        for out, a in ((ks, kc), (vs, vc), (cks, ck), (cvs, cv)):
            out.append(a.to(cache_dtype))
    h = L.layernorm(params["dec_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], h[:, -1:])[:, 0]
    return logits, EncDecCache(k=torch.stack(ks), v=torch.stack(vs), cross_k=torch.stack(cks),
                               cross_v=torch.stack(cvs), index=t)


@torch.no_grad()
def decode_step(params: Params, cfg: EncDecConfig, token: torch.Tensor, cache: EncDecCache):
    """One decode step. token: [B, 1], at position ``cache.index`` (its
    sinusoid computed in float32 from the index).  Returns (logits [B, V],
    the cache one token on; the self-attention caches written in place)."""
    x = L.embed(params["embed"], token)
    # a fill on the device, not a copy from the host
    pos = torch.full((1,), float(cache.index), device=x.device)
    x = x + _angles(pos, cfg.d_model)[None].to(x.dtype)
    self_cfg, cross_cfg = cfg.attn_config(True), cfg.attn_config(False)
    pos1 = torch.full((x.shape[0], 1), cache.index, device=x.device)
    for i, blk in enumerate(params["dec_blocks"]):
        y, _ = L.attention_decode(blk["attn"], self_cfg, L.layernorm(blk["ln1"], x, cfg.norm_eps),
                                  cache.index, (cache.k[i], cache.v[i]), cache.index)
        x = x + y
        x = x + L.attention(blk["cross"], cross_cfg, L.layernorm(blk["ln2"], x, cfg.norm_eps),
                            pos1, kv=(cache.cross_k[i], cache.cross_v[i]))
        x = x + L.mlp(blk["mlp"], L.layernorm(blk["ln3"], x, cfg.norm_eps))
    h = L.layernorm(params["dec_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], h)[:, 0]
    return logits, cache._replace(index=cache.index + 1)


# ---------------------------------------------------------------------------
# On an LM mesh (``launch.mesh.LMMesh``)
# ---------------------------------------------------------------------------

def _mesh_enc_layer(mp: MeshParams, cfg: EncDecConfig, i: int, xs: list, pos: list) -> list:
    blk, rest = T._layer_weights(mp, "enc_blocks", i)
    hs = [L.layernorm(b["ln1"], x, cfg.norm_eps) for b, x in zip(blk, xs)]
    ys, _ = T._mesh_attention(mp.mesh, cfg.attn_config(False), [b["attn"] for b in blk],
                              rest["attn"], hs, pos, "forward")
    xs = [x + y for x, y in zip(xs, ys)]
    hs = [L.layernorm(b["ln2"], x, cfg.norm_eps) for b, x in zip(blk, xs)]
    ys, _ = T._mesh_ffn(mp.mesh, None, blk, rest, hs)
    return [x + y for x, y in zip(xs, ys)]


def _mesh_encode(mp: MeshParams, cfg: EncDecConfig, frames: list) -> list:
    """Each shard's memory [B_j, S, D] from its frames."""
    b, s, d = frames[0].shape
    xs = [f + sinusoidal(s, d, f.device).to(f.dtype) for f in frames]
    pos = [L.token_positions(f.shape[0], s, f.device) for f in frames]

    def layer(i, xs):
        return _mesh_enc_layer(mp, cfg, i, xs, pos)

    for i in range(cfg.n_layers):
        xs = L.remat_call(cfg.remat, layer, i, xs)
    return [L.layernorm(sh["enc_norm"], x, cfg.norm_eps) for sh, x in zip(mp.shards, xs)]


def _mesh_dec_layer(mp: MeshParams, cfg: EncDecConfig, i: int, xs: list, pos: list, mode: str,
                    memory=None, cache=None, max_len: int = 0):
    """Decoder layer ``i`` on each local shard: (activations, each shard's
    self (k, v) and memory (k, v) in "prefill")."""
    mesh = mp.mesh
    blk, rest = T._layer_weights(mp, "dec_blocks", i)
    hs = [L.layernorm(b["ln1"], x, cfg.norm_eps) for b, x in zip(blk, xs)]
    self_kv = None if cache is None else [(k[i], v[i]) for k, v in zip(cache.k, cache.v)]
    ys, kvs = T._mesh_attention(mesh, cfg.attn_config(True), [b["attn"] for b in blk],
                                rest["attn"], hs, pos, mode, self_kv,
                                0 if cache is None else cache.index, max_len)
    xs = [x + y for x, y in zip(xs, ys)]
    hs = [L.layernorm(b["ln2"], x, cfg.norm_eps) for b, x in zip(blk, xs)]
    cross_kv = None if cache is None else [(k[i], v[i])
                                           for k, v in zip(cache.cross_k, cache.cross_v)]
    ys, mem_kv = T._mesh_attention(mesh, cfg.attn_config(False), [b["cross"] for b in blk],
                                   rest["cross"], hs, pos, "cross", memory=memory, kv=cross_kv)
    xs = [x + y for x, y in zip(xs, ys)]
    hs = [L.layernorm(b["ln3"], x, cfg.norm_eps) for b, x in zip(blk, xs)]
    ys, _ = T._mesh_ffn(mesh, None, blk, rest, hs)
    return [x + y for x, y in zip(xs, ys)], kvs, mem_kv


def _dec_embed(mp: MeshParams, cfg: EncDecConfig, toks: list) -> list:
    xs = T.mesh_embed(mp, toks)
    return [x + sinusoidal(x.shape[1], cfg.d_model, x.device).to(x.dtype) for x in xs]


def _mesh_hidden(mp: MeshParams, cfg: EncDecConfig, batch: dict):
    """(b_ax, the batch's parts, each shard's decoder hidden states after
    the final norm), each layer of both stacks checkpointed with its
    gather inside."""
    b_ax, parts = T._shard_batch(mp, batch)
    memory = _mesh_encode(mp, cfg, parts["frames"])

    def layer(i, xs, memory):
        return _mesh_dec_layer(mp, cfg, i, xs, parts["positions"], "forward", memory)[0]

    xs = _dec_embed(mp, cfg, parts["tokens"])
    for i in range(cfg.n_layers):
        xs = L.remat_call(cfg.remat, layer, i, xs, memory)
    return b_ax, parts, [L.layernorm(s["dec_norm"], x, cfg.norm_eps)
                         for s, x in zip(mp.shards, xs)]


def mesh_encode(mp: MeshParams, cfg: EncDecConfig, frames: torch.Tensor) -> torch.Tensor:
    """``encode`` on a mesh, with an autograd graph: the memory [B, S, D]
    gathered on every rank (``frames`` the whole batch)."""
    b_ax, parts = T._shard_batch(mp, {"tokens": frames[..., 0], "frames": frames})
    return gather(mp.mesh, _mesh_encode(mp, cfg, parts["frames"]), (b_ax, None, None))[0]


def mesh_decode_train(mp: MeshParams, cfg: EncDecConfig, tokens: torch.Tensor,
                      frames: torch.Tensor) -> torch.Tensor:
    """``encode`` of ``frames`` and ``decode_train`` of ``tokens`` on a mesh,
    with an autograd graph: hidden [B, T, D] after the final norm, gathered
    on every rank."""
    b_ax, _, hs = _mesh_hidden(mp, cfg, {"tokens": tokens, "frames": frames})
    return gather(mp.mesh, hs, (b_ax, None, None))[0]


def mesh_loss_fn(mp: MeshParams, cfg: EncDecConfig, batch: dict) -> torch.Tensor:
    """``loss_fn`` on a mesh, each token counted once
    (``transformer.mesh_cross_entropy``): the whole loss, autograd from
    this rank's part."""
    _, parts, hs = _mesh_hidden(mp, cfg, batch)
    return T.mesh_cross_entropy(mp, hs, parts["labels"], cfg.z_loss)


def _last_logits(mp: MeshParams, cfg: EncDecConfig, xs: list, b_ax):
    return T.mesh_unembed(mp, [L.layernorm(s["dec_norm"], x[:, -1:], cfg.norm_eps)
                               for s, x in zip(mp.shards, xs)], b_ax)


@torch.no_grad()
def mesh_prefill(mp: MeshParams, cfg: EncDecConfig, frames: torch.Tensor, tokens: torch.Tensor,
                 max_len: int, cache_dtype=torch.bfloat16):
    """``prefill`` on a mesh (``frames`` and ``tokens`` the whole batch, the
    same on every rank): (``MeshLogits``, the ``EncDecCache`` of lists)."""
    b_ax, parts = T._shard_batch(mp, {"tokens": tokens, "frames": frames})
    memory = _mesh_encode(mp, cfg, parts["frames"])
    xs = _dec_embed(mp, cfg, parts["tokens"])
    out = {k: [[] for _ in xs] for k in EncDecCache._fields[:4]}
    for i in range(cfg.n_layers):
        xs, kvs, mem_kv = _mesh_dec_layer(mp, cfg, i, xs, parts["positions"], "prefill",
                                          memory, max_len=max_len)
        for j, ((k, v), (ck, cv)) in enumerate(zip(kvs, mem_kv)):
            for name, a in (("k", k), ("v", v), ("cross_k", ck), ("cross_v", cv)):
                out[name][j].append(a.to(cache_dtype))
    return _last_logits(mp, cfg, xs, b_ax), EncDecCache(
        **{k: [torch.stack(a) for a in v] for k, v in out.items()}, index=tokens.shape[1])


@torch.no_grad()
def mesh_decode_step(mp: MeshParams, cfg: EncDecConfig, token: torch.Tensor,
                     cache: EncDecCache):
    """``decode_step`` on a mesh, at position ``cache.index``: (``MeshLogits``,
    the cache one token on; the self-attention caches written in place)."""
    b_ax, parts = T._shard_batch(mp, {"tokens": token})
    xs = T.mesh_embed(mp, parts["tokens"])
    angle = _angles(torch.full((1,), float(cache.index), device=xs[0].device), cfg.d_model)[None]
    xs = [x + angle.to(x.dtype) for x in xs]
    pos = [torch.full((x.shape[0], 1), cache.index, device=x.device) for x in xs]
    for i in range(cfg.n_layers):
        xs, _, _ = _mesh_dec_layer(mp, cfg, i, xs, pos, "decode", cache=cache)
    return _last_logits(mp, cfg, xs, b_ax), cache._replace(index=cache.index + 1)


def mesh_full_cache(mp: MeshParams, cfg: EncDecConfig, cache: EncDecCache,
                    batch: int) -> EncDecCache:
    """The one-card ``EncDecCache`` (float32) put back together from a mesh
    cache of ``batch`` rows."""
    rest = T.layer_rest(mp, "dec_blocks", 0)
    got = {}
    for name, sub, causal in (("k", "attn", True), ("v", "attn", True),
                              ("cross_k", "cross", False), ("cross_v", "cross", False)):
        got[name] = T.full_kv(mp, cfg.attn_config(causal), rest[sub], getattr(cache, name),
                              batch)
    return EncDecCache(**got, index=cache.index)
