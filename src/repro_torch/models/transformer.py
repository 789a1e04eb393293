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
``decode_step`` build no graph.  ``mesh_forward``, ``mesh_loss_fn``,
``mesh_prefill`` and ``mesh_decode_step`` run the same model on an LM mesh
(the section at the end says how each policy lays it out): the first two
record graphs for training, the last two serve.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (Laid, MeshParams, axes_of, batch_spec,
                                              block_index, gather, gather_tree, rest_tree)
from repro_torch.models import layers as L
from repro_torch.models.layers import AttnConfig, Params
from repro_torch.models.moe import (EXPERT_STACKS, moe_apply, moe_apply_ep, moe_apply_mesh,
                                    moe_init)


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The reference's ``TransformerConfig`` with torch dtypes, every field
    but the two that select its GSPMD code paths (``act_sharding``,
    ``attn_impl``).  ``moe_impl`` picks the MoE dispatch of ``forward`` and
    ``prefill`` on a mesh whose `model` is above 1: "gspmd" (the default:
    ``moe_apply``'s semantics over the whole token set) or "ep_a2a"
    (``moe_apply_ep``); on one shard, and in ``decode_step``, it is
    ``moe_apply``, as in the reference."""
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
    moe_impl: str = "gspmd"    # "gspmd" (gather dispatch) | "ep_a2a"
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


def init_parts(cfg: TransformerConfig, generator: torch.Generator, device):
    """The parameters as ``(key, subtree)`` pairs in the order ``init``
    draws them, each layer as ``("blocks", [layer])``: made one at a time
    (``sharding.shard_parts`` cuts each before the next is made)."""
    with torch.no_grad():
        yield "embed", L.embedding_init(cfg.vocab, cfg.d_model, generator, device,
                                        cfg.param_dtype)
        for _ in range(cfg.n_layers):
            yield "blocks", [_block_init(cfg, generator, device)]
        yield "final_norm", L.rmsnorm_init(cfg.d_model, cfg.param_dtype, device)


def init(cfg: TransformerConfig, generator: torch.Generator, *, device=None) -> Params:
    """Random parameters made on ``device`` (default: the card, which must
    be present) from ``generator``, a ``torch.Generator`` of that device:
    each weight normal times d_in**-0.5, the embedding normal times 0.02,
    norm scales 1, biases 0."""
    out = {}
    for key, sub in init_parts(cfg, generator, resolve_device(device)):
        if key == "blocks":
            out.setdefault(key, []).extend(sub)
        else:
            out[key] = sub
    return out


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


# ---------------------------------------------------------------------------
# On an LM mesh (``launch.mesh.LMMesh``)
# ---------------------------------------------------------------------------
#
# The parameters are ``sharding.MeshParams``: each local shard holds its
# blocks by ``sharding.param_specs``.  Each layer's weights are all-gathered
# over the axes the policy gathers (``_gathered``) just before the layer
# runs and dropped after it; what stays split over `model` runs tensor
# parallel:
#
#   * ``fsdp``: every axis is gathered; the batch is split as
#     ``batch_spec`` says (over every axis where that divides), so the only
#     collectives are the weight gathers, as the reference says of it.
#   * ``ep_dp``: the data axes are gathered; the expert stacks stay split
#     on E over `model` (``moe.moe_apply_mesh`` / ``moe_apply_ep``); the
#     batch as under ``fsdp``.
#   * ``fsdp_tp``: the data axes are gathered; the batch is split over
#     them.  wq / wk / wv have their columns over `model`: each model shard
#     runs its block of H / model q heads and the KV heads they read.  A
#     projection whose block is not whole heads (``param_spec`` divides the
#     flattened H*hd and KV*hd, so at H or KV not a multiple of `model` a
#     head can straddle two shards) is gathered over `model` first, and a
#     shard whose q heads are not whole runs all heads.  wo and w_down have
#     their rows over `model`: each shard's partial product is formed in
#     float32, summed over `model` and rounded once, as the one-shard
#     product is (summed in another order, a bfloat16 result now and then
#     rounds to the neighbouring value).  The MLP's d_ff is split over
#     `model`.  The embedding table has its rows over `model`: a masked
#     lookup, then a sum; the tied unembedding leaves the logits split on V
#     over `model` (``MeshLogits``).  A dimension the split does not divide
#     is replicated (``_maybe``), and its product runs whole on every shard.
#
# In training (``mesh_forward``, ``mesh_loss_fn``) a checkpointed layer
# (``remat``) covers its weight gather: the backward gathers the layer
# again instead of keeping every layer's gathered weights alive, which is
# what ``fsdp`` is for.  The loss counts each token once: every shard's
# mean over its rows weighs 1 / (data x model), and shards that share rows
# (the `model` line under ``fsdp_tp``; any axis the batch does not divide)
# share that weight, so the local shards holding one gathered logits
# tensor add its cross entropy once.  Under ``fsdp_tp`` the tied
# unembedding's logits, split on V, are gathered over `model` first.
#
# The KV cache is one tensor a local shard, [L, B_shard, S, KV_shard, hd]:
# the shard's batch rows and the KV heads its q heads read (whole heads),
# the full sequence.  Where KV is a multiple of `model` that is 1/model of
# the heads; ``cache_spec`` splits the sequence over `model` instead, which
# a tensor-parallel decode would have to gather back for every step.
# ``KVCache.index`` is one host integer for all shards.


class MeshLogits(NamedTuple):
    """Logits [B, V] on a mesh: ``parts[j]`` is local shard j's block under
    ``spec`` (batch rows, and the vocabulary under ``fsdp_tp``)."""
    parts: list
    spec: tuple
    mesh: Any

    def gather(self) -> torch.Tensor:
        """The full [B, V] logits (on every rank)."""
        return gather(self.mesh, self.parts, self.spec)[0]

    def greedy(self) -> torch.Tensor:
        """The argmax token [B, 1] of every row (on every rank), the lowest
        id of equal maxima: each shard's first maximum and its value, the
        first shard of the highest value along `model`."""
        mesh, (b_ax, v_ax) = self.mesh, self.spec
        best = [torch.argmax(p, -1) for p in self.parts]
        if axes_of(v_ax) == ("model",):
            v_loc = self.parts[0].shape[-1]
            vals = mesh.all_gather([p.gather(-1, i[:, None]) for p, i in zip(self.parts, best)],
                                   "model", 1)
            ids = mesh.all_gather([(i + c["model"] * v_loc)[:, None]
                                   for i, c in zip(best, mesh.local)], "model", 1)
            best = [i.gather(1, torch.argmax(v, 1, keepdim=True))[:, 0]
                    for v, i in zip(vals, ids)]
        return gather(mesh, best, (b_ax,))[0][:, None]


def _gathered(policy: str) -> tuple[str, ...]:
    """The mesh axes a policy gathers each layer's weights over."""
    return ("data", "model") if policy == "fsdp" else ("data",)


def _on_model(entry) -> bool:
    return axes_of(entry) == ("model",)


def _rows(mesh, b_ax, b: int) -> list[slice]:
    """Each local shard's batch rows under the batch entry ``b_ax``."""
    out = []
    for c in mesh.local:
        idx, n = block_index(b_ax, mesh.shape, c)
        out.append(slice(idx * b // n, (idx + 1) * b // n))
    return out


def _layer_weights(mp: MeshParams, key: str, index=None):
    """(each local shard's gathered weights, their specs after the gather)
    of ``mp.shards[j][key]`` (``[index]`` of a list of layers)."""
    axes = _gathered(mp.policy)
    trees = [s[key] if index is None else s[key][index] for s in mp.shards]
    specs = mp.specs[key] if index is None else mp.specs[key][index]
    return gather_tree(mp.mesh, trees, specs, axes), rest_tree(trees[0], specs, axes)


def _row_parallel(mesh, parts: list, dtype) -> list:
    """Partial products (float32) summed over `model` and rounded once."""
    return [y.to(dtype) for y in mesh.psum(parts, "model")]


def _mesh_attention(mesh, cfg: TransformerConfig, blk: list, rest: dict, hs: list, pos: list,
                    mode: str, cache, i: int, max_len: int):
    """The attention sublayer on each local shard (its input ``hs[j]`` the
    normed activations of its rows): returns (y list, (k, v) list or
    None)."""
    acfg = cfg.attn_config()
    h_n, kv_n, hd, m_n = cfg.n_heads, cfg.n_kv_heads, cfg.hd, mesh.model
    g = h_n // kv_n
    ra = rest["attn"]
    q_split = _on_model(ra["wq"]["w"][1])
    heads_split = q_split and h_n % m_n == 0
    kv_split = _on_model(ra["wk"]["w"][1])
    kv_aligned = kv_split and heads_split and kv_n % m_n == 0
    dev = hs[0].device
    q_sel, kv_sel, cfgs = [], [], []
    for c in mesh.local:
        lo, hi = ((c["model"] * h_n // m_n, (c["model"] + 1) * h_n // m_n) if heads_split
                  else (0, h_n))
        k_lo, k_hi = lo // g, (hi - 1) // g + 1
        q_sel.append(slice(lo * hd, hi * hd))
        if (lo % g == 0 and (hi - lo) % g == 0) or k_hi - k_lo == 1:
            kv_sel.append(slice(k_lo * hd, k_hi * hd))
            cfgs.append(dataclasses.replace(acfg, n_heads=hi - lo, n_kv_heads=k_hi - k_lo))
        else:    # uneven groups: one KV head a q head
            heads = torch.arange(lo, hi, device=dev) // g
            kv_sel.append((heads[:, None] * hd + torch.arange(hd, device=dev)).reshape(-1))
            cfgs.append(dataclasses.replace(acfg, n_heads=hi - lo, n_kv_heads=hi - lo))
    # each shard's projections: its own column block where that is exactly
    # its heads (``aligned``); else the whole projection (gathered over
    # `model` where split) and ``"cols"``, so its heads are cut from the
    # whole product as the one-shard model forms it
    proj = {}
    for name, split, aligned, sel in (("wq", q_split, heads_split, q_sel),
                                      ("wk", kv_split, kv_aligned, kv_sel),
                                      ("wv", kv_split, kv_aligned, kv_sel)):
        own = split and aligned
        ws = [b["attn"][name]["w"] for b in blk]
        if split and not own:
            ws = mesh.all_gather(ws, "model", -1)
        proj[name] = [{"w": w} if own else {"w": w, "cols": c} for w, c in zip(ws, sel)]
        if "b" in blk[0]["attn"][name]:
            bs = [b["attn"][name]["b"] for b in blk]
            b_split = _on_model(ra[name]["b"][0])
            if b_split and not own:
                bs = mesh.all_gather(bs, "model", -1)
            elif own and not b_split:          # a whole bias beside a weight block
                bs = [bias[c] for bias, c in zip(bs, sel)]
            for d, bias in zip(proj[name], bs):
                d["b"] = bias
    outs, kvs = [], []
    for j, (h, b) in enumerate(zip(hs, blk)):
        p_loc = {k: proj[k][j] for k in proj}
        for k in ("q_norm", "k_norm"):
            if k in b["attn"]:
                p_loc[k] = b["attn"][k]
        if mode == "decode":
            o, _ = L.attend_decode(p_loc, cfgs[j], h, cache.index,
                                   (cache.k[j][i], cache.v[j][i]), cache.index)
        else:
            o, kv = L.attend_prefill(p_loc, cfgs[j], h, pos[j],
                                     max_len if mode == "prefill" else h.shape[1])
            kvs.append(kv)
        outs.append(o)
    if _on_model(ra["wo"]["w"][0]):
        width = h_n * hd // m_n
        parts = [(o if heads_split else o[..., c["model"] * width:(c["model"] + 1) * width])
                 .float() @ b["attn"]["wo"]["w"].float()
                 for o, b, c in zip(outs, blk, mesh.local)]
        ys = _row_parallel(mesh, parts, hs[0].dtype)
    else:
        ys = [L.dense(b["attn"]["wo"], o) for o, b in zip(outs, blk)]
    return ys, (kvs if mode == "prefill" else None)


def _mesh_ffn(mesh, cfg: TransformerConfig, blk: list, rest: dict, hs: list, x_spec: tuple,
              use_ep: bool):
    """The FFN sublayer on each local shard: (y list, aux)."""
    if cfg.moe is not None:
        kw = dict(top_k=cfg.moe.top_k, n_experts=cfg.moe.n_experts,
                  capacity_factor=cfg.moe.capacity_factor)
        p = [b["moe"] for b in blk]
        w_specs = {k: rest["moe"][k] for k in EXPERT_STACKS}
        if use_ep:
            return moe_apply_ep(p, hs, mesh=mesh, x_spec=x_spec, w_specs=w_specs, **kw)
        return moe_apply_mesh(p, w_specs, hs, x_spec, mesh, **kw)
    zero = torch.zeros((), device=hs[0].device)
    if not _on_model(rest["mlp"]["w_up"]["w"][1]):
        return [L.mlp(b["mlp"], h) for b, h in zip(blk, hs)], zero
    parts = []
    for b, h in zip(blk, hs):
        up = L.dense(b["mlp"]["w_up"], h)
        up = L.silu(L.dense(b["mlp"]["w_gate"], h)) * up if "w_gate" in b["mlp"] else L.gelu(up)
        parts.append(up.float() @ b["mlp"]["w_down"]["w"].float())
    return _row_parallel(mesh, parts, hs[0].dtype), zero


def _mesh_embed(mp: MeshParams, cfg: TransformerConfig, toks: list) -> list:
    mesh = mp.mesh
    table, rest = _layer_weights(mp, "embed")
    if not _on_model(rest["table"][0]):
        return [L.embed(t, tok).to(cfg.act_dtype) for t, tok in zip(table, toks)]
    parts = []
    for t, tok, c in zip(table, toks, mesh.local):
        v_loc = t["table"].shape[0]
        rel = tok - c["model"] * v_loc
        ok = (rel >= 0) & (rel < v_loc)
        parts.append(t["table"][rel.clamp(0, v_loc - 1)] * ok[..., None].to(t["table"].dtype))
    return [x.to(cfg.act_dtype) for x in mesh.psum(parts, "model")]


def _mesh_unembed(mp: MeshParams, cfg: TransformerConfig, xs: list, b_ax) -> MeshLogits:
    """Final norm and the tied unembedding of each shard's last position."""
    mesh = mp.mesh
    table, rest = _layer_weights(mp, "embed")
    norm = [s["final_norm"] for s in mp.shards]
    parts = [L.unembed(t, L.rmsnorm(n, x[:, -1:], cfg.norm_eps))[:, 0]
             for t, n, x in zip(table, norm, xs)]
    return MeshLogits(parts, (b_ax, "model" if _on_model(rest["table"][0]) else None), mesh)


def _shard_batch(mp: MeshParams, batch: dict):
    """(the batch entry, each leaf of ``batch`` as one part a local shard:
    a ``Laid`` leaf's parts, a tensor's rows under ``batch_spec``), with
    the text positions (``arange``, [B_j, T]) where the batch has none."""
    batch = {k: v for k, v in batch.items() if v is not None}
    tokens = batch["tokens"]
    if isinstance(tokens, Laid):
        b_ax = tokens.spec[0]
        parts = {k: v.parts for k, v in batch.items()}
    else:
        b_ax = batch_spec("tokens", tokens, mp.mesh.shape, mp.policy)[0]
        rows = _rows(mp.mesh, b_ax, tokens.shape[0])
        parts = {k: [v[..., r, :] if k == "positions" else v[r] for r in rows]
                 for k, v in batch.items()}
    if "positions" not in parts:
        parts["positions"] = [L.token_positions(t.shape[0], t.shape[1], t.device)
                              for t in parts["tokens"]]
    return b_ax, parts


def _mesh_block(mp: MeshParams, cfg: TransformerConfig, i: int, xs: list, pos: list,
                x_spec: tuple, use_ep: bool, mode: str, cache=None, max_len: int = 0):
    """Layer ``i`` on the mesh, its weights gathered here: (each shard's
    activations after it, aux, each shard's (k, v) in ``"prefill"``)."""
    blk, rest = _layer_weights(mp, "blocks", i)
    hs = [L.rmsnorm(b["ln1"], x, cfg.norm_eps) for b, x in zip(blk, xs)]
    ys, kvs = _mesh_attention(mp.mesh, cfg, blk, rest, hs, pos, mode, cache, i, max_len)
    xs = [x + y for x, y in zip(xs, ys)]
    hs = [L.rmsnorm(b["ln2"], x, cfg.norm_eps) for b, x in zip(blk, xs)]
    ys, aux = _mesh_ffn(mp.mesh, cfg, blk, rest, hs, x_spec, use_ep)
    return [x + y for x, y in zip(xs, ys)], aux, kvs


def _mesh_run(mp: MeshParams, cfg: TransformerConfig, tokens, positions, mode: str,
              max_len: int = 0, cache=None, cache_dtype=torch.bfloat16):
    """The layers on the mesh for serving: (b_ax, each shard's final
    activations, the cache)."""
    b_ax, parts = _shard_batch(mp, {"tokens": tokens, "positions": positions})
    xs = _mesh_embed(mp, cfg, parts["tokens"])
    use_ep = cfg.moe_impl == "ep_a2a" and mp.mesh.model > 1 and mode != "decode"
    cache_k = cache_v = None
    for i in range(cfg.n_layers):
        xs, _, kvs = _mesh_block(mp, cfg, i, xs, parts["positions"], (b_ax, None, None), use_ep,
                                 mode, cache, max_len)
        if kvs is not None:
            if i == 0:
                cache_k = [torch.zeros((cfg.n_layers,) + tuple(k.shape), dtype=cache_dtype,
                                       device=k.device) for k, _ in kvs]
                cache_v = [torch.zeros_like(k) for k in cache_k]
            for j, (k, v) in enumerate(kvs):
                cache_k[j][i] = k
                cache_v[j][i] = v
    if mode == "prefill":
        cache = KVCache(k=cache_k, v=cache_v, index=tokens.shape[1])
    elif mode == "decode":
        cache = cache._replace(index=cache.index + 1)
    return b_ax, xs, cache


def _mesh_hidden(mp: MeshParams, cfg: TransformerConfig, batch: dict):
    """The layers on the mesh with an autograd graph, each checkpointed
    layer (or group, ``_remat_groups``) gathering its weights inside its
    checkpoint: (b_ax, the batch's parts, each shard's hidden states after
    the final norm, aux)."""
    b_ax, parts = _shard_batch(mp, batch)
    x_spec = (b_ax, None, None)
    use_ep = cfg.moe_impl == "ep_a2a" and mp.mesh.model > 1

    def run(layers, xs, aux):
        for i in layers:
            xs, a, _ = _mesh_block(mp, cfg, i, xs, parts["positions"], x_spec, use_ep, "forward")
            aux = aux + a
        return xs, aux

    xs = _mesh_embed(mp, cfg, parts["tokens"])
    aux = torch.zeros((), device=xs[0].device)
    for layers in _remat_groups(cfg, list(range(cfg.n_layers))):
        xs, aux = L.remat_call(cfg.remat, run, layers, xs, aux)
    hs = [L.rmsnorm(s["final_norm"], x, cfg.norm_eps) for s, x in zip(mp.shards, xs)]
    return b_ax, parts, hs, aux


@torch.no_grad()
def mesh_prefill(mp: MeshParams, cfg: TransformerConfig, tokens: torch.Tensor, max_len: int,
                 positions: torch.Tensor | None = None, cache_dtype=torch.bfloat16):
    """``prefill`` on a mesh: ``tokens`` [B, T] (and ``positions``) the
    whole batch, the same on every rank.  Returns (``MeshLogits`` of the
    last token, the ``KVCache`` of lists: one tensor a local shard)."""
    b_ax, xs, cache = _mesh_run(mp, cfg, tokens, positions, "prefill", max_len,
                                cache_dtype=cache_dtype)
    return _mesh_unembed(mp, cfg, xs, b_ax), cache


@torch.no_grad()
def mesh_decode_step(mp: MeshParams, cfg: TransformerConfig, token: torch.Tensor,
                     cache: KVCache):
    """``decode_step`` on a mesh: ``token`` [B, 1] the whole batch (the
    same on every rank), at position ``cache.index``.  Writes each shard's
    cache in place; returns (``MeshLogits``, the cache with index + 1).
    The MoE runs the default dispatch (``moe_impl`` aside), as the
    reference's decode does."""
    b_ax, xs, cache = _mesh_run(mp, cfg, token, None, "decode", cache=cache)
    return _mesh_unembed(mp, cfg, xs, b_ax), cache


def mesh_forward(mp: MeshParams, cfg: TransformerConfig, tokens: torch.Tensor,
                 positions: torch.Tensor | None = None):
    """``forward`` on a mesh, with an autograd graph: (hidden [B, T, D]
    after the final norm, gathered on every rank, aux)."""
    b_ax, _, hs, aux = _mesh_hidden(mp, cfg, {"tokens": tokens, "positions": positions})
    return gather(mp.mesh, hs, (b_ax, None, None))[0], aux


def mesh_loss_fn(mp: MeshParams, cfg: TransformerConfig, batch: dict) -> torch.Tensor:
    """``loss_fn`` on a mesh: the mean cross entropy (with z-loss) over the
    global batch plus ``aux_coef`` times the MoE aux, each token counted
    once.  ``batch`` holds the whole batch (the same on every rank), or
    ``sharding.Laid`` leaves cut onto the mesh
    (``launch.steps.microbatch_constraint``).  Autograd runs from this
    rank's part of the loss (its shards' weighted cross entropies, and the
    aux over the number of ranks); the value is the whole loss, summed over
    the ranks."""
    mesh = mp.mesh
    b_ax, parts, hs, aux = _mesh_hidden(mp, cfg, batch)
    table, rest = _layer_weights(mp, "embed")
    logits = [L.unembed(t, h) for t, h in zip(table, hs)]
    if _on_model(rest["table"][0]):
        logits = mesh.all_gather(logits, "model", -1)
    weight = 1.0 / mesh.n_shards
    held = {}
    for lg, lab in zip(logits, parts["labels"]):
        held.setdefault(id(lg), [lg, lab, 0.0])[2] += weight
    local = sum(L.cross_entropy(lg, lab, z_loss=cfg.z_loss) * w for lg, lab, w in held.values())
    local = local + cfg.aux_coef * aux / mesh.world
    if mesh.group is None:
        return local
    return mesh.total(local) + (local - local.detach())     # the value the total's, bit for bit
