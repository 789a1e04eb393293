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
record graphs for training, the last two serve.  That section's attention,
FFN, embedding, unembedding, loss and cache helpers also carry the
hybrid's shared block and the encoder-decoder on the mesh (``hybrid``,
``encdec``).
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


def layer_rest(mp: MeshParams, key: str, index=None) -> dict:
    """The specs ``_layer_weights`` gives ``mp.shards[j][key]`` (``[index]``)
    after its gather, without gathering."""
    tree = mp.shards[0][key] if index is None else mp.shards[0][key][index]
    specs = mp.specs[key] if index is None else mp.specs[key][index]
    return rest_tree(tree, specs, _gathered(mp.policy))


def batch_axis(mp: MeshParams, batch: int):
    """The batch entry of a [batch, T] token batch on ``mp``'s mesh."""
    return batch_spec("tokens", torch.empty((batch, 1), device="meta"), mp.mesh.shape,
                      mp.policy)[0]


def batch_rows(mp: MeshParams, batch: int) -> list[slice]:
    """Each local shard's rows of a [batch, ...] batch."""
    return _rows(mp.mesh, batch_axis(mp, batch), batch)


def _row_parallel(mesh, parts: list, dtype) -> list:
    """Partial products (float32) summed over `model` and rounded once."""
    return [y.to(dtype) for y in mesh.psum(parts, "model")]


class _Heads(NamedTuple):
    """One local shard's attention heads: its q heads [lo, hi), the KV
    heads they read (a slice, or a tensor of one KV head a q head where the
    groups are uneven) and the attention config of those heads."""
    lo: int
    hi: int
    kv: Any
    cfg: AttnConfig


def shard_heads(n_heads: int, n_groups: int, m: int, coord: int | None, device) -> tuple:
    """(lo, hi, the groups they read, how many) of the heads [lo, hi) that
    the shard at `model` coordinate ``coord`` of ``m`` runs (``coord``
    None: all of them), ``n_heads`` heads in ``n_groups`` equal groups
    (attention's KV heads, Mamba2's B / C groups).  The groups are a slice
    where the heads cover whole groups or lie in one group, else a tensor
    of one group a head."""
    lo, hi = (0, n_heads) if coord is None else (coord * n_heads // m,
                                                 (coord + 1) * n_heads // m)
    rep = n_heads // n_groups
    g_lo, g_hi = lo // rep, (hi - 1) // rep + 1
    if (lo % rep == 0 and (hi - lo) % rep == 0) or g_hi - g_lo == 1:
        return lo, hi, slice(g_lo, g_hi), g_hi - g_lo
    return lo, hi, torch.arange(lo, hi, device=device) // rep, hi - lo


def head_layout(mesh, acfg: AttnConfig, rest: dict) -> tuple[bool, list]:
    """(whether the q heads are split over `model`, each local shard's
    ``_Heads``) of an attention block whose gathered weights keep the specs
    ``rest``: a shard runs H / model q heads where wq's columns are over
    `model` and `model` divides H, else all of them."""
    heads_split = _on_model(rest["wq"]["w"][1]) and acfg.n_heads % mesh.model == 0
    out = []
    for c in mesh.local:
        lo, hi, kv, kv_n = shard_heads(acfg.n_heads, acfg.n_kv_heads, mesh.model,
                                       c["model"] if heads_split else None, mesh.device)
        out.append(_Heads(lo, hi, kv, dataclasses.replace(acfg, n_heads=hi - lo,
                                                          n_kv_heads=kv_n)))
    return heads_split, out


def _head_cols(sel, hd: int, device):
    """The columns of heads ``sel`` (a slice or a tensor of head ids) in a
    [..., heads * hd] projection."""
    if isinstance(sel, slice):
        return slice(sel.start * hd, sel.stop * hd)
    return (sel[:, None] * hd + torch.arange(hd, device=device)).reshape(-1)


def _attn_proj(mesh, acfg: AttnConfig, blk: list, rest: dict, heads: list,
               heads_split: bool) -> list:
    """Each local shard's q / k / v projections (and qk norms): its own
    column block where that is exactly its heads (``aligned``); else the
    whole projection (gathered over `model` where split) and ``"cols"``,
    so its heads are cut from the whole product as the one-shard model
    forms it."""
    hd, m_n = acfg.head_dim, mesh.model
    q_split = _on_model(rest["wq"]["w"][1])
    kv_split = _on_model(rest["wk"]["w"][1])
    kv_aligned = kv_split and heads_split and acfg.n_kv_heads % m_n == 0
    dev = blk[0]["wq"]["w"].device
    q_sel = [slice(hs.lo * hd, hs.hi * hd) for hs in heads]
    kv_sel = [_head_cols(hs.kv, hd, dev) for hs in heads]
    proj = [{} for _ in blk]
    for name, split, aligned, sel in (("wq", q_split, heads_split, q_sel),
                                      ("wk", kv_split, kv_aligned, kv_sel),
                                      ("wv", kv_split, kv_aligned, kv_sel)):
        own = split and aligned
        ws = [b[name]["w"] for b in blk]
        if split and not own:
            ws = mesh.all_gather(ws, "model", -1)
        ds = [{"w": w} if own else {"w": w, "cols": c} for w, c in zip(ws, sel)]
        if "b" in blk[0][name]:
            bs = [b[name]["b"] for b in blk]
            b_split = _on_model(rest[name]["b"][0])
            if b_split and not own:
                bs = mesh.all_gather(bs, "model", -1)
            elif own and not b_split:          # a whole bias beside a weight block
                bs = [bias[c] for bias, c in zip(bs, sel)]
            for d, bias in zip(ds, bs):
                d["b"] = bias
        for p, d in zip(proj, ds):
            p[name] = d
    for p, b in zip(proj, blk):
        for k in ("q_norm", "k_norm"):
            if k in b:
                p[k] = b[k]
    return proj


def _mesh_attention(mesh, acfg: AttnConfig, blk: list, rest: dict, hs: list, pos: list,
                    mode: str, cache=None, index: int = 0, max_len: int = 0, memory=None,
                    kv=None):
    """An attention sublayer on each local shard, ``blk`` each shard's
    gathered attention weights and ``rest`` their specs after the gather,
    ``hs[j]`` the normed activations of shard j's rows.  ``mode``:
    "forward" (no cache), "prefill" (returns each shard's [B, max_len, KV,
    hd] (k, v)), "decode" (``cache`` each shard's (k, v), written at
    ``index``) or "cross" (the queries read each shard's memory keys and
    values: ``kv``, or projected from ``memory`` and returned).  Returns
    (y list, (k, v) list or None)."""
    hd, m_n = acfg.head_dim, mesh.model
    heads_split, heads = head_layout(mesh, acfg, rest)
    proj = _attn_proj(mesh, acfg, blk, rest, heads, heads_split)
    outs, kvs = [], None
    if mode == "cross" and kv is None:
        kvs = []
        for p, hl, mem in zip(proj, heads, memory):
            b, s, _ = mem.shape
            kvs.append((L._proj(p["wk"], mem).reshape(b, s, hl.cfg.n_kv_heads, hd),
                        L._proj(p["wv"], mem).reshape(b, s, hl.cfg.n_kv_heads, hd)))
        kv = kvs
    elif mode == "prefill":
        kvs = []
    for j, (h, p, hl) in enumerate(zip(hs, proj, heads)):
        if mode == "decode":
            o, _ = L.attend_decode(p, hl.cfg, h, index, cache[j], index)
        elif mode == "cross":
            o = L.attend(p, hl.cfg, h, pos[j], kv=kv[j])
        elif mode == "prefill":
            o, c = L.attend_prefill(p, hl.cfg, h, pos[j], max_len)
            kvs.append(c)
        else:
            o = L.attend(p, hl.cfg, h, pos[j])
        outs.append(o)
    if _on_model(rest["wo"]["w"][0]):
        width = acfg.n_heads * hd // m_n
        parts = [(o if heads_split else o[..., c["model"] * width:(c["model"] + 1) * width])
                 .float() @ b["wo"]["w"].float()
                 for o, b, c in zip(outs, blk, mesh.local)]
        ys = _row_parallel(mesh, parts, hs[0].dtype)
    else:
        ys = [L.dense(b["wo"], o) for o, b in zip(outs, blk)]
    return ys, kvs


def _mesh_ffn(mesh, moe_spec, blk: list, rest: dict, hs: list, x_spec: tuple = (),
              use_ep: bool = False):
    """The FFN sublayer on each local shard (``blk`` each shard's gathered
    block, holding ``"moe"`` where ``moe_spec`` is given, else ``"mlp"``):
    (y list, aux)."""
    if moe_spec is not None:
        kw = dict(top_k=moe_spec.top_k, n_experts=moe_spec.n_experts,
                  capacity_factor=moe_spec.capacity_factor)
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


def mesh_embed(mp: MeshParams, toks: list, dtype=None) -> list:
    """Each local shard's token embeddings (in ``dtype`` where given): a
    masked lookup of its vocabulary block, summed over `model`, where the
    table's rows are over `model`."""
    mesh = mp.mesh
    table, rest = _layer_weights(mp, "embed")
    cast = (lambda x: x) if dtype is None else (lambda x: x.to(dtype))
    if not _on_model(rest["table"][0]):
        return [cast(L.embed(t, tok)) for t, tok in zip(table, toks)]
    parts = []
    for t, tok, c in zip(table, toks, mesh.local):
        v_loc = t["table"].shape[0]
        rel = tok - c["model"] * v_loc
        ok = (rel >= 0) & (rel < v_loc)
        parts.append(t["table"][rel.clamp(0, v_loc - 1)] * ok[..., None].to(t["table"].dtype))
    return [cast(x) for x in mesh.psum(parts, "model")]


def mesh_unembed(mp: MeshParams, hs: list, b_ax) -> MeshLogits:
    """The tied unembedding of each shard's normed last position ``hs[j]``
    [B_j, 1, D]."""
    table, rest = _layer_weights(mp, "embed")
    parts = [L.unembed(t, h)[:, 0] for t, h in zip(table, hs)]
    return MeshLogits(parts, (b_ax, "model" if _on_model(rest["table"][0]) else None), mp.mesh)


def mesh_cross_entropy(mp: MeshParams, hs: list, labels: list, z_loss: float,
                       extra=None) -> torch.Tensor:
    """The mean cross entropy (with z-loss) of each shard's hidden states
    ``hs[j]`` against ``labels[j]`` through the tied unembedding, each
    token counted once (plus ``extra``, this rank's part of another term).
    Autograd runs from this rank's part; the value is the whole loss,
    summed over the ranks."""
    mesh = mp.mesh
    table, rest = _layer_weights(mp, "embed")
    logits = [L.unembed(t, h) for t, h in zip(table, hs)]
    if _on_model(rest["table"][0]):
        logits = mesh.all_gather(logits, "model", -1)
    weight = 1.0 / mesh.n_shards
    held = {}
    for lg, lab in zip(logits, labels):
        held.setdefault(id(lg), [lg, lab, 0.0])[2] += weight
    local = sum(L.cross_entropy(lg, lab, z_loss=z_loss) * w for lg, lab, w in held.values())
    if extra is not None:
        local = local + extra
    if mesh.group is None:
        return local
    return mesh.total(local) + (local - local.detach())     # the value the total's, bit for bit


def put_back(parts: list, rows: list, sels: list, shape: tuple, bdim: int, sdim: int):
    """One tensor of ``shape`` (float32) from each local shard's part,
    ``parts[j]`` holding the batch rows ``rows[j]`` (along ``bdim``) and
    the entries ``sels[j]`` (a slice or an index tensor along ``sdim``);
    shards holding the same entries must agree."""
    full = torch.full(shape, float("nan"), device=parts[0].device)
    for part, r, s in zip(parts, rows, sels):
        idx = [slice(None)] * len(shape)
        idx[bdim] = r
        view = full[tuple(idx)]
        sidx = [slice(None)] * len(shape)
        sidx[sdim] = s
        seen = view[tuple(sidx)]
        done = ~torch.isnan(seen)
        if not torch.equal(seen[done], part.float()[done]):
            raise ValueError("two shards hold different values of one cache entry")
        view[tuple(sidx)] = part.float()
    if torch.isnan(full).any():
        raise ValueError("no shard holds some cache entries")
    return full


def full_kv(mp: MeshParams, acfg: AttnConfig, rest: dict, parts: list, batch: int):
    """The whole [n, B, S, KV, hd] KV cache (float32) from each local
    shard's [n, B_j, S, KV_j, hd] (its rows and the KV heads its q heads
    read), ``rest`` the attention block's specs after the gather."""
    _, heads = head_layout(mp.mesh, acfg, rest)
    shape = (parts[0].shape[0], batch, parts[0].shape[2], acfg.n_kv_heads, acfg.head_dim)
    return put_back(parts, batch_rows(mp, batch), [h.kv for h in heads], shape, 1, 3)


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
    kv = None if cache is None else [(k[i], v[i]) for k, v in zip(cache.k, cache.v)]
    ys, kvs = _mesh_attention(mp.mesh, cfg.attn_config(), [b["attn"] for b in blk],
                              rest["attn"], hs, pos, mode, kv,
                              0 if cache is None else cache.index, max_len)
    xs = [x + y for x, y in zip(xs, ys)]
    hs = [L.rmsnorm(b["ln2"], x, cfg.norm_eps) for b, x in zip(blk, xs)]
    ys, aux = _mesh_ffn(mp.mesh, cfg.moe, blk, rest, hs, x_spec, use_ep)
    return [x + y for x, y in zip(xs, ys)], aux, kvs


def _mesh_run(mp: MeshParams, cfg: TransformerConfig, tokens, positions, mode: str,
              max_len: int = 0, cache=None, cache_dtype=torch.bfloat16):
    """The layers on the mesh for serving: (b_ax, each shard's final
    activations, the cache)."""
    b_ax, parts = _shard_batch(mp, {"tokens": tokens, "positions": positions})
    xs = mesh_embed(mp, parts["tokens"], cfg.act_dtype)
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

    xs = mesh_embed(mp, parts["tokens"], cfg.act_dtype)
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
    return _last_logits(mp, cfg, xs, b_ax), cache


def _last_logits(mp: MeshParams, cfg, xs: list, b_ax) -> MeshLogits:
    """The final norm (``final_norm``, an RMSNorm at ``cfg.norm_eps``) and
    the tied unembedding of each shard's last position (the ssm and hybrid
    families' too)."""
    return mesh_unembed(mp, [L.rmsnorm(s["final_norm"], x[:, -1:], cfg.norm_eps)
                             for s, x in zip(mp.shards, xs)], b_ax)


@torch.no_grad()
def mesh_decode_step(mp: MeshParams, cfg: TransformerConfig, token: torch.Tensor,
                     cache: KVCache):
    """``decode_step`` on a mesh: ``token`` [B, 1] the whole batch (the
    same on every rank), at position ``cache.index``.  Writes each shard's
    cache in place; returns (``MeshLogits``, the cache with index + 1).
    The MoE runs the default dispatch (``moe_impl`` aside), as the
    reference's decode does."""
    b_ax, xs, cache = _mesh_run(mp, cfg, token, None, "decode", cache=cache)
    return _last_logits(mp, cfg, xs, b_ax), cache


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
    b_ax, parts, hs, aux = _mesh_hidden(mp, cfg, batch)
    return mesh_cross_entropy(mp, hs, parts["labels"], cfg.z_loss,
                              extra=cfg.aux_coef * aux / mp.mesh.world)
