"""Shared layers of the LM families (counterpart of
``repro/models/layers.py``).

Functional style, as the reference: parameters are nested dicts of
tensors and every function takes its dict.  Attention covers GQA with any
kv <= q head count, optional QKV bias (qwen2, whisper), optional qk-norm
(qwen3), RoPE and M-RoPE (qwen2-vl), causal masks, cross-attention into
an encoder memory (whisper), KV-cache decode, and prefill as flash
attention over [qc, kc] tiles (``_sdpa_flash``), so a 32k-token prefill
never materializes a [T, T] logits buffer.  Norms, RoPE angles and
softmax run in float32 whatever the activation dtype; the activations
(``silu``, ``gelu``) round each step to the input's dtype, as XLA does.

Attention is plain PyTorch following the reference's recurrence; the
reference computes it in XLA, not in a Pallas kernel.  The reference's
``pin_activations`` (a GSPMD sharding constraint) has no counterpart: on
an LM mesh the port lays out its activations itself
(``models/transformer.py``).  Nor have its two other recurrences, selected
only by its GSPMD cell programs: ``_sdpa_flash_sp`` (sequence
parallelism) and ``_sdpa_chunked`` (ROADMAP.md section 1).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.tree import tree_map  # noqa: F401  (re-exported: L.tree_map)

Params = dict

NEG = -1e30    # the masked logit


def remat_call(remat: bool, fn, *args):
    """``fn(*args)``; with ``remat``, while autograd records, under
    activation checkpointing (``torch.utils.checkpoint``, non-reentrant):
    the backward runs ``fn`` again instead of keeping its activations, the
    reference's ``jax.checkpoint``.  Without a graph (serving) it is a plain
    call."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def normal(shape, scale: float, dtype, generator: torch.Generator, device) -> torch.Tensor:
    """Standard normal draws times ``scale``, made in float32 on ``device``
    and then cast to ``dtype``."""
    return torch.randn(shape, generator=generator, device=device).mul_(scale).to(dtype)


# ------------------------------------------------------------------ norms ---

def rmsnorm_init(d: int, dtype=torch.float32, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def layernorm_init(d: int, dtype=torch.float32, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


# ----------------------------------------------------------------- linear ---

def dense_init(d_in: int, d_out: int, generator: torch.Generator, device, *,
               bias: bool = False, dtype=torch.float32) -> Params:
    p = {"w": normal((d_in, d_out), d_in ** -0.5, dtype, generator, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with the weight cast to the activation dtype."""
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# ------------------------------------------------------------------- RoPE ---

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Split-halves rotation of ``x`` [B, T, H, hd] by ``ang`` [B, T, hd/2]."""
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, T, H, hd]; positions: [B, T] integers."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)              # [hd/2]
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE. positions: [3, B, T] (t/h/w components).

    The hd/2 frequency slots are split into three contiguous sections, each
    rotated by its own position component (text tokens carry equal
    components, reducing to standard RoPE)."""
    hd = x.shape[-1]
    s_t, s_h, s_w = sections
    if s_t + s_h + s_w != hd // 2:
        raise ValueError(f"M-RoPE sections {sections} must cover hd/2 = {hd // 2}")
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions[..., None].float() * freqs                     # [3, B, T, hd/2]
    ang = torch.cat([ang[0, ..., :s_t], ang[1, ..., s_t:s_t + s_h],
                     ang[2, ..., s_t + s_h:]], dim=-1)             # [B, T, hd/2]
    return _rotate(x, ang)


# -------------------------------------------------------------- attention ---

@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    mrope_sections: tuple[int, int, int] | None = None
    causal: bool = True
    q_chunk: int = 1024        # prefill query-chunk size (memory bound)
    k_chunk: int = 1024        # key-chunk size
    norm_eps: float = 1e-6


def attn_init(cfg: AttnConfig, generator: torch.Generator, device,
              dtype=torch.float32) -> Params:
    h, kv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    p = {
        "wq": dense_init(d, h * hd, generator, device, bias=cfg.qkv_bias, dtype=dtype),
        "wk": dense_init(d, kv * hd, generator, device, bias=cfg.qkv_bias, dtype=dtype),
        "wv": dense_init(d, kv * hd, generator, device, bias=cfg.qkv_bias, dtype=dtype),
        "wo": dense_init(h * hd, d, generator, device, dtype=dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dtype, device)
        p["k_norm"] = rmsnorm_init(hd, dtype, device)
    return p


def token_positions(b: int, t: int, device) -> torch.Tensor:
    """Positions [B, T] of a text sequence: each row 0 .. T - 1."""
    return torch.arange(t, device=device)[None].expand(b, t)


def _rotate_heads(cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """``x`` [B, T, heads, hd] rotated by its positions (M-RoPE, RoPE, or
    none at ``rope_theta`` 0)."""
    if cfg.mrope_sections is not None:
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    if cfg.rope_theta > 0:
        return apply_rope(x, positions if positions.dim() == 2 else positions[0], cfg.rope_theta)
    return x


def _proj(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``dense``, then the output columns ``p["cols"]`` where given (a
    tensor-parallel shard's heads out of the whole projection)."""
    y = dense(p, x)
    return y[..., p["cols"]] if "cols" in p else y


def _project_q(p: Params, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor):
    b, t, _ = x.shape
    q = _proj(p["wq"], x).reshape(b, t, cfg.n_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
    return _rotate_heads(cfg, q, positions)


def _project_qkv(p: Params, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor):
    b, t, _ = x.shape
    k = _proj(p["wk"], x).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    v = _proj(p["wv"], x).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    return _project_q(p, cfg, x, positions), _rotate_heads(cfg, k, positions), v


def _pad_time(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``x`` [B, T, ...] with ``pad`` zero steps appended along T."""
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad)) if pad else x


def _sdpa_flash(q, k, v, *, causal: bool, q_chunk: int, k_chunk: int, q_offset: int = 0):
    """Grouped-query flash attention: an online softmax over [qc, kc]
    tiles, so only O(qc x kc) score tiles ever exist.

    q: [B, T, H, hd]; k/v: [B, S, KV, hd]; H % KV == 0 (GQA groups).  The
    last query and key chunks are zero-padded, the padded keys masked."""
    b, t, h, hd = q.shape
    s, kv_ = k.shape[1], k.shape[2]
    g = h // kv_
    scale = hd ** -0.5
    qc, kc = min(q_chunk, t), min(k_chunk, s)
    qr = _pad_time(q, (-t) % qc)
    nq = qr.shape[1] // qc
    qr = qr.reshape(b, nq, qc, kv_, g, hd)
    kr, vr = _pad_time(k, (-s) % kc), _pad_time(v, (-s) % kc)
    nk = kr.shape[1] // kc
    kr, vr = kr.reshape(b, nk, kc, kv_, hd), vr.reshape(b, nk, kc, kv_, hd)
    outs = []
    for qidx in range(nq):
        qf = qr[:, qidx].float() * scale                          # [b, qc, kv, g, hd]
        qpos = q_offset + qidx * qc + torch.arange(qc, device=q.device)
        m = torch.full((b, kv_, g, qc), NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, kv_, g, qc), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, kv_, g, qc, hd), dtype=torch.float32, device=q.device)
        for kidx in range(nk):
            logits = torch.einsum("bqkgd,bskd->bkgqs", qf, kr[:, kidx].float())
            kpos = kidx * kc + torch.arange(kc, device=q.device)
            ok = kpos[None, :] < s                                # key padding
            if causal:
                ok = ok & (qpos[:, None] >= kpos[None, :])
            logits = torch.where(ok, logits, NEG)
            m_new = torch.maximum(m, logits.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p,
                                                        vr[:, kidx].float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]          # [b, kv, g, qc, hd]
        outs.append(out.movedim(3, 1))                            # [b, qc, kv, g, hd]
    out = torch.stack(outs, dim=1).reshape(b, nq * qc, h, hd)
    return out[:, :t].to(q.dtype)


def attend(p: Params, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor, *,
           kv: tuple[torch.Tensor, torch.Tensor] | None = None) -> torch.Tensor:
    """``attention`` before its output projection: the heads' outputs
    [B, T, H*hd]."""
    if kv is None:
        q, k, v = _project_qkv(p, cfg, x, positions)
    else:
        q, (k, v) = _project_q(p, cfg, x, positions), kv
    out = _sdpa_flash(q, k, v, causal=cfg.causal and kv is None, q_chunk=cfg.q_chunk,
                      k_chunk=cfg.k_chunk)
    b, t = x.shape[:2]
    return out.reshape(b, t, cfg.n_heads * cfg.head_dim)


def attention(p: Params, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor, *,
              kv: tuple[torch.Tensor, torch.Tensor] | None = None) -> torch.Tensor:
    """x: [B, T, D]; positions: [B, T], or [3, B, T] for M-RoPE.  With
    ``kv`` (the cross-attention memory's keys and values, [B, S, KV, hd]
    each) the queries attend to it, unmasked; the reference projects the
    query's own keys and values there too and drops them, so they are not
    computed here."""
    return dense(p["wo"], attend(p, cfg, x, positions, kv=kv))


def attend_prefill(p: Params, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor,
                   cache_len: int):
    """``attention_prefill`` before its output projection: the heads'
    outputs [B, T, H*hd] and the [B, cache_len, KV, hd] KV cache."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = _sdpa_flash(q, k, v, causal=cfg.causal, q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk)
    b, t = x.shape[:2]
    return (out.reshape(b, t, cfg.n_heads * cfg.head_dim),
            (_pad_time(k, cache_len - t), _pad_time(v, cache_len - t)))


def attention_prefill(p: Params, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor,
                      cache_len: int):
    """Prefill returning the output and a [B, cache_len, KV, hd] KV cache,
    zero past the prompt."""
    out, cache = attend_prefill(p, cfg, x, positions, cache_len)
    return dense(p["wo"], out), cache


def attend_decode(p: Params, cfg: AttnConfig, x: torch.Tensor, position: int,
                  cache: tuple[torch.Tensor, torch.Tensor], cache_index: int):
    """``attention_decode`` before its output projection: the heads'
    outputs [B, 1, H*hd], the cache written at ``cache_index``."""
    b = x.shape[0]
    kc, vc = cache
    s = kc.shape[1]
    if not 0 <= cache_index < s:
        raise IndexError(f"KV cache index {cache_index} outside its {s} slots")
    # a fill on the device, not a copy from the host (which would sync)
    pos = torch.full((b, 1), position, device=x.device)
    if cfg.mrope_sections is not None:
        pos = pos[None].expand(3, b, 1)
    q, k, v = _project_qkv(p, cfg, x, pos)
    kc[:, cache_index] = k[:, 0].to(kc.dtype)
    vc[:, cache_index] = v[:, 0].to(vc.dtype)
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // kvh
    qf = q.float().reshape(b, 1, kvh, g, hd) * hd ** -0.5
    logits = torch.einsum("bqkgd,bskd->bkgqs", qf, kc.float())
    valid = torch.arange(s, device=x.device) <= cache_index
    logits = torch.where(valid, logits, NEG)
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, vc.float())
    return o.reshape(b, 1, h * hd).to(x.dtype), (kc, vc)


def attention_decode(p: Params, cfg: AttnConfig, x: torch.Tensor, position: int,
                     cache: tuple[torch.Tensor, torch.Tensor], cache_index: int):
    """One-token decode at ``position``. x: [B, 1, D]; cache k/v: [B, S, KV, hd].

    Writes the token's k/v into the cache at ``cache_index`` (in place) and
    returns (y [B, 1, D], the cache).  Entries beyond ``cache_index`` are
    masked out of the softmax."""
    o, cache = attend_decode(p, cfg, x, position, cache, cache_index)
    return dense(p["wo"], o), cache


# -------------------------------------------------------------------- MLP ---

def mlp_init(d: int, d_ff: int, generator: torch.Generator, device, *, gated: bool = True,
             dtype=torch.float32) -> Params:
    p = {"w_up": dense_init(d, d_ff, generator, device, dtype=dtype),
         "w_down": dense_init(d_ff, d, generator, device, dtype=dtype)}
    if gated:
        p["w_gate"] = dense_init(d, d_ff, generator, device, dtype=dtype)
    return p


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)``, the sigmoid as ``1 / (1 + exp(-x))`` with each
    step rounded to ``x``'s dtype, as XLA computes ``jax.nn.silu``
    (``F.silu`` and ``torch.sigmoid`` round once, an ulp off in bfloat16)."""
    return x * (1 / (1 + torch.exp(-x)))


def _const(v: float, dtype) -> float:
    """``v`` rounded to ``dtype``, as XLA rounds a constant to its operand's
    type before the op."""
    return float(torch.tensor(v, dtype=dtype))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default tanh form,
    ``x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x**3))))``, with
    its constants and each step rounded to ``x``'s dtype as XLA computes
    it (``F.gelu(approximate="tanh")`` rounds once: off by an ulp on 4.5%
    of bfloat16 inputs).  Equal to XLA's over every normal bfloat16 in
    [-20, 20]; XLA flushes subnormal results to zero."""
    inner = x + _const(0.044715, x.dtype) * (x * (x * x))
    return x * (0.5 * (1.0 + torch.tanh(_const(np.sqrt(2 / np.pi), x.dtype) * inner)))


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    up = dense(p["w_up"], x)
    if "w_gate" in p:
        up = silu(dense(p["w_gate"], x)) * up                     # SwiGLU
    else:
        up = gelu(up)
    return dense(p["w_down"], up)


# -------------------------------------------------------------- embedding ---

def embedding_init(vocab: int, d: int, generator: torch.Generator, device,
                   dtype=torch.float32) -> Params:
    return {"table": normal((vocab, d), 0.02, dtype, generator, device)}


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: logits = x @ table.T (float32 accumulation)."""
    return torch.einsum("btd,vd->btv", x.float(), p["table"].float())


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, *,
                  z_loss: float = 0.0) -> torch.Tensor:
    """Mean token cross entropy of ``logits`` [..., V] (float32) against
    integer ``targets`` [...]; with ``z_loss`` > 0 plus ``z_loss`` times
    the squared log-partition (stabilizes a big vocabulary)."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, targets[..., None].long(), dim=-1)[..., 0]
    loss = lse - ll
    if z_loss > 0.0:
        loss = loss + z_loss * lse ** 2
    return torch.mean(loss)
