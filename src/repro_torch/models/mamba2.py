"""Mamba2 block with the SSD (state-space duality) chunked algorithm
(Dao & Gu 2024), counterpart of ``repro/models/mamba2.py``: mamba2-130m
and the zamba2 hybrid's backbone.

Chunked SSD: the sequence is split into chunks of Q tokens; within a chunk
the recurrence is a masked quadratic (attention-like) form of products,
and a loop over the chunks carries the [h, n, p] state across them (the
reference's ``lax.scan``).  Every decay factor is the exp of a
non-positive sum (A < 0, dt > 0), so nothing needs rescaling.

Decode is the O(1)-state recurrent step.  The SSD and the decode state
run in float32 whatever the activation dtype, as the reference casts
them.  The depthwise
convolution is the reference's sum of shifted products, not
``F.conv1d``: cuDNN's convolutions may take TF32 on the card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.layers import Params
from repro_torch.models.transformer import _on_model, shard_heads


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 128         # n
    head_dim: int = 64         # p
    expand: int = 2
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 128           # Q (SSD chunk length)
    norm_eps: float = 1e-5

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        if self.d_inner % self.head_dim:
            raise ValueError(f"d_inner {self.d_inner} is not a multiple of head_dim "
                             f"{self.head_dim}")
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state

    @property
    def d_in_proj(self) -> int:
        return 2 * self.d_inner + 2 * self.n_groups * self.d_state + self.n_heads


class Mamba2State(NamedTuple):
    """Recurrent decode state: constant size, whatever the context."""

    conv: torch.Tensor   # [B, conv_width - 1, conv_dim] float32
    ssm: torch.Tensor    # [B, H, P, N] float32


def mamba2_init(cfg: Mamba2Config, generator: torch.Generator, device,
                dtype=torch.float32) -> Params:
    """The reference's init: projections normal times fan_in**-0.5, the
    conv weight times conv_width**-0.5, A = -exp(A_log) with A_log = log of
    uniform [1, 16], dt_bias the softplus inverse of a log-uniform draw in
    [1e-3, 1e-1], D 1 (the three in float32)."""
    d, h = cfg.d_model, cfg.n_heads

    def uniform(lo, hi):
        return torch.rand((h,), generator=generator, device=device) * (hi - lo) + lo

    in_w = L.normal((d, cfg.d_in_proj), d ** -0.5, dtype, generator, device)
    conv_w = L.normal((cfg.conv_width, cfg.conv_dim), cfg.conv_width ** -0.5, dtype,
                      generator, device)
    a_log = torch.log(uniform(1.0, 16.0))
    dt = torch.exp(uniform(math.log(1e-3), math.log(1e-1)))
    out_w = L.normal((cfg.d_inner, d), cfg.d_inner ** -0.5, dtype, generator, device)
    return {
        "in_proj": {"w": in_w},
        "conv_w": conv_w,
        "conv_b": torch.zeros((cfg.conv_dim,), dtype=dtype, device=device),
        "A_log": a_log,
        "D": torch.ones((h,), dtype=torch.float32, device=device),
        "dt_bias": torch.log(torch.expm1(dt)),
        "norm": L.rmsnorm_init(cfg.d_inner, dtype, device),
        "out_proj": {"w": out_w},
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, i.e. ``logaddexp(x, 0)``: ``max(x, 0) +
    log1p(exp(-|x|))`` (``F.softplus`` returns x above 20 and sums
    otherwise, ulps apart)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _split_proj(cfg: Mamba2Config, zxbcdt: torch.Tensor):
    di = cfg.d_inner
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + cfg.conv_dim]
    dt = zxbcdt[..., di + cfg.conv_dim:]
    return z, xbc, dt


def _conv1d(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv, width K: y_t = sum_k w_k x_{t-K+1+k}, then
    SiLU.  xbc: [B, T, C]; w: [K, C]; b: [C]."""
    k, t = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    y = pad[:, 0:t] * w[0][None, None, :]
    for i in range(1, k):
        y = y + pad[:, i:i + t] * w[i][None, None, :]
    return L.silu(y + b[None, None, :])


def _ssd_chunked(x, b_, c_, dt, a_log, q: int):
    """x: [B, T, H, P]; b_ / c_: [B, T, G, N]; dt: [B, T, H] (after the
    softplus).  Returns y [B, T, H, P] (without the D skip term)."""
    bsz, t, h, p = x.shape
    g, n = b_.shape[2], b_.shape[3]
    rep = h // g
    a = (-torch.exp(a_log))[None, None, :] * dt                  # [B, T, H] <= 0
    pad = (-t) % q
    if pad:
        x, b_, c_ = (F.pad(v, (0, 0, 0, 0, 0, pad)) for v in (x, b_, c_))
        dt, a = (F.pad(v, (0, 0, 0, pad)) for v in (dt, a))
    tp = x.shape[1]
    nc = tp // q
    xc = x.reshape(bsz, nc, q, h, p).float()
    bc = torch.repeat_interleave(b_.reshape(bsz, nc, q, g, n), rep, dim=3).float()
    cc = torch.repeat_interleave(c_.reshape(bsz, nc, q, g, n), rep, dim=3).float()
    dtc = dt.reshape(bsz, nc, q, h).float()
    ac = a.reshape(bsz, nc, q, h).float()
    cs = torch.cumsum(ac, dim=2)                                 # [B, nc, Q, H]

    # intra-chunk quadratic form
    li = cs[:, :, :, None, :] - cs[:, :, None, :, :]             # [B, nc, Q(i), Q(j), H]
    idx = torch.arange(q, device=x.device)
    mask = idx[:, None] >= idx[None, :]
    # the mask goes in before the exp: above the diagonal li > 0 overflows at
    # chunk 128, and the gradient of where(mask, exp(li), 0) is 0 * inf there
    decay = torch.exp(torch.where(mask[None, None, :, :, None], li, float("-inf")))
    cb = torch.einsum("bcihn,bcjhn->bcijh", cc, bc)
    att = cb * decay * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", att, xc)

    # chunk-boundary states
    tail = torch.exp(cs[:, :, -1:, :] - cs)                      # [B, nc, Q, H]
    s = torch.einsum("bcjh,bcjhn,bcjhp->bchnp", tail * dtc, bc, xc)
    chunk_decay = torch.exp(cs[:, :, -1, :])                     # [B, nc, H]

    # the cross-chunk recurrence: each chunk reads the state before it
    hstate = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    h_prev = []
    for ci in range(nc):
        h_prev.append(hstate)
        hstate = chunk_decay[:, ci, :, None, None] * hstate + s[:, ci]
    h_prev = torch.stack(h_prev, dim=1)                          # [B, nc, H, N, P]

    y_inter = torch.einsum("bcihn,bchnp->bcihp", cc * torch.exp(cs)[..., None], h_prev)
    y = (y_intra + y_inter).reshape(bsz, tp, h, p)
    return y[:, :t].to(x.dtype)


def _heads(cfg: Mamba2Config, xbc: torch.Tensor):
    """The conv output [..., conv_dim] split into x [..., H, P], B and C
    [..., G, N]."""
    di, g, n = cfg.d_inner, cfg.n_groups, cfg.d_state
    lead = xbc.shape[:-1]
    return (xbc[..., :di].reshape(*lead, cfg.n_heads, cfg.head_dim),
            xbc[..., di:di + g * n].reshape(*lead, g, n),
            xbc[..., di + g * n:].reshape(*lead, g, n))


def _mix(p: Params, cfg, u: torch.Tensor):
    """The layer up to its gated norm: (y [B, T, d_inner] in u's dtype, z,
    the pieces the decode state is made of: the conv's input, x, B and dt
    after the softplus)."""
    bsz, t, _ = u.shape
    zxbcdt = u @ p["in_proj"]["w"].to(u.dtype)
    z, xbc_raw, dt = _split_proj(cfg, zxbcdt)
    xbc = _conv1d(xbc_raw, p["conv_w"].to(u.dtype), p["conv_b"].to(u.dtype))
    x, b_, c_ = _heads(cfg, xbc)
    dt = softplus(dt.float() + p["dt_bias"][None, None, :])
    y = _ssd_chunked(x, b_, c_, dt, p["A_log"], cfg.chunk)
    y = y + p["D"][None, None, :, None].to(y.dtype) * x.to(y.dtype)
    return y.reshape(bsz, t, cfg.d_inner).to(u.dtype), z, (xbc_raw, x, b_, dt)


def mamba2_forward(p: Params, cfg: Mamba2Config, u: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward (prefill). u: [B, T, D]."""
    y, z, _ = _mix(p, cfg, u)
    y = L.rmsnorm(p["norm"], y * L.silu(z), cfg.norm_eps)       # gated norm
    return y @ p["out_proj"]["w"].to(u.dtype)


def mamba2_init_state(cfg: Mamba2Config, batch: int, device=None) -> Mamba2State:
    return Mamba2State(
        conv=torch.zeros((batch, cfg.conv_width - 1, cfg.conv_dim), device=device),
        ssm=torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.d_state), device=device))


def _final_state(p: Params, cfg, xbc_raw, x, b_, dtv) -> Mamba2State:
    """The recurrence's final state in closed form and the conv window of
    the last ``conv_width - 1`` inputs (zeros before the first)."""
    t = xbc_raw.shape[1]
    x, b_ = x.float(), b_.float()
    a = (-torch.exp(p["A_log"]))[None, None, :] * dtv            # [B, T, H]
    bh = torch.repeat_interleave(b_, cfg.n_heads // cfg.n_groups, dim=2)   # [B, T, H, N]
    # final state = sum_j exp(sum_{l>j} a_l) dt_j x_j B_j^T
    rev = torch.flip(torch.cumsum(torch.flip(a, [1]), dim=1), [1])
    rev_decay = torch.exp(rev - a)
    ssm = torch.einsum("bth,bthp,bthn->bhpn", rev_decay * dtv, x, bh)
    w1 = cfg.conv_width - 1
    conv = F.pad(xbc_raw[:, max(t - w1, 0):].float(), (0, 0, max(w1 - t, 0), 0))
    return Mamba2State(conv=conv, ssm=ssm)


def mamba2_prefill_state(p: Params, cfg: Mamba2Config, u: torch.Tensor) -> Mamba2State:
    """The decode state after a full-sequence prefill: the recurrence's
    final state in closed form, and the conv window of the last
    ``conv_width - 1`` inputs (zeros before the first).

    The reference takes the window as ``xbc[:, t - (W - 1):]``, which at
    1 < T < W - 1 is a negative start and keeps only the last W - 1 - T
    rows (T = 2 at W = 4: one row, a [B, 2, C] state its decode step
    cannot read); here the window always holds the last min(T, W - 1)
    inputs, which is the reference's at every other T."""
    zxbcdt = u @ p["in_proj"]["w"].to(u.dtype)
    _, xbc_raw, dt = _split_proj(cfg, zxbcdt)
    xbc = _conv1d(xbc_raw, p["conv_w"].to(u.dtype), p["conv_b"].to(u.dtype))
    x, b_, _ = _heads(cfg, xbc)
    dtv = softplus(dt.float() + p["dt_bias"][None, None, :])
    return _final_state(p, cfg, xbc_raw, x, b_, dtv)


def _decode_mix(p: Params, cfg, u: torch.Tensor, state: Mamba2State):
    """One token up to the gated norm: (y [B, 1, d_inner] in u's dtype, z
    [B, 1, d_inner], the state after the token)."""
    bsz = u.shape[0]
    zxbcdt = u[:, 0] @ p["in_proj"]["w"].to(u.dtype)            # [B, d_in_proj]
    z, xbc_t, dt = _split_proj(cfg, zxbcdt)
    window = torch.cat([state.conv, xbc_t[:, None, :].float()], dim=1)   # [B, W, conv_dim]
    xbc = L.silu(torch.einsum("bwc,wc->bc", window, p["conv_w"].float())
                 + p["conv_b"].float())
    x, b_, c_ = _heads(cfg, xbc)
    rep = cfg.n_heads // cfg.n_groups
    bh = torch.repeat_interleave(b_, rep, dim=1)                 # [B, H, N]
    ch = torch.repeat_interleave(c_, rep, dim=1)
    dtv = softplus(dt.float() + p["dt_bias"][None, :])
    decay = torch.exp(-torch.exp(p["A_log"])[None, :] * dtv)     # [B, H]
    ssm = (decay[:, :, None, None] * state.ssm
           + torch.einsum("bh,bhp,bhn->bhpn", dtv, x, bh))
    y = torch.einsum("bhpn,bhn->bhp", ssm, ch) + p["D"][None, :, None] * x
    y = y.reshape(bsz, 1, cfg.d_inner).to(u.dtype)
    return y, z[:, None, :], Mamba2State(conv=window[:, 1:], ssm=ssm)


def mamba2_decode_step(p: Params, cfg: Mamba2Config, u: torch.Tensor,
                       state: Mamba2State) -> tuple[torch.Tensor, Mamba2State]:
    """One-token recurrent step. u: [B, 1, D] -> (y [B, 1, D], state)."""
    y, z, state = _decode_mix(p, cfg, u, state)
    y = L.rmsnorm(p["norm"], y * L.silu(z), cfg.norm_eps)
    return y @ p["out_proj"]["w"].to(u.dtype), state


# ---------------------------------------------------------------------------
# On an LM mesh (``launch.mesh.LMMesh``)
# ---------------------------------------------------------------------------
#
# ``mesh_mamba2`` runs one layer on each local shard, its weights gathered
# over the policy's axes by the caller (``transformer._layer_weights``).
# Under ``fsdp`` and ``ep_dp`` nothing stays split over `model` and each
# shard runs the whole layer on its batch rows.  Under ``fsdp_tp`` the
# shards of a `model` line share their rows and each runs H / model of the
# heads (all of them where `model` does not divide H):
#
#   * in_proj [d, 2 d_inner + 2 G N + H] has its columns over `model`, in
#     blocks that straddle z, xBC and dt and no shard's heads (mamba2-130m:
#     3,352 columns in blocks of 838 at `model` 4).  It is gathered over
#     `model`, and each shard takes its heads' z, x and dt columns and the
#     B and C columns of the groups its heads read (one group a head where
#     its heads do not cover whole groups).  conv_w [W, conv_dim] is split
#     on conv_dim off the heads as well: gathered, then the same channels.
#   * The gated RMSNorm normalises y * silu(z) over the whole d_inner: each
#     shard's float32 sum of squares over its heads is summed over `model`.
#   * out_proj [d_inner, d] has its rows over `model`: each shard's float32
#     partial product of its heads' rows, summed over `model` and rounded
#     once (``transformer._row_parallel``).
#
# The decode state is the port's own layout, one tensor a local shard: the
# SSM state of the shard's heads [B_j, H_j, P, N] and the conv window of
# exactly the channels it reads [B_j, W - 1, C_j] (x of its heads, B and C
# of their groups).  The reference's ``cache_spec`` cuts conv_dim into
# contiguous blocks, which do not match the heads, and the state's heads
# over `model` only where the batch leaves `model` free.


class _Local(NamedTuple):
    """The dimensions of one shard's heads (the ``Mamba2Config`` fields the
    layer's functions read)."""
    d_inner: int
    n_heads: int
    head_dim: int
    n_groups: int
    d_state: int
    conv_width: int
    chunk: int
    norm_eps: float

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


class _Shard(NamedTuple):
    """One local shard's part of a layer: its heads, the conv channels it
    reads (None: all) and its in_proj columns (None: all)."""
    heads: slice
    ch: torch.Tensor | None
    cols: torch.Tensor | None
    dims: _Local


def _range(lo: int, hi: int, device) -> torch.Tensor:
    return torch.arange(lo, hi, device=device)


def mesh_layout(mesh, cfg: Mamba2Config, rest: dict) -> tuple[bool, list]:
    """(whether the heads are split over `model`, each local shard's
    ``_Shard``) of a Mamba2 layer whose gathered weights keep the specs
    ``rest``."""
    h, p, g, n = cfg.n_heads, cfg.head_dim, cfg.n_groups, cfg.d_state
    di, m = cfg.d_inner, mesh.model
    tp = any(_on_model(e) for e in (rest["in_proj"]["w"][1], rest["conv_w"][1],
                                    rest["out_proj"]["w"][0]))
    split = tp and m > 1 and h % m == 0
    whole = _Local(di, h, p, g, n, cfg.conv_width, cfg.chunk, cfg.norm_eps)
    out = []
    for c in mesh.local:
        if not split:
            out.append(_Shard(slice(0, h), None, None, whole))
            continue
        dev = mesh.device
        lo, hi, groups, g_loc = shard_heads(h, g, m, c["model"], dev)
        if isinstance(groups, slice):
            groups = _range(groups.start, groups.stop, dev)
        bc = (groups[:, None] * n + torch.arange(n, device=dev)).reshape(-1)
        ch = torch.cat([_range(lo * p, hi * p, dev), di + bc, di + g * n + bc])
        cols = torch.cat([_range(lo * p, hi * p, dev), di + ch,
                          di + cfg.conv_dim + _range(lo, hi, dev)])
        out.append(_Shard(slice(lo, hi), ch, cols,
                          _Local((hi - lo) * p, hi - lo, p, g_loc, n, cfg.conv_width, cfg.chunk,
                                 cfg.norm_eps)))
    return split, out


def mesh_mamba2(mesh, cfg: Mamba2Config, blk: list, rest: dict, us: list, mode: str,
                states=None):
    """One Mamba2 layer on each local shard: ``blk`` each shard's gathered
    layer weights, ``rest`` their specs after the gather, ``us[j]`` shard
    j's normed input [B_j, T, D].  ``mode``: "forward", "prefill" (also
    returns each shard's decode state) or "decode" (``states`` each shard's
    ``Mamba2State``; returns the states after the token).  Returns (each
    shard's output, its states or None)."""
    split, shards = mesh_layout(mesh, cfg, rest)
    in_w = [b["in_proj"]["w"] for b in blk]
    if _on_model(rest["in_proj"]["w"][1]):
        in_w = mesh.all_gather(in_w, "model", -1)
    conv_w = [b["conv_w"] for b in blk]
    if _on_model(rest["conv_w"][1]):
        conv_w = mesh.all_gather(conv_w, "model", -1)
    gated, new = [], []
    for j, (b, u, sh) in enumerate(zip(blk, us, shards)):
        sel = (lambda t, i: t) if sh.ch is None else (lambda t, i: t[..., i])
        p = {"in_proj": {"w": sel(in_w[j], sh.cols)}, "conv_w": sel(conv_w[j], sh.ch),
             "conv_b": sel(b["conv_b"], sh.ch),
             **{k: b[k][sh.heads] for k in ("A_log", "D", "dt_bias")}}
        if mode == "decode":
            y, z, st = _decode_mix(p, sh.dims, u, states[j])
        else:
            y, z, pieces = _mix(p, sh.dims, u)
            st = _final_state(p, sh.dims, *pieces) if mode == "prefill" else None
        gated.append(y * L.silu(z))
        new.append(st)
    rows = [slice(sh.heads.start * cfg.head_dim, sh.heads.stop * cfg.head_dim) for sh in shards]
    if split:   # the gated norm over the whole d_inner: float32 sums of squares over `model`
        ssq = mesh.psum([torch.sum(y.float() * y.float(), -1, keepdim=True) for y in gated],
                        "model")
        normed = [(y.float() * torch.rsqrt(s / cfg.d_inner + cfg.norm_eps)
                   * b["norm"]["scale"][r].float()).to(y.dtype)
                  for y, s, b, r in zip(gated, ssq, blk, rows)]
    else:
        normed = [L.rmsnorm(b["norm"], y, cfg.norm_eps) for y, b in zip(gated, blk)]
    if _on_model(rest["out_proj"]["w"][0]) or split:
        width = cfg.d_inner // mesh.model
        parts = []
        for y, b, c, r in zip(normed, blk, mesh.local, rows):
            w = b["out_proj"]["w"]
            if not _on_model(rest["out_proj"]["w"][0]):
                w = w[r]
            elif not split:
                y = y[..., c["model"] * width:(c["model"] + 1) * width]
            parts.append(y.float() @ w.float())
        outs = [o.to(us[0].dtype) for o in mesh.psum(parts, "model")]
    else:
        outs = [y @ b["out_proj"]["w"].to(u.dtype) for y, b, u in zip(normed, blk, us)]
    return outs, (new if mode != "forward" else None)
