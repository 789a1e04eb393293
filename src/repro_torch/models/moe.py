"""Mixture-of-Experts layer of granite-moe and grok-1 (counterpart of
``repro/models/moe.py::moe_apply``).

Top-k routing with the reference's sort-based, gather-only dispatch:

  1. replicate each token k times, tag each copy with its routed expert;
  2. sort the M = N*k copies by expert (stable, so an expert's copies stay
     in token order);
  3. expert buffers [E, cap, d] are gathers from the sorted copies (slot
     (e, c) <- sorted copy offsets[e] + c, zero past the expert's count);
  4. one batched SwiGLU FFN over the stacked buffers;
  5. each sorted copy reads its output back from its slot (a copy past its
     expert's capacity reads 0: it is dropped), unsorts, and the k copies
     combine with the router's gates in float32.

cap = max(8, min(ceil(N * k * capacity_factor / E), M)).  The router runs
in float32, and the top-k breaks ties toward the lower expert, as
``lax.top_k`` does.  The reference's expert-parallel variant
(``moe_apply_ep``: ``shard_map`` and an all-to-all over cards) is queued
with the tensor-parallel slice (ROADMAP.md section 1).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.layers import Params, dense_init, normal, silu


def moe_init(d: int, d_ff: int, n_experts: int, generator: torch.Generator, device, *,
             dtype=torch.float32) -> Params:
    return {
        "router": dense_init(d, n_experts, generator, device, dtype=torch.float32),
        "w_gate": normal((n_experts, d, d_ff), d ** -0.5, dtype, generator, device),
        "w_up": normal((n_experts, d, d_ff), d ** -0.5, dtype, generator, device),
        "w_down": normal((n_experts, d_ff, d), d_ff ** -0.5, dtype, generator, device),
    }


class Dispatch(NamedTuple):
    """The routing of N tokens' k copies to E experts of ``cap`` slots."""
    gates: torch.Tensor      # [N, k] float32 router weights, renormalized
    experts: torch.Tensor    # [N, k] int64 expert of each copy
    order: torch.Tensor      # [M] copy index (token * k + j) of each sorted copy
    counts: torch.Tensor     # [E] copies routed to each expert
    buf_tok: torch.Tensor    # [E, cap] token read into each slot
    slot_valid: torch.Tensor  # [E, cap] slot holds a routed copy
    in_cap: torch.Tensor     # [M] sorted copy fits its expert's capacity
    flat_slot: torch.Tensor  # [M] slot (e * cap + c) each sorted copy reads back
    cap: int
    aux: torch.Tensor        # scalar: load-balance + router-z loss


def route(router_w: torch.Tensor, xf: torch.Tensor, *, top_k: int, n_experts: int,
          capacity_factor: float = 1.25, router_z_coef: float = 1e-3) -> Dispatch:
    """The dispatch of the rows of ``xf`` [N, D] (router weight [D, E])."""
    n, e = xf.shape[0], n_experts
    dev = xf.device
    logits = xf.float() @ router_w                                 # [N, E]
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort keeps equal probabilities in expert order
    gate_w, sel = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, sel = gate_w[:, :top_k], sel[:, :top_k]
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)

    m = n * top_k
    eid = sel.reshape(m)
    # copies routed to each expert; a scatter, where bincount and one_hot
    # would read their input's range back to the host
    counts = torch.zeros(e, dtype=torch.int64, device=dev).index_add_(
        0, eid, torch.ones_like(eid))

    # aux losses (Switch-style load balance + router z); the reference's
    # mean over tokens of one_hot(sel).sum(1) is counts / N
    me = torch.mean(probs, dim=0)
    ce_frac = counts.float() / n / top_k
    aux = e * torch.sum(me * ce_frac)
    aux = aux + router_z_coef * torch.mean(torch.logsumexp(logits, -1) ** 2)

    cap = max(8, min(int(-(-(n * top_k * capacity_factor) // e)), m))   # ceil
    tok = torch.arange(m, device=dev) // top_k
    order = torch.sort(eid, stable=True).indices
    s_eid, s_tok = eid[order], tok[order]
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(m, device=dev) - offsets[s_eid]            # rank in its expert
    slots = torch.arange(cap, device=dev)
    slot_rows = torch.clamp(offsets[:, None] + slots[None, :], 0, m - 1)
    slot_valid = slots[None, :] < torch.clamp(counts, max=cap)[:, None]
    flat_slot = torch.clamp(s_eid * cap + pos, 0, e * cap - 1)
    return Dispatch(gates=gate_w, experts=sel, order=order, counts=counts,
                    buf_tok=s_tok[slot_rows], slot_valid=slot_valid, in_cap=pos < cap,
                    flat_slot=flat_slot, cap=cap, aux=aux)


def moe_apply(p: Params, x: torch.Tensor, *, top_k: int, n_experts: int,
              capacity_factor: float = 1.25,
              router_z_coef: float = 1e-3) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, T, D].  Returns (y [B, T, D], aux loss scalar: load balance +
    router z)."""
    b, t, d = x.shape
    n, e = b * t, n_experts
    xf = x.reshape(n, d)
    r = route(p["router"]["w"], xf, top_k=top_k, n_experts=n_experts,
              capacity_factor=capacity_factor, router_z_coef=router_z_coef)
    xb = xf[r.buf_tok] * r.slot_valid[..., None].to(xf.dtype)     # [E, cap, D]

    # batched expert FFN (SwiGLU)
    up = torch.bmm(xb, p["w_up"].to(xb.dtype))
    gate = torch.bmm(xb, p["w_gate"].to(xb.dtype))
    yb = torch.bmm(silu(gate) * up, p["w_down"].to(xb.dtype))     # [E, cap, D]

    # combine: each sorted copy reads back its slot (dropped copies read 0)
    y_rows = yb.reshape(e * r.cap, d)[r.flat_slot] * r.in_cap[:, None].to(yb.dtype)
    y_nk = torch.empty_like(y_rows)
    y_nk[r.order] = y_rows                                         # unsort
    y = torch.einsum("nkd,nk->nd", y_nk.reshape(n, top_k, d).float(), r.gates)
    return y.to(x.dtype).reshape(b, t, d), r.aux
