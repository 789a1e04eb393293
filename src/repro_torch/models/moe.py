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
``lax.top_k`` does.

On an LM mesh (``launch.mesh.LMMesh``): ``moe_apply_mesh`` is
``moe_apply``'s semantics over the whole token set with the experts split
over `model` (the default dispatch), and ``moe_apply_ep`` the reference's
expert-parallel all-to-all dispatch with its per-shard capacities.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.distributed.sharding import axes_of, gather, shard
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


def experts(p: Params, xb: torch.Tensor) -> torch.Tensor:
    """The batched SwiGLU expert FFN over buffers ``xb`` [E', cap, D] with
    the stacks of ``p`` ([E', D, ff], [E', ff, D]), in ``xb``'s dtype."""
    up = torch.bmm(xb, p["w_up"].to(xb.dtype))
    gate = torch.bmm(xb, p["w_gate"].to(xb.dtype))
    return torch.bmm(silu(gate) * up, p["w_down"].to(xb.dtype))


def combine(r: Dispatch, yb: torch.Tensor, top_k: int, e_lo: int = 0) -> torch.Tensor:
    """y [N, D] (float32): each sorted copy reads its slot of ``yb``
    [E', cap, D], the buffers of experts ``e_lo ..`` (a copy dropped, or
    routed outside them, reads 0), unsorts, and the k copies of a token sum
    with the router's gates."""
    e_n, cap, d = yb.shape
    rel = r.flat_slot - e_lo * cap
    keep = r.in_cap & (rel >= 0) & (rel < e_n * cap)
    y_rows = yb.reshape(e_n * cap, d)[rel.clamp(0, e_n * cap - 1)] * keep[:, None].to(yb.dtype)
    y_nk = torch.empty_like(y_rows)
    y_nk[r.order] = y_rows                                         # unsort
    return torch.einsum("nkd,nk->nd", y_nk.reshape(-1, top_k, d).float(), r.gates)


def moe_apply(p: Params, x: torch.Tensor, *, top_k: int, n_experts: int,
              capacity_factor: float = 1.25,
              router_z_coef: float = 1e-3) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, T, D].  Returns (y [B, T, D], aux loss scalar: load balance +
    router z)."""
    b, t, d = x.shape
    xf = x.reshape(b * t, d)
    r = route(p["router"]["w"], xf, top_k=top_k, n_experts=n_experts,
              capacity_factor=capacity_factor, router_z_coef=router_z_coef)
    xb = xf[r.buf_tok] * r.slot_valid[..., None].to(xf.dtype)     # [E, cap, D]
    y = combine(r, experts(p, xb), top_k)
    return y.to(x.dtype).reshape(b, t, d), r.aux


# ---------------------------------------------------------------------------
# On an LM mesh (``launch.mesh.LMMesh``)
# ---------------------------------------------------------------------------

EXPERT_STACKS = ("w_gate", "w_up", "w_down")
EP_SPEC = ("model", None, None)     # expert stacks [E, ., .] split on E over `model`


def _split_on_model(spec) -> bool:
    return spec is not None and axes_of(spec) == ("model",)


def moe_apply_mesh(p: list, w_specs: dict, x: list, x_spec: tuple, mesh, *, top_k: int,
                   n_experts: int, capacity_factor: float = 1.25,
                   router_z_coef: float = 1e-3) -> tuple[list, torch.Tensor]:
    """``moe_apply`` (the default, gather dispatch) on a mesh, over the
    layer's whole token set as GSPMD computes it: the capacity comes from
    the global N and the drops are ``moe_apply``'s.

    ``x[j]`` is local shard j's block of the activations [B, T, D] under
    ``x_spec``; ``p[j]`` its MoE parameters: the router whole, each expert
    stack as ``w_specs[name]`` leaves it over `model` (data axes gathered):
    split on E (``EP_SPEC``), split on ff (tensor parallel inside the
    experts), or whole.  Every shard gathers the tokens and routes them
    all; each runs its own experts (or its ff block of every expert), and
    the combine (or the expert outputs, under ff) is summed over `model` in
    float32 and rounded once.  Returns (each shard's block of y, aux)."""
    xs = gather(mesh, x, x_spec)
    b, t, d = xs[0].shape
    ep = _split_on_model(w_specs["w_gate"][0])
    ff = _split_on_model(w_specs["w_gate"][2])
    routes, parts = {}, []
    for j, c in enumerate(mesh.local):
        xf = xs[j].reshape(b * t, d)
        if id(xs[j]) not in routes:
            routes[id(xs[j])] = route(p[j]["router"]["w"], xf, top_k=top_k, n_experts=n_experts,
                                      capacity_factor=capacity_factor,
                                      router_z_coef=router_z_coef)
        r = routes[id(xs[j])]
        if ep:
            e_loc = n_experts // mesh.model
            e_lo = c["model"] * e_loc
            sl = slice(e_lo, e_lo + e_loc)
            xb = xf[r.buf_tok[sl]] * r.slot_valid[sl, :, None].to(xf.dtype)
            parts.append(combine(r, experts(p[j], xb), top_k, e_lo))
            continue
        xb = xf[r.buf_tok] * r.slot_valid[..., None].to(xf.dtype)
        if ff:
            w = p[j]
            hidden = silu(torch.bmm(xb, w["w_gate"].to(xb.dtype))) * \
                torch.bmm(xb, w["w_up"].to(xb.dtype))
            parts.append(torch.bmm(hidden.float(), w["w_down"].float()))
        else:
            parts.append(combine(r, experts(p[j], xb), top_k))
    if ff:
        parts = [combine(routes[id(xs[j])], yb.to(xs[j].dtype), top_k)
                 for j, yb in enumerate(mesh.psum(parts, "model"))]
    elif ep:
        parts = mesh.psum(parts, "model")
    y = [part.to(xs[j].dtype).reshape(b, t, d) for j, part in enumerate(parts)]
    return ([shard(yj, x_spec, mesh.shape, c) for yj, c in zip(y, mesh.local)],
            next(iter(routes.values())).aux)


def moe_apply_ep(p: list, x: list, *, top_k: int, n_experts: int, mesh, x_spec: tuple,
                 capacity_factor: float = 1.25, router_z_coef: float = 1e-3,
                 w_specs: dict | None = None) -> tuple[list, torch.Tensor]:
    """Expert parallelism with an explicit all-to-all over `model`
    (counterpart of ``repro/models/moe.py::moe_apply_ep``).

    ``x[j]`` is local shard j's block [bl, tl, D] of the activations under
    ``x_spec``, ``p[j]`` its MoE parameters: the router whole and the
    expert stacks its block of E/model experts (``EP_SPEC``).  Each shard
    routes its own tokens: the k copies go, ``cap_send`` at most to each
    model shard, to the shard owning their expert (``routing.
    group_by_capacity``, then ``mesh.all_to_all``), are regrouped there by
    local expert, ``cap_e`` at most each, run through the expert FFN, and
    come home the same way to combine with the gates in float32.  The
    capacities are the reference's (from the local token count, rounded up
    to 8, at least 8), so tokens past them drop as the reference drops them,
    shard by shard: not ``moe_apply``'s drops.  The aux loss is the mean
    over every shard of the mesh.  With `model` 1, or E not a multiple of
    it, the default dispatch runs instead (``moe_apply_mesh`` over
    ``w_specs``).  Returns (each shard's y block, aux)."""
    from repro_torch.distributed.routing import group_by_capacity

    sm = mesh.model
    if sm == 1 or n_experts % sm != 0:
        return moe_apply_mesh(p, w_specs or {k: (None,) * 3 for k in EXPERT_STACKS}, x, x_spec,
                              mesh, top_k=top_k, n_experts=n_experts,
                              capacity_factor=capacity_factor, router_z_coef=router_z_coef)
    e_loc = n_experts // sm
    bl, tl, d = x[0].shape
    n_loc = bl * tl
    cap_send = -(-n_loc * top_k * int(capacity_factor * 4) // (4 * sm))
    cap_send = max(8, -(-cap_send // 8) * 8)
    cap_e = -(-n_loc * sm * top_k * int(capacity_factor * 4) // (4 * n_experts))
    cap_e = max(8, -(-cap_e // 8) * 8)

    m = n_loc * top_k
    local, me, ce, z = [], [], [], []
    for xl, pj in zip(x, p):
        xf = xl.reshape(n_loc, d)
        logits = xf.float() @ pj["router"]["w"]                   # [n, E]
        probs = torch.softmax(logits, dim=-1)
        gate_w, sel = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate_w, sel = gate_w[:, :top_k], sel[:, :top_k]
        gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
        eid = sel.reshape(m)
        counts = torch.zeros(n_experts, dtype=torch.int64, device=xf.device).index_add_(
            0, eid, torch.ones_like(eid))
        me.append(torch.mean(probs, dim=0))
        ce.append(counts.float() / n_loc)
        z.append(torch.mean(torch.logsumexp(logits, -1) ** 2))
        slot = torch.arange(m, device=xf.device)
        (s_x, s_eid, s_slot), s_ok = group_by_capacity(
            eid // e_loc, torch.ones(m, dtype=torch.bool, device=xf.device), sm, cap_send,
            [xf.repeat_interleave(top_k, 0), eid, slot])
        local.append((gate_w, s_x, s_eid, s_slot, s_ok))
    me, ce, z = mesh.pmean(me), mesh.pmean(ce), mesh.pmean(z)
    aux = n_experts * torch.sum(me[0] * (ce[0] / top_k)) + router_z_coef * z[0]

    r_x = mesh.all_to_all([s[1] for s in local])
    r_eid = mesh.all_to_all([s[2] for s in local])
    r_ok = mesh.all_to_all([s[4] for s in local])
    nr = sm * cap_send
    y_send = []
    for j, pj in enumerate(p):
        rx, reid, rok = r_x[j].reshape(nr, d), r_eid[j].reshape(nr), r_ok[j].reshape(nr)
        # regroup by LOCAL expert
        lex = torch.where(rok, reid % e_loc, e_loc)
        (b_x, b_src), b_ok = group_by_capacity(
            lex, rok, e_loc, cap_e, [rx, torch.arange(nr, device=rx.device)])
        b_x = torch.where(b_ok[..., None], b_x, 0.0)
        yb = experts(pj, b_x)                                      # [e_loc, cap_e, d]
        y_r = torch.zeros((nr, d), dtype=torch.float32, device=rx.device)
        y_r[b_src[b_ok]] = yb[b_ok].float()
        y_send.append(y_r.reshape(sm, cap_send, d))
    y_home = mesh.all_to_all(y_send)                               # my send layout
    out = []
    for (gate_w, _, _, s_slot, s_ok), yh, xl in zip(local, y_home, x):
        y_flat = torch.zeros((m, d), dtype=torch.float32, device=xl.device)
        y_flat[s_slot[s_ok]] = yh[s_ok]
        y = torch.einsum("nkd,nk->nd", y_flat.reshape(n_loc, top_k, d), gate_w)
        out.append(y.to(xl.dtype).reshape(bl, tl, d))
    return out, aux
