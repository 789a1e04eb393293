"""Distributed PiPNN index build (counterpart of ``repro/launch/build_index.py``):
the paper's technique as a bulk-synchronous program over S shards.

Two supersteps, each a per-shard body with explicit exchanges between its
stages:

  tile step (``make_tile_step``), per ``n_tile``-point tile:
    1. local sketches + level-0 leaders -> top-f0 bucket ids       [local]
    2. capacity-routed all_to_all: point replicas -> bucket owners  [A2A #1]
    3. level-1 leaders + top-f1 -> leaf grouping                    [local]
    4. batched leaf all-pairs product + top-k -> bidirected edges   [local]
    5. capacity-routed all_to_all: edges -> src owner               [A2A #2]
    6. HashPrune fold into the reservoir (Theorem 3.1's
       mergeability)                                                [local]

  final prune step (``make_final_prune_step``):
    7. request/response all_to_all for candidate vectors            [A2A #3, #4]
    8. RobustPrune over each reservoir                              [local]

Everything is static-shape: routing uses per-destination capacities with
slack (``distributed.routing.group_by_capacity``) and drops overflow.

**The mesh** (``launch.mesh.ShardMesh``) gives each of W ranks the
contiguous block of ``L = S / W`` shards ``mesh.local``; every step and
``build_distributed`` take a mesh or, as shorthand, ``n_shards`` (all S
shards in this process, ``launch.mesh.make_local_mesh``).  A rank runs
its shards' bodies one after another, holds its rows of the tile (rows
``[rank*L*n_loc, (rank+1)*L*n_loc)``) and of the reservoir, and meets the
other shards only in the mesh's ``all_gather``, ``all_to_all`` and
``psum``: list functions in one process, ``torch.distributed``
collectives (NCCL on the card, gloo on the CPU) across processes.  The
body's ``me`` argument is the reference's ``axis_index``.  Every rank
draws the same hyperplanes and level-0 leaders and gets the whole graph
back.

Kernel routes: level 0 and level 1 run ``core.leader_assign.leader_assign(
use_kernels=True)`` (the ``pairwise_distance`` and ``rowwise_topk`` kernels
on the card), with ``lax.top_k``'s pick restored where a row has fewer
than f finite entries (``_assign``); the leaf chunk's selection runs the
``rowwise_topk`` kernel on the negation of the reference's matrix, and the
quantized variant's int32 inner products come from the
``pairwise_distance_int8`` kernel; the fold is
``core.hashprune.merge_segmented_edges`` (the merge kernel) or
``merge_flat_edges``.  CPU tensors take every kernel's plain version.
On the card the segmented fold writes the input reservoir's tensors in
place, as ``merge_segmented_edges`` does.

Variants (``DistBuildParams``): ``route_dtype="int8"`` routes int8 vectors
with float32 scales (the repo's one symmetric scheme,
``kernels.gather_distance_int8.quantize_symmetric``) and forms the leaf
products in int8; ``leaf_dtype="bf16"`` rounds the leaf matrix to bfloat16
before the selection; ``merge="flat"`` folds by re-sorting.

``build_distributed`` streams the data tile by tile, each tile with a
fresh reservoir, as the reference does: tiles are never merged, so a build
of more than one tile is ``ceil(n / n_tile)`` disconnected graphs.

The reference's AOT lowering (``mesh_axes``, ``lower_build_step``,
``lower_final_prune_step``) belongs to XLA and has no counterpart here.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import sketch as _sketch
from repro_torch.core.hashprune import (INVALID_ID, Reservoir, merge_flat_edges,
                                        merge_segmented_edges, reservoir_init)
from repro_torch.core.leader_assign import leader_assign
from repro_torch.core.metrics import pairwise
from repro_torch.core.robust_prune import prune_reservoir_block
from repro_torch.distributed.routing import group_by_capacity
from repro_torch.kernels.distance import pairwise_distance_int8
from repro_torch.kernels.gather_distance_int8 import quantize_symmetric
from repro_torch.kernels.topk import rowwise_topk, stable_argsort
from repro_torch.launch.mesh import (ShardMesh, all_gather, all_to_all,  # noqa: F401
                                     make_local_mesh, psum)

INF = float("inf")


# ---------------------------------------------------------------------------
# Static configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DistBuildParams:
    dim: int = 128
    n_tile: int = 1 << 24        # points per superstep tile
    m_bits: int = 12
    l0: int = 1024               # level-0 leaders (global, paper cap 1000)
    f0: int = 10                 # top-level fanout      (paper Sec. 4.1)
    l1: int = 1152               # level-1 leaders per bucket (target leaf
    #                              fill ~55%: skewed leaves stay under c_max)
    f1: int = 3                  # second-level fanout   (paper: ~3)
    c_max: int = 1024            # leaf size cap
    k: int = 2                   # leaf k-NN (paper default, Fig. 11)
    l_max: int = 64              # HashPrune reservoir
    max_deg: int = 64
    alpha: float = 1.44          # RobustPrune alpha^2 (squared-l2 space)
    bucket_slack: float = 1.3
    leaf_slack: float = 1.0      # leaves already have c_max as the hard cap
    edge_slack: float = 1.3
    assign_chunk: int = 2048     # level-1 product chunk rows
    leaf_chunk: int = 8          # leaves per batched product
    prune_chunk: int = 2048
    route_dtype: str = "f32"     # "f32" | "int8" (quantized variant)
    leaf_dtype: str = "f32"      # "f32" | "bf16": dtype of the leaf matrix
    #                              (ranking-only use)
    merge: str = "segmented"     # reservoir fold: "segmented" sorts only the
    #                              received edges and merges per row;
    #                              "flat" re-sorts (the oracle)

    @classmethod
    def tiny(cls, **kw) -> "DistBuildParams":
        """CPU-test scale."""
        base = dict(dim=16, n_tile=2048, l0=16, f0=3, l1=32, f1=2,
                    c_max=128, k=2, l_max=32, max_deg=24,
                    assign_chunk=256, leaf_chunk=4, prune_chunk=256,
                    bucket_slack=2.0, edge_slack=2.0)
        base.update(kw)
        return cls(**base)

    def derived(self, n_shards: int) -> dict[str, int]:
        assert self.n_tile % n_shards == 0, (self.n_tile, n_shards)
        assert self.l0 % n_shards == 0, "l0 must divide over shards"
        n_loc = self.n_tile // n_shards
        nb_loc = self.l0 // n_shards
        # level-0 dispatch capacity per destination shard
        cap_send = _round_up(
            int(n_loc * self.f0 / n_shards * self.bucket_slack) + 1, 8)
        # per-bucket capacity (points landing in one level-0 bucket)
        cap_b = _round_up(
            int(self.n_tile * self.f0 / self.l0 * self.bucket_slack) + 1,
            self.assign_chunk)
        n_leaf = _round_up(nb_loc * self.l1, self.leaf_chunk)
        e_loc = nb_loc * cap_b  # leaf instances before fanout
        n_edges = n_leaf * self.c_max * self.k * 2
        cap_edge = _round_up(
            int(n_edges / n_shards * self.edge_slack) + 1, 8)
        cap_req = _round_up(
            int(n_loc * self.l_max / n_shards * self.edge_slack) + 1, 8)
        return dict(n_loc=n_loc, nb_loc=nb_loc, cap_send=cap_send,
                    cap_b=cap_b, n_leaf=n_leaf, n_edges=n_edges,
                    cap_edge=cap_edge, cap_req=cap_req, e_loc=e_loc)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _as_mesh(mesh: ShardMesh | int) -> ShardMesh:
    """A mesh, or ``n_shards`` as all of them in this process."""
    return mesh if isinstance(mesh, ShardMesh) else ShardMesh(int(mesh))


# ---------------------------------------------------------------------------
# Tile superstep
# ---------------------------------------------------------------------------

def _route_pack(v: torch.Tensor, p: DistBuildParams):
    if p.route_dtype == "int8":
        return quantize_symmetric(v)
    return v, None


def _route_unpack(v: torch.Tensor, scale, p: DistBuildParams) -> torch.Tensor:
    if p.route_dtype == "int8":
        return v.to(torch.float32) * scale[..., None]
    return v


def _leaf_pair_dists_neg(vecs: torch.Tensor, p: DistBuildParams) -> torch.Tensor:
    """NEGATED all-pairs squared L2 for a [B, C, d] leaf batch,
    ``min(2<a,b> - |a|^2 - |b|^2, 0)``, in the reference's operation
    order; ``leaf_dtype="bf16"`` rounds it to bfloat16.

    The quantized variant takes the int32 inner products of the int8 rows
    from the ``pairwise_distance_int8`` kernel's exact squared distances,
    ``<a,b> = (|a|^2 + |b|^2 - d) / 2`` in int32, and rescales them as the
    reference does."""
    if p.route_dtype == "int8":
        q, scale = quantize_symmetric(vecs)
        q32 = q.to(torch.int32)
        n8 = torch.sum(q32 * q32, dim=-1, dtype=torch.int32)
        d8 = pairwise_distance_int8(q.contiguous(), q.contiguous())
        ip = torch.div(n8[:, :, None] + n8[:, None, :] - d8, 2, rounding_mode="floor")
        ip = ip.to(torch.float32) * scale[:, :, None] * scale[:, None, :]
    else:
        ip = vecs @ vecs.transpose(1, 2)
    v = vecs.to(torch.float32)
    n2 = torch.sum(v * v, dim=-1)
    neg = 2.0 * ip - n2[:, :, None] - n2[:, None, :]
    neg = torch.where(neg < 0, neg, torch.zeros((), device=neg.device))
    if p.leaf_dtype == "bf16":
        neg = neg.to(torch.bfloat16)
    return neg


def _assign(points: torch.Tensor, leaders: torch.Tensor, f: int, *,
            point_valid: torch.Tensor | None = None,
            leader_valid: torch.Tensor | None = None) -> torch.Tensor:
    """``leader_assign`` on the kernel route, with ``lax.top_k``'s pick
    where a row has fewer than ``f`` finite entries.

    The kernel route gives -1 in those slots; the reference's top-k takes
    the lowest-indexed masked leaders, ascending, after the finite ones.
    A valid point's masked leaders are the invalid leaders; an invalid
    point's row is all masked, so it takes leaders 0..f-1."""
    ids = leader_assign(points, leaders, f, point_valid=point_valid,
                        leader_valid=leader_valid, use_kernels=True)
    dev = ids.device
    if leader_valid is None:
        leader_valid = torch.ones(leaders.shape[:-1], dtype=torch.bool, device=dev)
    # the invalid leaders first, ascending, then the valid ones
    masked_order = stable_argsort(leader_valid.to(torch.int8))[..., :f]
    miss = ids < 0
    j = torch.arange(f, dtype=torch.int64, device=dev)
    pos = (j - (~miss).sum(-1, keepdim=True)).clamp_min(0)
    fill = torch.gather(masked_order.unsqueeze(-2).expand(ids.shape), -1, pos).to(ids.dtype)
    if point_valid is not None:
        fill = torch.where(point_valid[..., None], fill, j.to(ids.dtype))
    return torch.where(miss, fill, ids)


def _dispatch(me: int, points, sk, leaders0, p: DistBuildParams, dv: dict, S: int):
    """Stages 1-2 of shard ``me``: level-0 buckets and the point replicas
    grouped by the bucket's owner.  Returns (payloads [S, cap_send, ...],
    valid [S, cap_send], dispatch drops)."""
    n_loc = dv["n_loc"]
    gid0 = me * n_loc + torch.arange(n_loc, dtype=torch.int32, device=points.device)
    bucket = _assign(points, leaders0, p.f0)                  # [n_loc, f0]
    flat_bucket = bucket.reshape(-1)
    owner = flat_bucket % S
    rep = lambda a: a.repeat_interleave(p.f0, dim=0)
    vec_r, scale_r = _route_pack(rep(points), p)
    pay = [vec_r, rep(sk), rep(gid0), flat_bucket]
    if scale_r is not None:
        pay.append(scale_r)
    sent, sent_valid = group_by_capacity(
        owner, torch.ones_like(owner, dtype=torch.bool), S, dv["cap_send"], pay)
    drop = n_loc * p.f0 - sent_valid.sum(dtype=torch.int32)
    return sent, sent_valid, drop


def _leaf_chunk_edges(vec, skc, gidc, val, p: DistBuildParams):
    """Bidirected k-NN edges of a [ch, C] leaf chunk, flat (src, dst, hash,
    dist) with -1 / 0 / +inf where an edge is not valid."""
    c = p.c_max
    nd_mat = _leaf_pair_dists_neg(vec, p)                    # [ch, C, C] (-d2)
    eye = torch.eye(c, dtype=torch.bool, device=vec.device)
    bad = (~val[:, None, :]) | (~val[:, :, None]) | eye
    # duplicate gids (same point via two buckets) -> mask; the diagonal is
    # masked already
    dup = gidc[:, :, None] == gidc[:, None, :]
    # lax.top_k's k largest of the masked -d2 are the k smallest of its
    # negation, ties to the lower column in both; the negation is exact
    d = -nd_mat.to(torch.float32)
    d.masked_fill_(bad | dup, INF)
    ni, nv = rowwise_topk(d, p.k)                             # [ch, C, k]
    del d, nd_mat, bad, dup
    nd = torch.where(ni >= 0, nv, INF)
    # the kernel's -1 (a masked slot) would wrap as an index: clamp; the
    # edge is masked by isfinite(nd) either way
    nic = ni.clamp_min(0).long()
    ch = nic.shape[0]
    src = gidc[:, :, None].expand(ni.shape)
    dst = torch.gather(gidc, 1, nic.reshape(ch, -1)).reshape(ni.shape)
    sks = skc[:, :, None, :].expand(ni.shape + (p.m_bits,))
    skd = skc[torch.arange(ch, device=vec.device)[:, None, None], nic]   # [ch, C, k, m]
    ok = torch.isfinite(nd) & (dst != INVALID_ID) & (src != INVALID_ID)
    # out-edge src->dst hashed h_src(dst); in-edge dst->src h_dst(src)
    h_out = _sketch.hash_from_sketches(skd, sks)
    h_in = _sketch.hash_from_sketches(sks, skd)
    e_ok = torch.stack([ok, ok], -1)
    inv = torch.full((), INVALID_ID, dtype=torch.int32, device=vec.device)
    return (torch.where(e_ok, torch.stack([src, dst], -1), inv).reshape(-1),
            torch.where(e_ok, torch.stack([dst, src], -1), inv).reshape(-1),
            torch.where(e_ok, torch.stack([h_out, h_in], -1), 0).reshape(-1),
            torch.where(e_ok, torch.stack([nd, nd], -1), INF).reshape(-1))


def _leaf_edges(me: int, recv, recv_valid, p: DistBuildParams, dv: dict, S: int):
    """Stages 3-5 of shard ``me``: regroup the received replicas into its
    buckets, assign level-1 leaders, group into leaves, form the leaves'
    k-NN edges and group them by their source's owner.  Returns (edge
    payloads [S, cap_edge], valid [S, cap_edge])."""
    nb_loc, cap_b = dv["nb_loc"], dv["cap_b"]
    dev = recv_valid.device
    if p.route_dtype == "int8":
        r_vec, r_sk, r_gid, r_bucket, r_scale = recv
    else:
        (r_vec, r_sk, r_gid, r_bucket), r_scale = recv, None

    # regroup into my local buckets: bucket b lives at slot b // S
    bslot = torch.where(recv_valid, torch.div(r_bucket, S, rounding_mode="floor"), nb_loc)
    pay2 = [r_vec, r_sk, r_gid] + ([r_scale] if r_scale is not None else [])
    grouped, g_valid = group_by_capacity(bslot, recv_valid, nb_loc, cap_b, pay2)
    del pay2, recv
    b_vec, b_sk, b_gid = grouped[:3]
    b_vecf = _route_unpack(b_vec, grouped[3] if r_scale is not None else None, p)
    b_vecf = torch.where(g_valid[..., None], b_vecf, torch.zeros((), device=dev))
    del grouped, b_vec

    # level-1 leaders + leaf assignment
    l1_stride = max(cap_b // p.l1, 1)
    lead1 = b_vecf[:, ::l1_stride][:, : p.l1]                 # [nb, l1, d]
    lead1_ok = g_valid[:, ::l1_stride][:, : p.l1]             # [nb, l1]
    ac = p.assign_chunk
    leader1 = torch.cat([
        _assign(b_vecf[:, s:s + ac], lead1, p.f1, point_valid=g_valid[:, s:s + ac],
                leader_valid=lead1_ok)
        for s in range(0, cap_b, ac)], dim=1)                 # [nb, cap_b, f1]

    # leaf key = bucket_slot * l1 + leader1 ; group to [n_leaf, c_max]
    binst = nb_loc * cap_b
    slot = torch.arange(nb_loc, dtype=torch.int32, device=dev)[:, None, None]
    leaf_key = (slot * p.l1 + leader1).reshape(-1)
    inst_valid = g_valid.reshape(-1).repeat_interleave(p.f1)
    rep1 = lambda a: a.reshape((binst,) + a.shape[2:]).repeat_interleave(p.f1, dim=0)
    pay3 = [rep1(b_vecf), rep1(b_sk), rep1(b_gid)]
    del b_vecf, b_sk
    (lf_vec, lf_sk, lf_gid), lf_valid = group_by_capacity(
        leaf_key, inst_valid, dv["n_leaf"], p.c_max, pay3, shuffle=True)
    del pay3

    # leaf all-pairs products + bidirected k-NN edges, leaf_chunk leaves at a time
    lc = p.leaf_chunk
    parts = [_leaf_chunk_edges(lf_vec[s:s + lc], lf_sk[s:s + lc], lf_gid[s:s + lc],
                               lf_valid[s:s + lc], p)
             for s in range(0, dv["n_leaf"], lc)]
    del lf_vec, lf_sk
    e_src, e_dst, e_h, e_d = (torch.cat([pt[i] for pt in parts]) for i in range(4))
    del parts

    # route edges home
    e_owner = torch.where(e_src >= 0, torch.div(e_src, dv["n_loc"], rounding_mode="floor"), S)
    return group_by_capacity(e_owner, e_src >= 0, S, dv["cap_edge"], [e_src, e_dst, e_h, e_d])


def _fold(me: int, res: Reservoir, r_edges, r_ok, p: DistBuildParams, dv: dict):
    """Stage 6 of shard ``me``: fold the received edges into its reservoir."""
    n_loc = dv["n_loc"]
    m_src, m_dst, m_h, m_d = (x.reshape((-1,) + x.shape[2:]) for x in r_edges)
    lsrc = torch.where(r_ok, m_src - me * n_loc, n_loc)
    fold = merge_flat_edges if p.merge == "flat" else merge_segmented_edges
    return fold(res.ids, res.hashes, res.dists,
                lsrc, torch.where(r_ok, m_dst, INVALID_ID), m_h,
                torch.where(r_ok, m_d, INF))


def make_tile_step(mesh: ShardMesh | int, p: DistBuildParams):
    """Returns ``tile_step(points, hyperplanes, reservoir) -> (reservoir,
    stats)`` on ``mesh`` (or ``n_shards`` in this process).

    ``points`` and the reservoir ([rows, l_max] each) are this rank's row
    block of the tile, ``L * n_loc`` rows (the whole [n_tile, ...] tile in
    one process), cut into one block a local shard; ``hyperplanes`` [m, d]
    are every shard's.  Returns this rank's reservoir rows and ``stats``,
    int32 [edges received, replicas received, dispatch drops] summed over
    all S shards.  Every tensor stays on ``points``' device."""
    mesh = _as_mesh(mesh)
    S, local = mesh.n_shards, mesh.local
    dv = p.derived(S)
    n_loc, nb_loc = dv["n_loc"], dv["nb_loc"]
    lead_stride = n_loc // nb_loc

    def tile_step(points, hyperplanes, res: Reservoir):
        pts = points.to(torch.float32)
        hp = (hyperplanes if isinstance(hyperplanes, torch.Tensor)
              else torch.tensor(np.asarray(hyperplanes))).to(pts.device, torch.float32)
        rows = [slice(j * n_loc, (j + 1) * n_loc) for j in range(len(local))]
        xs = [pts[r] for r in rows]
        sks = [_sketch.sketch(x, hp) for x in xs]                        # [n_loc, m]
        leaders0 = mesh.all_gather([x[::lead_stride][:nb_loc] for x in xs])   # [l0, d]

        sent = [_dispatch(me, x, sk, leaders0, p, dv, S) for me, x, sk in zip(local, xs, sks)]
        del sks
        drops = [s[2] for s in sent]
        recv = mesh.exchange([s[0] for s in sent])
        recv_valid = mesh.all_to_all([s[1] for s in sent])
        del sent
        recv = [[x.reshape((-1,) + x.shape[2:]) for x in r] for r in recv]
        recv_valid = [v.reshape(-1) for v in recv_valid]
        n_replicas = [v.sum(dtype=torch.int32) for v in recv_valid]

        routed = []
        for j, me in enumerate(local):
            routed.append(_leaf_edges(me, recv[j], recv_valid[j], p, dv, S))
            recv[j] = None
        r_edges = mesh.exchange([r[0] for r in routed])
        r_ok = mesh.all_to_all([r[1] for r in routed])
        del routed

        merged, n_edges = [], []
        for j, me in enumerate(local):
            ok = r_ok[j].reshape(-1)
            merged.append(_fold(me, Reservoir(res.ids[rows[j]], res.hashes[rows[j]],
                                              res.dists[rows[j]]), r_edges[j], ok, p, dv))
            n_edges.append(ok.sum(dtype=torch.int32))
            r_edges[j] = None
        stats = mesh.psum([torch.stack([e, r, d.to(torch.int32)])
                           for e, r, d in zip(n_edges, n_replicas, drops)])
        return Reservoir(*(torch.cat([m[i] for m in merged]) for i in range(3))), stats

    return tile_step


# ---------------------------------------------------------------------------
# Final prune superstep (request/response vector exchange + RobustPrune)
# ---------------------------------------------------------------------------

def make_final_prune_step(mesh: ShardMesh | int, p: DistBuildParams):
    """Returns ``final_prune_step(points, res_ids, res_dists) -> (graph,
    dists)`` on ``mesh`` (or ``n_shards`` in this process): this rank's
    row block of the tile and its reservoir in, as the tile step takes
    them, on tile-local ids; its [rows, max_deg] rows of the graph out."""
    mesh = _as_mesh(mesh)
    S, local = mesh.n_shards, mesh.local
    dv = p.derived(S)
    n_loc = dv["n_loc"]

    def final_prune_step(points, res_ids, res_dists):
        pts = points.to(torch.float32)
        dev = pts.device
        rows = [slice(j * n_loc, (j + 1) * n_loc) for j in range(len(local))]
        # requests: each reservoir slot's candidate id, grouped by its owner
        reqs = []
        for j in range(len(local)):
            flat_ids = res_ids[rows[j]].reshape(-1)           # [n_loc*l_max]
            valid = flat_ids != INVALID_ID
            owner = torch.where(valid, torch.div(flat_ids, n_loc, rounding_mode="floor"), S)
            slot = torch.arange(n_loc * p.l_max, dtype=torch.int32, device=dev)
            reqs.append(group_by_capacity(owner, valid, S, dv["cap_req"], [flat_ids, slot]))
        r_cand = mesh.all_to_all([r[0][0] for r in reqs])     # [S, capR]
        r_ok = mesh.all_to_all([r[1] for r in reqs])
        # responses: the owner's vectors for each request it received
        resp = []
        for j, me in enumerate(local):
            lidx = (r_cand[j] - me * n_loc).clamp(0, n_loc - 1).long()
            r_vecs = pts[rows[j]][lidx]                       # [S, capR, d]
            resp.append(torch.where(r_ok[j][..., None], r_vecs, torch.zeros((), device=dev)))
        del r_cand, r_ok
        # slice s of a receiver's buffer answers its own requests to owner s
        b_vecs = mesh.all_to_all(resp)
        del resp

        g_out, d_out = [], []
        for j in range(len(local)):
            (_, s_slot), s_ok = reqs[j]
            gat = torch.zeros((n_loc * p.l_max, p.dim), dtype=torch.float32, device=dev)
            gat[s_slot[s_ok].long()] = b_vecs[j][s_ok]
            b_vecs[j] = None
            cand_vecs = gat.reshape(n_loc, p.l_max, p.dim)
            ids, dists = res_ids[rows[j]], res_dists[rows[j]]
            for s in range(0, n_loc, p.prune_chunk):
                vecs = cand_vecs[s:s + p.prune_chunk]
                # d_cc from the routed vectors; the shared prune block keeps,
                # compacts and truncates
                gid, gd = prune_reservoir_block(
                    ids[s:s + p.prune_chunk], dists[s:s + p.prune_chunk],
                    pairwise(vecs, vecs, "l2"), alpha=p.alpha, max_deg=p.max_deg)
                g_out.append(gid)
                d_out.append(gd)
        return torch.cat(g_out), torch.cat(d_out)

    return final_prune_step


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def production_params(dim: int, variant: str = "baseline") -> DistBuildParams:
    if variant == "quantized":
        return DistBuildParams(dim=dim, route_dtype="int8")
    if variant == "opt":          # the full beyond-paper stack
        return DistBuildParams(dim=dim, route_dtype="int8", leaf_dtype="bf16")
    if variant == "bf16leaf":
        return DistBuildParams(dim=dim, leaf_dtype="bf16")
    return DistBuildParams(dim=dim)


def useful_flops(n_points: int, dim: int, p: DistBuildParams | None = None) -> float:
    """Algorithmically required MACs*2 for ONE tile step: level-0 product +
    level-1 product + leaf all-pairs + sketch."""
    p = p or production_params(dim)
    n = p.n_tile
    per_point = (p.l0 + p.f0 * p.l1 + p.f0 * p.f1 * p.c_max + p.m_bits)
    return 2.0 * n * per_point * p.dim


def build_distributed(x: np.ndarray, mesh: ShardMesh | int, p: DistBuildParams, *,
                      seed: int = 0, final_prune: bool = True, hyperplanes=None, device=None):
    """Runnable distributed build over ``mesh``, or over ``n_shards``
    shards in this process on ``device`` (default: the card, raising
    without one).  On a mesh the tensors live on ``mesh.device`` and
    ``device`` must be None; every rank passes the same ``x`` and
    arguments and gets the same result.

    Streams ``x`` tile by tile through the tile step, each tile from a
    fresh reservoir (tiles are not merged), then runs the final-prune
    step on it; each rank moves only its row block of a tile to its
    device, and one ``all_gather`` a tile assembles the graph.  The
    hyperplanes are ``hyperplanes`` ([m_bits, dim]) or
    ``sketch.make_hyperplanes(seed, ...)``.  Returns numpy (graph [n,
    max_deg] int32 with -1 padding, dists [n, max_deg] float32 with +inf
    padding)."""
    if isinstance(mesh, ShardMesh):
        if device is not None:
            raise ValueError("build_distributed on a mesh runs on mesh.device; "
                             f"device={device!r} is not taken")
        dev = mesh.device
    else:
        mesh = make_local_mesh(mesh, device)
        dev = mesh.device
    n, d = x.shape
    assert d == p.dim
    block = p.n_tile // mesh.world                 # this rank's rows of a tile
    pad_n = _round_up(n, p.n_tile)
    if pad_n != n:
        filler = x[np.random.default_rng(seed).integers(0, n, pad_n - n)]
        x = np.concatenate([x, filler + 1e3], 0)  # far-away pad points
    if hyperplanes is None:
        hyperplanes = _sketch.make_hyperplanes(seed, p.m_bits, p.dim)
    hp = torch.tensor(np.asarray(hyperplanes), dtype=torch.float32, device=dev)
    tile_step = make_tile_step(mesh, p)
    fp_step = make_final_prune_step(mesh, p)
    graph_parts, dist_parts = [], []
    for t0 in range(0, pad_n, p.n_tile):
        r0 = t0 + mesh.rank * block
        tile = torch.tensor(np.asarray(x[r0: r0 + block]), device=dev)
        res_t, _ = tile_step(tile, hp, reservoir_init(block, p.l_max, device=dev))
        if final_prune:
            # the final prune routes vectors by tile-local ids
            gid, gd = fp_step(tile, res_t.ids, res_t.dists)
        else:
            gid, gd = res_t.ids[:, : p.max_deg], res_t.dists[:, : p.max_deg]
        del res_t, tile
        gid, gd = mesh.all_gather([gid]), mesh.all_gather([gd])
        gid = torch.where(gid >= 0, gid + t0, gid)
        graph_parts.append(gid.cpu().numpy())
        dist_parts.append(gd.cpu().numpy())
        del gid, gd
    graph = np.concatenate(graph_parts)[:n]
    dists = np.concatenate(dist_parts)[:n]
    # drop edges pointing at pad points
    bad = graph >= n
    graph = np.where(bad, -1, graph)
    dists = np.where(bad, np.inf, dists)
    return graph, dists
