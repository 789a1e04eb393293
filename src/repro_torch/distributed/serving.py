"""Sharded serving: the index cut into partition-aligned shards, searched
shard by shard and merged (counterpart of ``repro/distributed/serving.py``).

  * **Partition-aligned shards with a 1-hop halo.**  ``S`` leaders are a
    seeded sample of the dataset; every point joins the shard of its
    nearest leader (``core.leader_assign``), so ownership is a disjoint
    partition.  Each shard also carries as ghost rows the out-of-shard
    endpoints of its members' edges, so no edge is dropped: member rows
    keep their whole neighbour lists under local renumbering, ghost rows
    keep whichever of their edges land in the shard.  Each shard has its
    own entry point (the owned member nearest the global entry) and a
    ``gids`` map back to global ids; shards pad to the largest row count
    ``m``, so a rank's packing is stacked ``[L, m, ...]`` tensors.
  * **The mesh** (``launch.mesh.ShardMesh``).  The reference puts one
    shard on each device of a jax mesh.  Here each of W ranks holds the
    ``L = S / W`` shards ``mesh.local`` on its device (``n_shards=S``
    alone: all S in this process, W = 1).  Every rank computes the same
    ownership and halo on the host and packs only its own shards; a
    search runs the unchanged multi-expansion engine
    (``beam_search._beam_search_multi``) over each local shard's
    ``[m, ...]`` slice in turn, so the gather kernel is launched once a
    step for every local shard that serves queries.  A shard searches
    only the queries routed to it; the merged result is the reference's,
    which searches every shard and masks the rest out.  Across ranks,
    every rank gathers the [L, Q, beam] blocks and the telemetry of all
    shards (``mesh.all_gather``) and merges them itself, so ids and
    telemetry are the same on every rank.  The SPMD contract: every rank
    calls ``search``, ``mark_shard_down`` / ``mark_shard_up`` and
    ``probe_shard`` alike, with the same arguments (the serving loop keeps
    it by sending rank 0's calls to the other ranks,
    ``launch.serve_loop.serve_follower``).
  * **Routing.**  ``router="all"`` sends every query to every healthy
    shard (the recall-parity configuration); ``router="leaders"`` to its
    ``n_probes`` nearest healthy leaders.
  * **Cross-shard top-k.**  A ghost row reaching two shards' beams carries
    bit-identical distances in both (same row, same query, and a gather
    whose sum order does not depend on the row's slot), which is the
    dedup contract of ``beam_search.merge_block``: ``cross_shard_topk``
    folds the shards' beams into one [Q, k] block with it.
  * **Health.**  ``mark_shard_down`` tombstones a shard (masked out of
    every merge, never probed by the leaders router); ``probe_shard``
    re-admits it when a probe search succeeds.  The mask is host state
    that every rank holds whole.  With every shard down a search raises
    ``AllShardsDown`` on every rank, before any collective; a tombstoned
    or unrouted local shard still takes part in the gather, with (-1,
    +inf) entries.

``ServingIndex.from_graph(..., n_shards= | mesh=)``, ``pipnn.search(n_shards=
| mesh=)`` and ``launch.serve.Retriever(n_shards= | mesh=)`` route here.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import beam_search as _bs
from repro_torch.core.leader_assign import leader_assign
from repro_torch.core.metrics import point_norms
from repro_torch.core.serving import _is_int8, serve_chunks
from repro_torch.core.transfers import to_device
from repro_torch.kernels.gather_distance_int8 import quantize_symmetric
from repro_torch.launch.mesh import ShardMesh, make_local_mesh

ROUTERS = ("all", "leaders")


class AllShardsDown(RuntimeError):
    """Every shard is marked unhealthy: no result could be served.

    The serving loop treats this as fail-stop rather than returning an all
    ``-1`` result that looks like an empty index."""


def _dist_to_point(x: np.ndarray, p: np.ndarray, metric: str) -> np.ndarray:
    """Host-side dissimilarity of every row of ``x`` to the point ``p``
    (entry-point selection)."""
    ip = x @ p
    if metric == "mips":
        return -ip
    if metric == "cosine":
        return 1.0 - ip / np.maximum(np.linalg.norm(x, axis=1) * np.linalg.norm(p), 1e-30)
    return np.sum(x * x, axis=1) + p @ p - 2.0 * ip


def cross_shard_topk(ids_s: torch.Tensor, ds_s: torch.Tensor, *, k: int):
    """Merge per-shard result blocks into the global top-k.

    ``ids_s`` [S, Q, B] global ids (-1 = pad or masked), ``ds_s`` [S, Q, B]
    float32 (+inf at pads) -> (ids [Q, k] int32, dists [Q, k]) ascending by
    (dist, id), padded with (-1, +inf) when the union holds fewer than
    ``k`` valid entries.  A fold of ``beam_search.merge_block`` over shards
    0..S-1 in order, as the reference's scan; ``k`` may exceed B."""
    _, nq, _ = ids_s.shape
    dev = ids_s.device
    ids = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    ds = torch.full((nq, k), float("inf"), dtype=torch.float32, device=dev)
    vis = torch.zeros((nq, k), dtype=torch.bool, device=dev)
    for bids, bds in zip(ids_s, ds_s):
        ids, ds, vis = _bs.merge_block(ids, ds, vis, bids.to(torch.int32),
                                       bds.to(torch.float32))
    return ids, ds


def cross_shard_topk_workspace_bytes(n_shards: int, nq: int, b: int, k: int) -> int:
    """Modeled device temp bytes of one ``cross_shard_topk``, per query:
    one ``merge_block`` of a shard's B entries into the [k] carry
    (``core.serving.merge_block_workspace_bytes``) and the carry, old and
    new (ids, dists, visited: 9 B a slot, each).  The fold merges one shard
    at a time, so ``n_shards`` appears only in the stacked input blocks,
    which are arguments."""
    from repro_torch.core.serving import merge_block_workspace_bytes

    return nq * (merge_block_workspace_bytes(b, k) + 2 * 9 * (k + 1))


def _host(a, dtype) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(a, dtype=dtype)


@dataclasses.dataclass
class ShardedServingIndex:
    """A PiPNN index packed as ``S`` partition-aligned shards, this rank's
    ``L`` of them (``mesh.local``; all S in one process) on its device.

    Every shard tensor is stacked on a leading shard axis ``[L, ...]``;
    ``-1`` pads the gids and the local graph ids.  The leaders, the owned
    and live row counts and the health mask cover all S shards.  Not
    frozen and without ``__slots__``: ``testing.faults.inject_faults``
    patches ``search`` on the instance."""

    gids: torch.Tensor         # [L, m] int32 global ids, -1 pad
    graph: torch.Tensor        # [L, m, R] int32 local neighbour ids, -1 pad
    points: torch.Tensor       # [L, m, d] float32, downcast, or int8
    norms: torch.Tensor        # [L, m] float32 point norms (before any downcast)
    starts: torch.Tensor       # [L] int32 per-shard local entry point
    leaders: torch.Tensor      # [S, d] float32 shard leader vectors (router)
    metric: str = "l2"
    scales: torch.Tensor | None = None   # [L, m] float32 scales (int8), 1.0 at pads
    router: str = "all"
    n_probes: int = 2
    n_points: int = 0          # dataset size (each point owned by one shard)
    owned: np.ndarray | None = None    # [S] owned (member) row counts
    live: np.ndarray | None = None     # [S] live (member + ghost) row counts
    health: np.ndarray | None = None   # [S] bool shard health mask (None = all)
    # the shards' mesh; None: all of them here (a one-process mesh)
    mesh: ShardMesh | None = dataclasses.field(default=None, repr=False, compare=False)
    # host copy of ``starts``, recorded by from_graph, so a search reads no
    # entry point back from the device
    start_ids: tuple[int, ...] | None = dataclasses.field(default=None, repr=False,
                                                          compare=False)
    _health_dev: Any = dataclasses.field(default=None, repr=False, compare=False)

    # Declared host <-> device crossings of ``search`` a chunk, those made
    # through ``core.transfers``: queries in, merged ids out.
    # ``with_stats=True`` adds three d2h (hops, dist_comps, converged); the
    # first search after a health change adds one h2d (the mask, cached
    # until the next change).  Not a bound on host traffic: the engine
    # reads its early-exit flag back every step, and the leaders router
    # syncs once a routed shard to size its rows.
    TRANSFER_BUDGET = {"h2d": 1, "d2h": 1}

    # ------------------------------------------------------------- sizing --
    @property
    def n_shards(self) -> int:
        return self._mesh.n_shards

    @property
    def _mesh(self) -> ShardMesh:
        return self.mesh if self.mesh is not None else ShardMesh(self.gids.shape[0])

    @property
    def shard_capacity(self) -> int:
        return self.gids.shape[1]

    @property
    def n(self) -> int:
        """Dataset size.  Live rows across shards exceed it by the halo."""
        return self.n_points

    @property
    def device(self) -> torch.device:
        return self.points.device

    def device_bytes(self, per_shard: bool = False, breakdown: bool = False):
        """Device-resident footprint of this rank's packing (the whole
        packing in one process), or (with ``per_shard=True``) of one of its
        shards' slices.  ``breakdown=True`` also splits the row-indexed
        bytes into member / ghost / pad shares (``halo_stats``)."""
        parts = (self.gids, self.graph, self.points, self.norms, self.starts,
                 self.leaders) + (() if self.scales is None else (self.scales,))
        n_local = self._mesh.n_local
        total = sum(t.numel() * t.element_size() for t in parts)
        total = total // n_local if per_shard else total
        if not breakdown:
            return total
        hs = self.halo_stats()
        mine = list(self._mesh.local)
        scale = 1.0 / n_local if per_shard else 1.0
        return {"total": total,
                "member_bytes": int(hs["member_bytes"][mine].sum() * scale),
                "ghost_bytes": int(hs["ghost_bytes"][mine].sum() * scale),
                "pad_bytes": int(hs["pad_bytes"][mine].sum() * scale),
                "halo_fraction": hs["halo_fraction"]}

    def halo_stats(self) -> dict[str, Any]:
        """Member / ghost / pad rows of each of the S shards (``members``,
        ``ghosts``, ``pads``), their bytes at ``row_bytes`` a row (gids +
        graph + points + norms [+ scales]), and ``halo_fraction``: the ghost
        rows' share of all live rows (0.0 means no replication)."""
        if self.owned is None:
            raise ValueError("halo_stats needs the owned-row counts recorded by "
                             "from_graph; this packing was constructed without them")
        m = self.shard_capacity
        members = np.asarray(self.owned, np.int64)
        live = (np.asarray(self.live, np.int64) if self.live is not None
                else (self.gids.cpu().numpy() >= 0).sum(axis=1).astype(np.int64))
        ghosts = live - members
        pads = m - live
        r, d = self.graph.shape[2], self.points.shape[2]
        row_bytes = (self.gids.element_size() + r * self.graph.element_size()
                     + d * self.points.element_size() + self.norms.element_size()
                     + (0 if self.scales is None else self.scales.element_size()))
        total_live = max(int(live.sum()), 1)
        return {"members": members, "ghosts": ghosts, "pads": pads,
                "row_bytes": int(row_bytes), "member_bytes": members * row_bytes,
                "ghost_bytes": ghosts * row_bytes, "pad_bytes": pads * row_bytes,
                "halo_fraction": float(ghosts.sum() / total_live)}

    # ------------------------------------------------------------ packing --
    @classmethod
    def from_graph(cls, graph, x, start: int, *, n_shards: int | None = None,
                   mesh: ShardMesh | None = None, metric: str = "l2", dtype=None,
                   router: str = "all", n_probes: int = 2, seed: int = 0, halo: bool = True,
                   device=None) -> "ShardedServingIndex":
        """Cut an adjacency matrix and its dataset (numpy arrays or tensors)
        into ``n_shards`` shards on ``device`` (default: the card, raising
        without one), or into ``mesh.n_shards`` shards of which this rank
        packs ``mesh.local`` on ``mesh.device`` (``device`` must then be
        None, and ``n_shards`` None or the mesh's).  On a mesh every rank
        passes the same arguments.

        Leaders are ``n_shards`` points drawn with ``seed``; every point
        joins its nearest leader (ties to the lower leader index).  With
        ``halo`` (default) each shard also carries its members'
        out-of-shard neighbours as ghost rows; ``halo=False`` keeps the bare
        induced subgraph.  Each shard's entry point is its owned member
        nearest ``x[start]``.  ``dtype`` as in ``ServingIndex.from_graph``:
        None (float32), a downcast dtype, or ``"int8"``; quantization is
        per row, so a ghost row has the same bits in every shard."""
        if router not in ROUTERS:
            raise ValueError(f"router must be one of {ROUTERS}, got {router!r}")
        if router == "leaders" and int(n_probes) <= 0:
            # an empty probe set would mask every shard out of the merge
            raise ValueError(f"router='leaders' needs n_probes >= 1, got {n_probes}")
        if mesh is None:
            if n_shards is None:
                raise ValueError("from_graph needs n_shards or mesh")
            if int(n_shards) < 1:
                raise ValueError(f"n_shards must be >= 1, got {n_shards}")
            mesh = make_local_mesh(int(n_shards), device)
        elif device is not None or (n_shards is not None and int(n_shards) != mesh.n_shards):
            raise ValueError(f"a mesh of {mesh.n_shards} shards on {mesh.device} does not take "
                             f"n_shards={n_shards!r}, device={device!r}")
        s, dev, mine = mesh.n_shards, mesh.device, list(mesh.local)
        x = _host(x, np.float32)
        graph = _host(graph, np.int32)
        n, d = x.shape
        r = graph.shape[1]
        if n < s:
            raise ValueError(f"cannot shard {n} points over {s} shards")
        rng = np.random.default_rng(seed)
        leader_ids = np.sort(rng.choice(n, size=s, replace=False))
        leaders = np.ascontiguousarray(x[leader_ids])
        xt = torch.from_numpy(x).to(dev)
        leaders_t = torch.from_numpy(leaders).to(dev)
        assign = leader_assign(xt, leaders_t, 1, metric=metric)[:, 0].cpu().numpy()
        # per-shard rows: owned members (ascending global id), then the
        # 1-hop halo, so no member edge is dropped
        rows, owned = [], np.zeros(s, np.int64)
        for i in range(s):
            mem = np.where(assign == i)[0]
            owned[i] = len(mem)
            if halo and len(mem):
                flat = graph[mem]
                flat = flat[flat >= 0]
                ghosts = np.unique(flat[assign[flat] != i])
            else:
                ghosts = np.empty(0, np.int64)
            rows.append(np.concatenate([mem, ghosts]))
        n_live = np.array([len(ridx) for ridx in rows], np.int64)
        m = max(1, int(n_live.max()))
        # this rank's shards only, stacked [L, m, ...]
        gids = np.full((len(mine), m), -1, np.int32)
        graph_s = np.full((len(mine), m, r), -1, np.int32)
        lookup = np.full(n, -1, np.int64)
        for j, i in enumerate(mine):
            ridx = rows[i]
            c = len(ridx)
            gids[j, :c] = ridx
            lookup[:] = -1
            lookup[ridx] = np.arange(c)
            ga = graph[ridx]
            # member rows: every endpoint is in the shard by the halo; ghost
            # rows keep the edges that land in the shard
            graph_s[j, :c] = np.where(ga >= 0, lookup[np.maximum(ga, 0)], -1)
        # the rows gathered on the device; norms from the float32 points
        # before any downcast or quantization
        gids_t = torch.from_numpy(gids).to(dev)
        live = gids_t >= 0
        safe = gids_t.clamp_min(0).long()
        norms = point_norms(xt, metric)
        norms_s = torch.where(live, norms[safe], torch.zeros((), device=dev))
        scales_s = None
        if _is_int8(dtype):
            x8, scl = quantize_symmetric(xt)
            pts_s = torch.where(live[..., None], x8[safe], torch.zeros((), dtype=torch.int8,
                                                                         device=dev))
            # pad scales are 1.0: a zero scale would be the only 0.0 the
            # rescale ever meets
            scales_s = torch.where(live, scl[safe], torch.ones((), device=dev))
        else:
            pts_s = torch.where(live[..., None], xt[safe], torch.zeros((), device=dev))
            if dtype is not None:
                pts_s = pts_s.to(dtype)
        del xt
        # per-shard entry: the owned member nearest the global entry point
        # (owned rows come first, so the argmin's position is its local id)
        dstart = _dist_to_point(x, x[start], metric)
        starts_local = np.zeros(len(mine), np.int32)
        for j, i in enumerate(mine):
            mem = rows[i][: owned[i]]
            if len(mem):
                starts_local[j] = np.argmin(dstart[mem])
        return cls(gids=gids_t, graph=torch.from_numpy(graph_s).to(dev),
                   points=pts_s.contiguous(), norms=norms_s.contiguous(),
                   starts=torch.from_numpy(starts_local).to(dev), leaders=leaders_t,
                   metric=metric, scales=None if scales_s is None else scales_s.contiguous(),
                   router=router, n_probes=int(n_probes), n_points=n, owned=owned, live=n_live,
                   mesh=mesh, start_ids=tuple(int(v) for v in starts_local))

    @classmethod
    def from_index(cls, index, x, *, n_shards: int | None = None, dtype=None,
                   **kw) -> "ShardedServingIndex":
        return cls.from_graph(index.graph, x, index.start, n_shards=n_shards,
                              metric=index.params.metric, dtype=dtype, **kw)

    # ------------------------------------------------------------- health --
    def _health_np(self) -> np.ndarray:
        """Host-side [S] bool shard health mask (all healthy at first)."""
        if self.health is None:
            self.health = np.ones(self.n_shards, dtype=bool)
        return self.health

    @property
    def healthy_shards(self) -> int:
        return int(self._health_np().sum())

    @property
    def down_shards(self) -> tuple[int, ...]:
        """Indices of tombstoned shards (empty when all are healthy)."""
        return tuple(int(i) for i in np.nonzero(~self._health_np())[0])

    def mark_shard_down(self, shard: int) -> None:
        """Tombstone a shard until ``probe_shard`` re-admits it: it serves
        no query.  The device copy of the mask is rebuilt once, at the next
        search."""
        self._health_np()[int(shard)] = False
        self._health_dev = None

    def mark_shard_up(self, shard: int) -> None:
        self._health_np()[int(shard)] = True
        self._health_dev = None

    def probe_shard(self, shard: int, probe=None) -> bool:
        """Try to re-admit a tombstoned shard: mark it up, then
        ``probe(shard)`` must return truthy without raising, or the
        tombstone is restored.  The default probe serves the shard's own
        leader through ``self.search``, looked up at call time, so under
        ``testing.faults.inject_faults`` it fails while the shard's outage
        is scheduled.  Returns True iff the shard is healthy afterwards."""
        i = int(shard)
        if self._health_np()[i]:
            return True
        if probe is None:
            probe = self._default_probe
        self.mark_shard_up(i)
        try:
            ok = bool(probe(i))
        except Exception:
            ok = False
        if not ok:
            self.mark_shard_down(i)
        return ok

    def _default_probe(self, shard: int) -> bool:
        q = self.leaders[int(shard)][None, :].cpu().numpy()
        ids = self.search(np.ascontiguousarray(q, np.float32), k=1, beam=4)
        return bool(ids[0, 0] >= 0)

    def _health_operand(self) -> torch.Tensor:
        """The device copy of the health mask, rebuilt only when the mask
        changes (one declared h2d)."""
        if self._health_dev is None:
            self._health_dev = to_device(np.ascontiguousarray(self._health_np()), self.device)
        return self._health_dev

    def _active_mask(self, queries: torch.Tensor) -> torch.Tensor | None:
        """Bool mask ([S, Q], or [S, 1] to broadcast) of the shards whose
        beams enter the merge for each query: the router's probe set AND
        the health mask.  ``None`` when every shard serves every query
        (router "all", all healthy)."""
        health = self._health_np()
        if not health.any():
            raise AllShardsDown(f"all {self.n_shards} shards are marked down")
        healthy = bool(health.all())
        hdev = None if healthy else self._health_operand()
        if self.router == "all":
            return None if healthy else hdev[:, None]
        if int(self.n_probes) <= 0:
            raise ValueError(f"router='leaders' needs n_probes >= 1, got {self.n_probes}")
        # a dead shard's leader is masked out, so each query probes its
        # next-best healthy leaders instead of losing a probe
        probes = min(int(self.n_probes), int(health.sum()))
        probe = leader_assign(queries, self.leaders, probes, metric=self.metric,
                              leader_valid=hdev)                    # [Q, probes]
        sids = torch.arange(self.n_shards, dtype=probe.dtype, device=probe.device)
        mask = torch.any(probe[None, :, :] == sids[:, None, None], dim=2)
        return mask if healthy else mask & hdev[:, None]

    # ------------------------------------------------------------- search --
    def _shard_search(self, queries: torch.Tensor, active: torch.Tensor | None, *,
                      beam: int, iters: int, expansions: int, early_exit: bool,
                      plain: bool):
        """Every shard's beam over the queries routed to it, ids mapped to
        global ids: (ids [S, Q, beam] int32, dists [S, Q, beam], hops [S, Q],
        dist_comps [S, Q], converged [S, Q]).  Entries of a shard that does
        not serve a query are (-1, +inf), 0 hops and comps, converged.  This
        rank searches its own shards; across ranks every rank then gathers
        all S shards' blocks, whatever its shards served."""
        mesh, nq = self._mesh, queries.shape[0]
        n_local = mesh.n_local
        dev = queries.device
        inf = torch.full((), float("inf"), device=dev)
        ids_s = torch.full((n_local, nq, beam), -1, dtype=torch.int32, device=dev)
        ds_s = torch.full((n_local, nq, beam), float("inf"), dtype=torch.float32, device=dev)
        hops_s = torch.zeros((n_local, nq), dtype=torch.int32, device=dev)
        comps_s = torch.zeros((n_local, nq), dtype=torch.int32, device=dev)
        conv_s = torch.ones((n_local, nq), dtype=torch.bool, device=dev)
        health = self._health_np()
        if self.start_ids is None:
            self.start_ids = tuple(self.starts.tolist())
        starts = self.start_ids
        for j, i in enumerate(mesh.local):
            rows = None
            if not health[i]:
                continue
            if active is not None and active.shape[1] == nq:
                rows = torch.nonzero(active[i])[:, 0]
                if rows.numel() == 0:
                    continue
                if rows.numel() == nq:
                    rows = None
            q = queries if rows is None else queries[rows]
            ids, ds, hops, comps, conv = _bs._beam_search_multi(
                self.graph[j], self.points[j], self.norms[j], q, starts[j], beam=beam,
                iters=iters, metric=self.metric, expansions=expansions,
                early_exit=early_exit, scales=None if self.scales is None else self.scales[j],
                plain=plain)
            gid = torch.where(ids >= 0, self.gids[j][ids.clamp_min(0).long()], -1)
            # an empty shard's pad entry point carries gid -1: +inf drops it
            ds = torch.where(gid >= 0, ds, inf)
            at = slice(None) if rows is None else rows
            ids_s[j, at], ds_s[j, at] = gid, ds
            hops_s[j, at], comps_s[j, at], conv_s[j, at] = hops, comps, conv
        blocks = (ids_s, ds_s, hops_s, comps_s, conv_s)
        if mesh.group is not None:
            blocks = tuple(mesh.all_gather([b]) for b in blocks)
        return blocks

    def search(self, queries, *, k: int = 10, beam: int = 32, expansions: int = 4,
               iters: int | None = None, early_exit: bool = True,
               kernel_path: str | None = None, query_chunk: int | None = None,
               with_stats: bool = False):
        """Serve a query batch; [Q, k] global ids (int64 numpy, -1-padded).

        As ``ServingIndex.search``, with ``beam`` the per-shard beam width;
        the ``router`` decides which shards serve each query, and their
        beams merge in ``cross_shard_topk``.  ``query_chunk`` bounds the
        batch a search runs; a short chunk is zero-padded to it, and the
        padded rows are searched and dropped.  ``with_stats=True`` adds
        per-query telemetry summed over the shards that served the query
        (``converged`` is the AND over them), the ``kernel_path`` that ran,
        the routing settings and the halo fraction.

        ``k``/``beam`` below 1 raise ``ValueError`` and NaN/Inf rows an
        ``InvalidQueryError``.  Tombstoned shards serve nothing; with every
        shard down the call raises ``AllShardsDown``.  The declared host
        crossings a chunk are ``TRANSFER_BUDGET`` (``core.transfers``)."""
        iters_cap = int(iters if iters is not None else _bs.default_iters(beam))
        path = _bs.resolve_kernel_path(self.points, kernel_path)

        def run(qt):
            ids_s, ds_s, hops_s, comps_s, conv_s = self._shard_search(
                qt, self._active_mask(qt), beam=beam, iters=iters_cap,
                expansions=int(expansions), early_exit=bool(early_exit), plain=path == "xla")
            ids, _ = cross_shard_topk(ids_s, ds_s, k=k)
            return (ids, hops_s.sum(dim=0, dtype=torch.int32),
                    comps_s.sum(dim=0, dtype=torch.int32), conv_s.all(dim=0))

        out = serve_chunks(queries, run, k=k, beam=beam, dim=int(self.points.shape[-1]),
                           device=self.device, query_chunk=query_chunk,
                           with_stats=with_stats)
        if with_stats:
            out[1].update(self._stats(expansions, iters_cap, path))
        return out

    def _stats(self, expansions, iters_cap, path) -> dict[str, Any]:
        stats = {"expansions": int(expansions), "iters_cap": int(iters_cap),
                 "kernel_path": path, "n_shards": self.n_shards,
                 "healthy_shards": self.healthy_shards, "router": self.router}
        if self.router == "leaders":
            stats["n_probes"] = min(int(self.n_probes), self.healthy_shards)
        if self.owned is not None:
            stats["halo_fraction"] = self.halo_stats()["halo_fraction"]
        return stats
