"""PiPNN (Algorithm 4) in PyTorch: partition -> pick -> HashPrune -> final
prune (counterpart of ``repro/core/pipnn.py``).

``build(x)`` runs on the card by default:

  * Stage 1, ``rbc.partition_padded``: the RBC carve (``PiPNNParams.
    partitioner``, ``RBCParams.execution``): on the card by default the
    worklist carve, with the leader GEMM and the bucket grouping on the
    device and the worklist on the host; ``execution="static"`` carves
    two levels on the device with no host recursion.
  * Stages 2+3, by ``build(..., streaming=)``:

    - STREAMING (default): chunk by chunk of leaves, the leaf method (the
      k-NN methods through ``kernels.leaf_knn``, or the all-to-all
      ``robust_prune``), edge emission, residual hashes from the
      precomputed sketches (``kernels.edge_hash``) and the fold into the
      persistent [n, l_max] reservoir (``PiPNNParams.merge``: the
      segmented fold, ``hashprune.hashprune_flat`` over the chunk then
      ``kernels.segmented_merge`` in place, or ``"flat"``, the
      reservoir-as-edges re-sort).  Candidate edges never leave the
      device; the chunk auto-sizes so its edge buffer is about the size
      of the reservoir.
    - FLAT (``streaming=False``, and the fallback of the ``mst`` leaf
      method): the whole candidate edge list (``leaf.build_leaf_edges``),
      then one global ``hashprune_flat`` over its valid edges.  O(E)
      memory; the oracle of the streaming path.

    Both give the same graph (HashPrune's mergeability, Theorem 3.1).
  * Stage 4, ``robust_prune.final_prune`` (or, with ``final_prune=False``,
    the reservoir cut or padded to ``max_deg``).

The graph is deterministic for a fixed seed.  The hyperplanes come from a
seeded numpy generator (``sketch.make_hyperplanes``), or from the caller
(``hyperplanes=``), as the leaves may (``leaves=``).

Alpha note: the metrics return squared L2, so ``PiPNNParams`` squares the
paper's alpha for l2; MIPS uses alpha = 1.  ``LeafParams.alpha`` (the
``robust_prune`` leaf method) is used as given, as in the reference.

Not ported: ``use_pallas_hash`` and ``use_pallas_merge`` (the kernel
follows the tensors' device here).  ``stream_step_workspace_bytes`` models
the device bytes of one fused chunk step (``analysis.memory_audit``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import sketch as _sketch
from repro_torch.core.beam_search import beam_search_np, medoid
from repro_torch.core.hashprune import (INVALID_ID, Reservoir, hashprune_flat,
                                        merge_flat_edges, merge_flat_workspace_bytes,
                                        merge_segmented_edges,
                                        merge_segmented_workspace_bytes, reservoir_init)
from repro_torch.core.leaf import (KNN_METHODS, LeafParams, build_leaf_edges, check_k,
                                   check_method, emit_knn_edges, emit_robust_prune_edges,
                                   iter_leaf_id_chunks, leaf_knn, leaf_robust_prune)
from repro_torch.core.rbc import (RBCParams, leaves_to_padded, padded_coverage,
                                  partition_padded, resolve_execution)
from repro_torch.core.robust_prune import final_prune
from repro_torch.core.validation import validate_queries, validate_search_params
from repro_torch.device import resolve_device, synchronize

_STREAM_METHODS = KNN_METHODS + ("robust_prune",)
MERGES = ("segmented", "flat")
# bytes of one materialised candidate edge (src + dst + hash + dist), of
# one host-style edge without its hash, and of one reservoir slot (id +
# hash + dist): the reference's memory stats
_EDGE_BYTES = 16
_EDGE_BYTES_NOHASH = 12
_SLOT_BYTES = 12


@dataclasses.dataclass(frozen=True)
class PiPNNParams:
    rbc: RBCParams = dataclasses.field(default_factory=RBCParams)
    leaf: LeafParams = dataclasses.field(default_factory=LeafParams)
    partitioner: str = "rbc"   # "rbc" | "binary" | "kmeans" | "sorting_lsh"
    hash_bits: int = 12        # m hyperplanes (paper default 12)
    l_max: int = 64            # reservoir capacity (paper: 64..192)
    final_prune: bool = True   # Sec. 4.3 (on by default in the paper)
    alpha: float = 1.2         # on TRUE distance; squared for l2 internally
    max_deg: int = 64          # final graph degree cap
    metric: str = "l2"
    seed: int = 0
    merge: str = "segmented"   # streaming fold: "segmented" or "flat" (the
    #                            reservoir-as-edges re-sort); same graph

    def effective_alpha(self) -> float:
        if self.metric == "l2":
            return float(self.alpha) ** 2
        if self.metric == "mips":
            return 1.0
        return float(self.alpha)

    def with_(self, **kw) -> "PiPNNParams":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class PiPNNIndex:
    graph: torch.Tensor        # [n, max_deg] int32, -1 padded
    dists: torch.Tensor        # [n, max_deg] float32, +inf padded
    start: int                 # entry point (medoid)
    params: PiPNNParams
    timings: dict[str, float]
    stats: dict[str, Any]

    @property
    def n(self) -> int:
        return self.graph.shape[0]

    def average_degree(self) -> float:
        return float((self.graph >= 0).sum().item() / self.graph.shape[0])


def _stream_edges_per_leaf(leaf: LeafParams, c_max: int) -> int:
    """Candidate-edge entries one padded leaf emits in a stream chunk (the
    emitters' fixed output shapes)."""
    if leaf.method == "robust_prune":
        return c_max * c_max
    fan = 2 if leaf.method == "bidirected" else 1
    return fan * c_max * leaf.k


def _stream_chunk_leaves(leaf: LeafParams, n: int, l_max: int, nleaves: int,
                         c_max: int) -> int:
    """Leaves per streaming merge step: ``leaf.stream_chunk``, or sized so
    the chunk's padded candidate-edge buffer is about the [n, l_max]
    reservoir; never past the leaf count, rounded up to a multiple of
    ``leaf.leaf_chunk``."""
    lc = max(1, leaf.leaf_chunk)
    if leaf.stream_chunk is not None:
        s = max(lc, int(leaf.stream_chunk))
    else:
        s = max(lc, (n * l_max) // max(1, _stream_edges_per_leaf(leaf, c_max)))
    s = min(s, max(lc, nleaves))
    return -(-s // lc) * lc


def _chunk_edges(xt, sketches, ids, *, leaf: LeafParams, knn_fn: Callable | None = None):
    """One chunk's candidate edges as the fold takes them: the leaf method
    (``knn_fn`` or the leaf k-NN, or the ``robust_prune`` leaf method) ->
    edges -> residual hashes, with invalid slots as (src = n, dst =
    INVALID_ID, hash 0, dist +inf).  Returns ((src, dst, hash, dist), the
    valid edge count as a device scalar)."""
    n = xt.shape[0]
    if leaf.method == "robust_prune":
        keep, d = leaf_robust_prune(xt, ids, metric=leaf.metric, alpha=leaf.alpha,
                                    max_deg=leaf.max_deg)
        src, dst, dist = emit_robust_prune_edges(ids, keep, d)
        del keep, d
    else:
        knn = knn_fn or (lambda pts, leaf_ids: leaf_knn(pts, leaf_ids, k=leaf.k,
                                                        metric=leaf.metric))
        ni, nd = knn(xt, ids)
        src, dst, dist = emit_knn_edges(ids, ni, nd, leaf.method)
    h = _sketch.edge_hashes_from_ids(sketches, src, dst)
    ok = src >= 0
    edges = (torch.where(ok, src, n), torch.where(ok, dst, INVALID_ID), torch.where(ok, h, 0),
             torch.where(ok, dist, torch.full((), float("inf"), device=dist.device)))
    return edges, ok.sum()


def _stream_step(res: Reservoir, xt, sketches, ids, *, leaf: LeafParams, merge: str,
                 knn_fn: Callable | None = None):
    """One fused chunk: leaf method -> edges -> hashes -> fold (the
    segmented merge, in place on the card, or the flat re-sort).  Returns
    the new reservoir and the chunk's valid edge count (a device scalar, so
    the loop never waits on the host)."""
    edges, count = _chunk_edges(xt, sketches, ids, leaf=leaf, knn_fn=knn_fn)
    fold = merge_flat_edges if merge == "flat" else merge_segmented_edges
    return fold(res.ids, res.hashes, res.dists, *edges), count


def stream_step_workspace_bytes(n: int, l_max: int, s: int, c: int, k: int, *,
                                method: str = "bidirected", merge: str = "segmented") -> int:
    """Modeled device temp bytes of one ``_stream_step`` on the card: ``s``
    leaves of ``c`` padded entries emit ``e = s * edges-a-leaf`` candidate
    edges, which reach the fold as four masked columns (16 B an edge: the
    build's ``stats["peak_edge_bytes"]``), and the fold adds its own
    workspace (``hashprune.merge_*_workspace_bytes``).  The emission before
    it (the k-NN lists, raw edges, hashes and masks, under 42 B an edge)
    stays below the fold's peak.  Only the chunk and the reservoir shapes
    appear, never the build's total edge count E: the bounded-memory
    contract ``analysis.memory_audit`` checks."""
    e = s * _stream_edges_per_leaf(LeafParams(method=method, k=k), c)
    fold = merge_flat_workspace_bytes if merge == "flat" else merge_segmented_workspace_bytes
    return e * _EDGE_BYTES + fold(n, l_max, e)


def _build_reservoir_streaming(xt: torch.Tensor, leaves_padded: np.ndarray,
                               sketches: torch.Tensor, params: PiPNNParams,
                               knn_fn: Callable | None = None):
    """Stream leaf chunks through the fused step; returns
    (reservoir, n_candidate_edges, memory stats)."""
    leaf = params.leaf
    n = xt.shape[0]
    nleaves, c_max = leaves_padded.shape
    chunk = _stream_chunk_leaves(leaf, n, params.l_max, nleaves, c_max)
    knn_fn = knn_fn if leaf.method in KNN_METHODS else None
    res = reservoir_init(n, params.l_max, xt.device)
    counts = []
    for ids in iter_leaf_id_chunks(torch.from_numpy(leaves_padded).to(xt.device), chunk):
        res, cnt = _stream_step(res, xt, sketches, ids, leaf=leaf, merge=params.merge,
                                knn_fn=knn_fn)
        counts.append(cnt)
    n_edges = int(torch.stack(counts).sum().item()) if counts else 0
    # the padded entries of one chunk, src/dst/hash/dist each
    chunk_entries = chunk * _stream_edges_per_leaf(leaf, c_max)
    if params.merge == "flat":
        # the reservoir re-expressed as n * l_max edges, sorted with the chunk
        merge_ws = (n * params.l_max + chunk_entries) * _EDGE_BYTES
    else:
        # chunk-only global sort + [n, 2*l_max] per-row merge
        merge_ws = chunk_entries * _EDGE_BYTES + 2 * n * params.l_max * _SLOT_BYTES
    mem = {
        "stream_chunk_leaves": chunk,
        "peak_edge_bytes": chunk_entries * _EDGE_BYTES,
        "edge_bytes_build_leaves": chunk_entries * _EDGE_BYTES,
        "merge_workspace_bytes": merge_ws,
    }
    return res, n_edges, mem


def _as_host_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.ascontiguousarray(x, dtype=np.float32)


def build(x, params: PiPNNParams | None = None, *, leaves: list[np.ndarray] | None = None,
          hyperplanes=None, device=None, knn_fn: Callable | None = None,
          streaming: bool = True) -> PiPNNIndex:
    """Build a PiPNN index over ``x`` [n, d] float32 (numpy or tensor).

    ``device`` defaults to the card and raises without one; pass
    ``device="cpu"`` for the CPU.  ``leaves`` (a list of index arrays) and
    ``hyperplanes`` ([hash_bits, d]) replace Stage 1 and the seeded
    hyperplanes with the caller's, so two builds can share random state.
    ``streaming=True`` (default) runs Stages 2+3 chunk by chunk on the
    device; ``False`` takes the O(E) flat path (as does the ``mst`` leaf
    method, with ``stats["streaming"]`` False).  Both give the same graph.
    ``knn_fn(points, leaf_ids) -> (in-leaf idx [B, C, k], dist [B, C, k])``
    replaces the leaf k-NN of the k-NN methods (default ``leaf.leaf_knn``;
    the reference's takes gathered points and a valid mask instead, as the
    port's leaf kernel gathers its own rows).
    ``timings`` holds per-phase wall seconds (the device is synchronised at
    each phase end) and ``stats`` the reference's keys."""
    dev = resolve_device(device)
    params = params or PiPNNParams()
    check_method(params.leaf.method)
    if params.leaf.method in KNN_METHODS:
        check_k(params.leaf.k)   # before Stage 1
    if params.merge not in MERGES:
        raise ValueError(f"unknown merge {params.merge!r}; expected one of {MERGES}")
    x_host = _as_host_f32(x)
    n, d = x_host.shape
    xt = (x if isinstance(x, torch.Tensor) and x.device == dev and x.dtype == torch.float32
          else torch.from_numpy(x_host).to(dev)).contiguous()
    timings: dict[str, float] = {}
    stats: dict[str, Any] = {}

    # --- Stage 1: overlapping partitioning --------------------------------
    t0 = time.perf_counter()
    if leaves is None:
        rbc = dataclasses.replace(params.rbc, metric=params.metric, seed=params.seed)
        padded = partition_padded(xt, rbc, params.partitioner)
        stats["partition_execution"] = (
            resolve_execution(rbc, dev) if params.partitioner == "rbc" else "host")
    else:
        padded = leaves_to_padded(leaves, params.rbc.c_max)
        stats["partition_execution"] = "caller"
    synchronize(dev)
    timings["partition"] = time.perf_counter() - t0
    sizes = (padded >= 0).sum(axis=1)
    stats["n_leaves"] = int(padded.shape[0])
    stats["leaf_size_mean"] = float(sizes.mean()) if len(sizes) else 0.0
    stats["point_repeat"] = float(sizes.sum() / max(n, 1))
    stats["pad_ratio"] = float(padded.size / max(sizes.sum(), 1))
    stats["partition_uncovered"] = n - padded_coverage(padded, n)

    if hyperplanes is None:
        hyperplanes = _sketch.make_hyperplanes(params.seed, params.hash_bits, d)
    hp = torch.as_tensor(np.asarray(hyperplanes, dtype=np.float32)).to(dev)
    leaf = dataclasses.replace(params.leaf, metric=params.metric)
    lparams = dataclasses.replace(params, leaf=leaf)
    stream_ok = streaming and leaf.method in _STREAM_METHODS
    stats["streaming"] = stream_ok

    if stream_ok:
        # --- Stages 2+3 fused: streaming device-resident pipeline ---------
        # the sketch GEMM is charged to hashprune, the fused loop to
        # build_leaves
        t0 = time.perf_counter()
        sketches = _sketch.sketch(xt, hp).contiguous()
        synchronize(dev)
        timings["hashprune"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res, n_edges, mem = _build_reservoir_streaming(xt, padded, sketches, lparams, knn_fn)
        synchronize(dev)
        timings["build_leaves"] = time.perf_counter() - t0
        stats["n_candidate_edges"] = n_edges
        stats.update(mem)
    else:
        # --- Stage 2: leaf building -> the whole candidate edge list ------
        t0 = time.perf_counter()
        edges = build_leaf_edges(xt, padded, leaf, knn_fn=knn_fn)
        synchronize(dev)
        timings["build_leaves"] = time.perf_counter() - t0
        e = int(edges.src.numel())
        ok = edges.valid()
        stats["n_candidate_edges"] = int(ok.sum().item())
        # the reference's accounting: its host edge list carries no hash
        # (12 B/edge), its Stage 3 src/dst/hash/dist arrays (16 B/edge)
        stats["edge_bytes_build_leaves"] = e * _EDGE_BYTES_NOHASH
        stats["merge_workspace_bytes"] = e * _EDGE_BYTES
        stats["peak_edge_bytes"] = e * _EDGE_BYTES

        # --- Stage 3: HashPrune, one global sort ---------------------------
        # padding never reaches a reservoir, so only the valid edges are
        # hashed and sorted (the same reservoir)
        t0 = time.perf_counter()
        sketches = _sketch.sketch(xt, hp).contiguous()
        src, dst, dist = edges.src[ok], edges.dst[ok], edges.dist[ok]
        del edges, ok
        h = _sketch.edge_hashes_from_ids(sketches, src, dst)
        res = hashprune_flat(src, dst, h, dist, n_points=n, l_max=params.l_max)
        del src, dst, dist, h
        synchronize(dev)
        timings["hashprune"] = time.perf_counter() - t0

    # --- Stage 4: final prune ---------------------------------------------
    t0 = time.perf_counter()
    if params.final_prune:
        graph, dists = final_prune(xt, res, alpha=params.effective_alpha(),
                                   max_deg=params.max_deg, metric=params.metric)
    else:
        # the reservoir itself, cut or padded to max_deg: rows sorted by
        # (dist, id), -1 / +inf padding
        graph, dists = res.ids[:, :params.max_deg], res.dists[:, :params.max_deg]
        pad = params.max_deg - graph.shape[1]
        if pad > 0:
            graph = torch.nn.functional.pad(graph, (0, pad), value=INVALID_ID)
            dists = torch.nn.functional.pad(dists, (0, pad), value=float("inf"))
        graph, dists = graph.contiguous(), dists.contiguous()
    synchronize(dev)
    timings["final_prune"] = time.perf_counter() - t0
    timings["total"] = sum(timings.values())

    return PiPNNIndex(graph=graph, dists=dists, start=medoid(x_host, seed=params.seed),
                      params=params, timings=timings, stats=stats)


def serving_index(index: PiPNNIndex, x, *, dtype=None, n_shards: int | None = None,
                  mesh=None, device=None):
    """The ``ServingIndex`` (or, with ``n_shards`` or ``mesh``, the
    ``ShardedServingIndex``) for ``(index, x)``, cached on the index: the
    first call packs graph, points and norms (and the int8 scales with
    ``dtype="int8"``) onto the device, later calls with the same ``x``,
    graph object, dtype, shard count, mesh and device reuse it.  On a mesh
    the device is the mesh's and ``device`` must be None."""
    from repro_torch.core.serving import ServingIndex

    dev = resolve_device(device) if mesh is None else device
    key = (index.start, index.params.metric, None if dtype is None else str(dtype),
           n_shards, mesh, str(dev))
    cached = getattr(index, "_serving", None)
    if (cached is not None and getattr(index, "_serving_x", None) is x
            and getattr(index, "_serving_graph", None) is index.graph
            and getattr(index, "_serving_key", None) == key):
        return cached
    sv = ServingIndex.from_index(index, x, dtype=dtype, device=dev, n_shards=n_shards,
                                 mesh=mesh)
    index._serving, index._serving_x = sv, x
    index._serving_graph, index._serving_key = index.graph, key
    return sv


def search(index: PiPNNIndex, x, queries, *, k: int = 10, beam: int = 32,
           batch: bool = True, expansions: int | None = None, iters: int | None = None,
           query_chunk: int | None = None, dtype=None, n_shards: int | None = None,
           mesh=None, with_stats: bool = False, device=None):
    """Query the index; returns [Q, k] neighbour ids (int64 numpy, -1-padded
    when fewer than ``k`` are found).

    ``batch=True`` (the serving path) goes through the cached
    ``ServingIndex`` and the multi-expansion beam search (``expansions``
    default 4) on ``device``.  ``dtype`` downcasts the serving copy of the
    points (``torch.bfloat16``) or, with ``dtype="int8"``, serves the
    scalar-quantized packing.  ``n_shards`` serves through the sharded
    packing (``distributed.serving.ShardedServingIndex``, all shards on
    ``device``), and ``mesh`` (a ``launch.mesh.ShardMesh``) through the
    sharded packing spread over the mesh's ranks, each calling ``search``
    alike and getting the same ids.

    ``batch=False`` is the pointer-chasing host oracle ``beam_search_np``,
    one query at a time on the host (``device`` is not used); it takes
    none of the serving options (``expansions``, ``iters``,
    ``query_chunk``, ``dtype``, ``n_shards``, ``mesh``, ``with_stats``) and
    raises ``ValueError`` when one is given."""
    validate_search_params(k=k, beam=beam)
    if batch:
        sv = serving_index(index, x, dtype=dtype, n_shards=n_shards, mesh=mesh, device=device)
        return sv.search(queries, k=k, beam=beam,
                         expansions=4 if expansions is None else expansions,
                         iters=iters, query_chunk=query_chunk, with_stats=with_stats)
    if (with_stats or iters is not None or dtype is not None or expansions is not None
            or query_chunk is not None or n_shards is not None or mesh is not None):
        raise ValueError(
            "with_stats / iters / dtype / expansions / query_chunk / n_shards / mesh are "
            "serving-path options; the batch=False host oracle expands one vertex per "
            "hop and does not take them")
    x_host = _as_host_f32(x)
    q = validate_queries(_as_host_f32(queries) if isinstance(queries, torch.Tensor)
                         else queries, dim=x_host.shape[1])
    graph = index.graph.cpu().numpy()
    out = np.empty((q.shape[0], k), dtype=np.int64)
    for i, qi in enumerate(q):
        ids, _, _ = beam_search_np(graph, x_host, qi, start=index.start, beam=beam,
                                   metric=index.params.metric)
        out[i] = ids[:k] if len(ids) >= k else np.pad(ids, (0, k - len(ids)),
                                                      constant_values=-1)
    return out
