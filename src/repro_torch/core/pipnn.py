"""PiPNN (Algorithm 4) in PyTorch: partition -> pick -> HashPrune -> final
prune, with the streaming Stage 2+3 of ``repro/core/pipnn.py``.

``build(x)`` runs on the card by default:

  * Stage 1, ``rbc.partition_padded``: the RBC carve (``PiPNNParams.
    partitioner``, ``RBCParams.execution``): on the card by default the
    worklist carve, with the leader GEMM and the bucket grouping on the
    device and the worklist on the host; ``execution="static"`` carves
    two levels on the device with no host recursion.
  * Stages 2+3 fused, chunk by chunk of leaves: the leaf k-NN
    (``kernels.leaf_knn``), bidirected edge emission, residual hashes from
    the precomputed sketches (``kernels.edge_hash``) and the segmented fold
    into the persistent [n, l_max] reservoir (``hashprune.hashprune_flat``
    over the chunk, then ``kernels.segmented_merge`` in place).  Candidate
    edges never leave the device; the chunk auto-sizes so its edge buffer
    is about the size of the reservoir.
  * Stage 4, ``robust_prune.final_prune``.

The graph is deterministic for a fixed seed.  The hyperplanes come from a
seeded numpy generator (``sketch.make_hyperplanes``), or from the caller
(``hyperplanes=``), as the leaves may (``leaves=``).

Alpha note: the metrics return squared L2, so ``PiPNNParams`` squares the
paper's alpha for l2; MIPS uses alpha = 1.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core import sketch as _sketch
from repro_torch.core.beam_search import medoid
from repro_torch.core.hashprune import (INVALID_ID, Reservoir, merge_segmented_edges,
                                        reservoir_init)
from repro_torch.core.leaf import (LeafParams, check_k, emit_knn_edges, iter_leaf_id_chunks,
                                   leaf_knn)
from repro_torch.core.rbc import (RBCParams, leaves_to_padded, padded_coverage,
                                  partition_padded, resolve_execution)
from repro_torch.core.robust_prune import final_prune
from repro_torch.device import resolve_device, synchronize

# bytes of one materialised candidate edge (src + dst + hash + dist) and
# of one reservoir slot (id + hash + dist)
_EDGE_BYTES = 16
_SLOT_BYTES = 12
# stream chunks are a multiple of the reference's leaf_chunk (its GEMM
# sub-batch), so both packages cut the leaves into the same chunks
_LEAF_CHUNK = 8


@dataclasses.dataclass(frozen=True)
class PiPNNParams:
    rbc: RBCParams = dataclasses.field(default_factory=RBCParams)
    leaf: LeafParams = dataclasses.field(default_factory=LeafParams)
    partitioner: str = "rbc"   # "rbc" | "binary" | "kmeans" | "sorting_lsh"
    hash_bits: int = 12        # m hyperplanes (paper default 12)
    l_max: int = 64            # reservoir capacity (paper: 64..192)
    alpha: float = 1.2         # on TRUE distance; squared for l2 internally
    max_deg: int = 64          # final graph degree cap
    metric: str = "l2"
    seed: int = 0

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
    """Candidate-edge entries one padded leaf emits (bidirected k-NN)."""
    return 2 * c_max * leaf.k


def _stream_chunk_leaves(leaf: LeafParams, n: int, l_max: int, nleaves: int,
                         c_max: int) -> int:
    """Leaves per streaming merge step: sized so the chunk's padded
    candidate-edge buffer is about the [n, l_max] reservoir, never past the
    leaf count, rounded up to a multiple of ``_LEAF_CHUNK``."""
    lc = _LEAF_CHUNK
    s = max(lc, (n * l_max) // max(1, _stream_edges_per_leaf(leaf, c_max)))
    s = min(s, max(lc, nleaves))
    return -(-s // lc) * lc


def _chunk_edges(xt, sketches, ids, *, k: int, metric: str):
    """One chunk's candidate edges as the fold takes them: leaf k-NN ->
    bidirected edges -> residual hashes, with invalid slots as (src = n,
    dst = INVALID_ID, hash 0, dist +inf).  Returns ((src, dst, hash, dist),
    the valid edge count as a device scalar)."""
    n = xt.shape[0]
    ni, nd = leaf_knn(xt, ids, k=k, metric=metric)
    src, dst, dist = emit_knn_edges(ids, ni, nd)
    h = _sketch.edge_hashes_from_ids(sketches, src, dst)
    ok = src >= 0
    edges = (torch.where(ok, src, n), torch.where(ok, dst, INVALID_ID), torch.where(ok, h, 0),
             torch.where(ok, dist, torch.full((), float("inf"), device=dist.device)))
    return edges, ok.sum()


def _stream_step(res: Reservoir, xt, sketches, ids, *, k: int, metric: str):
    """One fused chunk: leaf k-NN -> edges -> hashes -> segmented fold.
    Returns the new reservoir and the chunk's valid edge count (a device
    scalar, so the loop never waits on the host)."""
    edges, count = _chunk_edges(xt, sketches, ids, k=k, metric=metric)
    return merge_segmented_edges(res.ids, res.hashes, res.dists, *edges), count


def _build_reservoir_streaming(xt: torch.Tensor, leaves_padded: np.ndarray,
                               sketches: torch.Tensor, params: PiPNNParams):
    """Stream leaf chunks through the fused step; returns
    (reservoir, n_candidate_edges, memory stats)."""
    leaf = params.leaf
    n = xt.shape[0]
    nleaves, c_max = leaves_padded.shape
    chunk = _stream_chunk_leaves(leaf, n, params.l_max, nleaves, c_max)
    res = reservoir_init(n, params.l_max, xt.device)
    counts = []
    for ids in iter_leaf_id_chunks(torch.from_numpy(leaves_padded).to(xt.device), chunk):
        res, cnt = _stream_step(res, xt, sketches, ids, k=leaf.k, metric=params.metric)
        counts.append(cnt)
    n_edges = int(torch.stack(counts).sum().item()) if counts else 0
    chunk_entries = chunk * _stream_edges_per_leaf(leaf, c_max)
    mem = {
        "stream_chunk_leaves": chunk,
        "peak_edge_bytes": chunk_entries * _EDGE_BYTES,
        "edge_bytes_build_leaves": chunk_entries * _EDGE_BYTES,
        # chunk-only global sort + [n, 2*l_max] per-row merge
        "merge_workspace_bytes": (chunk_entries * _EDGE_BYTES
                                  + 2 * n * params.l_max * _SLOT_BYTES),
    }
    return res, n_edges, mem


def _as_host_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.ascontiguousarray(x, dtype=np.float32)


def build(x, params: PiPNNParams | None = None, *, leaves: list[np.ndarray] | None = None,
          hyperplanes=None, device=None) -> PiPNNIndex:
    """Build a PiPNN index over ``x`` [n, d] float32 (numpy or tensor).

    ``device`` defaults to the card and raises without one; pass
    ``device="cpu"`` for the CPU.  ``leaves`` (a list of index arrays) and
    ``hyperplanes`` ([hash_bits, d]) replace Stage 1 and the seeded
    hyperplanes with the caller's, so two builds can share random state.
    ``timings`` holds per-phase wall seconds (the device is synchronised at
    each phase end) and ``stats`` the reference's keys."""
    dev = resolve_device(device)
    params = params or PiPNNParams()
    check_k(params.leaf.k)   # before Stage 1
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
    stats["streaming"] = True

    # --- Stages 2+3 fused: streaming device-resident pipeline -------------
    # the sketch GEMM is charged to hashprune, the fused loop to build_leaves
    t0 = time.perf_counter()
    sketches = _sketch.sketch(xt, hp).contiguous()
    synchronize(dev)
    timings["hashprune"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res, n_edges, mem = _build_reservoir_streaming(xt, padded, sketches, params)
    synchronize(dev)
    timings["build_leaves"] = time.perf_counter() - t0
    stats["n_candidate_edges"] = n_edges
    stats.update(mem)

    # --- Stage 4: final prune ---------------------------------------------
    t0 = time.perf_counter()
    graph, dists = final_prune(xt, res, alpha=params.effective_alpha(),
                               max_deg=params.max_deg, metric=params.metric)
    synchronize(dev)
    timings["final_prune"] = time.perf_counter() - t0
    timings["total"] = sum(timings.values())

    return PiPNNIndex(graph=graph, dists=dists, start=medoid(x_host, seed=params.seed),
                      params=params, timings=timings, stats=stats)


def serving_index(index: PiPNNIndex, x, *, dtype=None, device=None):
    """The ``ServingIndex`` for ``(index, x)``, cached on the index: the
    first call packs graph, points and norms (and the int8 scales with
    ``dtype="int8"``) onto the device, later calls with the same ``x``,
    graph object, dtype and device reuse it."""
    from repro_torch.core.serving import ServingIndex

    dev = resolve_device(device)
    key = (index.start, index.params.metric, None if dtype is None else str(dtype), str(dev))
    cached = getattr(index, "_serving", None)
    if (cached is not None and getattr(index, "_serving_x", None) is x
            and getattr(index, "_serving_graph", None) is index.graph
            and getattr(index, "_serving_key", None) == key):
        return cached
    sv = ServingIndex.from_index(index, x, dtype=dtype, device=dev)
    index._serving, index._serving_x = sv, x
    index._serving_graph, index._serving_key = index.graph, key
    return sv


def search(index: PiPNNIndex, x, queries, *, k: int = 10, beam: int = 32,
           expansions: int | None = None, iters: int | None = None,
           query_chunk: int | None = None, dtype=None, with_stats: bool = False,
           device=None):
    """Query the index; returns [Q, k] neighbour ids (int64 numpy, -1-padded
    when fewer than ``k`` are found), through the cached ``ServingIndex``
    and the multi-expansion beam search (``expansions`` default 4).
    ``dtype`` downcasts the serving copy of the points (``torch.bfloat16``)
    or, with ``dtype="int8"``, serves the scalar-quantized packing."""
    sv = serving_index(index, x, dtype=dtype, device=device)
    return sv.search(queries, k=k, beam=beam,
                     expansions=4 if expansions is None else expansions,
                     iters=iters, query_chunk=query_chunk, with_stats=with_stats)
