"""Device-resident query serving (counterpart of ``repro/core/serving.py``).

``ServingIndex`` packs what the query path touches onto the device once:
the [n, R] int32 adjacency, the [n, d] points, their metric norms
(``metrics.point_norms``, always float32 and computed from the float32
points) and the entry point.  The points are float32, a downcast copy
(``dtype=torch.bfloat16``), or with ``dtype="int8"`` the scalar-quantized
packing: int8 rows and [n] float32 per-point scales
(``kernels.gather_distance_int8.quantize_symmetric``), a quarter of the
float32 points' bytes, with the norm half of every distance kept exact.
A ``search`` call then moves nothing but the queries in and the ids out
(``core.transfers``), and runs the multi-expansion beam search
(``beam_search.beam_search_batch``).  The reference's VMEM-vs-HBM kernel
selection has no counterpart on the card: one gather kernel reads the
points from device memory, and ``search(kernel_path=)`` keeps the
reference's names (``beam_search.resolve_kernel_path``).

``from_graph(..., n_shards=S)`` / ``from_index(..., n_shards=S)`` pack a
``distributed.serving.ShardedServingIndex`` instead: S partition-aligned
shards with a 1-hop halo, all on one device, their results merged across
shards; ``mesh=`` (a ``launch.mesh.ShardMesh``, the reference's ``mesh=``)
spreads them over the mesh's ranks.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import beam_search as _bs
from repro_torch.core.metrics import point_norms
from repro_torch.core.transfers import to_device, to_host
from repro_torch.core.validation import validate_queries, validate_search_params
from repro_torch.device import resolve_device
from repro_torch.kernels.gather_distance_int8 import quantize_symmetric


def _is_int8(dtype) -> bool:
    """True for the scalar-quantized packing request: the string ``"int8"``
    or any spelling of the int8 dtype (``torch.int8``, ``np.int8``, ...)."""
    if dtype is None:
        return False
    if isinstance(dtype, str):
        return dtype == "int8"
    if isinstance(dtype, torch.dtype):
        return dtype == torch.int8
    try:
        return np.dtype(dtype) == np.int8
    except TypeError:
        return False


def merge_block_workspace_bytes(m: int, l: int) -> int:
    """Modeled device bytes one query row of ``beam_search.merge_block``
    holds at its peak, folding ``m`` candidates into an ``l``-wide beam:
    13 B a candidate held throughout (the block's masked distances and
    valid flags, and its id order, then its ranks) beside, first, the
    dist sort's keys, values, indices and composed order (24 B a
    candidate), then the three [l, m] buffers of its cross counts: the
    comparison mask, its masked copy and the int64 copy the row sum makes
    (10 B a pair).  Linear in ``m``: no [m, m] buffer."""
    return max(10 * l * m, 24 * m) + 13 * m


def engine_workspace_bytes(nq: int, n: int, d: int, r: int, beam: int,
                           expansions: int) -> int:
    """Modeled device temp bytes of one ``beam_search._beam_search_multi``
    run over a chunk of ``nq`` queries on the card, per query: a step's
    candidate block of E = ``expansions`` x R ids (the neighbour rows, their
    mask, the candidate ids and the gather kernel's distances: 13 B a
    candidate, and 28 B an expansion for its picks), one ``merge_block``
    of R candidates into the beam (``merge_block_workspace_bytes``) and the
    beam state, old and new (ids, dists, visited: 9 B a slot, each).
    Chunk-shaped: the index (``n``, ``d``) is argument, and the kernel
    gathers no [nq, E*R, d] block, so neither appears."""
    c = expansions * r
    cand = 13 * c + 28 * expansions
    state = 2 * 9 * (beam + 1) + 16
    return nq * (cand + merge_block_workspace_bytes(r, beam) + state)


def _to_device(a, dtype, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype).contiguous()
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


@dataclasses.dataclass
class ServingIndex:
    graph: torch.Tensor    # [n, R] int32, -1 padded, on the device
    points: torch.Tensor   # [n, d] on the device (float32, downcast or int8)
    norms: torch.Tensor    # [n] float32 point norms (metrics.point_norms)
    start: int             # entry point (medoid)
    metric: str = "l2"
    scales: torch.Tensor | None = None   # [n] float32 scales (int8 packing)

    @property
    def n(self) -> int:
        return self.graph.shape[0]

    @property
    def device(self) -> torch.device:
        return self.points.device

    def device_bytes(self) -> int:
        """Device-resident footprint of the packing (graph + points + norms,
        plus the per-point scales on the int8 packing)."""
        parts = (self.graph, self.points, self.norms) + (
            () if self.scales is None else (self.scales,))
        return sum(t.numel() * t.element_size() for t in parts)

    @classmethod
    def from_graph(cls, graph, x, start: int, *, metric: str = "l2", dtype=None,
                   device=None, n_shards: int | None = None, mesh=None, **shard_kw):
        """Pack an adjacency matrix and its points (numpy arrays or tensors)
        onto ``device`` (default: the card, raising without one).

        ``dtype`` (e.g. ``torch.bfloat16``) downcasts the points copy;
        ``dtype="int8"`` (or ``torch.int8``, ``np.int8``) packs the
        scalar-quantized copy.  Either way the norms are computed from the
        float32 points first.  ``n_shards`` or ``mesh`` packs a
        ``distributed.serving.ShardedServingIndex`` instead, and the
        shard-only options (``router``, ``n_probes``, ``seed``, ``halo``)
        pass through to it; without either they raise ``TypeError``."""
        if n_shards is not None or mesh is not None:
            from repro_torch.distributed.serving import ShardedServingIndex

            return ShardedServingIndex.from_graph(graph, x, start, n_shards=n_shards,
                                                  mesh=mesh, metric=metric, dtype=dtype,
                                                  device=device, **shard_kw)
        if shard_kw:
            raise TypeError(f"single-device serving does not accept {sorted(shard_kw)} "
                            "(options of the sharded packing, n_shards=)")
        dev = resolve_device(device)
        points = _to_device(x, torch.float32, dev)
        norms = point_norms(points, metric)
        scales = None
        if _is_int8(dtype):
            points, scales = quantize_symmetric(points)
        elif dtype is not None:
            points = points.to(dtype)
        return cls(graph=_to_device(graph, torch.int32, dev), points=points,
                   norms=norms, start=int(start), metric=metric, scales=scales)

    @classmethod
    def from_index(cls, index, x, *, dtype=None, device=None, n_shards: int | None = None,
                   mesh=None, **shard_kw):
        """Pack a ``PiPNNIndex`` over its dataset ``x`` (sharded with
        ``n_shards`` or ``mesh``)."""
        return cls.from_graph(index.graph, x, index.start, metric=index.params.metric,
                              dtype=dtype, device=device, n_shards=n_shards, mesh=mesh,
                              **shard_kw)

    def search(self, queries, *, k: int = 10, beam: int = 32, expansions: int = 4,
               iters: int | None = None, early_exit: bool = True,
               kernel_path: str | None = None, query_chunk: int | None = None,
               with_stats: bool = False):
        """Serve a query batch; returns [Q, k] neighbour ids (int64 numpy,
        -1-padded when fewer than ``k`` are found).

        ``query_chunk`` bounds the batch per engine run; a short last chunk
        is zero-padded to the chunk's shape, as in the reference.
        ``kernel_path`` (None | "vmem" | "hbm" | "xla") picks the gather as
        ``beam_search.resolve_kernel_path`` says.  ``with_stats=True`` also
        returns per-query ``hops``, ``dist_comps`` and ``converged``
        telemetry and the ``kernel_path`` that ran.  NaN/Inf rows, a wrong
        width, or ``k``/``beam`` below 1 raise at this boundary."""
        iters_cap = int(iters if iters is not None else _bs.default_iters(beam))
        path = _bs.resolve_kernel_path(self.points, kernel_path)

        def run(qt):
            ids, _, hops, comps, conv = _bs.beam_search_batch(
                self.graph, self.points, qt, start=self.start, beam=beam, iters=iters_cap,
                metric=self.metric, expansions=expansions, norms=self.norms,
                scales=self.scales, early_exit=early_exit, with_stats=True, kernel_path=path)
            return ids, hops, comps, conv

        out = serve_chunks(queries, run, k=k, beam=beam, dim=int(self.points.shape[1]),
                           device=self.device, query_chunk=query_chunk,
                           with_stats=with_stats)
        if with_stats:
            out[1].update(expansions=int(expansions), iters_cap=iters_cap, kernel_path=path)
        return out


def serve_chunks(queries, run, *, k: int, beam: int, dim: int, device,
                 query_chunk: int | None, with_stats: bool):
    """The host side of a ``search`` call, shared by ``ServingIndex`` and
    ``distributed.serving.ShardedServingIndex``: validate ``k``, ``beam``,
    ``query_chunk`` and the queries, cut them into chunks of
    ``query_chunk`` (zero-padding a short chunk to it), hand each chunk to
    ``run`` on the device, and cut its padded rows off again.

    ``run(queries [chunk, d] tensor)`` returns device tensors (ids [chunk,
    >= 1], hops, dist_comps, converged [chunk]).  Returns [Q, k] int64 ids
    (-1-padded) and, with ``with_stats``, the dict of the three per-query
    telemetry arrays.  A chunk crosses the host boundary once in (the
    queries) and once out (the ids), three more times out with stats."""
    validate_search_params(k=k, beam=beam)
    if query_chunk is not None and int(query_chunk) <= 0:
        raise ValueError(f"query_chunk must be >= 1, got {query_chunk}")
    q = validate_queries(queries, dim=dim)
    nq = q.shape[0]
    keys = ("hops", "dist_comps", "converged")
    parts: dict[str, list] = {"ids": [np.full((0, k), -1)], "hops": [np.empty(0, np.int32)],
                              "dist_comps": [np.empty(0, np.int32)],
                              "converged": [np.empty(0, bool)]}
    chunk = int(query_chunk) if query_chunk else max(nq, 1)
    for s in range(0, nq, chunk):
        qc = q[s: s + chunk]
        take = qc.shape[0]
        if take < chunk:
            qc = np.pad(qc, ((0, chunk - take), (0, 0)))
        ids, *tele = run(to_device(qc, device))
        parts["ids"].append(_bs.pad_ids(to_host(ids)[:take], k))
        if with_stats:
            for key, val in zip(keys, tele):
                parts[key].append(to_host(val)[:take])
    out = np.concatenate(parts["ids"]).astype(np.int64)
    if not with_stats:
        return out
    return out, {key: np.concatenate(parts[key]) for key in keys}
