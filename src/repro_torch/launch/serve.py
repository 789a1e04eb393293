"""ANN retrieval for a serving stack (counterpart of ``Retriever`` in
``repro/launch/serve.py``).

``Retriever`` wraps a PiPNN index and its corpus embeddings as a packed
``ServingIndex`` on the device, so each ``retrieve`` moves only the query
embeddings in and the ids out.  ``points_dtype`` picks the precision of the
corpus copy: "f32" (exact), "bf16" (half the footprint) or "int8" (the
scalar-quantized packing, about a quarter, with exact norm terms).
``n_shards`` serves through the sharded packing
(``distributed.serving.ShardedServingIndex``), all shards on one device;
``mesh`` (a ``launch.mesh.ShardMesh``) spreads it over the mesh's ranks,
each constructing the ``Retriever`` and calling ``retrieve`` alike.

The reference module's LM ``Server`` is template scaffolding and is not
ported.
"""
from __future__ import annotations

import numpy as np
import torch

RETRIEVER_DTYPES = ("f32", "bf16", "int8")


class Retriever:
    """Device-resident ANN retrieval over ``corpus_emb`` [n, d].

    ``index`` is a prebuilt ``PiPNNIndex``; without one the corpus is built
    here, with ``build_params`` or, by default, the reference's MIPS
    settings (c_max 256, c_min 32, fanout (4, 2), leaf k 2, max_deg 32,
    ``final_prune`` off for MIPS, ``seed``).  ``metric`` defaults to the
    index's (or ``build_params``') own, and to "mips" for the default
    build; one that disagrees raises ``ValueError``.  ``device`` defaults
    to the card and raises without one; with ``mesh`` the device is the
    mesh's and ``device`` must be None."""

    def __init__(self, corpus_emb, index=None, *, points_dtype: str = "f32",
                 metric: str | None = None, build_params=None, seed: int = 0,
                 n_shards: int | None = None, mesh=None, device=None):
        from repro_torch.core import pipnn
        from repro_torch.core.serving import ServingIndex

        if mesh is not None and device is not None:
            raise ValueError(f"a Retriever on a mesh runs on mesh.device; device={device!r} "
                             "is not taken")
        if points_dtype not in RETRIEVER_DTYPES:
            raise ValueError(f"points_dtype must be one of {RETRIEVER_DTYPES}, "
                             f"got {points_dtype!r}")
        if index is not None:
            if metric is not None and index.params.metric != metric:
                raise ValueError(f"metric={metric!r} does not match the prebuilt "
                                 f"index's metric={index.params.metric!r}")
        elif build_params is not None:
            if metric is not None and build_params.metric != metric:
                raise ValueError(f"metric={metric!r} does not match "
                                 f"build_params.metric={build_params.metric!r}")
        elif metric is None:
            metric = "mips"
        if index is None:
            from repro_torch.core.leaf import LeafParams
            from repro_torch.core.rbc import RBCParams

            if build_params is None:
                # MIPS alpha-pruning over-sparsifies hub-structured graphs:
                # keep the HashPrune reservoir as it is for MIPS
                build_params = pipnn.PiPNNParams(
                    rbc=RBCParams(c_max=256, c_min=32, fanout=(4, 2)),
                    leaf=LeafParams(k=2), metric=metric, max_deg=32,
                    final_prune=(metric != "mips"), seed=seed)
            index = pipnn.build(corpus_emb, build_params,
                                device=device if mesh is None else mesh.device)
        self.index = index
        dtype = {"f32": None, "bf16": torch.bfloat16, "int8": "int8"}[points_dtype]
        self.points_dtype = points_dtype
        self.sv = ServingIndex.from_index(index, corpus_emb, dtype=dtype, device=device,
                                          n_shards=n_shards, mesh=mesh)

    def retrieve(self, q_emb: np.ndarray, *, k: int = 2, beam: int = 32) -> np.ndarray:
        """Top-k corpus ids [Q, k] (int64) for a batch of query embeddings.
        ``k``/``beam`` below 1 raise ``ValueError``, NaN/Inf rows an
        ``InvalidQueryError`` naming them."""
        from repro_torch.core.validation import validate_queries, validate_search_params

        validate_search_params(k=k, beam=beam)
        q = validate_queries(q_emb, dim=int(self.sv.points.shape[-1]))
        return self.sv.search(q, k=k, beam=beam)

    def device_bytes(self) -> int:
        return self.sv.device_bytes()
