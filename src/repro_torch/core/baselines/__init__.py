"""Paper baselines (Sec. 5): Vamana (DiskANN), HNSW, HCNNG (counterpart of
``repro/core/baselines``).

These are the incremental, beam-search-driven builders whose search
bottleneck PiPNN removes.  They are host algorithms by nature
(pointer-chasing over a mutable graph) with vectorised numpy distance
math; the same numpy seeds give the reference's graphs.  Each takes
``device=`` as every entry point does (default the card, raising without
one); only HCNNG puts work there, its leaf distance matrices.
"""
from repro_torch.core.baselines.hcnng import HCNNGParams, build_hcnng
from repro_torch.core.baselines.hnsw import HNSWParams, build_hnsw
from repro_torch.core.baselines.vamana import VamanaParams, build_vamana

__all__ = [
    "VamanaParams", "build_vamana",
    "HNSWParams", "build_hnsw",
    "HCNNGParams", "build_hcnng",
]
