"""Hand-written CUDA kernels of the port, one wrapper module each.

Each wrapper module holds the wrapper that launches its kernel, the plain
PyTorch version of the same function, a ``launches`` counter and a note on
the TPU kernel it replaces.  A wrapper takes the plain version only for
CPU tensors; for CUDA tensors it launches the kernel or raises.  The CUDA
sources are in ``csrc/`` and are built at first use (``_build``).
"""
from __future__ import annotations

from repro_torch.kernels import (distance, edge_hash, gather_distance, gather_distance_int8,
                                 leaf_knn, segmented_merge, topk)

# counter name -> (wrapper module, the attribute its wrapper counts in);
# ``distance`` holds two kernels, so it has two counters
_MODULES = {"leaf_knn": (leaf_knn, "launches"),
            "edge_hash": (edge_hash, "launches"),
            "segmented_merge": (segmented_merge, "launches"),
            "gather_distance": (gather_distance, "launches"),
            "gather_distance_int8": (gather_distance_int8, "launches"),
            "pairwise_distance": (distance, "launches"),
            "pairwise_distance_int8": (distance, "launches_int8"),
            "rowwise_topk": (topk, "launches")}


def reset_launch_counts() -> None:
    for mod, attr in _MODULES.values():
        setattr(mod, attr, 0)


def launch_counts() -> dict[str, int]:
    return {name: getattr(mod, attr) for name, (mod, attr) in _MODULES.items()}
