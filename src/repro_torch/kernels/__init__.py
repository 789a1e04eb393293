"""Hand-written CUDA kernels of the port, one wrapper module each.

Each wrapper module holds the wrapper that launches its kernel, the plain
PyTorch version of the same function, a ``launches`` counter and a note on
the TPU kernel it replaces.  A wrapper takes the plain version only for
CPU tensors; for CUDA tensors it launches the kernel or raises.  The CUDA
sources are in ``csrc/`` and are built at first use (``_build``).
"""
from __future__ import annotations

from repro_torch.kernels import edge_hash, gather_distance, leaf_knn, segmented_merge

_MODULES = {"leaf_knn": leaf_knn, "edge_hash": edge_hash,
            "segmented_merge": segmented_merge, "gather_distance": gather_distance}


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: mod.launches for name, mod in _MODULES.items()}
