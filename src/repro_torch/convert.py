"""Carry the reference's state into the port.

The system has no weights; what crosses between the packages is the
dataset, the RBC leaves, the hyperplanes or sketches, the HashPrune
reservoir and the built graph.  These functions take that state as numpy
arrays (never objects of the JAX package) and return the port's
counterparts on ``device`` (default: the card).  Leaves and hyperplanes go
straight to ``pipnn.build(leaves=..., hyperplanes=...)``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hashprune import Reservoir
from repro_torch.core.pipnn import PiPNNIndex, PiPNNParams
from repro_torch.device import resolve_device


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def index_from_arrays(graph, dists, start: int, *, metric: str = "l2",
                      params: PiPNNParams | None = None, device=None) -> PiPNNIndex:
    """A servable ``PiPNNIndex`` from a built graph ([n, R] ids with -1
    padding, [n, R] dists, entry point)."""
    dev = resolve_device(device)
    params = (params or PiPNNParams()).with_(metric=metric)
    return PiPNNIndex(graph=_tensor(graph, torch.int32, dev),
                      dists=_tensor(dists, torch.float32, dev), start=int(start),
                      params=params, timings={}, stats={})


def reservoir_from_arrays(ids, hashes, dists, device=None) -> Reservoir:
    """A HashPrune reservoir from its three [n, l_max] arrays."""
    dev = resolve_device(device)
    return Reservoir(ids=_tensor(ids, torch.int32, dev),
                     hashes=_tensor(hashes, torch.int32, dev),
                     dists=_tensor(dists, torch.float32, dev))
