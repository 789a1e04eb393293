"""Carry the reference's state into the port.

What crosses between the packages is the dataset, the RBC leaves, the
hyperplanes or sketches, the HashPrune reservoir, the built graph, a
serving packing, and an LM's parameters and train state.  These functions
take that state as numpy arrays (never objects of the JAX package) and
return the port's counterparts on ``device`` (default: the card);
``lm_to_arrays`` carries an LM tree back.  Leaves and
hyperplanes go straight to ``pipnn.build(leaves=..., hyperplanes=...)``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hashprune import Reservoir
from repro_torch.core.pipnn import PiPNNIndex, PiPNNParams
from repro_torch.core.serving import ServingIndex
from repro_torch.device import resolve_device
from repro_torch.launch.steps import TrainState, shard_train_state
from repro_torch.optim.adamw import AdamWState


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def _leaf(a: np.ndarray, device) -> torch.Tensor:
    """A parameter array as a tensor of the same dtype; bfloat16 (numpy's
    ``ml_dtypes`` kind) carried bit for bit."""
    a = np.array(a)   # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


STACKED = ("blocks", "enc_blocks", "dec_blocks")


def lm_from_arrays(params: dict, *, device=None) -> dict:
    """The port's parameter tree of an LM (``models.transformer``,
    ``ssm_lm``, ``hybrid`` or ``encdec``) from the reference's, given as
    numpy arrays: each stacked tree (``blocks``, ``enc_blocks``,
    ``dec_blocks``: every leaf on a leading [L, ...] axis) split into a
    list of one dict a layer; the rest (``embed``, the norms, the hybrid's
    ``shared`` block) carried as it is; each array kept in its dtype, on
    ``device``."""
    dev = resolve_device(device)

    def tree(node, pick=None):
        if isinstance(node, dict):
            return {k: tree(v, pick) for k, v in node.items()}
        a = np.asarray(node)
        return _leaf(a if pick is None else a[pick], dev)

    def n_layers(node) -> int:
        while isinstance(node, dict):
            node = next(iter(node.values()))
        return len(np.asarray(node))

    return {k: [tree(v, i) for i in range(n_layers(v))] if k in STACKED else tree(v)
            for k, v in params.items()}


def lm_to_arrays(tree: dict) -> dict:
    """The inverse of ``lm_from_arrays`` for a tree of the port's LM
    tensors (parameters, or their gradients or moments): each list of
    layers stacked on a leading [L, ...] axis as the reference keeps it,
    numpy on the host; bfloat16 widened to float32 (exactly: numpy has no
    bfloat16)."""

    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def tree_np(node):
        if isinstance(node, dict):
            return {k: tree_np(v) for k, v in node.items()}
        return leaf(node)

    def stack(layers):
        if isinstance(layers[0], dict):
            return {k: stack([lay[k] for lay in layers]) for k in layers[0]}
        return np.stack([leaf(t) for t in layers])

    return {k: stack(v) if k in STACKED else tree_np(v) for k, v in tree.items()}


def train_state_from_arrays(params: dict, opt, *, device=None, mesh=None, family: str = "",
                            policy: str = "fsdp_tp"):
    """The port's ``launch.steps.TrainState`` from the reference's, given
    as numpy arrays: ``params`` through ``lm_from_arrays``, ``opt`` (its
    AdamW state: ``step``, ``m``, ``v``, in that order) with the moments
    split the same way and the step an int32 scalar.  With ``mesh`` (an
    ``LMMesh``) the state is cut onto it under ``family``'s ``policy``
    rules (``steps.shard_train_state``) on ``mesh.device``."""
    dev = resolve_device(device if mesh is None else mesh.device)
    step, m, v = opt
    state = TrainState(params=lm_from_arrays(params, device=dev),
                       opt=AdamWState(step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                                                        device=dev),
                                      m=lm_from_arrays(m, device=dev),
                                      v=lm_from_arrays(v, device=dev)))
    return state if mesh is None else shard_train_state(state, mesh, family, policy)


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


def serving_index_from_arrays(graph, points, norms, start: int, *, scales=None,
                              metric: str = "l2", device=None) -> ServingIndex:
    """A ``ServingIndex`` holding a given packing as it is: [n, R] graph,
    [n, d] points (float32, or the int8 packing with its [n] float32
    ``scales``), [n] float32 norms and the entry point.  This serves the
    reference's own int8 packing without quantizing again."""
    dev = resolve_device(device)
    int8 = np.asarray(points).dtype == np.int8
    if int8 and scales is None:
        raise ValueError("int8 points need their scales")
    pts = _tensor(points, torch.int8 if int8 else torch.float32, dev)
    return ServingIndex(graph=_tensor(graph, torch.int32, dev), points=pts,
                        norms=_tensor(norms, torch.float32, dev), start=int(start),
                        metric=metric,
                        scales=None if scales is None else _tensor(scales, torch.float32, dev))
