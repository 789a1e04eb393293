"""Elastic restore: any checkpoint onto any LM mesh (counterpart of
``repro/distributed/elastic.py``).

Checkpoints hold logical (one-card) arrays (``checkpoint.Checkpointer``
saves a mesh state so), so growing or shrinking the mesh is a restart
with another ``--model-parallel``: ``restore_to_mesh`` hands
``Checkpointer.restore`` a ``shard_fn`` that cuts each leaf of a
parameter tree into this rank's shards' blocks by the family's rules
(``sharding.param_specs``) as it is read, so the card receives only the
blocks.  ``data_shard_slice`` is each data rank's batch after a re-scale.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.distributed.sharding import (MeshParams, data_axes, param_specs, shard,
                                              spec_leaves)
from repro_torch.tree import tree_flatten, tree_map


def _is_params(node) -> bool:
    """A parameter tree (or a moment of one): an LM tree has an ``embed``."""
    return isinstance(node, dict) and "embed" in node


class _Blocks:
    """One leaf's blocks, one a local shard (a leaf of the tree module)."""

    def __init__(self, parts: list):
        self.parts = parts


def _walk(like, prefix: str, fn):
    """``fn(subtree, prefix)`` of each parameter tree in ``like``."""
    if _is_params(like):
        fn(like, prefix)
        return
    if isinstance(like, dict):
        items = like.items()
    elif isinstance(like, tuple) and hasattr(like, "_fields"):
        items = zip(like._fields, like)
    elif isinstance(like, (list, tuple)):
        items = enumerate(like)
    else:
        return
    for key, child in items:
        _walk(child, f"{prefix}_{key}" if prefix else str(key), fn)


def _rebuild(like, got, mesh, family: str, policy: str):
    if _is_params(like):
        specs = param_specs(like, mesh.shape, family, policy)
        return MeshParams(shards=[tree_map(lambda b: b.parts[j], got)
                                  for j in range(mesh.n_local)],
                          specs=specs, mesh=mesh, policy=policy)
    if isinstance(like, dict):
        return {k: _rebuild(like[k], got[k], mesh, family, policy) for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*[_rebuild(a, b, mesh, family, policy) for a, b in zip(like, got)])
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(a, b, mesh, family, policy) for a, b in zip(like, got))
    return got


def restore_to_mesh(checkpointer, step: int, like: Any, mesh, family: str,
                    policy: str = "fsdp_tp") -> tuple[Any, dict]:
    """Checkpoint ``step`` restored onto ``mesh`` (an ``LMMesh``):
    ``like`` is the one-card structure (a train state or a parameter tree,
    e.g. on the ``meta`` device); each parameter tree in it (the
    parameters and AdamW's moments) comes back as ``MeshParams`` of this
    rank's blocks on ``mesh.device`` (a leaf whose spec splits nothing as
    one tensor the local shards share), every other leaf (the step) as one
    tensor there.  Returns (state, extra)."""
    spec_by_name = {}

    def note(tree, prefix):
        specs = param_specs(tree, mesh.shape, family, policy)
        for name, spec in zip(tree_flatten(tree, prefix)[0], spec_leaves(tree, specs)):
            spec_by_name[name] = spec

    _walk(like, "", note)

    def shard_fn(name: str, t: torch.Tensor):
        spec = spec_by_name.get(name)
        if spec is None:
            return t.to(mesh.device)
        moved = {}
        parts = [shard(t, spec, mesh.shape, c) for c in mesh.local]
        return _Blocks([moved.setdefault(id(p), p.to(mesh.device)) for p in parts])

    tree, extra = checkpointer.restore(step, like, shard_fn=shard_fn)
    return _rebuild(like, tree, mesh, family, policy), extra


def data_shard_slice(global_batch: int, mesh) -> int:
    """Each data rank's batch after a re-scale (the pipeline's re-split):
    ``global_batch`` over the data axes' size; ``ValueError`` where it does
    not divide."""
    ranks = math.prod(mesh.shape.shape[a] for a in data_axes(mesh.shape))
    if global_batch % ranks:
        raise ValueError(f"a global batch of {global_batch} does not split over {ranks} "
                         "data ranks")
    return global_batch // ranks
