"""Sharding rules of the LM parameters, batches and caches on a
("data", "model") mesh (counterpart of ``repro/distributed/sharding.py``).

The rules (``data_axes``, ``all_axes``, ``POLICIES``, ``_dim_ok``,
``_maybe``, ``param_spec``, ``batch_spec``, ``cache_spec``) are the
reference's, letter for letter.  They take a ``MeshShape`` (axis names and
sizes, standing in for a jax ``Mesh``) and return a spec: a plain tuple with
one entry a dimension, each ``None`` (replicated), an axis name or a tuple
of axis names (the dimension split over those axes, the first the major
one), entry for entry the reference's ``PartitionSpec``.

The port keeps each stacked tree of layers (``blocks``, ``enc_blocks``,
``dec_blocks``) as a list of one dict a layer, where the reference stacks
every leaf on a leading [L, ...] axis.  ``param_specs`` names a layer's
leaf by its path in the stacked tree (``blocks_ln1_scale``), computes its
spec at the stacked shape [n_layers, *shape] and drops the layer entry:
under ``fsdp`` a norm scale [28, 3584] is (None, ("data", "model")), so the
layer's [3584] is (("data", "model"),), where its own 1-D shape would give
().  Where the stacked spec splits the layer dimension itself (``spec2`` on
the 2-D stacked QKV biases under ``fsdp_tp``), the layer's leaf is kept
whole on every shard: its spec is all None.

``shard`` cuts one shard's block of a tensor, ``unshard`` puts the blocks
back together, and ``shard_params`` / ``unshard_params`` do so for a
parameter tree on an ``launch.mesh.LMMesh``.  The reference's
``params_shardings``, ``batch_shardings`` and ``cache_shardings`` build
jax ``NamedSharding``s and have no counterpart beyond ``param_specs``.

Training on the mesh (the last section): a leaf whose spec splits nothing
is one tensor that every local shard refers to, so autograd sums its
gradient over the local shards; a leaf split over some axes but
replicated over others is held as one copy a coordinate of those others.
``reduce_replicated`` sums each block's gradient over the axes its spec
does not split, counting a shared tensor once, so every copy ends with
the logical gradient; ``global_norm`` counts each logical element once;
``distinct_leaves`` lists each shared tensor once (the optimizer steps it
once).  ``logical_tree`` turns a mesh state back into the one-card tree
(a checkpoint), and ``Laid`` is a batch leaf cut onto the mesh.
"""
from __future__ import annotations

import math
import re
from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_flatten, tree_unflatten


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, all the rules read of a jax ``Mesh``."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def axes_of(entry) -> tuple[str, ...]:
    """The axes of one spec entry, major first: () for None."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def data_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def all_axes(mesh) -> tuple[str, ...]:
    return tuple(mesh.axis_names)


# The parallelism policies (ArchConfig.parallelism):
#   fsdp_tp: parameters FSDP over (pod, data) and tensor parallel over
#            `model` (attention heads, d_ff, vocabulary);
#   fsdp:    ZeRO-3, parameters over every axis, the batch over every axis
#            where it divides; the only collectives are per-layer weight
#            all-gathers;
#   ep_dp:   MoE expert stacks over `model`, everything else FSDP over
#            (pod, data), the batch over every axis where it divides.
POLICIES = ("fsdp_tp", "fsdp", "ep_dp")


def _dim_ok(dim: int, mesh, axes) -> bool:
    if isinstance(axes, str):
        axes = (axes,)
    size = int(math.prod([mesh.shape[a] for a in axes]))
    return dim % size == 0


def _maybe(dim: int, mesh, axes):
    """Shard dim over axes when divisible, else replicate that dim."""
    return axes if _dim_ok(dim, mesh, axes) else None


def param_spec(name: str, leaf: Any, mesh, family: str, policy: str = "fsdp_tp") -> tuple:
    """The spec of a flattened parameter name (the reference's stacked
    path, ``blocks_attn_wq_w``) and a leaf with its ``shape``."""
    da = data_axes(mesh)
    shape = tuple(leaf.shape)
    if len(shape) <= 1:
        return ()

    if policy in ("fsdp", "ep_dp"):
        # MoE expert stacks keep EP over `model` under ep_dp
        if policy == "ep_dp" and re.search(r"(w_gate|w_up|w_down)$", name) \
                and len(shape) == 4:
            return (None, _maybe(shape[1], mesh, "model"), _maybe(shape[2], mesh, da), None)
        # ZeRO-3: shard the largest dim over every available axis
        axes = all_axes(mesh) if policy == "fsdp" else da
        stacked = len(shape) >= 3
        lead = 1 if stacked else 0
        dims = shape[lead:]
        order = sorted(range(len(dims)), key=lambda i: -dims[i])
        spec = [None] * len(dims)
        for i in order:
            if _dim_ok(dims[i], mesh, axes):
                spec[i] = axes
                break
        else:
            if _dim_ok(dims[order[0]], mesh, da):
                spec[order[0]] = da
        return (None,) * lead + tuple(spec)

    def spec2(rows_axes, cols_axes, extra_lead=0):
        """Spec for a (maybe layer-stacked) 2D matrix."""
        return (None,) * extra_lead + (rows_axes, cols_axes)

    stacked = len(shape) >= 3   # leading layer dim
    lead = 1 if stacked else 0
    r, c = shape[-2], shape[-1]

    # embedding table [vocab, d]
    if "embed" in name and "table" in name:
        return (_maybe(r, mesh, "model"), _maybe(c, mesh, da))
    # MoE expert stacks [L, E, d, ff] / [L, E, ff, d]
    if re.search(r"(w_gate|w_up|w_down)$", name) and len(shape) == 4:
        e = shape[1]
        if _dim_ok(e, mesh, "model"):      # EP
            return (None, "model", _maybe(shape[2], mesh, da), None)
        # TP inside experts: shard the ff dim
        if "w_down" in name:
            return (None, None, _maybe(shape[2], mesh, "model"), _maybe(shape[3], mesh, da))
        return (None, None, _maybe(shape[2], mesh, da), _maybe(shape[3], mesh, "model"))
    # router [d, E]
    if "router" in name:
        return (None,) * lead + (_maybe(r, mesh, da), None)
    # attention projections: wq/wk/wv [.., d, H*hd]; wo [.., H*hd, d]
    if re.search(r"w[qkv]_w$|w[qkv]$", name) or "_wq" in name or \
            re.search(r"attn.*w[qkv]", name) or re.search(r"cross.*w[qkv]", name):
        return spec2(_maybe(r, mesh, da), _maybe(c, mesh, "model"), lead)
    if "wo" in name:
        return spec2(_maybe(r, mesh, "model"), _maybe(c, mesh, da), lead)
    # MLP [.., d, ff] up/gate ; [.., ff, d] down
    if "w_up" in name or "w_gate" in name:
        return spec2(_maybe(r, mesh, da), _maybe(c, mesh, "model"), lead)
    if "w_down" in name:
        return spec2(_maybe(r, mesh, "model"), _maybe(c, mesh, da), lead)
    # mamba in_proj [.., d, d_proj] / out_proj [.., d_inner, d]
    if "in_proj" in name:
        return spec2(_maybe(r, mesh, da), _maybe(c, mesh, "model"), lead)
    if "out_proj" in name:
        return spec2(_maybe(r, mesh, "model"), _maybe(c, mesh, da), lead)
    if "conv_w" in name:
        return (None,) * lead + (None, _maybe(c, mesh, "model"))
    # fallback: replicate
    return (None,) * len(shape)


def batch_spec(name: str, leaf: Any, mesh, policy: str = "fsdp_tp") -> tuple:
    da = data_axes(mesh)
    shape = tuple(leaf.shape)
    # fsdp / ep_dp: the model axis carries batch too (when divisible)
    axes = all_axes(mesh) if policy in ("fsdp", "ep_dp") else da
    if name == "positions":                       # [3, B, T]
        b_ax = axes if _dim_ok(shape[1], mesh, axes) else \
            (da if _dim_ok(shape[1], mesh, da) else None)
        return (None, b_ax, None)
    if len(shape) >= 1:
        if _dim_ok(shape[0], mesh, axes):
            return (axes,) + (None,) * (len(shape) - 1)
        if _dim_ok(shape[0], mesh, da):
            return (da,) + (None,) * (len(shape) - 1)
    return (None,) * len(shape)


def cache_spec(name: str, leaf: Any, mesh, policy: str = "fsdp_tp") -> tuple:
    """KV / SSM cache specs for serving: the batch over as many axes as
    divide it (all axes under the fsdp policies); an axis the batch leaves
    unused shards the sequence / head / channel dim."""
    shape = tuple(leaf.shape)
    if name == "index" or len(shape) == 0:
        return ()
    da = data_axes(mesh)
    aa = all_axes(mesh)

    def batch_and_rest(bdim: int):
        if policy in ("fsdp", "ep_dp") and _dim_ok(bdim, mesh, aa):
            return aa, None                 # batch takes everything
        b_ax = da if _dim_ok(bdim, mesh, da) else None
        rest = "model" if "model" in mesh.axis_names else None
        return b_ax, rest

    if name in ("k", "v", "cross_k", "cross_v"):  # [L, B, S, KV, hd]
        b_ax, rest = batch_and_rest(shape[1])
        return (None, b_ax, _maybe(shape[2], mesh, rest) if rest else None, None, None)
    if name == "conv":                            # [L, B, W-1, conv_dim]
        b_ax, rest = batch_and_rest(shape[1])
        return (None, b_ax, None, _maybe(shape[3], mesh, rest) if rest else None)
    if name == "ssm":                             # [L, B, H, P, N]
        b_ax, rest = batch_and_rest(shape[1])
        return (None, b_ax, _maybe(shape[2], mesh, rest) if rest else None, None, None)
    return (None,) * len(shape)


# ---------------------------------------------------------------------------
# The port's trees
# ---------------------------------------------------------------------------

STACKED = ("blocks", "enc_blocks", "dec_blocks")


class _Shape(NamedTuple):
    shape: tuple


def _layer_spec(name: str, shape: tuple, n_layers: int, mesh, family: str,
                policy: str) -> tuple:
    spec = param_spec(name, _Shape((n_layers,) + tuple(shape)), mesh, family, policy)
    if not spec:
        return (None,) * len(shape)
    if spec[0] is not None:
        return (None,) * len(shape)        # the layer dim is split: kept whole
    return spec[1:]


def part_specs(key: str, sub, n_layers: int, mesh, family: str, policy: str):
    """The specs of one top-level entry ``key`` of a parameter tree: each
    layer of a stacked list (``n_layers`` layers in all) at the stacked
    name and shape, its layer entry dropped (a split layer entry keeps the
    leaf whole); any other subtree at its own names and shapes."""
    if key in STACKED:
        return [tree_unflatten(layer, [_layer_spec(n, leaf.shape, n_layers, mesh, family, policy)
                                       for n, leaf in zip(*tree_flatten(layer, key))])
                for layer in sub]
    names, leaves = tree_flatten(sub, key)
    return tree_unflatten(sub, [param_spec(n, leaf, mesh, family, policy)
                                for n, leaf in zip(names, leaves)])


def param_specs(tree: dict, mesh, family: str, policy: str) -> dict:
    """The port's parameter tree (leaves with a ``shape``) -> the same tree
    of specs (``part_specs`` of each entry)."""
    return {key: part_specs(key, sub, len(sub) if key in STACKED else 0, mesh, family, policy)
            for key, sub in tree.items()}


def block_index(entry, mesh, coord: dict) -> tuple[int, int]:
    """(index, count) of the block a shard at ``coord`` ({axis: index})
    holds along a dimension of spec ``entry``: the axes' coordinates
    row-major, the first axis the major one."""
    idx, n = 0, 1
    for a in axes_of(entry):
        idx = idx * mesh.shape[a] + coord[a]
        n *= mesh.shape[a]
    return idx, n


def shard(tensor: torch.Tensor, spec: tuple, mesh, coord: dict) -> torch.Tensor:
    """The block of ``tensor`` the shard at ``coord`` holds under ``spec``:
    a copy with its own storage where it is a part (never a view, so an
    update in place of one shard's block writes no other's), the tensor
    itself where the spec splits nothing."""
    if len(spec) not in (0, tensor.dim()):
        raise ValueError(f"spec {spec} does not fit a tensor of shape {tuple(tensor.shape)}")
    out = tensor
    for dim, entry in enumerate(spec):
        idx, n = block_index(entry, mesh, coord)
        if n == 1:
            continue
        size = tensor.shape[dim]
        if size % n:
            raise ValueError(f"dim {dim} of {size} does not divide into {n} blocks ({spec})")
        out = out.narrow(dim, idx * (size // n), size // n)
    return out if out is tensor else out.clone(memory_format=torch.contiguous_format)


def coords(mesh) -> list[dict]:
    """Every shard's coordinate ({axis: index}), row-major over the axes."""
    out = [{}]
    for a in mesh.axis_names:
        out = [dict(c, **{a: i}) for c in out for i in range(mesh.shape[a])]
    return out


def unshard(blocks: list[torch.Tensor], spec: tuple, mesh) -> torch.Tensor:
    """The full tensor from every shard's block (``blocks`` in the order of
    ``coords(mesh)``); a replicated dimension is read from the first shard
    of its line."""
    cs = coords(mesh)
    shape = list(blocks[0].shape)
    for dim, entry in enumerate(spec):
        shape[dim] *= block_index(entry, mesh, cs[0])[1]
    full = blocks[0].new_empty(shape)
    for blk, c in zip(blocks, cs):
        view = full
        for dim, entry in enumerate(spec):
            idx, n = block_index(entry, mesh, c)
            if n > 1:
                view = view.narrow(dim, idx * blk.shape[dim], blk.shape[dim])
        view.copy_(blk)
    return full


# ---------------------------------------------------------------------------
# Parameters on a mesh
# ---------------------------------------------------------------------------

class MeshParams(NamedTuple):
    """A parameter tree on an ``LMMesh``: ``shards[j]`` is the tree of
    local shard ``mesh.local[j]``'s blocks (a leaf its spec splits nothing
    is the one tensor every local shard refers to), ``specs`` the tree of
    specs (``param_specs``)."""
    shards: list
    specs: dict
    mesh: Any
    policy: str


def spec_leaves(tree, specs) -> list:
    """The specs of ``tree``'s leaves in its order (``specs`` has the
    tree's structure, a spec tuple where the tree has a leaf)."""
    if isinstance(tree, dict):
        return [s for k in tree for s in spec_leaves(tree[k], specs[k])]
    if isinstance(tree, (list, tuple)):
        return [s for a, sp in zip(tree, specs) for s in spec_leaves(a, sp)]
    return [specs]


def _cut(sub, specs, mesh) -> list:
    """One subtree cut into each local shard's blocks."""
    leaves, specs_l = tree_flatten(sub)[1], spec_leaves(sub, specs)
    return [tree_unflatten(sub, [shard(t, s, mesh.shape, c) for t, s in zip(leaves, specs_l)])
            for c in mesh.local]


def shard_parts(parts, mesh, family: str, policy: str, n_layers: int) -> MeshParams:
    """``MeshParams`` from ``(key, subtree)`` pairs in the tree's order,
    each stacked list given one layer at a time as ``(key, [layer])``: each
    part is cut as it comes, so a caller that makes the parts one by one
    holds the blocks and one full part at a time."""
    shards = [{} for _ in mesh.local]
    specs = {}
    for key, sub in parts:
        sp = part_specs(key, sub, n_layers, mesh.shape, family, policy)
        cut = _cut(sub, sp, mesh)
        if key in STACKED:
            specs.setdefault(key, []).extend(sp)
            for tree, blk in zip(shards, cut):
                tree.setdefault(key, []).extend(blk)
        else:
            specs[key] = sp
            for tree, blk in zip(shards, cut):
                tree[key] = blk
    return MeshParams(shards=shards, specs=specs, mesh=mesh, policy=policy)


def shard_params(params: dict, mesh, family: str, policy: str) -> MeshParams:
    """A parameter tree (the same on every rank) cut into this rank's
    shards' blocks by ``param_specs``."""
    n_layers = max([len(v) for k, v in params.items() if k in STACKED] or [0])

    def parts():
        for key, sub in params.items():
            if key in STACKED:
                for layer in sub:
                    yield key, [layer]
            else:
                yield key, sub
    return shard_parts(parts(), mesh, family, policy, n_layers)


def gather(mesh, parts: list, spec: tuple, axes=("data", "model")) -> list:
    """Each local shard's block gathered over the mesh ``axes`` its
    ``spec`` splits (each dimension's minor axis first), one tensor a local
    shard.  A dimension split over axes outside ``axes`` stays split; its
    ``axes`` part must be the minor end of its entry."""
    for dim, entry in enumerate(spec):
        ax = axes_of(entry)
        sel = [a for a in ax if a in axes]
        if not sel:
            continue
        if tuple(sel) != ax[len(ax) - len(sel):]:
            raise ValueError(f"cannot gather {sel} alone out of the entry {entry}")
        for a in reversed(sel):
            parts = mesh.all_gather(parts, a, dim)
    return parts


def gather_tree(mesh, trees: list, specs, axes=("data", "model")) -> list:
    """``gather`` of every leaf of the local shards' ``trees`` (one tree a
    local shard, all of ``specs``' structure)."""
    flat = [tree_flatten(t)[1] for t in trees]
    spec_l = spec_leaves(trees[0], specs)
    cols = [gather(mesh, [f[i] for f in flat], s, axes) for i, s in enumerate(spec_l)]
    return [tree_unflatten(trees[j], [col[j] for col in cols]) for j in range(len(trees))]


def rest(spec: tuple, axes) -> tuple:
    """``spec`` with the mesh ``axes`` taken out of its entries: how a
    block gathered over ``axes`` stays split."""
    out = []
    for entry in spec:
        left = tuple(a for a in axes_of(entry) if a not in axes)
        out.append(None if not left else left[0] if len(left) == 1 else left)
    return tuple(out)


def rest_tree(tree, specs, axes):
    """``rest`` of every spec of ``specs`` (``tree``'s structure)."""
    return tree_unflatten(tree, [rest(s, axes) for s in spec_leaves(tree, specs)])


def unshard_params(mp: MeshParams) -> dict:
    """The full parameter tree back from ``mp`` (on every rank: each leaf
    gathered over every axis its spec splits)."""
    return gather_tree(mp.mesh, mp.shards, mp.specs)[0]


def shard_bytes(tree) -> int:
    """The bytes of one shard's tree of blocks."""
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[1])


# ---------------------------------------------------------------------------
# Training on a mesh
# ---------------------------------------------------------------------------

def split_axes(spec: tuple) -> set:
    """The mesh axes a spec splits some dimension over."""
    return {a for entry in spec for a in axes_of(entry)}


def distinct_leaves(mp: MeshParams):
    """(the distinct tensors of ``mp``'s local shards, each shared tensor
    once, in the order of the shards' leaves; ``rebuild(tensors)``: a
    ``MeshParams`` of ``mp``'s specs holding ``tensors`` in their places,
    shared as ``mp``'s are)."""
    index, uniq, where = {}, [], []
    for tree in mp.shards:
        w = []
        for t in tree_flatten(tree)[1]:
            if id(t) not in index:
                index[id(t)] = len(uniq)
                uniq.append(t)
            w.append(index[id(t)])
        where.append(w)

    def rebuild(tensors) -> MeshParams:
        return mp._replace(shards=[tree_unflatten(tree, [tensors[i] for i in w])
                                   for tree, w in zip(mp.shards, where)])
    return uniq, rebuild


def _each_once(parts: list, fn) -> list:
    memo = {}
    return [memo[id(p)] if id(p) in memo else memo.setdefault(id(p), fn(p)) for p in parts]


def reduce_replicated(grads: list, mesh, specs) -> list:
    """Each block's gradient summed over the mesh axes its spec does not
    split (in float32, back to its dtype), a tensor that local shards share
    counted once, so every copy of a block holds the logical gradient.
    ``grads`` holds one tree a local shard (``specs``' structure)."""
    flat = [tree_flatten(t)[1] for t in grads]
    cols = []
    for i, spec in enumerate(spec_leaves(grads[0], specs)):
        parts = [f[i] for f in flat]
        axes = [a for a in mesh.shape.axis_names
                if a not in split_axes(spec) and mesh.shape.shape[a] > 1]
        if axes:
            dtype = parts[0].dtype
            parts = _each_once(parts, lambda t: t.float())
            for a in axes:
                parts = mesh.psum_distinct(parts, a)
            parts = _each_once(parts, lambda t: t.to(dtype))
        cols.append(parts)
    return [tree_unflatten(tree, [col[j] for col in cols]) for j, tree in enumerate(grads)]


def global_norm(blocks: list, specs, mesh) -> torch.Tensor:
    """The float32 L2 norm of the logical tree whose blocks the local
    shards hold (one tree a local shard): each shard sums the squares of
    its blocks, a block replicated over some axes only at coordinate 0 of
    them, and the sums are summed over the mesh."""
    spec_l = spec_leaves(blocks[0], specs)
    parts = []
    for tree, c in zip(blocks, mesh.local):
        total = torch.zeros((), dtype=torch.float32, device=tree_flatten(tree)[1][0].device)
        for t, spec in zip(tree_flatten(tree)[1], spec_l):
            if all(c[a] == 0 for a in mesh.shape.axis_names if a not in split_axes(spec)):
                total = total + torch.sum(torch.square(t.float()))
        parts.append(total)
    return torch.sqrt(mesh.psum(mesh.psum(parts, "model"), "data")[0])


@torch.no_grad()
def logical_tree(tree):
    """``tree`` (a dict, list or NamedTuple such as a train state) with
    each ``MeshParams`` in it replaced by its full tree
    (``unshard_params``: a gather on every rank, so every rank calls it)."""
    if isinstance(tree, MeshParams):
        return unshard_params(tree)
    if isinstance(tree, dict):
        return {k: logical_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[logical_tree(v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(logical_tree(v) for v in tree)
    return tree


class Laid(NamedTuple):
    """A batch leaf laid out on an LM mesh: ``parts[j]`` local shard j's
    block under ``spec`` (the counterpart of a leaf pinned to a
    ``NamedSharding``)."""
    parts: list
    spec: tuple

    def micro(self, i: int) -> "Laid":
        """Microbatch ``i`` of a leaf stacked [n_micro, ...]."""
        return Laid([p[i] for p in self.parts], self.spec[1:])
