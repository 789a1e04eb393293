"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the reference's ``repro.distributed.sharding``, and its blocks.

- ``param_spec``, ``batch_spec`` and ``cache_spec`` equal the reference's
  for every leaf of all ten archs (full and smoke configs, abstract shapes
  from the reference's ``jax.eval_shape(model.init, ...)``), under each
  policy, on the meshes (1, 2), (1, 4), (1, 8), (2, 2), (16, 16) and
  (2, 16, 16) built as ``AbstractMesh``es the way ``tests/test_policies.py``
  builds them.  jax 0.9's ``PartitionSpec`` writes a one-axis tuple entry
  as the axis name; entries are compared as tuples of axis names.
- ``param_specs`` of the port's tree of per-layer dicts: each layer's spec
  is the stacked leaf's without its layer entry, or all None where the
  stacked spec splits the layer dimension.
- ``shard`` / ``unshard`` round trips, ``shard_params`` / ``unshard_params``
  bit for bit, each shard holding only its blocks, and the LM mesh's
  exchanges and layouts.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs.registry import ARCH_IDS, get_config
from repro.distributed import sharding as J
from repro.models import model_zoo as j_zoo
from repro_torch.configs import registry
from repro_torch.distributed import sharding as T
from repro_torch.launch import mesh as lm
from repro_torch.tree import tree_flatten

MESHES = [((1, 2), ("data", "model")), ((1, 4), ("data", "model")),
          ((1, 8), ("data", "model")), ((2, 2), ("data", "model")),
          ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]


def _abstract_mesh(sizes, names):
    try:
        return AbstractMesh(sizes, names)          # jax >= 0.5
    except TypeError:
        return AbstractMesh(tuple(zip(names, sizes)))  # jax 0.4.x


def _norm(spec) -> tuple:
    return tuple(T.axes_of(e) for e in spec)


_SHAPES = {}


def _ref_leaves(arch_id: str, smoke: bool):
    """(stacked name, abstract leaf) of the reference's parameters."""
    key = (arch_id, smoke)
    if key not in _SHAPES:
        arch = get_config(arch_id)
        m = j_zoo.build(arch.smoke_model if smoke else arch.model, arch.family)
        flat, _ = jax.tree_util.tree_flatten_with_path(
            jax.eval_shape(m.init, jax.random.PRNGKey(0)))
        _SHAPES[key] = [("_".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path),
                         leaf) for path, leaf in flat]
    return _SHAPES[key]


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_param_spec_equals_reference(arch_id):
    family = get_config(arch_id).family
    n = 0
    for sizes, names in MESHES:
        am, ms = _abstract_mesh(sizes, names), T.MeshShape(names, sizes)
        for smoke in (True, False):
            for name, leaf in _ref_leaves(arch_id, smoke):
                for policy in T.POLICIES:
                    want = J.param_spec(name, leaf, am, family, policy)
                    got = T.param_spec(name, leaf, ms, family, policy)
                    assert len(got) == len(want), (name, policy, sizes)
                    assert _norm(got) == _norm(want), (name, leaf.shape, policy, sizes)
                    n += 1
    assert n > 0


class _Leaf:
    def __init__(self, shape):
        self.shape = tuple(shape)


_TREES = {}


def _port_shape_tree(arch_id: str, smoke: bool) -> dict:
    """The port's parameter tree of abstract leaves: each stacked leaf
    split into one dict a layer."""
    if (arch_id, smoke) in _TREES:
        return _TREES[(arch_id, smoke)]
    tree = _TREES[(arch_id, smoke)] = {}
    arch = get_config(arch_id)
    m = j_zoo.build(arch.smoke_model if smoke else arch.model, arch.family)
    shapes = jax.eval_shape(m.init, jax.random.PRNGKey(0))

    def conv(node, stacked):
        if isinstance(node, dict):
            return {k: conv(v, stacked) for k, v in node.items()}
        return _Leaf(node.shape[1:] if stacked else node.shape)

    for key, sub in shapes.items():
        if key in T.STACKED:
            n_layers = jax.tree.leaves(sub)[0].shape[0]
            tree[key] = [conv(sub, True) for _ in range(n_layers)]
        else:
            tree[key] = conv(sub, False)
    return tree


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_param_specs_of_the_port_tree(arch_id):
    """Each per-layer leaf's spec is the reference's stacked spec without
    its layer entry; a split layer entry keeps the leaf whole."""
    arch = get_config(arch_id)
    for sizes, names in MESHES[:5]:
        am, ms = _abstract_mesh(sizes, names), T.MeshShape(names, sizes)
        for policy in (arch.parallelism, "fsdp_tp"):
            for smoke in (True, False):
                ref = dict(_ref_leaves(arch_id, smoke))
                specs = T.param_specs(_port_shape_tree(arch_id, smoke), ms, arch.family, policy)
                for key, sub in specs.items():
                    layers = sub if key in T.STACKED else [sub]
                    for layer in layers:
                        names_l = tree_flatten(_as_names(layer), key)[0]
                        for name, spec in zip(names_l, T.spec_leaves(_as_names(layer),
                                                                     layer)):
                            want = tuple(J.param_spec(name, ref[name], am, arch.family, policy))
                            if key in T.STACKED:
                                want = (want or (None,) * (len(spec) + 1))
                                want = (None,) * len(spec) if want[0] is not None else want[1:]
                            assert _norm(spec) == _norm(want), (name, policy, sizes)


def _as_names(specs):
    """A tree of the specs' structure whose leaves are 0 (a spec tuple is
    one leaf)."""
    if isinstance(specs, dict):
        return {k: _as_names(v) for k, v in specs.items()}
    return 0


def test_the_stacked_traps():
    """Under fsdp a stacked norm scale [28, 3584] is sharded (its 1-D layer
    shape alone would give ()); under fsdp_tp the 2-D stacked QKV bias's
    layer dim is split, so each layer's bias stays whole."""
    ms = T.MeshShape(("data", "model"), (16, 16))
    tree = _port_shape_tree("qwen2-7b", False)
    specs = T.param_specs(tree, ms, "dense", "fsdp")
    assert _norm(specs["blocks"][0]["ln1"]["scale"]) == (("data", "model"),)
    assert T.param_spec("blocks_ln1_scale", _Leaf((3584,)), ms, "dense", "fsdp") == ()
    ms = T.MeshShape(("data", "model"), (2, 16))
    tp = T.param_specs(tree, ms, "dense", "fsdp_tp")
    assert T.param_spec("blocks_attn_wq_b", _Leaf((28, 3584)), ms, "dense", "fsdp_tp") == \
        (("data",), "model")
    assert tp["blocks"][0]["attn"]["wq"]["b"] == (None,)
    assert _norm(tp["blocks"][0]["attn"]["wq"]["w"]) == (("data",), ("model",))
    assert _norm(tp["embed"]["table"]) == (("model",), ("data",))


BATCH_SHAPES = {"tokens": [(256, 4096), (32, 4096), (8, 64), (3, 7), (1, 5)],
                "labels": [(256, 4096), (2, 9)], "positions": [(3, 256, 64), (3, 2, 8)],
                "frames": [(32, 100, 384)]}
CACHE_SHAPES = {"k": [(28, 128, 32768, 8, 128), (2, 4, 20, 2, 8), (2, 3, 21, 1, 8)],
                "v": [(2, 32, 1024, 8, 64)], "cross_k": [(4, 8, 1500, 6, 64)],
                "conv": [(24, 8, 3, 1792), (2, 3, 3, 96)], "ssm": [(24, 8, 24, 64, 128)],
                "index": [()]}


@pytest.mark.parametrize("policy", ["fsdp_tp", "fsdp", "ep_dp"])
def test_batch_and_cache_specs_equal_reference(policy):
    for sizes, names in MESHES:
        am, ms = _abstract_mesh(sizes, names), T.MeshShape(names, sizes)
        for name, shapes in BATCH_SHAPES.items():
            for shape in shapes:
                leaf = _Leaf(shape)
                assert _norm(T.batch_spec(name, leaf, ms, policy)) == \
                    _norm(J.batch_spec(name, leaf, am, policy)), (name, shape, sizes)
        for name, shapes in CACHE_SHAPES.items():
            for shape in shapes:
                leaf = _Leaf(shape)
                got, want = T.cache_spec(name, leaf, ms, policy), J.cache_spec(name, leaf, am,
                                                                                policy)
                assert len(got) == len(want) and _norm(got) == _norm(want), (name, shape, sizes)


SPECS = [((4, 6), (("data",), "model")), ((4, 8), (None, ("data", "model"))),
         ((8, 3, 2), (("data", "model"), None, None)), ((4, 6), ("model", None)),
         ((5,), ()), ((2, 4, 6), (None, "model", ("data",)))]


@pytest.mark.parametrize("shape,spec", SPECS, ids=[str(s[1]) for s in SPECS])
def test_shard_unshard_round_trip(shape, spec):
    ms = T.MeshShape(("data", "model"), (2, 2))
    x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    blocks = [T.shard(x, spec, ms, c) for c in T.coords(ms)]
    n = {e: T.block_index(e, ms, T.coords(ms)[0])[1] for e in spec}
    for blk in blocks:
        assert tuple(blk.shape) == tuple(s // n[e] for s, e in zip(shape, spec)) or not spec
    assert torch.equal(T.unshard(blocks, spec, ms), x)
    if spec == (None, ("data", "model")):     # data the major axis: (1, 0) is block 2
        assert torch.equal(blocks[2], x[:, 4:6])
    with pytest.raises(ValueError):
        T.shard(torch.zeros(3, 5), ("model", None), ms, T.coords(ms)[0])


@pytest.mark.parametrize("mesh_shape", [(1, 2), (1, 4), (2, 2)])
def test_shard_params_holds_only_blocks(mesh_shape):
    """Each shard holds exactly its blocks (a split leaf's bytes over its
    block count, a replicated leaf whole); unshard gives the one-shard
    parameters bit for bit; a gather over data alone leaves `model`
    split."""
    d, m = mesh_shape
    arch = registry.get_config("granite-moe-1b-a400m")
    model = __import__("repro_torch.models.model_zoo", fromlist=["build"]).build(
        arch.smoke_model, arch.family)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    mesh = lm.make_lm_mesh(m, data=d, device="cpu")
    mp = T.shard_params(params, mesh, arch.family, arch.parallelism)
    assert len(mp.shards) == d * m
    names, leaves = tree_flatten(params)
    specs = T.spec_leaves(params, mp.specs)
    want = sum(t.numel() * t.element_size() // int(np.prod(
        [T.block_index(e, mesh.shape, mesh.local[0])[1] for e in s] or [1]))
        for t, s in zip(leaves, specs))
    for tree in mp.shards:
        assert T.shard_bytes(tree) == want
    assert want < sum(t.numel() * t.element_size() for t in leaves)
    full = T.unshard_params(mp)
    for a, b in zip(tree_flatten(full)[1], leaves):
        assert torch.equal(a, b)
    expert = [s["blocks"][0]["moe"]["w_up"] for s in mp.shards]
    got = T.gather(mesh, expert, mp.specs["blocks"][0]["moe"]["w_up"], ("data",))
    assert tuple(got[0].shape) == (8 // m, 64, 32)


def test_lm_mesh_exchanges_and_layouts(monkeypatch):
    mesh = lm.make_lm_mesh(2, data=2, device="cpu")
    assert [tuple(c.values()) for c in mesh.local] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    parts = [torch.full((2, 1), float(i)) for i in range(4)]
    assert [p.flatten().tolist() for p in mesh.all_gather(parts, "model", 1)] == \
        [[0, 1, 0, 1], [0, 1, 0, 1], [2, 3, 2, 3], [2, 3, 2, 3]]
    assert [p.flatten().tolist() for p in mesh.all_gather(parts, "data", 0)] == \
        [[0, 0, 2, 2], [1, 1, 3, 3], [0, 0, 2, 2], [1, 1, 3, 3]]
    assert [float(p[0, 0]) for p in mesh.psum(parts, "data")] == [2, 4, 2, 4]
    assert [float(p[0, 0]) for p in mesh.pmean(parts)] == [1.5] * 4
    sends = [torch.tensor([[10 * i], [10 * i + 1]]) for i in range(4)]
    assert [r.flatten().tolist() for r in mesh.all_to_all(sends)] == \
        [[0, 10], [1, 11], [20, 30], [21, 31]]
    with pytest.raises(ValueError):
        lm.LMMesh(2, 3, world=4)
    with pytest.raises(ValueError):
        lm.LMMesh(3, 4, world=4)         # 3 shards a rank: neither divides 4
    assert lm.line_ranks("data", 1, 2, 4, 4) == [0, 2]
    assert lm.line_ranks("model", 1, 2, 4, 2) == [1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.make_lm_mesh(2)               # the card by default
