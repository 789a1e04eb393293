"""The distributed build (``repro_torch.launch.build_index``) against the JAX
package on the CPU at one shard: ``derived``, the tile step and each
variant, the final-prune step, ``build_distributed``, the two places where
the kernel route's -1 differs from ``lax.top_k``'s pick, and the
reference tests' own quality checks run on the port.

Inputs are integers in [0, 127] with each row's largest entry 127, so every
float32 sum is exact on both sides and the int8 route's vectors stay
integers (their scale is exactly 1.0); hyperplanes are dyadic or the
reference's own.  The reference's supersteps are jitted here (its own
functions, compiled once per variant instead of run op by op)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sketch as jsketch
from repro.core.hashprune import Reservoir as JReservoir
from repro.core.hashprune import reservoir_init as j_reservoir_init
from repro.launch import build_index as jbi
from repro_torch.convert import reservoir_from_arrays
from repro_torch.core.beam_search import beam_search_np, brute_force_knn
from repro_torch.core.hashprune import reservoir_init
from repro_torch.data import dyadic_hyperplanes
from repro_torch.launch import build_index as bi
from _torch_build_reference import outlier_points, round_trip_integers

CPU = "cpu"
_REF_TILE, _REF_PRUNE = jbi.make_tile_step, jbi.make_final_prune_step
VARIANTS = {"baseline": {}, "int8": dict(route_dtype="int8"),
            "bf16": dict(leaf_dtype="bf16"), "flat": dict(merge="flat")}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors: one torch thread a worker, as the xdist workers share
    the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def jitted(mesh):
    """The reference's supersteps, jitted once per parameter set."""
    cache = {}

    def get(kind, p):
        if (kind, p) not in cache:
            make = _REF_TILE if kind == "tile" else _REF_PRUNE
            cache[kind, p] = jax.jit(make(mesh, p))
        return cache[kind, p]

    return get


@pytest.fixture(scope="module")
def x():
    return round_trip_integers(3000, 16, seed=0)


@pytest.fixture(scope="module")
def hp():
    return dyadic_hyperplanes(3, 12, 16)


def _ref_tile(jitted, kw, x, hp, res=None):
    jp = jbi.DistBuildParams.tiny(**kw)
    res = res if res is not None else j_reservoir_init(jp.n_tile, jp.l_max)
    r, st = jitted("tile", jp)(jnp.asarray(x), jnp.asarray(hp), res)
    return [np.asarray(a) for a in r], np.asarray(st)


def _port_tile(kw, x, hp, res=None):
    p = bi.DistBuildParams.tiny(**kw)
    res = res if res is not None else reservoir_init(p.n_tile, p.l_max, device="cpu")
    r, st = bi.make_tile_step(1, p)(torch.from_numpy(x), hp, res)
    return [a.numpy() for a in r], st.numpy()


def _assert_same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# --------------------------------------------------------------- params ---

PARAMS = (dict(), dict(l0=16), dict(route_dtype="int8", l0=32, f1=3),
          dict(n_tile=4096, l0=64, bucket_slack=1.3, edge_slack=1.3, leaf_chunk=8))


@pytest.mark.parametrize("s", (1, 2, 4, 8, 16))
@pytest.mark.parametrize("kw", PARAMS)
def test_derived_equals_reference(kw, s):
    p, jp = bi.DistBuildParams.tiny(**kw), jbi.DistBuildParams.tiny(**kw)
    assert dataclasses.asdict(p) == dataclasses.asdict(jp)
    assert p.derived(s) == jp.derived(s)


@pytest.mark.parametrize("variant", ("baseline", "quantized", "opt", "bf16leaf"))
@pytest.mark.parametrize("dim", (128, 96))
def test_production_params_and_flops_equal_reference(variant, dim):
    p, jp = bi.production_params(dim, variant), jbi.production_params(dim, variant)
    assert dataclasses.asdict(p) == dataclasses.asdict(jp)
    for s in (1, 8, 512):
        assert p.derived(s) == jp.derived(s)
    assert bi.useful_flops(2 ** 30, dim, p) == jbi.useful_flops(2 ** 30, dim, jp)
    assert bi.useful_flops(2 ** 30, dim) == jbi.useful_flops(2 ** 30, dim)
    # the card configuration of chip_smoke.py's phase 9
    cut = dataclasses.replace(p, n_tile=2 ** 18, l0=16)
    jcut = dataclasses.replace(jp, n_tile=2 ** 18, l0=16)
    assert cut.derived(8) == jcut.derived(8) and cut.derived(1) == jcut.derived(1)


# ------------------------------------------------------------ tile step ---

@pytest.mark.parametrize("variant", tuple(VARIANTS))
def test_tile_step_equals_reference(jitted, x, hp, variant):
    """One shard: the reservoir's ids, hashes and dists and the stats equal
    the reference's exactly, for each variant."""
    kw = VARIANTS[variant]
    want, want_st = _ref_tile(jitted, kw, x[:2048], hp)
    got, got_st = _port_tile(kw, x[:2048], hp)
    _assert_same(got, want)
    np.testing.assert_array_equal(got_st, want_st)
    assert (got[0] >= 0).any()


@pytest.mark.parametrize("variant", ("baseline", "flat"))
def test_tile_step_folds_into_a_nonempty_reservoir(jitted, x, hp, variant):
    """A second step over the same points with other level-1 parameters
    (other leaves, so other candidates) folded into the first step's
    reservoir, carried over with ``convert.reservoir_from_arrays``: the
    same reservoir as the reference's.  The carried reservoir is of the
    same points and planes, so an id's hash and distance agree on both
    sides, as in every fold of a build."""
    first, _ = _ref_tile(jitted, {}, x[:2048], hp)
    kw = dict(VARIANTS[variant], l1=16, f1=3)
    want, want_st = _ref_tile(jitted, kw, x[:2048], hp, JReservoir(*map(jnp.asarray, first)))
    got, got_st = _port_tile(kw, x[:2048], hp, reservoir_from_arrays(*first, device=CPU))
    _assert_same(got, want)
    np.testing.assert_array_equal(got_st, want_st)
    assert not np.array_equal(got[0], first[0])


def test_final_prune_step_equals_reference(jitted, x, hp):
    jp, p = jbi.DistBuildParams.tiny(), bi.DistBuildParams.tiny()
    (ids, _, dists), _ = _ref_tile(jitted, {}, x[:2048], hp)
    want = jitted("prune", jp)(jnp.asarray(x[:2048]), jnp.asarray(ids), jnp.asarray(dists))
    got = bi.make_final_prune_step(1, p)(torch.from_numpy(x[:2048]), torch.tensor(ids),
                                         torch.tensor(dists))
    _assert_same([g.numpy() for g in got], [np.asarray(w) for w in want])
    assert (got[0] >= 0).sum(1).min() > 0


# ---------------------------------------------------- build_distributed ---

@pytest.fixture(scope="module")
def jitted_build(jitted):
    """The reference's ``build_distributed`` with its supersteps jitted."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbi, "make_tile_step", lambda mesh, p: jitted("tile", p))
        mp.setattr(jbi, "make_final_prune_step", lambda mesh, p: jitted("prune", p))
        yield jbi.build_distributed


@pytest.mark.parametrize("n,final_prune", ((2048, True), (3000, True), (3000, False),
                                           (5000, True)))
def test_build_distributed_equals_reference(jitted_build, mesh, x, n, final_prune):
    """The reference's own ``jax.random`` hyperplanes handed to the port:
    one tile, two and three tiles with the far-away filler, and the
    reservoir without the final prune."""
    xs = x[:n] if n <= len(x) else np.concatenate([x, round_trip_integers(n - len(x), 16, 4)])
    jp, p = jbi.DistBuildParams.tiny(), bi.DistBuildParams.tiny()
    planes = np.asarray(jsketch.make_hyperplanes(jax.random.PRNGKey(0), p.m_bits, p.dim))
    wg, wd = jitted_build(xs, mesh, jp, seed=0, final_prune=final_prune)
    gg, gd = bi.build_distributed(xs, 1, p, seed=0, final_prune=final_prune,
                                  hyperplanes=planes, device=CPU)
    assert gg.dtype == wg.dtype and gd.dtype == wd.dtype
    np.testing.assert_array_equal(gg, wg)
    np.testing.assert_array_equal(gd, wd)


def test_tiles_are_disconnected(hp):
    """The reference's caveat, reproduced: each tile starts from a fresh
    reservoir and nothing merges tiles, so no edge crosses a tile's
    boundary, and the first tile's rows are the one-tile build's."""
    p = bi.DistBuildParams.tiny()
    xs = round_trip_integers(4096, 16, seed=5)
    two, _ = bi.build_distributed(xs, 1, p, hyperplanes=hp, device=CPU)
    one, _ = bi.build_distributed(xs[:2048], 1, p, hyperplanes=hp, device=CPU)
    np.testing.assert_array_equal(two[:2048], one)
    tile = np.arange(4096)[:, None] // p.n_tile
    ok = two >= 0
    assert ((two // p.n_tile)[ok] == np.broadcast_to(tile, two.shape)[ok]).all()


# ----------------------------------------------- the kernel route's -1 ---

def test_level1_bucket_short_of_leaders_equals_reference(jitted, hp, monkeypatch):
    """A valid point in a bucket with fewer than f1 valid leaders: the
    kernel route gives -1 where ``lax.top_k`` takes the lowest-indexed
    masked leader; ``_assign`` restores the reference's pick, so the
    leaves and the reservoir are the reference's."""
    x = outlier_points(2048, 16, seed=2)
    seen = []
    real = bi.leader_assign

    def spy(points, leaders, f, **kw):
        ids = real(points, leaders, f, **kw)
        if kw.get("point_valid") is not None:
            seen.append(bool(((ids < 0) & kw["point_valid"][..., None]).any()))
        return ids

    monkeypatch.setattr(bi, "leader_assign", spy)
    want, want_st = _ref_tile(jitted, {}, x, hp)
    got, got_st = _port_tile({}, x, hp)
    assert any(seen), "no valid point met a short bucket"
    _assert_same(got, want)
    np.testing.assert_array_equal(got_st, want_st)


def test_assign_takes_the_reference_pick_in_short_rows():
    """``_assign`` against the reference's ``leader_assign`` on rows with
    fewer valid leaders than f, and on invalid points."""
    from repro.core.leader_assign import leader_assign as j_leader_assign

    rng = np.random.default_rng(3)
    pts = rng.integers(0, 30, (3, 40, 8)).astype(np.float32)
    lead = rng.integers(0, 30, (3, 12, 8)).astype(np.float32)
    lv = np.zeros((3, 12), bool)
    lv[0, [2, 7]] = True                      # 2 valid leaders, f = 4
    lv[1] = True
    lv[2, [0, 1, 5, 11]] = True
    pv = rng.random((3, 40)) < 0.8
    want = j_leader_assign(jnp.asarray(pts), jnp.asarray(lead), 4,
                           point_valid=jnp.asarray(pv), leader_valid=jnp.asarray(lv))
    got = bi._assign(torch.from_numpy(pts), torch.from_numpy(lead), 4,
                     point_valid=torch.from_numpy(pv), leader_valid=torch.from_numpy(lv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_leaf_short_of_k_plus_one_members_wraps_no_gather(jitted, hp, monkeypatch):
    """A leaf with fewer than k + 1 valid members: the top-k gives -1 in
    the empty slots, which is clamped before the gathers, so its edges are
    only those between its members; the tile step equals the
    reference's."""
    p = bi.DistBuildParams.tiny()
    c = p.c_max
    gid = torch.full((1, c), -1, dtype=torch.int32)
    gid[0, :2] = torch.tensor([7, 9], dtype=torch.int32)
    vec = torch.full((1, c, p.dim), float("inf"))
    vec[0, :2] = torch.arange(2 * p.dim, dtype=torch.float32).reshape(2, p.dim)
    sk = torch.zeros((1, c, p.m_bits))
    src, dst, _, dist = bi._leaf_chunk_edges(vec, sk, gid, gid >= 0, p)
    ok = src >= 0
    assert sorted(zip(src[ok].tolist(), dst[ok].tolist())) == [(7, 9), (7, 9), (9, 7), (9, 7)]
    assert torch.isfinite(dist[ok]).all() and not torch.isfinite(dist[~ok]).any()

    seen = []
    real = bi.rowwise_topk

    def spy(d, k):
        ids, vals = real(d, k)
        seen.append(bool((ids < 0).any()))
        return ids, vals

    monkeypatch.setattr(bi, "rowwise_topk", spy)
    x = outlier_points(2048, 16, seed=2)
    want, _ = _ref_tile(jitted, {}, x, hp)
    got, _ = _port_tile({}, x, hp)
    assert any(seen)
    _assert_same(got, want)


# ------------------------------------- the reference tests, on the port ---

@pytest.fixture(scope="module")
def gauss():
    return np.random.default_rng(0).standard_normal((2048, 16)).astype(np.float32)


def _recall(graph, x, n_queries=100):
    """``tests/test_build_index.py::_recall`` on the port's host search."""
    truth = brute_force_knn(torch.from_numpy(x), torch.from_numpy(x[:n_queries]), 11)
    hits = []
    for i in range(n_queries):
        ids, _, _ = beam_search_np(graph, x, x[i], start=0, beam=32)
        t = truth[i][truth[i] != i][:10]
        f = [j for j in ids if j != i][:10]
        hits.append(len(set(f) & set(t)) / 10)
    return float(np.mean(hits))


def test_distributed_build_quality_and_determinism(gauss):
    p = bi.DistBuildParams.tiny()
    g1, d1 = bi.build_distributed(gauss, 1, p, seed=0, device=CPU)
    assert g1.shape == (2048, p.max_deg)
    assert (g1 >= 0).any(axis=1).all(), "no isolated points"
    assert _recall(g1, gauss) > 0.9
    g2, d2 = bi.build_distributed(gauss, 1, p, seed=0, device=CPU)
    np.testing.assert_array_equal(g1, g2)
    np.testing.assert_array_equal(d1, d2)


def test_quantized_route_quality(gauss):
    p = bi.DistBuildParams.tiny(route_dtype="int8")
    graph, _ = bi.build_distributed(gauss, 1, p, seed=0, device=CPU)
    assert _recall(graph, gauss) > 0.88


def test_tile_step_stats(gauss):
    p = bi.DistBuildParams.tiny()
    hpl = bi._sketch.make_hyperplanes(0, p.m_bits, p.dim)
    _, stats = bi.make_tile_step(1, p)(torch.from_numpy(gauss), hpl,
                                       reservoir_init(p.n_tile, p.l_max, device="cpu"))
    edges_recv, replicas_recv, drops = stats.tolist()
    assert replicas_recv == gauss.shape[0] * p.f0
    assert edges_recv > gauss.shape[0]
    assert drops == 0


def test_build_distributed_defaults_to_the_card(monkeypatch, gauss):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bi.build_distributed(gauss, 1, bi.DistBuildParams.tiny())
