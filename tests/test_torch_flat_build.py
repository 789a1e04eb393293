"""The port's other build and search options against the JAX package on
the CPU: the flat build (``streaming=False``), the flat fold
(``merge="flat"``) and the rest of HashPrune's folds and oracles,
``final_prune=False``, ``final_prune_host`` and ``robust_prune_np``,
``knn_fn``, the host search (``search(batch=False)``) and the legacy
``beam_search_single``.  Integer data makes every comparison exact;
leaves and hyperplanes are handed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import beam_search as jbs
from repro.core import hashprune as jhp
from repro.core import pipnn as jpipnn
from repro.core import robust_prune as jrp
from repro.core import sketch as jsketch
from repro.core.leaf import LeafParams as JLeafParams
from repro.core.rbc import RBCParams as JRBCParams
from repro.core.rbc import ball_carve as j_ball_carve
from repro_torch.convert import reservoir_from_arrays
from repro_torch.core import beam_search as bs
from repro_torch.core import hashprune as hp_
from repro_torch.core import leaf, pipnn
from repro_torch.core import robust_prune as rp
from repro_torch.core.rbc import RBCParams
from repro_torch.data import dyadic_hyperplanes
from test_torch_build import _edges


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: under six test workers the default (one a core)
    oversubscribes the cores on these small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


CPU = "cpu"
METRICS = ("l2", "mips")


def _t(a):
    return torch.from_numpy(np.array(a))


def _same_res(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------------ HashPrune ---

def _reservoir(seed, n, l_max, metric):
    """A reservoir of the tie-heavy edges, from the reference."""
    return jhp.hashprune_flat(*(jnp.asarray(a) for a in _edges(seed, n, 900, metric)),
                              n_points=n, l_max=l_max)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("seed", (0, 1))
def test_flat_fold_matches_reference(seed, metric):
    """``reservoir_as_edges``, ``merge_flat_edges`` and
    ``hashprune_merge_flat``; the fold equals ``hashprune_flat`` over every
    edge folded in (mergeability)."""
    n, l_max = 50, 8
    res = _reservoir(seed, n, l_max, metric)
    tres = hp_.Reservoir(*(_t(a) for a in res))
    for g, w in zip(hp_.reservoir_as_edges(*tres), jhp.reservoir_as_edges(*res)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    chunk = _edges(seed + 10, n, 700, metric)
    want = jhp.merge_flat_edges(*res, *(jnp.asarray(a) for a in chunk))
    got = hp_.merge_flat_edges(*tres, *(_t(a) for a in chunk))
    _same_res(got, want)
    _same_res(hp_.hashprune_merge_flat(tres, *(_t(a) for a in chunk)), want)
    assert all(torch.equal(a, _t(b)) for a, b in zip(tres, res))   # res untouched
    both = [np.concatenate([a, b]) for a, b in zip(_edges(seed, n, 900, metric), chunk)]
    _same_res(got, hp_.hashprune_flat(*(_t(a) for a in both), n_points=n, l_max=l_max))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("seed", (0, 1))
def test_reservoir_merges_match_reference(seed, metric):
    """``hashprune_merge`` (padded candidate lists and a second reservoir)
    and ``hashprune_merge_segmented`` (a flat chunk)."""
    n, l_max = 50, 8
    res = _reservoir(seed, n, l_max, metric)
    other = _reservoir(seed + 20, n, l_max, metric)
    tres = hp_.Reservoir(*(_t(a) for a in res))
    tother = hp_.Reservoir(*(_t(a) for a in other))
    _same_res(hp_.hashprune_merge(tres, tother), jhp.hashprune_merge(res, other))
    _same_res(hp_.hashprune_merge(tres, cand_ids=tother.ids, cand_hashes=tother.hashes,
                                  cand_dists=tother.dists),
              jhp.hashprune_merge(res, None, other.ids, other.hashes, other.dists))
    chunk = _edges(seed + 10, n, 700, metric)
    want = jhp.hashprune_merge_segmented(jhp.Reservoir(*(jnp.array(a) for a in res)),
                                         *(jnp.asarray(a) for a in chunk))
    _same_res(hp_.hashprune_merge_segmented(tres, *(_t(a) for a in chunk)), want)


def _stream_candidates(kind, metric):
    """Per-point candidate lists (ids, hashes, dists): the tie-heavy edges,
    or lists whose few distinct dists tie at the eviction slot often (an
    id's hash is a function of the id, as a residual hash is)."""
    if kind == "edges":
        src, dst, hashes, dist = _edges(3, 12, 400, metric)
        return [(dst[src == p], hashes[src == p], dist[src == p]) for p in range(12)]
    rng = np.random.default_rng(5)
    out = []
    for _ in range(12):
        ids = rng.integers(-1, 30, 60).astype(np.int32)
        dist = np.where(ids >= 0, rng.integers(0, 3, 60) / 2.0 - (metric == "mips"),
                        np.inf).astype(np.float32)
        out.append((ids, np.where(ids >= 0, ids * 5 % 13, 0).astype(np.int32), dist))
    return out


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("kind", ("edges", "ties"))
@pytest.mark.parametrize("l_max", (1, 4, 16))
def test_hashprune_stream_and_canonicalize_match_reference(l_max, kind, metric):
    """Sequential Algorithm 3 per point, slot for slot, and its canonical
    form equal to the closed form (history independence)."""
    for cand in _stream_candidates(kind, metric):
        ids, hs, ds = (_t(a) for a in cand)
        want = jhp.hashprune_stream(*(jnp.asarray(a) for a in cand), l_max=l_max)
        got = hp_.hashprune_stream(ids, hs, ds, l_max=l_max)
        _same_res(got, want)
        canon = hp_.canonicalize(got)
        _same_res(canon, jhp.canonicalize(want))
        _same_res(canon, hp_.hashprune_batch(ids[None], hs[None], ds[None], l_max=l_max))


# -------------------------------------------------------- RobustPrune ---

@pytest.mark.parametrize("metric", METRICS)
def test_robust_prune_np_and_final_prune_host_match_reference(metric):
    rng = np.random.default_rng(4)
    n, l_max = 200, 16
    x = rng.integers(0, 12, (n, 10)).astype(np.float32)
    for i in range(20):
        cands = rng.integers(-1, n, 40)
        want = jrp.robust_prune_np(x[i], cands, x, alpha=1.44, r=6, metric=metric)
        np.testing.assert_array_equal(rp.robust_prune_np(x[i], cands, x, alpha=1.44, r=6,
                                                         metric=metric), want)
    src = rng.integers(0, n, 4000).astype(np.int32)
    dst = rng.integers(0, n, 4000).astype(np.int32)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    dist = (np.sum((x[src] - x[dst]) ** 2, axis=1) if metric == "l2"
            else -np.sum(x[src] * x[dst], axis=1)).astype(np.float32)
    hashes = ((src * 5 + dst * 3) % 32).astype(np.int32)
    res = jhp.hashprune_flat(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(hashes),
                             jnp.asarray(dist), n_points=n, l_max=l_max)
    tres = reservoir_from_arrays(*(np.asarray(a) for a in res), device=CPU)
    alpha = 1.44 if metric == "l2" else 1.0
    for max_deg in (8, 24):          # below and past l_max
        want = jrp.final_prune_host(x, res, alpha=alpha, max_deg=max_deg, metric=metric,
                                    chunk=64)
        got = rp.final_prune_host(_t(x), tres, alpha=alpha, max_deg=max_deg, metric=metric,
                                  chunk=50)
        streamed = rp.final_prune(_t(x), tres, alpha=alpha, max_deg=max_deg, metric=metric)
        for g, w, s in zip(got, want, streamed):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(s.numpy(), w)


# ------------------------------------------------------------- builds ---

def _data(n=1200, d=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 32, (n, d)).astype(np.float32)
    x[100:110] = x[99]
    return x


def _params(port: bool, metric: str, **kw):
    rbc, lp, pp = ((RBCParams, leaf.LeafParams, pipnn.PiPNNParams) if port
                   else (JRBCParams, JLeafParams, jpipnn.PiPNNParams))
    kw = {"l_max": 32, "max_deg": 16, **kw}
    return pp(rbc=rbc(c_max=128, c_min=16, fanout=(3,)), leaf=lp(k=2, leaf_chunk=8),
              metric=metric, seed=1, **kw)


@pytest.fixture
def shared(monkeypatch):
    """Integer data, the reference's leaves and dyadic hyperplanes given to
    both packages."""
    x = _data()
    hp = dyadic_hyperplanes(5, 12, x.shape[1])
    monkeypatch.setattr(jsketch, "make_hyperplanes",
                        lambda key, m, d, dtype=jnp.float32: jnp.asarray(hp))
    leaves = j_ball_carve(x, JRBCParams(c_max=128, c_min=16, fanout=(3,), seed=1),
                          execution="host")
    return x, hp, leaves


FLAT_STATS = ("streaming", "n_candidate_edges", "peak_edge_bytes", "edge_bytes_build_leaves",
              "merge_workspace_bytes", "n_leaves", "point_repeat", "pad_ratio")


@pytest.mark.parametrize("metric", METRICS)
def test_flat_build_equals_reference(shared, metric):
    x, hp, leaves = shared
    want = jpipnn.build(x, _params(False, metric), leaves=leaves, streaming=False)
    got = pipnn.build(x, _params(True, metric), leaves=leaves, hyperplanes=hp, device=CPU,
                      streaming=False)
    np.testing.assert_array_equal(got.graph.numpy(), want.graph)
    np.testing.assert_array_equal(got.dists.numpy(), want.dists)
    assert got.start == want.start
    for key in FLAT_STATS:
        assert got.stats[key] == want.stats[key], key
    assert not got.stats["streaming"]
    assert list(got.timings) == list(want.timings)


@pytest.mark.parametrize("metric", METRICS)
def test_streaming_flat_and_flat_fold_builds_are_identical(shared, metric):
    """The streamed build with either fold and the flat build give one
    graph; the flat fold's stats are the reference's."""
    x, hp, leaves = shared
    kw = dict(leaves=leaves, hyperplanes=hp, device=CPU)
    seg = pipnn.build(x, _params(True, metric), **kw)
    flat = pipnn.build(x, _params(True, metric), streaming=False, **kw)
    fold = pipnn.build(x, _params(True, metric, merge="flat"), **kw)
    for other in (flat, fold):
        assert torch.equal(seg.graph, other.graph) and torch.equal(seg.dists, other.dists)
        assert seg.stats["n_candidate_edges"] == other.stats["n_candidate_edges"]
    want = jpipnn.build(x, _params(False, metric, merge="flat"), leaves=leaves)
    np.testing.assert_array_equal(fold.graph.numpy(), want.graph)
    for key in FLAT_STATS + ("stream_chunk_leaves",):
        assert fold.stats[key] == want.stats[key], key
    assert fold.stats["merge_workspace_bytes"] != seg.stats["merge_workspace_bytes"]


def test_unknown_merge_is_refused():
    with pytest.raises(ValueError, match="unknown merge"):
        pipnn.build(_data(200), _params(True, "l2", merge="sorted"), device=CPU)


@pytest.mark.parametrize("streaming", (True, False))
@pytest.mark.parametrize("metric", METRICS)
def test_final_prune_off_equals_reference(shared, metric, streaming):
    """The reservoir itself, cut to max_deg (16 < l_max) or padded to it
    (48 > l_max): rows sorted by (dist, id), -1 / +inf padding."""
    x, hp, leaves = shared
    for max_deg in (16, 48):
        want = jpipnn.build(x, _params(False, metric, final_prune=False, max_deg=max_deg),
                            leaves=leaves, streaming=streaming)
        got = pipnn.build(x, _params(True, metric, final_prune=False, max_deg=max_deg),
                          leaves=leaves, hyperplanes=hp, device=CPU, streaming=streaming)
        np.testing.assert_array_equal(got.graph.numpy(), want.graph)
        np.testing.assert_array_equal(got.dists.numpy(), want.dists)
        assert got.graph.shape == (x.shape[0], max_deg)


def test_knn_fn_replaces_the_leaf_knn(shared):
    """``knn_fn(points, leaf_ids)`` runs on both paths; one that keeps a
    single neighbour builds the k = 1 graph."""
    x, hp, leaves = shared
    calls = []

    def one_nn(points, leaf_ids):
        calls.append(leaf_ids.shape[0])
        return leaf.leaf_knn(points, leaf_ids, k=1)

    kw = dict(leaves=leaves, hyperplanes=hp, device=CPU)
    k1 = pipnn.build(x, _params(True, "l2").with_(leaf=leaf.LeafParams(k=1)), **kw)
    for streaming in (True, False):
        calls.clear()
        got = pipnn.build(x, _params(True, "l2"), knn_fn=one_nn, streaming=streaming, **kw)
        assert calls and torch.equal(got.graph, k1.graph)


# ------------------------------------------------------------- search ---

@pytest.mark.parametrize("metric", METRICS)
def test_host_search_equals_reference(shared, metric):
    """``search(batch=False)`` runs ``beam_search_np`` per query on the same
    graph: the same int64 ids, -1 past the beam."""
    x, hp, leaves = shared
    index = pipnn.build(x, _params(True, metric), leaves=leaves, hyperplanes=hp, device=CPU)
    ref = jpipnn.build(x, _params(False, metric), leaves=leaves)
    np.testing.assert_array_equal(index.graph.numpy(), ref.graph)
    q = np.random.default_rng(8).integers(0, 32, (30, x.shape[1])).astype(np.float32)
    for beam, k in ((24, 10), (6, 10)):
        want = jpipnn.search(ref, x, q, k=k, beam=beam, batch=False)
        got = pipnn.search(index, x, q, k=k, beam=beam, batch=False)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
    assert (got[:, 6:] == -1).all()


@pytest.mark.parametrize("option", ({"with_stats": True}, {"iters": 8}, {"dtype": "int8"},
                                    {"expansions": 2}, {"query_chunk": 16}))
def test_host_search_refuses_serving_options(option):
    x = _data(300)
    index = pipnn.build(x, _params(True, "l2"), device=CPU)
    with pytest.raises(ValueError, match="serving-path options"):
        pipnn.search(index, x, x[:4], batch=False, **option)


@pytest.mark.parametrize("metric", METRICS)
def test_beam_search_single_matches_reference(metric):
    """The legacy engine on a kNN graph with short rows (-1 slots) and a
    duplicate cluster, at a budget that does and one that does not run to
    the end of the frontier."""
    rng = np.random.default_rng(7)
    x = rng.integers(0, 24, (400, 12)).astype(np.float32)
    x[10:16] = x[9]
    truth = jbs.brute_force_knn(x, x, 13, metric=metric)
    graph = truth[:, 1:13].astype(np.int32)
    graph[::3, 8:] = -1
    q = rng.integers(0, 24, (16, 12)).astype(np.float32)
    start = jbs.medoid(x)
    for beam, iters in ((24, 28), (8, 3)):
        want = jbs.beam_search_single(jnp.asarray(graph), jnp.asarray(x), jnp.asarray(q),
                                      start=start, beam=beam, iters=iters, metric=metric)
        got = bs.beam_search_single(_t(graph), _t(x), _t(q), start=start, beam=beam,
                                    iters=iters, metric=metric)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
