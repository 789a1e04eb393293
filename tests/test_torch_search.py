"""The port's search path against the JAX package on the CPU: the rank
merge, the multi-expansion engine (ids exact on the one-hop and
disconnected graphs of tests/test_serving.py), ``ServingIndex`` and
serving a reference-built graph through ``convert``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import beam_search as jbs
from repro.core import pipnn as jpipnn
from repro.core.leaf import LeafParams as JLeafParams
from repro.core.rbc import RBCParams as JRBCParams
from repro_torch.convert import index_from_arrays
from repro_torch.core import beam_search as bs
from repro_torch.core import pipnn
from repro_torch.core.serving import ServingIndex
from repro_torch.core.validation import InvalidQueryError
from repro_torch.data import VectorPipelineConfig, make_queries, make_vectors


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: under six test workers the default (one a core)
    oversubscribes the cores on these small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


CPU = "cpu"


def _grid_points(n, d, seed=0, lo=0, hi=30):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, (n, d)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _one_hop_graph(n):
    graph = np.full((n, n - 1), -1, dtype=np.int32)
    for i in range(n):
        graph[i] = [j for j in range(n) if j != i]
    return graph


def _disconnected_graph(n):
    graph = np.full((n, 2), -1, dtype=np.int32)
    comp = [0, 1, 2, 3, 4]
    for a, b in zip(comp, comp[1:] + comp[:1]):
        graph[a] = [b, comp[(comp.index(a) + 2) % 5]]
    for i in range(5, n):
        graph[i] = [(i + 1 - 5) % (n - 5) + 5, -1]
    return graph


def _run_both(graph, x, q, **kw):
    want = jbs.beam_search_batch(graph, x, q, with_stats=True, **kw)
    got = bs.beam_search_batch(_t(graph), _t(x), _t(q), with_stats=True, **kw)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


# ------------------------------------------------------------ merge_block ---

@pytest.mark.parametrize("seed", (0, 1, 2))
def test_merge_block_matches_jax(seed):
    rng = np.random.default_rng(seed)
    nq, beam, m = 6, 12, 10
    ids = np.full((nq, beam), -1, np.int32)
    ds = np.full((nq, beam), np.inf, np.float32)
    vis = np.zeros((nq, beam), bool)
    for r in range(nq):                      # a sorted, duplicate-free beam
        live = int(rng.integers(0, beam + 1))
        row_ids = rng.choice(40, live, replace=False)
        row_ds = (row_ids % 7).astype(np.float32)
        order = np.lexsort((row_ids, row_ds))
        ids[r, :live], ds[r, :live] = row_ids[order], row_ds[order]
        vis[r, :live] = rng.random(live) < 0.5
    bids = rng.integers(-1, 40, (nq, m)).astype(np.int32)
    bds = np.where(bids >= 0, (bids % 7), np.inf).astype(np.float32)
    want = jbs.merge_block(*(jnp.asarray(a) for a in (ids, ds, vis, bids, bds)))
    got = bs.merge_block(*(_t(a) for a in (ids, ds, vis, bids, bds)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_merge_block_ranks_ties_and_repeats_as_jax(seed):
    """A block wider than the beam, with repeated ids, equal distances,
    -0.0 beside +0.0, NaN and padding: the port's sorted ranks place every
    entry where the reference's pairwise counts do (the reference's one-hot
    sums write a -0.0 distance as +0.0, so the values compare as numbers)."""
    rng = np.random.default_rng(100 + seed)
    nq, beam, m = 8, 6, 40
    vals = np.array([0.0, -0.0, 0.5, 1.0, 1.0, 2.0, np.inf, np.nan], np.float32)
    ids = np.full((nq, beam), -1, np.int32)
    ds = np.full((nq, beam), np.inf, np.float32)
    for r in range(nq):
        live = int(rng.integers(0, beam + 1))
        row_ids = rng.choice(30, live, replace=False).astype(np.int32)
        row_ds = rng.choice(vals[:6], live)
        order = np.lexsort((row_ids, row_ds))
        ids[r, :live], ds[r, :live] = row_ids[order], row_ds[order]
    vis = rng.random((nq, beam)) < 0.5
    bids = rng.integers(-1, 30, (nq, m)).astype(np.int32)
    bds = rng.choice(vals, (nq, m))
    want = jbs.merge_block(*(jnp.asarray(a) for a in (ids, ds, vis, bids, bds)))
    got = bs.merge_block(*(_t(a) for a in (ids, ds, vis, bids, bds)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------- engine ---

@pytest.mark.parametrize("expansions", (1, 2, 4, 8))
def test_engine_exact_on_one_hop_graph(expansions):
    x = _grid_points(64, 8, seed=1)
    q = _grid_points(12, 8, seed=2)
    want, got = _run_both(_one_hop_graph(64), x, q, start=3, beam=16,
                          expansions=expansions)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_engine_exact_on_disconnected_graph():
    x = _grid_points(40, 4, seed=9)
    q = _grid_points(6, 4, seed=10)
    want, got = _run_both(_disconnected_graph(40), x, q, start=0, beam=16, expansions=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    ids = got[0]
    assert (got[2] <= 5).all() and (ids[:, 5:] == -1).all()


@pytest.mark.parametrize("metric", ("l2", "mips"))
def test_engine_exact_on_knn_graph_with_early_exit_cap(metric):
    x = _grid_points(300, 8, seed=11)
    q = _grid_points(10, 8, seed=12)
    truth = jbs.brute_force_knn(x, x, 13, metric=metric)
    graph = truth[:, 1:13].astype(np.int32)
    for early in (True, False):
        want, got = _run_both(graph, x, q, start=jbs.medoid(x), beam=20, iters=40,
                              expansions=4, metric=metric, early_exit=early)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_beam_search_np_oracle_is_a_copy():
    x = _grid_points(120, 6, seed=5)
    graph = jbs.brute_force_knn(x, x, 9)[:, 1:].astype(np.int32)
    q = _grid_points(4, 6, seed=6)
    for row in q:
        w = jbs.beam_search_np(graph, x, row, start=7, beam=10)
        g = bs.beam_search_np(graph, x, row, start=7, beam=10)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert bs.default_iters(32) == jbs.default_iters(32)
    assert bs.medoid(x, seed=3) == jbs.medoid(x, seed=3)


def test_brute_force_and_recall_helpers():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((500, 16)).astype(np.float32)
    q = rng.standard_normal((30, 16)).astype(np.float32)
    want = jbs.brute_force_knn(x, q, 10)
    got = bs.brute_force_knn(_t(x), _t(q), 10, chunk=7)
    np.testing.assert_array_equal(got, want)
    f = rng.integers(0, 50, (30, 10))
    assert bs.recall_at_k(f, want, 10) == jbs.recall_at_k(f, want, 10)
    np.testing.assert_array_equal(bs.pad_ids(f[:, :3], 5), jbs.pad_ids(f[:, :3], 5))


# ---------------------------------------------------------- ServingIndex ---

@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1500, 24)).astype(np.float32)
    jp = jpipnn.PiPNNParams(rbc=JRBCParams(c_max=128, c_min=16, fanout=(3,)),
                            leaf=JLeafParams(k=2), l_max=32, max_deg=16, seed=1)
    return jpipnn.build(x, jp), x


def test_serving_matches_reference_engine_and_telemetry(built):
    index, x = built
    q = np.random.default_rng(3).standard_normal((50, 24)).astype(np.float32)
    want_ids, want_st = jpipnn.search(index, x, q, k=10, beam=24, with_stats=True)
    tidx = index_from_arrays(index.graph, index.dists, index.start, device=CPU)
    got_ids, got_st = pipnn.search(tidx, x, q, k=10, beam=24, with_stats=True, device=CPU)
    np.testing.assert_array_equal(got_ids, want_ids)
    for key in ("hops", "dist_comps", "converged", "iters_cap", "expansions"):
        np.testing.assert_array_equal(got_st[key], want_st[key])


def test_serving_chunking_caching_and_bytes(built):
    index, x = built
    q = np.random.default_rng(4).standard_normal((37, 24)).astype(np.float32)
    tidx = index_from_arrays(index.graph, index.dists, index.start, device=CPU)
    full = pipnn.search(tidx, x, q, k=10, beam=16, device=CPU)
    chunked = pipnn.search(tidx, x, q, k=10, beam=16, query_chunk=8, device=CPU)
    np.testing.assert_array_equal(chunked, full)
    sv = pipnn.serving_index(tidx, x, device=CPU)
    assert pipnn.serving_index(tidx, x, device=CPU) is sv          # cached
    assert sv.device_bytes() == 1500 * 16 * 4 + 1500 * 24 * 4 + 1500 * 4
    short = pipnn.search(tidx, x, q, k=10, beam=4, device=CPU)     # beam < k pads
    assert (short[:, 4:] == -1).all()
    assert pipnn.search(tidx, x, q[:0], k=10, device=CPU).shape == (0, 10)


def test_serving_rejects_bad_queries(built):
    index, x = built
    sv = ServingIndex.from_graph(index.graph, x, index.start, device=CPU)
    q = np.zeros((4, 24), np.float32)
    q[2, 3] = np.nan
    with pytest.raises(InvalidQueryError) as e:
        sv.search(q)
    assert e.value.rows == (2,) and e.value.reason == "nan_inf"
    with pytest.raises(InvalidQueryError):
        sv.search(np.zeros((4, 23), np.float32))
    with pytest.raises(ValueError):
        sv.search(q[:2] * 0, k=0)


def test_convert_serves_reference_graph_with_reference_recall():
    """A graph built by the JAX package, served by the port through
    ``convert.index_from_arrays``: recall@10 within 0.01 of the
    reference's own search."""
    cfg = VectorPipelineConfig(n=4096, dim=32, n_clusters=32, seed=0)
    x, q = make_vectors(cfg), make_queries(cfg, 256)
    jp = jpipnn.PiPNNParams(rbc=JRBCParams(c_max=256, c_min=32, fanout=(4, 2)),
                            leaf=JLeafParams(k=2), l_max=64, max_deg=32, seed=0)
    index = jpipnn.build(x, jp)
    truth = jbs.brute_force_knn(x, q, 10)
    r_ref = jbs.recall_at_k(jpipnn.search(index, x, q, k=10, beam=32), truth, 10)
    tidx = index_from_arrays(index.graph, index.dists, index.start, device=CPU)
    r_port = bs.recall_at_k(pipnn.search(tidx, x, q, k=10, beam=32, device=CPU), truth, 10)
    assert abs(r_port - r_ref) <= 0.01, (r_port, r_ref)
