"""The k-NN-graph task (``repro_torch.core.knn_graph``) and the paper's
baselines (``repro_torch.core.baselines``) against the JAX package on the
CPU, on the same numpy inputs and seeds: identical k-NN ids, graphs and
start points."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbase
from repro.core import knn_graph as jknn
from repro.core import pipnn as jpipnn
from repro.core import rbc as jrbc
from repro.core import sketch as jsketch
from repro.core.leaf import LeafParams as JLeafParams
from repro_torch.core import baselines, knn_graph, pipnn, rbc
from repro_torch.core import sketch as tsketch
from repro_torch.core.beam_search import recall_at_k
from repro_torch.core.leaf import LeafParams
from repro_torch.data import VectorPipelineConfig, dyadic_hyperplanes, make_vectors, sift_like

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _params(port: bool):
    rp, lp, pp = ((rbc.RBCParams, LeafParams, pipnn.PiPNNParams) if port
                  else (jrbc.RBCParams, JLeafParams, jpipnn.PiPNNParams))
    return pp(rbc=rp(c_max=128, c_min=16, fanout=(3, 2)), leaf=lp(k=2),
              hash_bits=12, l_max=32, max_deg=16, seed=1)


@pytest.fixture(scope="module")
def ints():
    return sift_like(make_vectors(VectorPipelineConfig(n=1500, dim=16, n_clusters=16, seed=2)))


def test_knn_graph_equals_reference(ints, monkeypatch):
    """Integer data and the same dyadic hyperplanes in both builds: the
    k-NN ids equal the reference's, and the sampled recall is the exact one."""
    hp = dyadic_hyperplanes(7, 12, 16)
    monkeypatch.setattr(jsketch, "make_hyperplanes",
                        lambda key, m, d, dtype=jnp.float32: jnp.asarray(hp))
    monkeypatch.setattr(tsketch, "make_hyperplanes", lambda seed, m, d: hp)
    want, wt = jknn.knn_graph_pipnn(ints, k=10, beam=32, params=_params(False))
    got, gt = knn_graph.knn_graph_pipnn(ints, k=10, beam=32, params=_params(True), device=CPU)
    assert got.dtype == want.dtype and got.shape == (1500, 10)
    np.testing.assert_array_equal(got, want)
    assert set(gt) == set(wt) == {"build", "query", "total"}
    # the sampled recall against exact integer distances, ties to the lower
    # id (the reference's brute force takes any member of a tie at the
    # (k+1)-th place: ``argpartition``)
    r = knn_graph.knn_graph_recall(ints, got, k=10, sample=500, device=CPU)
    idx = np.random.default_rng(0).choice(len(ints), 500, replace=False)
    d = ((ints[idx, None, :] - ints[None]) ** 2).sum(-1)
    near = np.argsort(d, axis=1, kind="stable")[:, :11]
    truth = np.array([row[row != i][:10] for i, row in zip(idx, near)])
    assert r == recall_at_k(got[idx], truth, 10)
    assert r > 0.85


def test_knn_graph_drops_self_and_pads():
    found = np.array([[0, 3, 4, 5], [7, 1, -1, 1], [2, 5, 6, 7]])
    got = knn_graph._drop_self(found, np.array([0, 1, 9]), 3)
    np.testing.assert_array_equal(got, [[3, 4, 5], [7, -1, -1], [2, 5, 6]])
    np.testing.assert_array_equal(knn_graph._drop_self(found[:, :2], np.arange(3), 3),
                                  [[3, -1, -1], [7, -1, -1], [5, -1, -1]])


@pytest.fixture(scope="module")
def gauss():
    return np.random.default_rng(9).standard_normal((1000, 16)).astype(np.float32)


CASES = {
    "vamana_1pass": ("build_vamana", "VamanaParams", dict(max_deg=16, beam=32, passes=1, seed=0)),
    "vamana_2pass": ("build_vamana", "VamanaParams", dict(max_deg=12, beam=24, passes=2, seed=3)),
    "hnsw": ("build_hnsw", "HNSWParams", dict(m=6, ef_construction=24, seed=1)),
    "hnsw_simple": ("build_hnsw", "HNSWParams", dict(m=6, ef_construction=16, heuristic=False,
                                                      seed=2)),
    "hcnng": ("build_hcnng", "HCNNGParams", dict(c_max=128, replicas=4, max_deg=30, seed=1)),
    "hcnng_capped": ("build_hcnng", "HCNNGParams", dict(c_max=64, replicas=6, max_deg=8,
                                                         seed=4)),
}


@pytest.mark.parametrize("case", tuple(CASES))
def test_baseline_equals_reference(gauss, case):
    fn, params, kw = CASES[case]
    x = gauss if case != "vamana_2pass" else gauss[:600]
    wg, ws, wst = getattr(jbase, fn)(x, getattr(jbase, params)(**kw))
    gg, gs, gst = getattr(baselines, fn)(x, getattr(baselines, params)(**kw), device=CPU)
    assert gg.dtype == wg.dtype
    np.testing.assert_array_equal(gg, wg)
    assert gs == ws
    assert {k: v for k, v in gst.items() if k != "build_time"} == \
        {k: v for k, v in wst.items() if k != "build_time"}


def test_hcnng_union_on_integer_leaves_equals_reference():
    """Integer points (exact leaf distances, so many equal-distance edges
    across replicas): the capped union's order and dedup are the
    reference's."""
    x = np.random.default_rng(5).integers(0, 6, (800, 8)).astype(np.float32)
    kw = dict(c_max=64, replicas=8, max_deg=6, seed=2)
    wg, ws, _ = jbase.build_hcnng(x, jbase.HCNNGParams(**kw))
    gg, gs, _ = baselines.build_hcnng(x, baselines.HCNNGParams(**kw), device=CPU)
    np.testing.assert_array_equal(gg, wg)
    assert gs == ws


def test_entry_points_need_a_card_unless_told(monkeypatch, ints):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        knn_graph.knn_graph_pipnn(ints, params=_params(True))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        knn_graph.knn_graph_recall(ints, np.zeros((1500, 10), np.int64))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        baselines.build_hcnng(ints, baselines.HCNNGParams(c_max=256, replicas=1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        baselines.build_vamana(ints, baselines.VamanaParams(max_deg=8, beam=8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        baselines.build_hnsw(ints, baselines.HNSWParams(m=4, ef_construction=8))
