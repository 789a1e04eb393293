"""The port's build path against the JAX package, module by module and end
to end, on the CPU.  Inputs come from numpy seeds; random state that the
two packages draw differently (leaves, hyperplanes) is handed to both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipnn as jpipnn
from repro.core import sketch as jsketch
from repro.core.beam_search import brute_force_knn as j_brute_force_knn
from repro.core.beam_search import recall_at_k as j_recall_at_k
from repro.core.hashprune import hashprune_batch as j_hashprune_batch
from repro.core.hashprune import hashprune_flat as j_hashprune_flat
from repro.core.leader_assign import leader_assign as j_leader_assign
from repro.core.leaf import LeafParams as JLeafParams
from repro.core.rbc import RBCParams as JRBCParams
from repro.core.rbc import ball_carve as j_ball_carve
from repro.core.robust_prune import final_prune as j_final_prune
from repro.kernels.topk import topf as j_topf
from repro_torch.convert import reservoir_from_arrays
from repro_torch.core import pipnn
from repro_torch.core.hashprune import hashprune_batch, hashprune_flat
from repro_torch.core.leader_assign import leader_assign
from repro_torch.core.leaf import LeafParams
from repro_torch.core.rbc import RBCParams, ball_carve
from repro_torch.core.robust_prune import final_prune
from repro_torch.core.sketch import edge_hashes_from_ids, hash_from_sketches, sketch
from repro_torch.data import (VectorPipelineConfig, dyadic_hyperplanes, make_queries,
                              make_vectors, sift_like)
from repro_torch.kernels.topk import topf


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: under six test workers the default (one a core)
    oversubscribes the cores on these small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


CPU = "cpu"


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------- selection ---

@pytest.mark.parametrize("f", (1, 3, 8))
def test_topf_ties_go_to_lower_index(f):
    rng = np.random.default_rng(0)
    d = rng.integers(0, 3, (50, 20)).astype(np.float32)    # heavy ties
    d[:5] = np.inf                                          # all-masked rows
    d[5:10, ::2] = np.inf
    np.testing.assert_array_equal(topf(_t(d), f).numpy(), np.asarray(j_topf(jnp.asarray(d), f)))


# --------------------------------------------------------------- hashing ---

def test_sketches_and_hashes_match_given_the_same_hyperplanes():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((300, 24)).astype(np.float32)
    hp = dyadic_hyperplanes(3, 12, 24)
    sk_j = np.asarray(jsketch.sketch(jnp.asarray(x), jnp.asarray(hp)))
    sk_t = sketch(_t(x), _t(hp))
    np.testing.assert_allclose(sk_t.numpy(), sk_j, rtol=1e-5, atol=1e-5)
    # hashes from the SAME sketches are bit-exact
    src = rng.integers(-1, 300, 4000).astype(np.int32)
    dst = rng.integers(-1, 300, 4000).astype(np.int32)
    want = jsketch.edge_hashes_from_ids(jnp.asarray(sk_j), jnp.asarray(src), jnp.asarray(dst))
    np.testing.assert_array_equal(edge_hashes_from_ids(_t(sk_j), _t(src), _t(dst)).numpy(),
                                  np.asarray(want))
    want_h = jsketch.hash_from_sketches(jnp.asarray(sk_j[:50]), jnp.asarray(sk_j[50:100]))
    np.testing.assert_array_equal(hash_from_sketches(_t(sk_j[:50]), _t(sk_j[50:100])).numpy(),
                                  np.asarray(want_h))


# ---------------------------------------------------------------- stage 1 ---

@pytest.mark.parametrize("metric", ("l2", "mips"))
def test_leader_assign_matches_jax(metric):
    rng = np.random.default_rng(2)
    pts = rng.integers(0, 6, (200, 8)).astype(np.float32)   # integer: exact, tied
    leaders = pts[rng.choice(200, 24, replace=False)]
    lv = np.ones(24, bool)
    lv[20:] = False
    want = j_leader_assign(jnp.asarray(pts), jnp.asarray(leaders), 5, metric=metric,
                           leader_valid=jnp.asarray(lv))
    got = leader_assign(_t(pts), _t(leaders), 5, metric=metric, leader_valid=_t(lv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", (0, 5))
def test_rbc_leaves_equal_reference_host_carve(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 40, (3000, 16)).astype(np.float32)
    x[100:160] = x[99]                                       # a duplicate cluster
    kw = dict(c_max=128, c_min=16, fanout=(4, 2), seed=seed)
    want = j_ball_carve(x, JRBCParams(**kw), execution="host")
    got = ball_carve(_t(x), RBCParams(**kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------- HashPrune ---

def _edges(seed, n, e, metric):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n + 1, e).astype(np.int32)        # n = padding
    dst = np.where(src < n, rng.integers(0, n, e), -1).astype(np.int32)
    hashes = ((src * 31 + dst * 7) % 16).astype(np.int32)
    dist = ((dst * 131 + src * 17) % 23 / 4.0).astype(np.float32)
    if metric == "mips":
        dist -= 3.0
    dist[src == n] = np.inf
    ndup = e // 8                                            # exact duplicate edges
    for a in (src, dst, hashes, dist):
        a[:ndup] = a[e // 2: e // 2 + ndup]
    return src, dst, hashes, dist


@pytest.mark.parametrize("metric", ("l2", "mips"))
@pytest.mark.parametrize("seed", (0, 1, 2))
def test_hashprune_flat_matches_jax(seed, metric):
    n, l_max = 50, 8
    args = _edges(seed, n, 1500, metric)
    want = j_hashprune_flat(*(jnp.asarray(a) for a in args), n_points=n, l_max=l_max)
    got = hashprune_flat(*(_t(a) for a in args), n_points=n, l_max=l_max)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n_cand,l_max", ((40, 16), (10, 16)))
def test_hashprune_batch_matches_jax(n_cand, l_max):
    rng = np.random.default_rng(3)
    ids = rng.integers(-1, 30, (20, n_cand)).astype(np.int32)
    hashes = np.where(ids >= 0, (ids * 7) % 5, 0).astype(np.int32)
    dists = np.where(ids >= 0, (ids * 13 % 9) / 2.0, np.inf).astype(np.float32)
    want = j_hashprune_batch(jnp.asarray(ids), jnp.asarray(hashes), jnp.asarray(dists),
                             l_max=l_max)
    got = hashprune_batch(_t(ids), _t(hashes), _t(dists), l_max=l_max)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------- final prune ---

@pytest.mark.parametrize("metric", ("l2", "mips"))
def test_final_prune_matches_jax_on_the_same_reservoir(metric):
    rng = np.random.default_rng(4)
    n, l_max = 300, 24
    x = rng.integers(0, 20, (n, 12)).astype(np.float32)
    src = rng.integers(0, n, 6000).astype(np.int32)
    dst = rng.integers(0, n, 6000).astype(np.int32)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    diff = x[src] - x[dst]
    dist = (np.sum(diff * diff, axis=1) if metric == "l2"
            else -np.sum(x[src] * x[dst], axis=1)).astype(np.float32)
    hashes = ((src * 5 + dst * 3) % 32).astype(np.int32)
    res = j_hashprune_flat(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(hashes),
                           jnp.asarray(dist), n_points=n, l_max=l_max)
    alpha = 1.44 if metric == "l2" else 1.0
    want_g, want_d = j_final_prune(x, res, alpha=alpha, max_deg=16, metric=metric, chunk=64)
    tres = reservoir_from_arrays(*(np.asarray(a) for a in res), device=CPU)
    got_g, got_d = final_prune(_t(x), tres, alpha=alpha, max_deg=16, metric=metric, chunk=100)
    np.testing.assert_array_equal(got_g.numpy(), want_g)
    np.testing.assert_array_equal(got_d.numpy(), want_d)


# ------------------------------------------------------------ end to end ---

BENCH_N, BENCH_D = 4096, 32     # the BENCH_build.json shape


def _bench_params(port: bool, k: int = 2):
    rbc, leaf, pp = ((RBCParams, LeafParams, pipnn.PiPNNParams) if port
                     else (JRBCParams, JLeafParams, jpipnn.PiPNNParams))
    return pp(rbc=rbc(c_max=256, c_min=32, fanout=(4, 2)), leaf=leaf(k=k),
              hash_bits=12, l_max=64, max_deg=32, seed=0)


@pytest.mark.parametrize("k", (2, 12))
def test_streaming_build_equals_reference_given_leaves_and_hyperplanes(monkeypatch, k):
    """Integer-valued 4096 x 32 data, the reference's own leaves and the
    same dyadic hyperplanes: the graphs, their dists and the entry point
    are identical, at the paper's leaf k and at a k past 8 (the card
    kernel's wide lists)."""
    cfg = VectorPipelineConfig(n=BENCH_N, dim=BENCH_D, n_clusters=32, seed=0)
    x = sift_like(make_vectors(cfg))
    hp = dyadic_hyperplanes(7, 12, BENCH_D)
    monkeypatch.setattr(jsketch, "make_hyperplanes",
                        lambda key, m, d, dtype=jnp.float32: jnp.asarray(hp))
    jp = _bench_params(port=False, k=k)
    leaves = j_ball_carve(x, jp.rbc, execution="host")
    want = jpipnn.build(x, jp, leaves=leaves, streaming=True)
    got = pipnn.build(x, _bench_params(port=True, k=k), leaves=leaves, hyperplanes=hp,
                      device=CPU)
    np.testing.assert_array_equal(got.graph.numpy(), want.graph)
    np.testing.assert_array_equal(got.dists.numpy(), want.dists)
    assert got.start == want.start
    for key in ("n_leaves", "point_repeat", "pad_ratio", "n_candidate_edges",
                "stream_chunk_leaves", "peak_edge_bytes", "merge_workspace_bytes"):
        assert got.stats[key] == want.stats[key], key
    assert set(got.timings) == set(want.timings)


def test_recall_within_001_of_reference_on_own_rng():
    """Gaussian 4096 x 32 data (the BENCH_build.json shape and params), each
    package on its own random state: recall@10 within 0.01."""
    cfg = VectorPipelineConfig(n=BENCH_N, dim=BENCH_D, n_clusters=32, seed=0)
    x, q = make_vectors(cfg), make_queries(cfg, 256)
    truth = j_brute_force_knn(x, q, 10)
    want = jpipnn.build(x, _bench_params(port=False))
    r_ref = j_recall_at_k(jpipnn.search(want, x, q, k=10, beam=64), truth, 10)
    got = pipnn.build(x, _bench_params(port=True), device=CPU)
    r_port = j_recall_at_k(pipnn.search(got, x, q, k=10, beam=64, device=CPU), truth, 10)
    assert got.stats["partition_uncovered"] == 0
    assert abs(r_port - r_ref) <= 0.01, (r_port, r_ref)


@pytest.mark.parametrize("k", (0, -1))
def test_leaf_k_below_one_is_refused(monkeypatch, k):
    """k < 1 raises ``ValueError`` from ``build`` (before Stage 1: the
    partition is never called) and from ``leaf_knn``, on the CPU."""
    from repro_torch.core import leaf

    x = np.random.default_rng(3).standard_normal((200, 8)).astype(np.float32)
    called = []
    monkeypatch.setattr(pipnn, "partition_padded", lambda *a, **kw: called.append(1))
    with pytest.raises(ValueError, match="at least 1"):
        pipnn.build(x, pipnn.PiPNNParams(leaf=LeafParams(k=k)), device=CPU)
    assert not called
    ids = torch.arange(64, dtype=torch.int32).reshape(2, 32)
    with pytest.raises(ValueError, match="at least 1"):
        leaf.leaf_knn(torch.from_numpy(x), ids, k=k)
