"""Stage 1 in full against the JAX package on the CPU: capacity routing, the
static two-level carve, the numpy ``"host"`` carve, replicas, the ablation
partitioners, and the build through each of them.  Inputs come from numpy
seeds and are integer-valued where the leaves are compared bit for bit, so
every distance is exact on both sides."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipnn as jpipnn
from repro.core import rbc as jrbc
from repro.core import sketch as jsketch
from repro.core.beam_search import brute_force_knn as j_brute_force_knn
from repro.core.beam_search import recall_at_k as j_recall_at_k
from repro.core.leaf import LeafParams as JLeafParams
from repro.distributed.routing import group_by_capacity as j_group_by_capacity
from repro_torch.core import pipnn, rbc
from repro_torch.core.leaf import LeafParams
from repro_torch.data import VectorPipelineConfig, dyadic_hyperplanes, make_vectors, sift_like
from repro_torch.distributed.routing import group_by_capacity


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


def _same_leaves(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _clustered(n=3000, d=16, n_clusters=8, seed=1):
    """Integer points in few clusters: buckets and leaves overflow."""
    return sift_like(make_vectors(VectorPipelineConfig(n=n, dim=d, n_clusters=n_clusters,
                                                       seed=seed)))


# assign_rows = 1024 makes the reference's row sub-batch 1024, so n = 3000
# pads to n_pad = 3072 and the Weyl orders run over padded entries
STATIC = dict(c_max=64, c_min=8, fanout=(3, 2), seed=3, assign_rows=1024)


# --------------------------------------------------------------- routing ---

@pytest.mark.parametrize("shuffle", (False, True))
def test_group_by_capacity_matches_reference(shuffle):
    rng = np.random.default_rng(0)
    e, n_groups, cap = 2000, 16, 64
    keys = rng.integers(0, n_groups, e).astype(np.int32)
    keys[:300] = 3                                          # one key far past cap
    valid = rng.random(e) < 0.85
    pay_i = rng.integers(0, 10_000, e).astype(np.int32)
    pay_f = rng.standard_normal((e, 2)).astype(np.float32)
    assert np.bincount(keys[valid], minlength=n_groups).max() > cap   # overflow
    want, want_ok = j_group_by_capacity(jnp.asarray(keys), jnp.asarray(valid), n_groups, cap,
                                        [jnp.asarray(pay_i), jnp.asarray(pay_f)],
                                        shuffle=shuffle)
    got, got_ok = group_by_capacity(_t(keys), _t(valid), n_groups, cap,
                                    [_t(pay_i), _t(pay_f)], shuffle=shuffle)
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------------ static carve ---

@pytest.mark.parametrize("metric", ("l2", "mips"))
def test_static_carve_equals_reference_under_overflow(metric):
    """Clustered integer data: some level-0 bucket is asked for more than
    cap_b placements and some leaf for more than c_max, so which replicas
    drop is decided by the Weyl orders; the matrix is the reference's."""
    x = _clustered()
    xt = _t(x)
    p = rbc.RBCParams(metric=metric, **STATIC)
    sh = rbc.carve_chunks(len(x), p)
    assert sh == jrbc.carve_chunks(len(x), jrbc.RBCParams(metric=metric, **STATIC))
    assert sh["n_pad"] > len(x)
    lead0 = rbc.static_leaders(len(x), p)
    a0 = jrbc._nearest_leaders(x, x[lead0], sh["f0r"], metric)
    assert np.bincount(a0.ravel(), minlength=sh["l0"]).max() > sh["cap_b"]
    bpid, bval = rbc.static_level0(xt, _t(lead0), sh, metric)
    a1 = rbc.static_level1(xt, bpid, bval, *rbc.static_level1_leaders(bpid, bval, sh), sh,
                           metric)
    raw = rbc.static_leaf_ids(xt, p)
    assert int((raw >= 0).sum()) < int((a1 >= 0).sum())    # leaf overflow dropped some
    assert bool((raw >= 0).all(dim=1).any())

    want = jrbc.ball_carve_device(x, jrbc.RBCParams(metric=metric, **STATIC))
    got = rbc.ball_carve_device(xt, p)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_static_carve_salvage_equals_reference():
    """The duplicate-heavy case of the reference's salvage test on integer
    data: a dense cluster overflows every ball it reaches, its lost points
    go into appended salvage leaves, as in the reference."""
    rng = np.random.default_rng(21)
    x = np.concatenate([np.zeros((1500, 8), np.float32),
                        rng.integers(-20, 20, (500, 8)).astype(np.float32)])
    kw = dict(c_max=64, c_min=8, fanout=(3, 2), seed=6)
    p = rbc.RBCParams(**kw)
    raw = rbc.static_leaf_ids(_t(x), p).numpy()
    assert rbc.padded_coverage(raw, len(x)) < len(x)        # salvage is needed
    got = rbc.ball_carve_device(_t(x), p)
    np.testing.assert_array_equal(got, jrbc.ball_carve_device(x, jrbc.RBCParams(**kw)))
    assert got.shape[0] > int((raw >= 0).any(axis=1).sum())
    assert rbc.padded_coverage(got, len(x)) == len(x)
    dup = np.ones((600, 8), np.float32)                     # all identical
    np.testing.assert_array_equal(rbc.ball_carve_device(_t(dup), p),
                                  jrbc.ball_carve_device(dup, jrbc.RBCParams(**kw)))


def test_static_carve_at_most_c_max_points_is_one_leaf():
    x = np.arange(50 * 4, dtype=np.float32).reshape(50, 4)
    p = rbc.RBCParams(c_max=64)
    got = rbc.ball_carve_device(_t(x), p)
    np.testing.assert_array_equal(got, jrbc.ball_carve_device(x, jrbc.RBCParams(c_max=64)))
    assert got.shape == (1, 64)


@pytest.mark.parametrize("block_rows", (300, 1 << 19))
def test_static_carve_block_size_changes_nothing(monkeypatch, block_rows):
    """Level 0 in blocks of ``block_rows`` points, level 1 in blocks of
    whole buckets (one bucket a block at 300 rows, all at once at 2^19):
    the same matrix as the reference's."""
    x = _clustered(seed=2)
    monkeypatch.setattr(rbc, "_BLOCK_ROWS", block_rows)
    sh = rbc.carve_chunks(len(x), rbc.RBCParams(**STATIC))
    per_block = rbc.static_level1_block_buckets(sh)
    assert per_block == 1 if block_rows == 300 else per_block >= sh["l0"]
    np.testing.assert_array_equal(rbc.ball_carve_device(_t(x), rbc.RBCParams(**STATIC)),
                                  jrbc.ball_carve_device(x, jrbc.RBCParams(**STATIC)))


# -------------------------------------------------------- worklist carves ---

@pytest.mark.parametrize("metric", ("l2", "mips"))
def test_host_carve_equals_reference(metric):
    """The numpy oracle, picked explicitly and by ``"auto"`` on the CPU,
    and the device worklist on the CPU: the reference host carve's leaves."""
    x = _clustered(n=2500, seed=4)
    kw = dict(c_max=128, c_min=16, p_samp=0.02, fanout=(3, 2), metric=metric, seed=9)
    want = jrbc.ball_carve(x, jrbc.RBCParams(**kw), execution="host")
    p = rbc.RBCParams(**kw)
    assert rbc.resolve_execution(p, CPU) == "host"
    _same_leaves(rbc.ball_carve(_t(x), p), want)
    _same_leaves(rbc.ball_carve(_t(x), p, execution="host"), want)
    _same_leaves(rbc.ball_carve(_t(x), rbc.RBCParams(execution="device", **kw)), want)


def test_resolve_execution_follows_the_device():
    p = rbc.RBCParams()
    assert rbc.resolve_execution(p, "cuda") == "device"
    assert rbc.resolve_execution(p, torch.device("cpu")) == "host"
    for mode in ("host", "device", "static"):
        assert rbc.resolve_execution(rbc.RBCParams(execution=mode), "cuda") == mode


@pytest.mark.parametrize("execution", ("static", "device", "host"))
def test_partition_padded_with_replicas_equals_reference(execution):
    """Two replicas, reseeded seed + 7919 r: static concatenates the
    matrices, the worklists stack the union of leaves."""
    x = _clustered(n=2000, seed=5)
    kw = dict(c_max=64, c_min=8, fanout=(3, 2), seed=2, replicas=2, execution=execution)
    want = jrbc.partition_padded(x, jrbc.RBCParams(**kw))
    got = rbc.partition_padded(_t(x), rbc.RBCParams(**kw))
    np.testing.assert_array_equal(got, want)
    if execution == "static":
        one = rbc.ball_carve_device(_t(x), rbc.RBCParams(**kw))
        np.testing.assert_array_equal(got[:len(one)], one)
        assert len(got) > len(one)
    else:
        _same_leaves(rbc.ball_carve_replicated(_t(x), rbc.RBCParams(**kw)),
                     jrbc.ball_carve_replicated(x, jrbc.RBCParams(**kw)))


def test_static_ball_carve_returns_the_matrix_rows():
    x = _clustered(n=1500, seed=6)
    p = rbc.RBCParams(**STATIC)
    rows = rbc.ball_carve_device(_t(x), p)
    _same_leaves(rbc.ball_carve(_t(x), p, execution="static"),
                 [r[r >= 0].astype(np.int64) for r in rows])


# --------------------------------------------------- ablation partitioners ---

@pytest.mark.parametrize("metric", ("l2", "mips"))
@pytest.mark.parametrize("method", ("binary", "kmeans", "sorting_lsh"))
def test_ablation_partitioners_equal_reference(method, metric):
    rng = np.random.default_rng(3)
    x = rng.integers(-8, 8, (1500, 12)).astype(np.float32)
    kw = dict(c_max=96, c_min=12, p_samp=0.02, fanout=(3, 2), metric=metric, seed=5,
              replicas=2)
    want = jrbc.partition(x, jrbc.RBCParams(**kw), method)
    _same_leaves(rbc.partition(_t(x), rbc.RBCParams(**kw), method), want)
    np.testing.assert_array_equal(rbc.partition_padded(_t(x), rbc.RBCParams(**kw), method),
                                  jrbc.partition_padded(x, jrbc.RBCParams(**kw), method))


def test_ablation_helpers_equal_reference():
    rng = np.random.default_rng(11)
    bits = rng.random((300, 70)) < 0.5
    np.testing.assert_array_equal(rbc.bit_lex_order(bits), jrbc.bit_lex_order(bits))
    dup = np.ones((400, 4), np.float32)
    _same_leaves(rbc.binary_partition(dup, c_max=16, seed=3),
                 jrbc.binary_partition(dup, c_max=16, seed=3))
    p = dict(c_max=64, c_min=8, p_samp=0.05, fanout=(2,), seed=1)
    _same_leaves(rbc.kmeans_carve(dup[:, :3].copy(), rbc.RBCParams(**p)),
                 jrbc.kmeans_carve(dup[:, :3].copy(), jrbc.RBCParams(**p)))


# ------------------------------------------------------------ the build ---

def _small_params(port: bool, **rbc_kw):
    rp, lp, pp = ((rbc.RBCParams, LeafParams, pipnn.PiPNNParams) if port
                  else (jrbc.RBCParams, JLeafParams, jpipnn.PiPNNParams))
    return pp(rbc=rp(c_max=128, c_min=16, fanout=(3, 2), **rbc_kw), leaf=lp(k=2),
              hash_bits=12, l_max=32, max_deg=16, seed=1)


def test_static_build_equals_reference(monkeypatch):
    """Integer 4096 x 32 data and the same dyadic hyperplanes: the static
    build's graph, dists, entry point and Stage-1 stats are the
    reference's static build's."""
    x = sift_like(make_vectors(VectorPipelineConfig(n=4096, dim=32, n_clusters=32, seed=0)))
    hp = dyadic_hyperplanes(7, 12, 32)
    monkeypatch.setattr(jsketch, "make_hyperplanes",
                        lambda key, m, d, dtype=jnp.float32: jnp.asarray(hp))
    want = jpipnn.build(x, _small_params(False, execution="static"), streaming=True)
    got = pipnn.build(x, _small_params(True, execution="static"), hyperplanes=hp, device=CPU)
    np.testing.assert_array_equal(got.graph.numpy(), want.graph)
    np.testing.assert_array_equal(got.dists.numpy(), want.dists)
    assert got.start == want.start
    for key in ("partition_execution", "n_leaves", "point_repeat", "pad_ratio",
                "partition_uncovered", "n_candidate_edges"):
        assert got.stats[key] == want.stats[key], key


def test_static_build_recall_at_parity_with_host_build():
    """The reference's end-to-end check on the port: the static build's
    recall@10 is at least the host build's - 0.03."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2000, 32)).astype(np.float32)
    q = x[:64] + 0.01 * rng.standard_normal((64, 32)).astype(np.float32)
    truth = j_brute_force_knn(x, q, 10)
    recalls = {}
    for mode in ("host", "static"):
        idx = pipnn.build(x, _small_params(True, execution=mode), device=CPU)
        assert idx.stats["partition_execution"] == mode
        assert idx.stats["partition_uncovered"] == 0
        recalls[mode] = j_recall_at_k(pipnn.search(idx, x, q, k=10, beam=64, device=CPU),
                                      truth, 10)
    assert recalls["static"] >= recalls["host"] - 0.03, recalls


STRATEGIES = (("rbc", "auto", False), ("rbc", "host", False), ("rbc", "device", False),
              ("rbc", "static", False), ("binary", "auto", False), ("kmeans", "auto", False),
              ("sorting_lsh", "static", False), ("rbc", "auto", True))


@pytest.mark.parametrize("partitioner,execution,given", STRATEGIES)
def test_partition_execution_stat_equals_reference(partitioner, execution, given):
    """``stats["partition_execution"]``: the resolved strategy, "host" for
    a non-RBC partitioner, "caller" with ``leaves=``; the leaves and Stage-1
    stats equal the reference's too."""
    x = np.random.default_rng(8).integers(0, 16, (700, 8)).astype(np.float32)
    leaves = [np.arange(s, min(s + 128, 700)) for s in range(0, 700, 100)] if given else None
    jp = _small_params(False, execution=execution).with_(partitioner=partitioner)
    tp = _small_params(True, execution=execution).with_(partitioner=partitioner)
    want = jpipnn.build(x, jp, leaves=leaves)
    got = pipnn.build(x, tp, leaves=leaves, device=CPU)
    for key in ("partition_execution", "n_leaves", "point_repeat", "pad_ratio",
                "partition_uncovered"):
        assert got.stats[key] == want.stats[key], key


def test_params_carry_the_reference_stage1_fields():
    import dataclasses

    def fields(cls):
        return {f.name: f.default for f in dataclasses.fields(cls)
                if f.default is not dataclasses.MISSING}

    assert fields(rbc.RBCParams) == fields(jrbc.RBCParams)
    assert pipnn.PiPNNParams().partitioner == jpipnn.PiPNNParams().partitioner == "rbc"
