"""The kernel-routed leader assignment against the JAX package on the CPU:
the plain versions of ``pairwise_distance``, ``pairwise_distance_int8`` and
``rowwise_topk`` against the Pallas kernels in interpret mode, and
``leader_assign(use_kernels=True)`` against the reference's
``leader_assign(use_pallas=True)``.

Tolerances: exact on integer data (every float32 sum is an integer below
2^24) and for the int8 distances and the top-k selection; on Gaussian data
the float32 distances agree to rtol 1e-5 plus atol 1e-4 of |a|^2 + |b|^2
(another summation order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.leader_assign import leader_assign as j_leader_assign
from repro.kernels.distance import pairwise_distance as j_pairwise
from repro.kernels.distance import pairwise_distance_int8 as j_pairwise_int8
from repro.kernels.topk import rowwise_topk as j_rowwise_topk
from repro_torch.core.leader_assign import leader_assign
from repro_torch.kernels import distance, topk


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: under six test workers the default (one a core)
    oversubscribes the cores on these small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


METRICS = ("l2", "mips", "cosine")


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------ pairwise_distance ---

@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("b,m,n,d", [(1, 70, 130, 16), (3, 5, 9, 33)])
def test_pairwise_distance_plain_exact_on_integers(metric, b, m, n, d):
    """TPU kernel #8 in interpret mode.  Tolerance: exact for l2 and mips;
    cosine divides by a product of two rounded square roots, held to 4 eps."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (b, m, d)).astype(np.float32)
    bb = rng.integers(0, 256, (b, n, d)).astype(np.float32)
    a[0, 1] = bb[0, 2]                                    # a zero distance
    want = np.asarray(j_pairwise(jnp.asarray(a), jnp.asarray(bb), metric=metric,
                                 interpret=True))
    got = distance.pairwise_distance(_t(a), _t(bb), metric).numpy()
    assert got.shape == (b, m, n)
    if metric == "cosine":
        np.testing.assert_allclose(got, want, rtol=0, atol=4 * np.finfo(np.float32).eps)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("metric", METRICS)
def test_pairwise_distance_plain_gaussian(metric):
    """Tolerance: rtol 1e-5, atol 1e-4 * (|a|^2 + |b|^2) (1e-5 for cosine)."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((2, 40, 48)).astype(np.float32)
    bb = rng.standard_normal((2, 150, 48)).astype(np.float32)
    want = np.asarray(j_pairwise(jnp.asarray(a), jnp.asarray(bb), metric=metric,
                                 interpret=True))
    got = distance.pairwise_distance(_t(a), _t(bb), metric).numpy()
    scale = (a * a).sum(-1)[:, :, None] + (bb * bb).sum(-1)[:, None, :]
    atol = 1e-5 if metric == "cosine" else 1e-4 * scale
    assert (np.abs(got - want) <= 1e-5 * np.abs(want) + atol).all()


@pytest.mark.parametrize("b,m,n,d", [(1, 130, 70, 128), (2, 9, 17, 37)])
def test_pairwise_distance_int8_plain_exact(b, m, n, d):
    """TPU kernel #9 in interpret mode.  Tolerance: exact (int32)."""
    rng = np.random.default_rng(2)
    a = rng.integers(-127, 128, (b, m, d)).astype(np.int8)
    bb = rng.integers(-127, 128, (b, n, d)).astype(np.int8)
    a[0, 0], bb[0, 0] = 127, -127                         # the extreme products
    want = np.asarray(j_pairwise_int8(jnp.asarray(a), jnp.asarray(bb), interpret=True))
    got = distance.pairwise_distance_int8(_t(a), _t(bb))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_pairwise_wrappers_check_shapes_and_count_nothing_on_cpu():
    a = torch.zeros((2, 3, 4))
    before = (distance.launches, distance.launches_int8)
    distance.pairwise_distance(a, a)
    distance.pairwise_distance_int8(a.to(torch.int8), a.to(torch.int8))
    assert (distance.launches, distance.launches_int8) == before
    with pytest.raises(ValueError):
        distance.pairwise_distance(a, torch.zeros((2, 3, 5)))
    with pytest.raises(TypeError):
        distance.pairwise_distance_int8(a, a)


# ---------------------------------------------------------- rowwise_topk ---

def _masked_matrix(rng, b, m, n, hi=6):
    """Small integer values (many exact ties), +inf masks, a fully masked
    row and a row with fewer finite entries than any k tested."""
    d = rng.integers(0, hi, (b, m, n)).astype(np.float32)
    d[rng.random((b, m, n)) < 0.3] = np.inf
    d[0, 0] = np.inf
    d[0, 1] = np.inf
    d[0, 1, [3, n - 1]] = [2.0, 1.0]
    return d


@pytest.mark.parametrize("k", (1, 3, 10, 16, 17, 32))
@pytest.mark.parametrize("b,m,n", [(1, 37, 200), (2, 130, 11), (1, 4, 256)])
def test_rowwise_topk_plain_exact(k, b, m, n):
    """TPU kernel #10 in interpret mode, with ties, +inf masks, -1 ids, k
    above the number of finite columns (and above n), M and N not multiples
    of 128.  Tolerance: exact, ids and values, in (ids, values) order."""
    d = _masked_matrix(np.random.default_rng(3), b, m, n)
    want_i, want_v = j_rowwise_topk(jnp.asarray(d), k=k, interpret=True)
    got_i, got_v = topk.rowwise_topk(_t(d), k)
    assert got_i.dtype == torch.int32 and got_i.shape == (b, m, k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    ids = got_i.numpy()
    assert (ids[0, 0] == -1).all()
    np.testing.assert_array_equal(ids[0, 1, :2], [n - 1, 3][:k])   # two finite entries
    assert (ids[0, 1, 2:] == -1).all()


def test_rowwise_topk_ties_go_to_the_lower_column():
    d = np.full((1, 2, 300), 5.0, np.float32)
    d[0, 1, ::7] = 1.0
    got_i, got_v = topk.rowwise_topk(_t(d), 4)
    np.testing.assert_array_equal(got_i.numpy()[0], [[0, 1, 2, 3], [0, 7, 14, 21]])
    want_i, _ = j_rowwise_topk(jnp.asarray(d), k=4, interpret=True)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_rowwise_topk_wrapper_checks_and_counts_nothing_on_cpu():
    before = topk.launches
    topk.rowwise_topk(torch.zeros((1, 2, 3)), 2)
    assert topk.launches == before
    with pytest.raises(ValueError):
        topk.rowwise_topk(torch.zeros((2, 3)), 2)
    with pytest.raises(ValueError):
        topk.rowwise_topk(torch.zeros((1, 2, 3)), 0)


# ------------------------------------------------ leader assignment route ---

@pytest.mark.parametrize("metric", ("l2", "mips"))
@pytest.mark.parametrize("batched", (False, True))
def test_leader_assign_kernel_route_matches_reference_pallas_route(metric, batched):
    """``use_kernels=True`` against the reference's ``use_pallas=True`` in
    interpret mode, with leader and point masks, on integer data (many
    tied distances).  Tolerance: identical ids, -1 included."""
    rng = np.random.default_rng(4)
    shape_p, shape_l = ((3, 60, 12), (3, 9, 12)) if batched else ((150, 12), (20, 12))
    pts = rng.integers(0, 4, shape_p).astype(np.float32)
    lead = rng.integers(0, 4, shape_l).astype(np.float32)
    lv = rng.random(shape_l[:-1]) < 0.7
    lv[..., :2] = True
    pv = rng.random(shape_p[:-1]) < 0.9
    f = 4
    want = np.asarray(j_leader_assign(
        jnp.asarray(pts), jnp.asarray(lead), f, metric=metric, point_valid=jnp.asarray(pv),
        leader_valid=jnp.asarray(lv), use_pallas=True, interpret=True))
    got = leader_assign(_t(pts), _t(lead), f, metric=metric, point_valid=_t(pv),
                        leader_valid=_t(lv), use_kernels=True).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[~pv] == -1).all()                 # masked points: all -1


def test_leader_assign_kernel_route_equals_topf_route_where_rows_are_full():
    """Without masks the kernel route and the default ``topf`` route pick
    the same leaders (the same tie rule); with masks they differ only where
    a row has fewer than f finite entries (-1 against arbitrary ids)."""
    rng = np.random.default_rng(5)
    pts = _t(rng.integers(0, 256, (500, 16)).astype(np.float32))
    lead = pts[rng.choice(500, 30, replace=False)]
    for f in (1, 3, 10):
        assert torch.equal(leader_assign(pts, lead, f, use_kernels=True),
                           leader_assign(pts, lead, f))
    lv = torch.zeros(30, dtype=torch.bool)
    lv[:2] = True
    a = leader_assign(pts, lead, 3, leader_valid=lv, use_kernels=True)
    b = leader_assign(pts, lead, 3, leader_valid=lv)
    assert torch.equal(a[:, :2], b[:, :2]) and (a[:, 2] == -1).all()
