"""The port's int8 and bfloat16 serving against the JAX package on the CPU:
the quantization scheme, the int8 gather-distance plain version, and
``ServingIndex``/``search`` with ``dtype="int8"`` and ``torch.bfloat16``.

Tolerances: the quantization, the int8 gather and the int8 search are held
bit for bit (integer dot products are exact and every float32 operation is
done in the reference's order); bfloat16 search is held to identical ids on
integer data (exact in bfloat16 and float32) and to recall within 0.01 of
the reference on Gaussian data (the f32 sums run in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import beam_search as jbs
from repro.core import pipnn as jpipnn
from repro.core.leaf import LeafParams as JLeafParams
from repro.core.metrics import point_norms as j_point_norms
from repro.core.rbc import RBCParams as JRBCParams
from repro.core.serving import ServingIndex as JServingIndex
from repro.kernels.gather_distance import gather_distance_int8 as j_gather_int8
from repro.kernels import ref
from repro_torch.convert import index_from_arrays, serving_index_from_arrays
from repro_torch.core import beam_search as bs
from repro_torch.core import pipnn
from repro_torch.core.metrics import point_norms
from repro_torch.core.serving import ServingIndex, _is_int8
from repro_torch.data import VectorPipelineConfig, make_queries, make_vectors, sift_like
from repro_torch.kernels import gather_distance_int8 as g8


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: under six test workers the default (one a core)
    oversubscribes the cores on these small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


CPU = "cpu"
METRICS = ("l2", "mips", "cosine")


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------- quantization ---

def _quant_rows():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((40, 33)).astype(np.float32) * 3
    x[0] = 0.0                                        # zero row -> zeros
    x[1] = 1e-14                                      # below eps: scale eps/127
    # max 127 gives scale exactly 1.0: the rest sit halfway between steps
    x[2, :8] = [127, 0.5, 1.5, 2.5, -2.5, -0.5, 126.5, -126.5]
    x[3, :4] = [-127, 63.5, -64.5, 0.5]               # negative max -> -127
    x[4] = -np.abs(x[4])                              # all negative
    x[5, :] = 254.0                                   # scale 2.0: every value -> 127
    return x


def test_quantize_symmetric_bit_exact_against_reference():
    """Tolerance: bit-exact (scale and every int8 value)."""
    x = _quant_rows()
    want_q, want_s = ref.quantize_symmetric(jnp.asarray(x))
    got_q, got_s = g8.quantize_symmetric(torch.from_numpy(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    q = got_q.numpy()
    assert (q[0] == 0).all() and (q[1] == 1).all()    # 1e-14 / (1e-12 / 127) = 1.27
    np.testing.assert_array_equal(q[2, :8], [127, 0, 2, 2, -2, 0, 126, -126])  # half to even
    assert q[3, 0] == -127 and (q[5] == 127).all()
    assert q.min() >= -127 and q.max() <= 127


def test_quantize_symmetric_batched_rows():
    """Leading axes are rows; tolerance: bit-exact."""
    x = _quant_rows().reshape(4, 10, 33)
    want_q, want_s = ref.quantize_symmetric(jnp.asarray(x))
    got_q, got_s = g8.quantize_symmetric(torch.from_numpy(x))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_is_int8_spellings():
    for spelling in ("int8", torch.int8, np.int8, np.dtype("int8")):
        assert _is_int8(spelling)
    for other in (None, "bfloat16", torch.bfloat16, np.float32, torch.float32):
        assert not _is_int8(other)


# ------------------------------------------------------- int8 gather block ---

def _int8_inputs(seed, n, d, nq, c, metric, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        x = rng.integers(0, 256, (n, d)).astype(np.float32)
        q = rng.integers(0, 256, (nq, d)).astype(np.float32)
    else:
        x = rng.standard_normal((n, d)).astype(np.float32)
        q = rng.standard_normal((nq, d)).astype(np.float32)
    ids = rng.integers(-1, n, (nq, c)).astype(np.int32)
    p8, sc = ref.quantize_symmetric(jnp.asarray(x))
    norms = j_point_norms(jnp.asarray(x), metric)
    q_norms = j_point_norms(jnp.asarray(q), metric)
    return [np.asarray(a) for a in (p8, sc, norms, q, q_norms, ids)]


def _port_block(arrs, metric):
    return g8.gather_distance_int8(*(_t(a) for a in arrs), metric).numpy()


@pytest.mark.parametrize("integer", (False, True), ids=("gaussian", "integer"))
@pytest.mark.parametrize("metric", METRICS)
def test_gather_int8_plain_bit_exact_against_pallas_interpret_and_ref(metric, integer):
    """TPU kernel #6 (``gather_distance_int8``) in interpret mode, and its
    oracle.  Tolerance: bit-exact, on Gaussian and integer data alike."""
    arrs = _int8_inputs(1, 300, 64, 19, 40, metric, integer)
    got = _port_block(arrs, metric)
    want_ref = ref.gather_distance_int8_ref(*(jnp.asarray(a) for a in arrs), metric=metric)
    want_pl = j_gather_int8(*(jnp.asarray(a) for a in arrs), metric=metric, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want_ref))
    np.testing.assert_array_equal(got, np.asarray(want_pl))
    assert np.array_equal(np.isinf(got), arrs[-1] < 0)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("n,d,nq,c", [(257, 17, 9, 65), (128, 128, 8, 256)])
def test_gather_int8_plain_bit_exact_against_ref_at_streaming_shapes(metric, n, d, nq, c):
    """TPU kernel #7 (``gather_distance_int8_hbm``), held against its oracle
    at the reference's own test shapes (its interpret run does not work on
    this JAX).  Tolerance: bit-exact."""
    arrs = _int8_inputs(2, n, d, nq, c, metric)
    got = _port_block(arrs, metric)
    want = ref.gather_distance_int8_ref(*(jnp.asarray(a) for a in arrs), metric=metric)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_gather_int8_core_equals_plain_and_counts_nothing():
    """Quantizing once per batch (core) or per call (plain) gives the same
    bits; CPU tensors never count a launch."""
    arrs = [_t(a) for a in _int8_inputs(3, 100, 24, 7, 30, "l2")]
    q8, sq = g8.quantize_symmetric(arrs[3])
    before = g8.launches
    a = g8.gather_distance_int8(*arrs)
    b = g8.gather_distance_int8_core(arrs[0], arrs[1], arrs[2], q8, sq, arrs[4], arrs[5])
    assert torch.equal(a, b) and g8.launches == before


# ---------------------------------------------------------------- serving ---

@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1500, 24)).astype(np.float32)
    jp = jpipnn.PiPNNParams(rbc=JRBCParams(c_max=128, c_min=16, fanout=(3,)),
                            leaf=JLeafParams(k=2), l_max=32, max_deg=16, seed=1)
    return jpipnn.build(x, jp), x


@pytest.mark.parametrize("metric", METRICS)
def test_int8_search_matches_reference_packing_and_telemetry(built, metric):
    """The reference's int8 packing served by both packages (``convert``):
    identical ids and telemetry.  Tolerance: exact."""
    index, x = built
    q = np.random.default_rng(3).standard_normal((50, 24)).astype(np.float32)
    jsv = JServingIndex.from_graph(index.graph, x, index.start, metric=metric, dtype="int8")
    want_ids, want_st = jsv.search(q, k=10, beam=24, kernel_path="xla", with_stats=True)
    sv = serving_index_from_arrays(index.graph, np.asarray(jsv.points), np.asarray(jsv.norms),
                                   index.start, scales=np.asarray(jsv.scales), metric=metric,
                                   device=CPU)
    got_ids, got_st = sv.search(q, k=10, beam=24, with_stats=True)
    np.testing.assert_array_equal(got_ids, want_ids)
    for key in ("hops", "dist_comps", "converged", "iters_cap", "expansions"):
        np.testing.assert_array_equal(got_st[key], want_st[key])
    # the port's own packing: the same int8 rows and scales; the norms are
    # float32 sums in another order (a few ulps)
    own = ServingIndex.from_graph(index.graph, x, index.start, metric=metric, dtype="int8",
                                  device=CPU)
    np.testing.assert_array_equal(own.points.numpy(), np.asarray(jsv.points))
    np.testing.assert_array_equal(own.scales.numpy(), np.asarray(jsv.scales))
    np.testing.assert_allclose(own.norms.numpy(), np.asarray(jsv.norms), rtol=1e-6, atol=0)


def test_pipnn_search_int8_and_bf16_match_reference_on_integer_data():
    """``pipnn.search(dtype=...)`` against the reference's on integer data
    (exact in bfloat16, every f32 sum exact): identical ids.  The serving
    cache keys on the dtype."""
    cfg = VectorPipelineConfig(n=1200, dim=16, n_clusters=16, seed=2)
    x, q = sift_like(make_vectors(cfg)), sift_like(make_queries(cfg, 40))
    jp = jpipnn.PiPNNParams(rbc=JRBCParams(c_max=128, c_min=16, fanout=(3,)),
                            leaf=JLeafParams(k=2), l_max=32, max_deg=16, seed=0)
    index = jpipnn.build(x, jp)
    tidx = index_from_arrays(index.graph, index.dists, index.start, device=CPU)
    for dtype, jdtype in (("int8", "int8"), (torch.bfloat16, jnp.bfloat16)):
        want = jpipnn.search(index, x, q, k=10, beam=32, dtype=jdtype)
        got = pipnn.search(tidx, x, q, k=10, beam=32, dtype=dtype, device=CPU)
        np.testing.assert_array_equal(got, want)
    sv8 = pipnn.serving_index(tidx, x, dtype="int8", device=CPU)
    assert sv8.points.dtype == torch.int8 and sv8.scales is not None
    assert pipnn.serving_index(tidx, x, dtype="int8", device=CPU) is sv8
    sv16 = pipnn.serving_index(tidx, x, dtype=torch.bfloat16, device=CPU)
    assert sv16 is not sv8 and sv16.points.dtype == torch.bfloat16 and sv16.scales is None
    assert pipnn.serving_index(tidx, x, device=CPU).points.dtype == torch.float32


def test_bf16_search_recall_matches_reference_gaussian(built):
    """bfloat16 on Gaussian data: the rounding to bfloat16 is the same on
    both sides, the f32 sums are not.  Tolerance: recall@10 within 0.01 of
    the reference's bfloat16 search, and at least 95% of ids equal."""
    index, x = built
    q = np.random.default_rng(5).standard_normal((60, 24)).astype(np.float32)
    truth = jbs.brute_force_knn(x, q, 10)
    want = JServingIndex.from_graph(index.graph, x, index.start,
                                    dtype=jnp.bfloat16).search(q, k=10, beam=24)
    sv = ServingIndex.from_graph(index.graph, x, index.start, dtype=torch.bfloat16, device=CPU)
    got = sv.search(q, k=10, beam=24)
    assert abs(bs.recall_at_k(got, truth) - jbs.recall_at_k(want, truth)) <= 0.01
    assert (got == want).mean() >= 0.95
    assert sv.norms.dtype == torch.float32
    np.testing.assert_array_equal(sv.norms.numpy(), point_norms(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("metric", METRICS)
def test_int8_recall_within_002_of_f32(metric):
    """check.sh step 5's rule on the reference's own parity setup
    (tests/test_serving.py): int8 recall@10 within 0.02 of f32, and equal
    to the reference's int8 recall on the same graph."""
    rng = np.random.default_rng(17)
    x = rng.standard_normal((1200, 24)).astype(np.float32)
    graph = jbs.brute_force_knn(x, x, 17, metric=metric)[:, 1:17].astype(np.int32)
    q = rng.standard_normal((48, 24)).astype(np.float32)
    gt = jbs.brute_force_knn(x, q, 10, metric=metric)
    start = jbs.medoid(x)
    sv = ServingIndex.from_graph(graph, x, start, metric=metric, device=CPU)
    sv8 = ServingIndex.from_graph(graph, x, start, metric=metric, dtype="int8", device=CPU)
    r32 = bs.recall_at_k(sv.search(q, k=10, beam=32), gt, 10)
    r8 = bs.recall_at_k(sv8.search(q, k=10, beam=32), gt, 10)
    assert r8 >= r32 - 0.02, (metric, r32, r8)
    jsv8 = JServingIndex.from_graph(graph, x, start, metric=metric, dtype="int8")
    assert r8 == jbs.recall_at_k(jsv8.search(q, k=10, beam=32), gt, 10)


def test_int8_device_bytes_a_third_of_f32():
    """On a points-dominated packing (d = 128, R = 16) the int8 copy is at
    most ~1/3 of the float32 total, as the reference checks; the scales
    are counted."""
    x = np.random.default_rng(2).standard_normal((512, 128)).astype(np.float32)
    g = np.zeros((512, 16), np.int32)
    sv = ServingIndex.from_graph(g, x, 0, device=CPU)
    sv8 = ServingIndex.from_graph(g, x, 0, dtype="int8", device=CPU)
    assert sv8.device_bytes() == 512 * 16 * 4 + 512 * 128 + 512 * 4 + 512 * 4
    assert sv8.device_bytes() <= 0.35 * sv.device_bytes()
    assert sv8.device_bytes() == JServingIndex.from_graph(g, x, 0, dtype="int8").device_bytes()


def test_int8_guards_raise_the_reference_exceptions():
    x = np.random.default_rng(6).standard_normal((50, 8)).astype(np.float32)
    graph = np.tile(np.arange(1, 5, dtype=np.int32), (50, 1))
    q = x[:3]
    p8, sc = ref.quantize_symmetric(jnp.asarray(x))
    nrm = j_point_norms(jnp.asarray(x), "l2")
    cases = [  # (points, norms): scales with f32 points; int8 without norms
        (x, nrm, TypeError), (np.asarray(p8), None, ValueError)]
    for pts, norms, exc in cases:
        with pytest.raises(exc):
            jbs.beam_search_batch(graph, pts, q, start=0, beam=8, norms=norms,
                                  scales=np.asarray(sc))
        with pytest.raises(exc):
            bs.beam_search_batch(_t(graph), _t(pts), _t(q), start=0, beam=8,
                                 norms=None if norms is None else _t(norms), scales=_t(sc))
    with pytest.raises(ValueError):
        serving_index_from_arrays(graph, np.asarray(p8), np.asarray(nrm), 0, device=CPU)
