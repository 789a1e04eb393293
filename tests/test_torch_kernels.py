"""The port's four kernels: each plain PyTorch version against the JAX
package's oracle on the same numpy inputs (the CUDA kernels against their
plain versions are in tests/test_torch_cuda.py).

Integer-valued inputs make every float32 sum exact in any order, so those
comparisons are exact; Gaussian inputs are compared with the stated
tolerances (float32 rounding of a different summation order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import leaf as jleaf
from repro.core import sketch as jsketch
from repro.core.hashprune import hashprune_flat as j_hashprune_flat
from repro.core.hashprune import merge_segmented_edges as j_merge_segmented
from repro.core.metrics import point_norms as j_point_norms
from repro.kernels import ref
from _torch_merge_cases import KINDS as MERGE_KINDS
from _torch_merge_cases import L_VALUES, reservoir_pair
from repro_torch.core.metrics import point_norms
from repro_torch.kernels import edge_hash, gather_distance, leaf_knn, segmented_merge


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: under six test workers the default (one a core)
    oversubscribes the cores on these small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


METRICS = ("l2", "mips", "cosine")


def _int_points(rng, n, d, hi=256):
    return rng.integers(0, hi, (n, d)).astype(np.float32)


def _leaves(rng, n, n_leaves, c):
    """[B, C] int32 leaf ids with ragged -1 padding (and one all-padding leaf)."""
    ids = np.full((n_leaves, c), -1, np.int32)
    for i in range(n_leaves - 1):
        s = int(rng.integers(1, c + 1))
        ids[i, :s] = rng.choice(n, s, replace=False)
    return ids


# ------------------------------------------------------------ leaf top-k ---

@pytest.mark.parametrize("k", (1, 2, 4, 12, 32))
def test_leaf_topk_plain_matches_jax_exact_on_integers(k):
    rng = np.random.default_rng(0)
    x = _int_points(rng, 300, 16, hi=4)        # tiny range: many exact ties
    x[50:60] = x[40]                           # duplicate points: zero-distance ties
    ids = _leaves(rng, 300, 6, 64)
    ids[0, :20] = np.arange(40, 60)            # the duplicates share a leaf
    pts = jnp.asarray(x)[jnp.maximum(jnp.asarray(ids), 0)]
    want_i, want_d = jleaf.leaf_knn_jax(pts, jnp.asarray(ids >= 0), k=k, metric="l2")
    ref_i, ref_d = ref.leaf_topk_ref(pts, jnp.asarray(ids >= 0), k=k, metric="l2")
    got_i, got_d = leaf_knn.leaf_topk_plain(torch.from_numpy(x), torch.from_numpy(ids), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(ref_d))


@pytest.mark.parametrize("metric", METRICS)
def test_leaf_topk_plain_matches_jax_gaussian(metric):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((400, 32)).astype(np.float32)
    ids = _leaves(rng, 400, 5, 96)
    pts = jnp.asarray(x)[jnp.maximum(jnp.asarray(ids), 0)]
    want_i, want_d = jleaf.leaf_knn_jax(pts, jnp.asarray(ids >= 0), k=2, metric=metric)
    got_i, got_d = leaf_knn.leaf_topk(torch.from_numpy(x), torch.from_numpy(ids), 2, metric)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-5)
    assert (got_i.numpy() == np.asarray(want_i)).mean() > 0.99


def test_leaf_topk_cpu_wrapper_is_plain_and_counts_nothing():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(_int_points(rng, 100, 8))
    ids = torch.from_numpy(_leaves(rng, 100, 3, 32))
    before = leaf_knn.launches
    a = leaf_knn.leaf_topk(x, ids, 2)
    b = leaf_knn.leaf_topk_plain(x, ids, 2)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert leaf_knn.launches == before


# ----------------------------------------------------------- edge hashes ---

@pytest.mark.parametrize("m", (1, 12, 16))
def test_edge_hashes_plain_matches_jax_exact(m):
    rng = np.random.default_rng(3)
    sk = rng.standard_normal((200, m)).astype(np.float32)
    sk[5] = sk[7]                                 # equal sketches: zero differences
    src = rng.integers(-1, 200, 5000).astype(np.int32)
    dst = rng.integers(-1, 200, 5000).astype(np.int32)
    src[:10], dst[:10] = 5, 7
    want = jsketch.edge_hashes_from_ids(jnp.asarray(sk), jnp.asarray(src),
                                        jnp.asarray(dst), use_pallas=False)
    got = edge_hash.edge_hashes(torch.from_numpy(sk), torch.from_numpy(src),
                                torch.from_numpy(dst))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------------- merge ---

def _reservoir_pair(seed, n=60, e=1500, l_max=16, metric="l2"):
    """Two valid [n, l_max] reservoirs from JAX hashprune_flat over random
    edges with tied distances; the hash is a function of (src, dst)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        src = rng.integers(0, n, e).astype(np.int32)
        dst = rng.integers(0, n, e).astype(np.int32)
        hashes = ((src * 31 + dst * 7) % 8).astype(np.int32)
        dist = ((dst * 131 + src * 17) % 23 / 4.0).astype(np.float32)
        if metric == "mips":
            dist -= 3.0
        res = j_hashprune_flat(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(hashes),
                               jnp.asarray(dist), n_points=n, l_max=l_max)
        out.append(tuple(np.array(a) for a in res))
    return out


@pytest.mark.parametrize("metric", ("l2", "mips"))
@pytest.mark.parametrize("seed", (0, 1))
def test_merge_plain_matches_ref_exact(seed, metric):
    a, b = _reservoir_pair(seed, metric=metric)
    want = ref.merge_sorted_reservoirs_ref(*(jnp.asarray(t) for t in a + b))
    got = segmented_merge.merge_sorted_reservoirs(*(torch.from_numpy(t) for t in a + b))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_merge_plain_matches_segmented_fold_exact():
    """The port's fold (hashprune_flat on the chunk + the merge) equals the
    reference's ``merge_segmented_edges(use_pallas=False)``."""
    from repro_torch.core.hashprune import merge_segmented_edges

    rng = np.random.default_rng(4)
    (ra_i, ra_h, ra_d), _ = _reservoir_pair(5)
    n, e = ra_i.shape[0], 900
    src = rng.integers(0, n + 1, e).astype(np.int32)      # n = padding edge
    dst = np.where(src < n, rng.integers(0, n, e), -1).astype(np.int32)
    hashes = ((src * 31 + dst * 7) % 8).astype(np.int32)
    dist = np.where(src < n, (dst * 13 % 11) / 2.0, np.inf).astype(np.float32)
    args = (ra_i, ra_h, ra_d, src, dst, hashes, dist)
    want = j_merge_segmented(*(jnp.asarray(a) for a in args), use_pallas=False)
    got = merge_segmented_edges(*(torch.from_numpy(a) for a in args))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _assert_live_prefix(ids, hashes, dists):
    """The reservoir layout the merge kernel relies on: each row's live
    slots (id != -1) are a prefix in (dist, id) order with finite dists
    (an id may stand twice, in two buckets), and every later slot holds the
    padding (-1, 0, +inf)."""
    ids, hashes, dists = (np.asarray(t) for t in (ids, hashes, dists))
    live = ids != -1
    assert not (live[:, 1:] & ~live[:, :-1]).any(), "a live slot after a padding slot"
    assert (hashes[~live] == 0).all() and np.isposinf(dists[~live]).all()
    assert np.isfinite(dists[live]).all()
    d0, d1, i0, i1 = dists[:, :-1], dists[:, 1:], ids[:, :-1], ids[:, 1:]
    assert ((d0 < d1) | ((d0 == d1) & (i0 <= i1)))[live[:, 1:]].all(), "live prefix unsorted"


@pytest.mark.parametrize("l", L_VALUES)
@pytest.mark.parametrize("kind", MERGE_KINDS)
def test_merge_plain_matches_ref_on_edge_cases(kind, l):
    """The semantics the merge kernel must meet, on the edge cases its
    design depends on (``tests/_torch_merge_cases.py``): empty sides, full
    rows, rows past one warp chunk, exact cross-side ties, the same id on
    both sides, l at and past the 32- and 64-slot edges.  Exact, and the
    inputs and the result keep the live-prefix layout."""
    case = reservoir_pair(kind, l)
    _assert_live_prefix(*case[:3])
    _assert_live_prefix(*case[3:])
    want = ref.merge_sorted_reservoirs_ref(*(jnp.asarray(t) for t in case))
    got = segmented_merge.merge_sorted_reservoirs_plain(*(torch.from_numpy(t) for t in case))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _assert_live_prefix(*(t.numpy() for t in got))


def _producer_output(producer):
    """One reservoir from each of the port's producers, on the inputs of the
    merge tests above (edges with padding, +inf dists and duplicates)."""
    from repro_torch.core.hashprune import hashprune_flat, merge_segmented_edges, reservoir_init

    rng = np.random.default_rng(7)
    n, e, l_max = 60, 1500, 16
    src = rng.integers(0, n + 1, e).astype(np.int32)      # n = padding edge
    dst = np.where(src < n, rng.integers(0, n, e), -1).astype(np.int32)
    hashes = ((src * 31 + dst * 7) % 8).astype(np.int32)
    dist = ((dst * 131 + src * 17) % 23 / 4.0).astype(np.float32)
    if producer.endswith("mips"):
        dist -= 3.0
    dist[src == n] = np.inf
    m = e // 16
    dist[:m] = np.inf                                     # valid edges at +inf
    for a in (src, dst, hashes, dist):                    # exact duplicates
        a[m: 2 * m] = a[e // 2: e // 2 + m]
    edges = [torch.from_numpy(a) for a in (src, dst, hashes, dist)]
    if producer == "reservoir_init":
        return reservoir_init(n, l_max, device="cpu")
    if producer.startswith("hashprune_flat"):
        return hashprune_flat(*edges, n_points=n, l_max=l_max)
    a, b = _reservoir_pair(3, n=n, l_max=l_max)
    if producer == "merge_plain":
        return segmented_merge.merge_sorted_reservoirs_plain(
            *(torch.from_numpy(t) for t in a + b))
    return merge_segmented_edges(*(torch.from_numpy(t) for t in a), *edges)   # the fold


@pytest.mark.parametrize("producer", ("reservoir_init", "hashprune_flat_l2",
                                      "hashprune_flat_mips", "merge_plain", "fold"))
def test_reservoir_producers_keep_live_prefix(producer):
    """Every producer of the merge's inputs leaves the live-prefix layout
    the merge kernel reads only the prefix of (``csrc/segmented_merge.cu``)."""
    res = _producer_output(producer)
    assert (np.asarray(res[0]) != -1).any() or producer == "reservoir_init"
    _assert_live_prefix(*res)


# ------------------------------------------------------- gather distance ---

@pytest.mark.parametrize("metric", METRICS)
def test_gather_distance_plain_matches_ref_exact_on_integers(metric):
    rng = np.random.default_rng(6)
    x = _int_points(rng, 500, 24)
    q = _int_points(rng, 40, 24)
    ids = rng.integers(-1, 500, (40, 33)).astype(np.int32)
    want = ref.gather_distance_ref(jnp.asarray(x), j_point_norms(jnp.asarray(x), metric),
                                   jnp.asarray(q), jnp.asarray(ids), metric=metric)
    xt = torch.from_numpy(x)
    got = gather_distance.gather_distance(xt, point_norms(xt, metric), torch.from_numpy(q),
                                          torch.from_numpy(ids), metric)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("metric", METRICS)
def test_gather_distance_plain_matches_ref_gaussian(metric):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((500, 64)).astype(np.float32)
    q = rng.standard_normal((40, 64)).astype(np.float32)
    ids = rng.integers(-1, 500, (40, 256)).astype(np.int32)
    want = ref.gather_distance_ref(jnp.asarray(x), j_point_norms(jnp.asarray(x), metric),
                                   jnp.asarray(q), jnp.asarray(ids), metric=metric)
    xt = torch.from_numpy(x)
    got = gather_distance.gather_distance(xt, point_norms(xt, metric), torch.from_numpy(q),
                                          torch.from_numpy(ids), metric)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    assert np.array_equal(np.isinf(got.numpy()), ids < 0)
