"""The port's leaf methods (``LeafParams.method``: bidirected, directed and
inverted k-NN, ``mst`` and ``robust_prune``) against the JAX package on
the CPU: the emitters, the leaf RobustPrune, the MST, the flat edge list
and whole builds.  Integer data makes every float32 sum exact, so every
comparison is exact; leaves and hyperplanes are handed to both packages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import leaf as jleaf
from repro.core import metrics as jmetrics
from repro.core import pipnn as jpipnn
from repro.core import sketch as jsketch
from repro.core.rbc import RBCParams as JRBCParams
from repro.core.rbc import ball_carve as j_ball_carve
from repro_torch.core import leaf, pipnn
from repro_torch.core.rbc import RBCParams
from repro_torch.data import dyadic_hyperplanes


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: under six test workers the default (one a core)
    oversubscribes the cores on these small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


CPU = "cpu"
METHODS = ("bidirected", "directed", "inverted", "mst", "robust_prune")
METRICS = ("l2", "mips")


def _t(a):
    return torch.from_numpy(np.array(a))


def _points(seed, n=600, d=12, hi=16):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, hi, (n, d)).astype(np.float32)
    x[50:58] = x[49]                     # duplicate points: tied distances
    return x


def _leaf_ids(seed, n, b=7, c=48):
    """[b, c] leaves with -1 padding after a valid prefix; one leaf holds
    the duplicate cluster, one a repeated id, the last is all padding."""
    rng = np.random.default_rng(seed + 100)
    ids = np.full((b, c), -1, np.int32)
    for i in range(b - 1):
        s = int(rng.integers(2, c + 1))
        ids[i, :s] = rng.choice(n, s, replace=False)
    ids[0, :12] = np.arange(46, 58)
    ids[1, 1] = ids[1, 0]                # a repeated id: no self loop
    return ids


# ------------------------------------------------------------- emitters ---

@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("direction", ("bidirected", "directed", "inverted"))
def test_emit_knn_edges_matches_reference(direction, metric):
    x = _points(0)
    ids = _leaf_ids(0, x.shape[0])
    pts = jnp.asarray(x[np.maximum(ids, 0)])
    ni, nd = jleaf.leaf_knn_jax(pts, jnp.asarray(ids >= 0), k=3, metric=metric)
    ni, nd = np.asarray(ni), np.asarray(nd)
    host = jleaf._emit_knn_edges(ids, ni, nd, direction)
    dev = jleaf.emit_knn_edges_jax(jnp.asarray(ids), jnp.asarray(ni), jnp.asarray(nd),
                                   direction=direction)
    got = leaf.emit_knn_edges(_t(ids), _t(ni), _t(nd), direction)
    for g, h, w in zip(got, (host.src, host.dst, host.dist), dev):
        np.testing.assert_array_equal(g.numpy(), h)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("metric", METRICS)
def test_leaf_robust_prune_matches_reference(metric):
    """The keep mask and the masked leaf matrix; the port never forms the
    reference's [B*C, C, C] broadcast."""
    x = _points(1)
    ids = _leaf_ids(1, x.shape[0])
    pts, valid = x[np.maximum(ids, 0)], ids >= 0
    want_keep, want_d = jleaf._leaf_robust_prune(jnp.asarray(pts), jnp.asarray(valid),
                                                 metric=metric, alpha=1.2, max_deg=5)
    got_keep, got_d = leaf._leaf_robust_prune(_t(pts), _t(valid), metric=metric,
                                              alpha=1.2, max_deg=5)
    np.testing.assert_array_equal(got_keep.numpy(), np.asarray(want_keep))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    # the same from the ids, the way the builds call it
    by_ids = leaf.leaf_robust_prune(_t(x), _t(ids), metric=metric, alpha=1.2, max_deg=5)
    assert all(torch.equal(a, b) for a, b in zip(by_ids, (got_keep, got_d)))
    want = jleaf.emit_robust_prune_edges_jax(jnp.asarray(ids), want_keep, want_d)
    got = leaf.emit_robust_prune_edges(_t(ids), got_keep, got_d)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("metric", METRICS)
def test_mst_edges_matches_reference(metric):
    x = _points(2)
    ids = _leaf_ids(2, x.shape[0])
    pts = jnp.asarray(x[np.maximum(ids, 0)])
    d_ref = np.asarray(jax.vmap(lambda a: jmetrics.pairwise(a, a, metric))(pts))
    d = leaf.leaf_matrix(_t(x), _t(ids), metric).numpy()
    np.testing.assert_array_equal(d, d_ref)
    want = jleaf._mst_edges(ids, d_ref, ids >= 0, 3, 6)
    got = leaf._mst_edges(ids, d, ids >= 0, 3, 6)
    for g, w in zip((got.src, got.dst, got.dist), (want.src, want.dst, want.dist)):
        np.testing.assert_array_equal(g.numpy(), w)


# ------------------------------------------------------ flat edge lists ---

def _carve(x, c_max=64, seed=3):
    leaves = j_ball_carve(x, JRBCParams(c_max=c_max, c_min=8, fanout=(3,), seed=seed),
                          execution="host")
    return leaves, jpipnn.leaves_to_padded(leaves, c_max)


def _leaf_params(port: bool, method: str, metric: str, **kw):
    cls = leaf.LeafParams if port else jleaf.LeafParams
    return cls(method=method, k=2, metric=metric, alpha=1.2, max_deg=6, mst_sparsify=5,
               leaf_chunk=4, **kw)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("method", METHODS)
def test_build_leaf_edges_matches_reference(method, metric):
    """Entry for entry, padding included (the leaf count is no multiple of
    ``leaf_chunk``, so the last chunk is padded as the reference pads it)."""
    x = _points(4, n=700)
    _, padded = _carve(x)
    padded = padded[: 4 * (padded.shape[0] // 4) - 1]
    want = jleaf.build_leaf_edges(x, padded, _leaf_params(False, method, metric))
    got = leaf.build_leaf_edges(_t(x), padded, _leaf_params(True, method, metric))
    for g, w in zip((got.src, got.dst, got.dist), (want.src, want.dst, want.dist)):
        np.testing.assert_array_equal(g.numpy(), w)
    assert int(got.valid().sum()) == int(want.valid().sum())


@pytest.mark.parametrize("method", ("bidirected", "robust_prune", "mst"))
def test_build_leaf_edges_group_size_changes_nothing(monkeypatch, method):
    """The flat path runs many leaves a call; groups of one leaf chunk (the
    reference's granularity) give the same list."""
    x = _points(5, n=700)
    _, padded = _carve(x)
    p = _leaf_params(True, method, "l2")
    whole = leaf.build_leaf_edges(_t(x), padded, p)
    monkeypatch.setattr(leaf, "_GROUP_ENTRIES", 1)
    monkeypatch.setattr(leaf, "_GROUP_MATRIX", 1)
    small = leaf.build_leaf_edges(_t(x), padded, p)
    for a, b in zip((whole.src, whole.dst, whole.dist), (small.src, small.dst, small.dist)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("stream_chunk", (None, 1, 5, 64))
@pytest.mark.parametrize("leaf_chunk", (1, 8))
def test_stream_chunk_leaves_matches_reference(method, stream_chunk, leaf_chunk):
    for n, l_max, nleaves, c_max in ((700, 32, 23, 64), (10_000, 64, 1000, 256)):
        jl = jleaf.LeafParams(method=method, k=3, leaf_chunk=leaf_chunk,
                              stream_chunk=stream_chunk)
        tl = leaf.LeafParams(method=method, k=3, leaf_chunk=leaf_chunk,
                             stream_chunk=stream_chunk)
        assert (pipnn._stream_chunk_leaves(tl, n, l_max, nleaves, c_max)
                == jpipnn._stream_chunk_leaves(jl, n, l_max, nleaves, c_max))
        assert (pipnn._stream_edges_per_leaf(tl, c_max)
                == jpipnn._stream_edges_per_leaf(jl, c_max))


def test_unknown_leaf_method_is_refused():
    x = _points(6, n=200)
    with pytest.raises(ValueError, match="unknown leaf method"):
        pipnn.build(x, pipnn.PiPNNParams(leaf=leaf.LeafParams(method="knn")), device=CPU)


# ------------------------------------------------------------- builds ---

STAT_KEYS = ("streaming", "n_leaves", "point_repeat", "pad_ratio", "n_candidate_edges",
             "peak_edge_bytes", "edge_bytes_build_leaves", "merge_workspace_bytes")


def _build_params(port: bool, method: str, metric: str, **leaf_kw):
    rbc, pp = (RBCParams, pipnn.PiPNNParams) if port else (JRBCParams, jpipnn.PiPNNParams)
    lp = dataclasses.replace(_leaf_params(port, method, "l2"), **leaf_kw)
    return pp(rbc=rbc(c_max=64, c_min=8, fanout=(3,)), leaf=lp, hash_bits=8, l_max=24,
              max_deg=12, metric=metric, seed=2)


def _both(monkeypatch, method, metric, streaming, n=900, **leaf_kw):
    x = _points(7, n=n, d=16)
    hp = dyadic_hyperplanes(11, 8, 16)
    monkeypatch.setattr(jsketch, "make_hyperplanes",
                        lambda key, m, d, dtype=jnp.float32: jnp.asarray(hp))
    leaves, _ = _carve(x, seed=9)
    want = jpipnn.build(x, _build_params(False, method, metric, **leaf_kw), leaves=leaves,
                        streaming=streaming)
    got = pipnn.build(x, _build_params(True, method, metric, **leaf_kw), leaves=leaves,
                      hyperplanes=hp, device=CPU, streaming=streaming)
    return got, want


def _same(got, want, keys=STAT_KEYS):
    np.testing.assert_array_equal(got.graph.numpy(), want.graph)
    np.testing.assert_array_equal(got.dists.numpy(), want.dists)
    assert got.start == want.start
    for key in keys:
        if key in want.stats:
            assert got.stats[key] == want.stats[key], key
    assert set(got.timings) == set(want.timings)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("method", METHODS)
def test_leaf_method_build_equals_reference(monkeypatch, method, metric):
    """Streamed builds (``mst`` falls back to the flat path in both
    packages) equal the reference's, stats included."""
    got, want = _both(monkeypatch, method, metric, streaming=True)
    _same(got, want)
    assert got.stats["streaming"] == (method != "mst")


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("method", ("directed", "inverted", "robust_prune"))
def test_leaf_method_flat_build_equals_streamed_and_reference(monkeypatch, method, metric):
    flat, want = _both(monkeypatch, method, metric, streaming=False)
    _same(flat, want)
    assert not flat.stats["streaming"]
    streamed, _ = _both(monkeypatch, method, metric, streaming=True)
    assert torch.equal(streamed.graph, flat.graph) and torch.equal(streamed.dists, flat.dists)
    assert streamed.stats["n_candidate_edges"] == flat.stats["n_candidate_edges"]


@pytest.mark.parametrize("method", ("bidirected", "robust_prune"))
def test_given_stream_chunk_equals_reference(monkeypatch, method):
    got, want = _both(monkeypatch, method, "l2", streaming=True, stream_chunk=5)
    _same(got, want, STAT_KEYS + ("stream_chunk_leaves",))
    assert got.stats["stream_chunk_leaves"] == 8
