"""The port's CUDA kernels on the card: each against its plain PyTorch
version, the launch counters, and each path through its own kernels; and
the transformer-family smoke models, card logits against CPU logits.

Every test here needs an NVIDIA card (a CUDA kernel has no CPU mode) and
skips without one.  This file imports neither JAX nor ``repro``, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.analysis import contracts
from repro_torch.core.hashprune import hashprune_flat
from repro_torch.core.metrics import point_norms
from repro_torch.kernels import (distance, edge_hash, gather_distance, gather_distance_int8,
                                 leaf_knn, segmented_merge, topk)
from _torch_merge_cases import KINDS as MERGE_KINDS
from _torch_merge_cases import L_VALUES, reservoir_pair

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _int_points(rng, n, d):
    return rng.integers(0, 256, (n, d)).astype(np.float32)


def _leaves(rng, n, n_leaves, c):
    ids = np.full((n_leaves, c), -1, np.int32)
    for i in range(n_leaves - 1):           # the last leaf is all padding
        s = int(rng.integers(1, c + 1))
        ids[i, :s] = rng.choice(n, s, replace=False)
    return ids


@pytest.mark.parametrize("k", (1, 2, 8, 9, 16, 17, 32))
@pytest.mark.parametrize("d", (128, 40))
def test_leaf_topk_kernel_matches_plain(cuda, k, d):
    rng = np.random.default_rng(8)
    x = torch.from_numpy(_int_points(rng, 5000, d)).to(cuda)
    x[100:120] = x[99]                      # duplicate points: tied distances
    ids = torch.from_numpy(_leaves(rng, 5000, 12, 1024)).to(cuda)
    ids[0, :30] = torch.arange(95, 125, device=cuda, dtype=torch.int32)
    got = leaf_knn.leaf_topk(x, ids, k)
    want = leaf_knn.leaf_topk_plain(x, ids, k)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# leaf sizes at every edge of the kernel's tiles (16-row warps, 8-column
# MMA tiles, 64-row and 64-column tiles, 32-deep stages), up to c_max
LEAF_SIZES = (1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 1024)


def _edge_leaves(rng, n, c=1024):
    """One leaf of each of LEAF_SIZES (a prefix of valid ids), one all
    padding, and one whose valid ids are scattered among -1s."""
    ids = np.full((len(LEAF_SIZES) + 2, c), -1, np.int32)
    for i, s in enumerate(LEAF_SIZES):
        ids[i, :s] = rng.choice(n, s, replace=False)
    pos = np.sort(rng.choice(c, 300, replace=False))
    ids[-1, pos] = rng.choice(n, 300, replace=False)
    return ids


@pytest.mark.parametrize("metric", ("l2", "mips", "cosine"))
@pytest.mark.parametrize("k", (1, 2, 8, 32))
@pytest.mark.parametrize("d", (128, 40, 100, 37))
def test_leaf_topk_kernel_tile_edges(cuda, d, k, metric):
    """Exact against the plain version on integer data at every tile edge;
    d = 37 takes the 4-byte copies (rows not 16-byte aligned); k = 32 the
    wide lists in shared memory, with leaves shorter than k."""
    rng = np.random.default_rng(18)
    x = torch.from_numpy(_int_points(rng, 3000, d)).to(cuda)
    x[200:210] = x[199]                     # duplicate points: tied distances
    ids = torch.from_numpy(_edge_leaves(rng, 3000)).to(cuda)
    ids[10, 100:111] = torch.arange(199, 210, device=cuda, dtype=torch.int32)
    got = leaf_knn.leaf_topk(x, ids, k, metric)
    want = leaf_knn.leaf_topk_plain(x, ids, k, metric)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool((got[0][len(LEAF_SIZES)] == -1).all())


@pytest.mark.parametrize("k", (2, 16))
def test_leaf_topk_kernel_gaussian_within_tolerance(cuda, k):
    """Gaussian-mixture data, held to phase 1's tolerance:
    |err| <= 1e-5 |d| + 32 eps max|x|^2, the same finite pattern, at the
    default k and at a k of the wide lists."""
    from repro_torch.data import VectorPipelineConfig, make_vectors

    x = torch.from_numpy(make_vectors(VectorPipelineConfig(n=20_000, dim=128,
                                                           n_clusters=256))).to(cuda)
    rng = np.random.default_rng(19)
    ids = torch.from_numpy(_edge_leaves(rng, 20_000)).to(cuda)
    gi, gd = leaf_knn.leaf_topk(x, ids, k)
    hi, hd = leaf_knn.leaf_topk_plain(x, ids, k)
    fin = torch.isfinite(hd)
    assert torch.equal(torch.isfinite(gd), fin)
    max_sq = float((x * x).sum(dim=1).max())
    err = (gd[fin] - hd[fin]).abs()
    assert bool((err <= 1e-5 * hd[fin].abs() + 32 * 2.0 ** -23 * max_sq).all()), float(err.max())
    assert float((gi == hi).float().mean()) > 0.99


@pytest.mark.parametrize("k", (0, -1))
def test_build_refuses_leaf_k_below_one_on_the_card(cuda, k):
    import repro_torch
    from repro_torch.core.leaf import LeafParams

    x = np.random.default_rng(4).standard_normal((500, 16)).astype(np.float32)
    with pytest.raises(ValueError, match="at least 1"):
        repro_torch.build(x, repro_torch.PiPNNParams(leaf=LeafParams(k=k)))


def test_leaf_topk_kernel_refuses_k_above_32(cuda):
    x = torch.zeros((100, 16), device=cuda)
    ids = torch.arange(64, device=cuda, dtype=torch.int32).reshape(2, 32)
    with pytest.raises(ValueError, match="k <= 32"):
        leaf_knn.leaf_topk(x, ids, 33)


@pytest.mark.parametrize("metric", ("l2", "cosine"))
@pytest.mark.parametrize("d", (768, 960, 1000))
def test_leaf_topk_kernel_deep_rows(cuda, d, metric):
    """Rows too deep for a 64-row tile in shared memory (d > 736 at
    c_max = 1024; 960 is GIST's width) take the row tile in depth chunks:
    still exact against the plain version on integer data (below 128, so
    that every norm and product stays below 2^24)."""
    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.integers(0, 128, (3000, d)).astype(np.float32)).to(cuda)
    ids = torch.from_numpy(_edge_leaves(rng, 3000)).to(cuda)
    got = leaf_knn.leaf_topk(x, ids, 2, metric)
    want = leaf_knn.leaf_topk_plain(x, ids, 2, metric)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_edge_hashes_kernel_matches_plain(cuda):
    rng = np.random.default_rng(9)
    sk = torch.randn(1000, 12, device=cuda)
    src = torch.from_numpy(rng.integers(-1, 1000, 100_000).astype(np.int32)).to(cuda)
    dst = torch.from_numpy(rng.integers(-1, 1000, 100_000).astype(np.int32)).to(cuda)
    assert torch.equal(edge_hash.edge_hashes(sk, src, dst),
                       edge_hash.edge_hashes_plain(sk, src, dst))


def _check_hashes(sk, src, dst):
    got = edge_hash.edge_hashes(sk, src, dst)
    want = edge_hash.edge_hashes_plain(sk, src, dst)
    assert torch.equal(got, want), (sk.shape, src.numel())


def _offset(t):
    """A copy of ``t`` one element past a 16-byte boundary (contiguous)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return flat.view(t.shape).copy_(t)


@pytest.mark.parametrize("m", (1, 4, 12, 13, 16))
@pytest.mark.parametrize("e", (0, 1, 3, 4, 5, 100_003))
def test_edge_hashes_kernel_widths_and_lengths(cuda, m, e):
    """Every hash width (m % 4 == 0 takes the 16-byte rows) and edge counts
    around the four-edge groups; then offset views of the ids and of the
    sketches, so that every 16-byte path falls back.  Bit-exact."""
    rng = np.random.default_rng(30 + m)
    sk = torch.from_numpy(rng.standard_normal((2000, m)).astype(np.float32)).to(cuda)
    src = torch.from_numpy(rng.integers(-1, 2000, e).astype(np.int32)).to(cuda)
    dst = torch.from_numpy(rng.integers(-1, 2000, e).astype(np.int32)).to(cuda)
    _check_hashes(sk, src, dst)
    _check_hashes(sk, _offset(src), _offset(dst))
    _check_hashes(_offset(sk), src, dst)
    _check_hashes(_offset(sk), _offset(src), dst)


@pytest.mark.parametrize("m", (12, 13))
def test_edge_hashes_kernel_padding_and_nonfinite_row0(cuda, m):
    """All-padding ids (every edge hashes row 0 against itself), and a row 0
    of +inf or NaN with -1 ids mixed in: the kernel's copy of row 0 keeps
    it bit for bit.  Bit-exact."""
    rng = np.random.default_rng(31)
    e = 10_007
    sk = torch.from_numpy(rng.standard_normal((500, m)).astype(np.float32)).to(cuda)
    pad = torch.full((e,), -1, dtype=torch.int32, device=cuda)
    _check_hashes(sk, pad, pad)
    src = torch.from_numpy(rng.integers(-1, 500, e).astype(np.int32)).to(cuda)
    dst = torch.from_numpy(rng.integers(-1, 500, e).astype(np.int32)).to(cuda)
    src[::3] = -1
    dst[1::5] = -1
    for bad in (float("inf"), float("-inf"), float("nan")):
        sk0 = sk.clone()
        sk0[0, ::2] = bad
        sk0[7] = bad
        _check_hashes(sk0, src, dst)
        _check_hashes(sk0, pad, dst)


def test_edge_hashes_kernel_on_leaf_chunk_edges(cuda):
    """The edges ``emit_knn_edges`` makes from a real leaf chunk (leaf
    top-k on the card, then the bidirected emission), on the sketches of
    seeded hyperplanes.  Bit-exact."""
    from repro_torch.core import sketch
    from repro_torch.core.leaf import emit_knn_edges

    rng = np.random.default_rng(32)
    x = torch.from_numpy(_int_points(rng, 5000, 128)).to(cuda)
    ids = torch.from_numpy(_leaves(rng, 5000, 40, 1024)).to(cuda)
    ki, kd = leaf_knn.leaf_topk(x, ids, 2)
    src, dst, _ = emit_knn_edges(ids, ki, kd)
    hp = torch.from_numpy(sketch.make_hyperplanes(0, 12, 128)).to(cuda)
    _check_hashes(sketch.sketch(x, hp).contiguous(), src, dst)


@pytest.mark.parametrize("metric", ("l2", "mips"))
def test_merge_kernel_matches_plain(cuda, metric):
    rng = np.random.default_rng(10)
    n, e, l_max = 500, 20_000, 64

    def reservoir():
        src = torch.from_numpy(rng.integers(0, n, e).astype(np.int32)).to(cuda)
        dst = torch.from_numpy(rng.integers(0, n, e).astype(np.int32)).to(cuda)
        hashes = (src * 31 + dst * 7) % 64
        dist = ((dst * 131 + src * 17) % 23).float() / 4
        if metric == "mips":
            dist -= 3.0
        return hashprune_flat(src, dst, hashes.int(), dist, n_points=n, l_max=l_max)

    a, b = reservoir(), reservoir()
    want = segmented_merge.merge_sorted_reservoirs_plain(*a, *b)
    got = segmented_merge.merge_sorted_reservoirs(*(t.clone() for t in a), *b)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("l", L_VALUES + (400,))
@pytest.mark.parametrize("kind", MERGE_KINDS)
def test_merge_kernel_edge_cases(cuda, kind, l):
    """Empty sides, full rows, 33-63 live slots, exact cross-side ties, the
    same id on both sides, l at and past the 32- and 64-slot edges (400:
    several 64-slot segments, past 48 KB of shared memory a block); ids,
    hashes and dists bit for bit."""
    case = [torch.from_numpy(t).to(cuda) for t in reservoir_pair(kind, l)]
    want = segmented_merge.merge_sorted_reservoirs_plain(*case)
    got = segmented_merge.merge_sorted_reservoirs(*(t.clone() for t in case[:3]), *case[3:])
    for g, w in zip(got, want):
        assert torch.equal(g, w), (kind, l)


@pytest.mark.parametrize("metric", ("l2", "mips"))
@pytest.mark.parametrize("d", (128, 37))
def test_gather_distance_kernel_matches_plain(cuda, metric, d):
    rng = np.random.default_rng(11)
    x = torch.from_numpy(_int_points(rng, 4000, d)).to(cuda)
    q = torch.from_numpy(_int_points(rng, 300, d)).to(cuda)
    ids = torch.from_numpy(rng.integers(-1, 4000, (300, 257)).astype(np.int32)).to(cuda)
    nrm = point_norms(x, metric)
    assert torch.equal(gather_distance.gather_distance(x, nrm, q, ids, metric),
                       gather_distance.gather_distance_plain(x, nrm, q, ids, metric))


@pytest.mark.parametrize("metric", ("l2", "mips", "cosine"))
@pytest.mark.parametrize("d", (128, 37))
def test_gather_distance_bf16_kernel_matches_plain(cuda, metric, d):
    """bfloat16 rows: exact on integers below 256 (exact in bfloat16) for l2
    and mips; otherwise within 1e-5 |d| + 16 eps (|q|^2 + |p|^2) (l2, mips)
    or 1e-5 |d| + 1e-5 (cosine)."""
    rng = np.random.default_rng(12)
    for integer in (True, False):
        x32 = (_int_points(rng, 3000, d) if integer
               else rng.standard_normal((3000, d)).astype(np.float32))
        x32 = torch.from_numpy(x32).to(cuda)
        q = x32[:200] + 1
        ids = torch.from_numpy(rng.integers(-1, 3000, (200, 130)).astype(np.int32)).to(cuda)
        nrm = point_norms(x32, metric)
        xb = x32.to(torch.bfloat16)
        got = gather_distance.gather_distance(xb, nrm, q, ids, metric)
        want = gather_distance.gather_distance_plain(xb, nrm, q, ids, metric)
        if integer and metric != "cosine":
            assert torch.equal(got, want)
        fin = torch.isfinite(want)
        assert torch.equal(torch.isfinite(got), fin)
        scale = (q * q).sum(1)[:, None] + (x32 * x32).sum(1)[ids.clamp_min(0).long()]
        slack = 1e-5 if metric == "cosine" else 16 * 2.0 ** -23 * scale[fin]
        assert bool(((got[fin] - want[fin]).abs() <= 1e-5 * want[fin].abs() + slack).all())


@pytest.mark.parametrize("row_type", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("c", (1, 7, 256, 257))
def test_gather_distance_kernel_id_patterns(cuda, c, row_type):
    """Id rows all padding, all valid and mixed, at C that is below, at and
    past the 32-slot warp chunks; exact on integer data (l2, mips), also
    for points that are not 16-byte aligned (the one-element loads)."""
    rng = np.random.default_rng(20)
    x32 = torch.from_numpy(_int_points(rng, 4000, 128)).to(cuda)
    q = torch.from_numpy(_int_points(rng, 90, 128)).to(cuda)
    ids = rng.integers(0, 4000, (90, c)).astype(np.int32)
    ids[:30] = -1                            # all padding
    mixed = ids[60:]
    mixed[rng.random(mixed.shape) < 0.3] = -1
    ids = torch.from_numpy(ids).to(cuda)
    flat = torch.empty(4000 * 128 + 1, dtype=row_type, device=cuda)
    offset = flat[1:].view(4000, 128)
    offset.copy_(x32.to(row_type))
    for pts in (x32.to(row_type), offset):
        for metric in ("l2", "mips"):
            nrm = point_norms(x32, metric)
            got = gather_distance.gather_distance(pts, nrm, q, ids, metric)
            want = gather_distance.gather_distance_plain(pts, nrm, q, ids, metric)
            assert torch.equal(got, want), (metric, pts.data_ptr() % 16)
    assert bool(torch.isinf(got[:30]).all())


@pytest.mark.parametrize("metric", ("l2", "mips", "cosine"))
@pytest.mark.parametrize("d", (128, 37))
def test_gather_distance_int8_kernel_bit_exact(cuda, metric, d):
    """Bit-exact on Gaussian and integer data alike (no FMA contraction)."""
    rng = np.random.default_rng(13)
    for x32 in (torch.from_numpy(_int_points(rng, 4000, d)),
                torch.from_numpy(rng.standard_normal((4000, d)).astype(np.float32))):
        x32 = x32.to(cuda)
        q = x32[:300] * 0.5 + 1
        p8, sc = gather_distance_int8.quantize_symmetric(x32)
        ids = torch.from_numpy(rng.integers(-1, 4000, (300, 257)).astype(np.int32)).to(cuda)
        args = (p8, sc, point_norms(x32, metric), q, point_norms(q, metric), ids, metric)
        assert torch.equal(gather_distance_int8.gather_distance_int8(*args),
                           gather_distance_int8.gather_distance_int8_plain(*args))


@pytest.mark.parametrize("d", (128, 96, 37, 256))
@pytest.mark.parametrize("c", (1, 7, 256, 257))
def test_gather_distance_int8_kernel_id_patterns(cuda, c, d):
    """Id rows all padding, all valid and mixed, at C below, at and past the
    32-slot warp chunks; d one 128-byte row, part of one (96), ragged (37:
    the one-byte lanes) and two chunks a lane (256); points at a 4-byte but
    not 16-byte offset and queries at one float's offset (the one-byte
    lanes too).  Gaussian data, all three metrics, bit-exact."""
    rng = np.random.default_rng(21)
    x32 = torch.from_numpy(rng.standard_normal((4000, d)).astype(np.float32)).to(cuda)
    q = torch.from_numpy(rng.standard_normal((90, d)).astype(np.float32)).to(cuda)
    ids = rng.integers(0, 4000, (90, c)).astype(np.int32)
    ids[:30] = -1                            # all padding
    mixed = ids[60:]
    mixed[rng.random(mixed.shape) < 0.3] = -1
    ids = torch.from_numpy(ids).to(cuda)
    p8, sc = gather_distance_int8.quantize_symmetric(x32)
    p8_off = torch.empty(4000 * d + 4, dtype=torch.int8, device=cuda)[4:].view(4000, d)
    p8_off.copy_(p8)
    q_off = torch.empty(90 * d + 1, device=cuda)[1:].view(90, d)
    q_off.copy_(q)
    for pts, qq in ((p8, q), (p8_off, q), (p8, q_off)):
        for metric in ("l2", "mips", "cosine"):
            args = (pts, sc, point_norms(x32, metric), qq, point_norms(q, metric), ids, metric)
            got = gather_distance_int8.gather_distance_int8(*args)
            want = gather_distance_int8.gather_distance_int8_plain(*args)
            assert torch.equal(got, want), (metric, pts.data_ptr() % 16, qq.data_ptr() % 16)
    assert bool(torch.isinf(got[:30]).all())


@pytest.mark.parametrize("metric", ("l2", "mips", "cosine"))
@pytest.mark.parametrize("b,m,n,d", [(1, 3000, 1000, 128), (3, 70, 130, 37)])
def test_pairwise_distance_kernel_matches_plain(cuda, metric, b, m, n, d):
    """Exact on integer data for l2 and mips (cosine within 4 eps);
    Gaussian within 1e-5 |d| + 1e-4 (|a|^2 + |b|^2)."""
    rng = np.random.default_rng(14)
    a = torch.from_numpy(_int_points(rng, b * m, d).reshape(b, m, d)).to(cuda)
    bb = torch.from_numpy(_int_points(rng, b * n, d).reshape(b, n, d)).to(cuda)
    got = distance.pairwise_distance(a, bb, metric)
    want = distance.pairwise_distance_plain(a, bb, metric)
    if metric == "cosine":
        assert float((got - want).abs().max()) <= 4 * 2.0 ** -23
    else:
        assert torch.equal(got, want)
    a, bb = a.normal_(), bb.normal_()
    got = distance.pairwise_distance(a, bb, metric)
    want = distance.pairwise_distance_plain(a, bb, metric)
    scale = (a * a).sum(-1)[:, :, None] + (bb * bb).sum(-1)[:, None, :]
    atol = 1e-5 if metric == "cosine" else 1e-4 * scale
    assert bool(((got - want).abs() <= 1e-5 * want.abs() + atol).all())


def _int_panels(rng, b, m, n, d, hi=256):
    return (torch.from_numpy(rng.integers(0, hi, (b, m, d)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, hi, (b, n, d)).astype(np.float32)))


def _check_pairwise(a, bb, metric):
    """Integer data: l2 and mips bit for bit, cosine within 4 eps."""
    got = distance.pairwise_distance(a, bb, metric)
    want = distance.pairwise_distance_plain(a, bb, metric)
    if metric == "cosine":
        assert float((got - want).abs().max()) <= 4 * 2.0 ** -23
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("metric", ("l2", "mips", "cosine"))
@pytest.mark.parametrize("b,m,n,d", [(2, 300, 259, 1), (2, 129, 127, 37), (1, 257, 385, 128),
                                     (3, 130, 200, 960), (2, 130, 129, 0)])
def test_pairwise_distance_kernel_tile_edges(cuda, metric, b, m, n, d):
    """M and N off the 128x128 tiles (odd N takes the 4-byte stores), D of
    one element, ragged (37: the 4-byte copies), one 128-deep tile and 30
    stages (960, integers below 128 so that every sum stays below 2^24),
    D = 0 (every tile still written: 0, -0 or 1), B > 1.  Exact on integer
    data; Gaussian within 1e-5 |d| + 1e-4 (|a|^2 + |b|^2)."""
    rng = np.random.default_rng(22)
    a, bb = (t.to(cuda) for t in _int_panels(rng, b, m, n, d, 128 if d > 128 else 256))
    _check_pairwise(a, bb, metric)
    a, bb = a.normal_(), bb.normal_()
    got = distance.pairwise_distance(a, bb, metric)
    want = distance.pairwise_distance_plain(a, bb, metric)
    scale = (a * a).sum(-1)[:, :, None] + (bb * bb).sum(-1)[:, None, :]
    atol = 1e-5 if metric == "cosine" else 1e-4 * scale
    assert bool(((got - want).abs() <= 1e-5 * want.abs() + atol).all())


@pytest.mark.parametrize("metric", ("l2", "mips", "cosine"))
def test_pairwise_distance_kernel_offset_views(cuda, metric):
    """Inputs one float past a 16-byte boundary take the 4-byte copies at
    D = 128; exact on integer data all the same."""
    rng = np.random.default_rng(23)
    a, bb = (t.to(cuda) for t in _int_panels(rng, 2, 300, 260, 128))
    a_off = torch.empty(a.numel() + 1, device=cuda)[1:].view(a.shape)
    b_off = torch.empty(bb.numel() + 1, device=cuda)[1:].view(bb.shape)
    a_off.copy_(a)
    b_off.copy_(bb)
    for x, y in ((a_off, bb), (a, b_off), (a_off, b_off)):
        _check_pairwise(x, y, metric)


@pytest.mark.parametrize("metric", ("l2", "mips"))
def test_pairwise_distance_kernel_gaussian_within_tolerance(cuda, metric):
    """Gaussian-mixture points against 1,000 of them, held to phase 5's
    tolerance |err| <= 1e-5 |d| + 32 eps max|x|^2, which a kernel that
    drops the two lo products of the 3xTF32 split misses (integer data
    below 2048 cannot tell: there lo = 0)."""
    from repro_torch.data import VectorPipelineConfig, make_vectors

    x = torch.from_numpy(make_vectors(VectorPipelineConfig(n=20_000, dim=128,
                                                           n_clusters=256))).to(cuda)
    rng = np.random.default_rng(24)
    leaders = x[torch.from_numpy(rng.choice(20_000, 1000, replace=False)).to(cuda)]
    got = distance.pairwise_distance(x[None], leaders[None], metric)
    want = distance.pairwise_distance_plain(x[None], leaders[None], metric)
    max_sq = float((x * x).sum(dim=1).max())
    err = (got - want).abs()
    assert bool((err <= 1e-5 * want.abs() + 32 * 2.0 ** -23 * max_sq).all()), float(err.max())


@pytest.mark.parametrize("b,m,n,d", [(1, 2000, 1000, 128), (2, 70, 130, 37)])
def test_pairwise_distance_int8_kernel_exact(cuda, b, m, n, d):
    g = torch.Generator(device=cuda).manual_seed(15)
    a = torch.randint(-127, 128, (b, m, d), device=cuda, generator=g, dtype=torch.int8)
    bb = torch.randint(-127, 128, (b, n, d), device=cuda, generator=g, dtype=torch.int8)
    assert torch.equal(distance.pairwise_distance_int8(a, bb),
                       distance.pairwise_distance_int8_plain(a, bb))
    # an offset view: rows no longer start on 4-byte boundaries
    flat = torch.randint(-127, 128, (1 + m * d,), device=cuda, generator=g, dtype=torch.int8)
    av = flat[1:].view(1, m, d)
    assert torch.equal(distance.pairwise_distance_int8(av, bb[:1]),
                       distance.pairwise_distance_int8_plain(av, bb[:1]))


INT8_SIZES = (1, 127, 128, 129, 1000)


def _int8(g, shape, cuda):
    return torch.randint(-128, 128, shape, device=cuda, generator=g, dtype=torch.int8)


@pytest.mark.parametrize("m", INT8_SIZES)
@pytest.mark.parametrize("n", INT8_SIZES)
@pytest.mark.parametrize("d", (16, 37))
def test_pairwise_distance_int8_kernel_tile_edges(cuda, m, n, d):
    """M and N on and off the 128x128 tiles (N = 127, 129, 1 take the
    scalar stores), D through the 16-byte (16) and byte (37) copies.
    Exact."""
    g = torch.Generator(device=cuda).manual_seed(40 + m + n + d)
    a, bb = _int8(g, (1, m, d), cuda), _int8(g, (1, n, d), cuda)
    assert torch.equal(distance.pairwise_distance_int8(a, bb),
                       distance.pairwise_distance_int8_plain(a, bb))


@pytest.mark.parametrize("d", (0, 1, 16, 37, 128, 960))
def test_pairwise_distance_int8_kernel_depths(cuda, d):
    """Every depth class (D = 0 writes zeros; 1 and 37 the byte copies; 16,
    128 and 960, eight ring stages, the 16-byte copies), B = 2, then a
    view one byte past a 16-byte boundary (4-byte copies where D % 4 == 0,
    else bytes) and rows full of -128 and of 127.  Exact."""
    g = torch.Generator(device=cuda).manual_seed(50 + d)
    a, bb = _int8(g, (2, 300, d), cuda), _int8(g, (2, 129, d), cuda)
    want = distance.pairwise_distance_int8_plain(a, bb)
    assert torch.equal(distance.pairwise_distance_int8(a, bb), want)
    if d == 0:
        assert bool((want == 0).all())
    av = torch.empty(a.numel() + 1, dtype=torch.int8, device=cuda)[1:].view(a.shape)
    av.copy_(a)
    assert torch.equal(distance.pairwise_distance_int8(av, bb), want)
    ext = a.clone()
    ext[:, ::2] = -128
    ext[:, 1::4] = 127
    be = bb.clone()
    be[:, ::3] = 127
    be[:, 1::3] = -128
    assert torch.equal(distance.pairwise_distance_int8(ext, be),
                       distance.pairwise_distance_int8_plain(ext, be))


TOPK_K = (1, 2, 10, 16, 17, 32)


def _check_topk(d, k):
    got = topk.rowwise_topk(d, k)
    want = topk.rowwise_topk_plain(d, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), k
    return got


@pytest.mark.parametrize("k", TOPK_K)
@pytest.mark.parametrize("b,m,n", [(1, 5000, 1000), (2, 130, 11), (1, 37, 4097), (1, 40, 1),
                                   (3, 50, 31), (1, 20, 100_000)])
def test_rowwise_topk_kernel_exact(cuda, k, b, m, n):
    """Ties, +inf masks, -1 ids, fewer finite entries than k.  Exact."""
    rng = np.random.default_rng(16)
    d = rng.integers(0, 6, (b, m, n)).astype(np.float32)
    d[rng.random((b, m, n)) < 0.3] = np.inf
    d[0, 0] = np.inf
    d[0, 1, 2:] = np.inf
    d = torch.from_numpy(d).to(cuda)
    got = _check_topk(d, k)
    assert bool((got[0][0, 0] == -1).all())


def _continuous_rows(rng, m, n):
    """Squared distances of Gaussian points to n Gaussian leaders, as phase
    5 gives them: distinct continuous values."""
    x = rng.standard_normal((m, 16)).astype(np.float32)
    lead = rng.standard_normal((n, 16)).astype(np.float32)
    return ((x[:, None, :] - lead[None, :, :]) ** 2).sum(-1)[None]


@pytest.mark.parametrize("k", TOPK_K)
def test_rowwise_topk_kernel_continuous_rows(cuda, k):
    """Continuous rows at N = 1000, from a 16-byte aligned matrix (the
    16-byte lanes) and from a view one float past it (the 4-byte lanes).
    Exact."""
    d = torch.from_numpy(_continuous_rows(np.random.default_rng(24), 3000, 1000)).to(cuda)
    _check_topk(d, k)
    off = torch.empty(d.numel() + 1, device=cuda)[1:].view(d.shape)
    off.copy_(d)
    _check_topk(off, k)


def _adversarial_rows(rng, n):
    """Rows built against the kernel's bar and buffer: the small values all
    in one lane (for 16-byte lanes: columns 0-3 mod 128; for 4-byte lanes:
    0 mod 32), a whole row of one value and a row of 0/1 values (more
    candidates than the 256-entry buffer), fewer finite entries than any k,
    mostly +inf, -0.0 beside +0.0, and -inf entries."""
    c = np.arange(n)
    rows = []
    for lane_cols in (c % 128 < 4, c % 32 == 0):
        r = rng.uniform(100, 200, n).astype(np.float32)
        r[lane_cols] = rng.uniform(0, 1, int(lane_cols.sum()))
        rows.append(r)
    rows.append(np.full(n, 7.0, np.float32))
    rows.append(rng.integers(0, 2, n).astype(np.float32))
    few = np.full(n, np.inf, np.float32)
    few[rng.choice(n, min(n, 5), replace=False)] = rng.uniform(0, 1, min(n, 5))
    rows.append(few)
    mostly = rng.uniform(0, 1, n).astype(np.float32)
    mostly[rng.random(n) < 0.95] = np.inf
    rows.append(mostly)
    zeros = np.where(rng.random(n) < 0.5, -0.0, 0.0).astype(np.float32)
    zeros[rng.random(n) < 0.5] = 1.0
    rows.append(zeros)
    neg = rng.uniform(0, 1, n).astype(np.float32)
    neg[rng.choice(n, min(n, 3), replace=False)] = -np.inf
    rows.append(neg)
    return np.stack(rows)[None]


@pytest.mark.parametrize("k", TOPK_K)
@pytest.mark.parametrize("n", (1000, 4097))
def test_rowwise_topk_kernel_adversarial_rows(cuda, k, n):
    """Exact on every adversarial row (``_adversarial_rows``), through the
    16-byte lanes (N = 1000) and the 4-byte lanes (N = 4097)."""
    d = torch.from_numpy(_adversarial_rows(np.random.default_rng(25), n)).to(cuda)
    ids, vals = _check_topk(d, k)
    assert bool((ids[0, 2] == torch.arange(k, device=cuda)).all())   # one value: lowest columns


def test_rowwise_topk_kernel_refuses_k_above_32(cuda):
    d = torch.zeros((1, 4, 100), device=cuda)
    with pytest.raises(ValueError, match="k <= 32"):
        topk.rowwise_topk(d, 33)


def test_leader_assign_kernel_route_on_the_card(cuda):
    from repro_torch.core.leader_assign import leader_assign

    rng = np.random.default_rng(17)
    x = torch.from_numpy(_int_points(rng, 20_000, 128)).to(cuda)
    lead = x[torch.from_numpy(rng.choice(20_000, 200, replace=False)).to(cuda)]
    topk.launches = distance.launches = 0
    got = leader_assign(x, lead, 10, use_kernels=True)
    assert topk.launches == 1 and distance.launches == 1
    assert torch.equal(got, leader_assign(x, lead, 10))


def test_kernel_launch_counters_count_launches(cuda):
    from repro_torch import kernels

    kernels.reset_launch_counts()
    x = torch.randint(0, 256, (300, 16), device=cuda).float()
    ids = torch.arange(256, device=cuda, dtype=torch.int32).reshape(2, 128)
    leaf_knn.leaf_topk(x, ids, 2)
    leaf_knn.leaf_topk_plain(x, ids, 2)
    distance.pairwise_distance_int8(x[None].to(torch.int8), x[None].to(torch.int8))
    assert kernels.launch_counts() == {"leaf_knn": 1, "edge_hash": 0,
                                       "segmented_merge": 0, "gather_distance": 0,
                                       "gather_distance_int8": 0, "pairwise_distance": 0,
                                       "pairwise_distance_int8": 1, "rowwise_topk": 0}


def test_main_path_launches_every_kernel(cuda):
    """Each path through its own kernels: the build through leaf, hash and
    merge; float32 and bfloat16 search through the gather kernel; int8
    search through the int8 gather kernel and no other."""
    import repro_torch
    from repro_torch import kernels
    from repro_torch.data import VectorPipelineConfig, make_vectors, sift_like

    x = sift_like(make_vectors(VectorPipelineConfig(n=20_000, dim=128, n_clusters=64)))
    kernels.reset_launch_counts()
    index = repro_torch.build(x)
    counts = kernels.launch_counts()
    assert all(counts[k] > 0 for k in ("leaf_knn", "edge_hash", "segmented_merge")), counts
    for dtype, used in ((None, "gather_distance"), (torch.bfloat16, "gather_distance"),
                        ("int8", "gather_distance_int8")):
        kernels.reset_launch_counts()
        repro_torch.search(index, x, x[:100], k=10, beam=32, dtype=dtype)
        counts = kernels.launch_counts()
        assert counts[used] > 0 and sum(counts.values()) == counts[used], (dtype, counts)
    cpu = repro_torch.build(x, device="cpu")
    assert torch.equal(index.graph.cpu(), cpu.graph) and index.start == cpu.start


@pytest.mark.parametrize("m", (1504, 4001))
def test_pairwise_distance_kernel_level1_shapes(cuda, m):
    """The static carve's level-1 shape, [B, M, 80] x [B, 80, 128]: exact
    on integer data, Gaussian within 1e-5 |d| + 1e-4 (|a|^2 + |b|^2)."""
    rng = np.random.default_rng(26)
    a, bb = (t.to(cuda) for t in _int_panels(rng, 5, m, 80, 128))
    _check_pairwise(a, bb, "l2")
    _check_pairwise(a, bb, "mips")
    a, bb = a.normal_(), bb.normal_()
    got = distance.pairwise_distance(a, bb)
    want = distance.pairwise_distance_plain(a, bb)
    scale = (a * a).sum(-1)[:, :, None] + (bb * bb).sum(-1)[:, None, :]
    assert bool(((got - want).abs() <= 1e-5 * want.abs() + 1e-4 * scale).all())


@pytest.mark.parametrize("n,k", [(80, 3), (1000, 12)])
def test_rowwise_topk_kernel_static_carve_shapes(cuda, n, k):
    """The static carve's selections, k = 3 of N = 80 (level 1) and k = 12
    of N = 1000 (level 0), with +inf-masked columns (invalid leaders),
    all-inf rows (invalid points) and rows with fewer than k finite
    entries.  Exact, -1 ids included."""
    rng = np.random.default_rng(27)
    d = rng.integers(0, 50, (3, 2000, n)).astype(np.float32)
    d[:, :, rng.random(n) < 0.2] = np.inf          # invalid leaders, each batch
    d[1, :, k - 1:] = np.inf                       # fewer than k valid leaders
    d[:, 1500:] = np.inf                           # padded points
    ids, _ = _check_topk(torch.from_numpy(d).to(cuda), k)
    assert bool((ids[:, 1500:] == -1).all()) and bool((ids[1, :, k - 1:] == -1).all())


def test_leader_assign_kernel_route_masks_level1(cuda):
    """Level 1 through the kernels: -1 exactly where the ``topf`` route
    picks an invalid leader or serves an invalid point, its ids elsewhere."""
    from repro_torch.core.leader_assign import leader_assign

    rng = np.random.default_rng(28)
    pts = torch.from_numpy(_int_points(rng, 6 * 1504, 128).reshape(6, 1504, 128)).to(cuda)
    lead = torch.from_numpy(_int_points(rng, 6 * 80, 128).reshape(6, 80, 128)).to(cuda)
    pv = torch.from_numpy(rng.random((6, 1504)) < 0.9).to(cuda)
    lv = torch.from_numpy(rng.random((6, 80)) < 0.8).to(cuda)
    lv[2] = False
    lv[2, 5:7] = True                              # two valid leaders, f = 3
    got = leader_assign(pts, lead, 3, point_valid=pv, leader_valid=lv, use_kernels=True)
    ref = leader_assign(pts, lead, 3, point_valid=pv, leader_valid=lv)
    ok = pv[..., None] & torch.gather(lv, 1, ref.long().reshape(6, -1)).reshape(ref.shape)
    assert torch.equal(got, torch.where(ok, ref, -1))
    assert bool((got[2, :, 2] == -1).all())


@pytest.mark.parametrize("metric", ("l2", "mips"))
def test_static_carve_on_the_card_equals_cpu(cuda, monkeypatch, metric):
    """The static carve on integer data: the card's matrix (through the
    distance and top-k kernels) is the CPU's, bit for bit, at two block
    sizes; with l2 the static build's graph is the CPU's too."""
    import repro_torch
    from repro_torch import kernels
    from repro_torch.core import rbc
    from repro_torch.data import VectorPipelineConfig, make_vectors, sift_like

    x = sift_like(make_vectors(VectorPipelineConfig(n=30_000, dim=128, n_clusters=64)))
    p = rbc.RBCParams(metric=metric, execution="static")
    want = rbc.ball_carve_device(torch.from_numpy(x), p)
    kernels.reset_launch_counts()
    got = rbc.ball_carve_device(torch.from_numpy(x).to(cuda), p)
    counts = kernels.launch_counts()
    assert counts["pairwise_distance"] > 0 and counts["rowwise_topk"] > 0, counts
    np.testing.assert_array_equal(got, want)
    monkeypatch.setattr(rbc, "_BLOCK_ROWS", 5000)
    np.testing.assert_array_equal(rbc.ball_carve_device(torch.from_numpy(x).to(cuda), p), want)
    if metric != "l2":
        return
    params = repro_torch.PiPNNParams(rbc=p, metric=metric)
    card = repro_torch.build(x, params)
    cpu = repro_torch.build(x, params, device="cpu")
    assert card.stats["partition_execution"] == cpu.stats["partition_execution"] == "static"
    assert torch.equal(card.graph.cpu(), cpu.graph) and card.start == cpu.start


def _small_sift(n=8000, seed=0):
    from repro_torch.data import VectorPipelineConfig, make_vectors, sift_like

    return sift_like(make_vectors(VectorPipelineConfig(n=n, dim=128, n_clusters=64,
                                                       seed=seed)))


def _card_and_cpu(x, params, **kw):
    """The same build on the card and on the CPU, with the CPU's leaves
    and dyadic hyperplanes given to both; the launch counts of the card's."""
    import repro_torch
    from repro_torch import kernels
    from repro_torch.core.rbc import partition
    from repro_torch.data import dyadic_hyperplanes

    leaves = partition(torch.from_numpy(x), params.rbc)
    hp = dyadic_hyperplanes(3, params.hash_bits, x.shape[1])
    kernels.reset_launch_counts()
    card = repro_torch.build(x, params, leaves=leaves, hyperplanes=hp, **kw)
    counts = kernels.launch_counts()
    cpu = repro_torch.build(x, params, leaves=leaves, hyperplanes=hp, device="cpu", **kw)
    assert torch.equal(card.graph.cpu(), cpu.graph) and torch.equal(card.dists.cpu(), cpu.dists)
    assert card.start == cpu.start and card.stats["streaming"] == cpu.stats["streaming"]
    return card, counts


@pytest.mark.parametrize("option", ("flat build", "flat fold", "no final prune"))
def test_build_options_on_the_card_equal_cpu(cuda, option):
    """The flat build, the flat fold and ``final_prune=False`` on integer
    data: identical graphs on the card and the CPU; the flat paths launch
    the leaf and hash kernels and never the merge kernel."""
    import repro_torch
    from repro_torch.core.rbc import RBCParams

    x = _small_sift()
    params = repro_torch.PiPNNParams(rbc=RBCParams(c_max=256, c_min=32, fanout=(4, 2)),
                                     max_deg=32)
    kw = {}
    if option == "flat build":
        kw["streaming"] = False
    elif option == "flat fold":
        params = params.with_(merge="flat")
    else:
        params = params.with_(final_prune=False)
    card, counts = _card_and_cpu(x, params, **kw)
    assert counts["leaf_knn"] > 0 and counts["edge_hash"] > 0, counts
    assert (counts["segmented_merge"] == 0) == (option != "no final prune"), counts


@pytest.mark.parametrize("method", ("bidirected", "directed", "inverted", "mst",
                                    "robust_prune"))
@pytest.mark.parametrize("streaming", (True, False))
def test_leaf_methods_on_the_card_equal_cpu(cuda, method, streaming):
    """Every leaf method, streamed and flat, on integer data: identical
    graphs on the card and the CPU; the k-NN methods launch the leaf
    kernel, every method the hash kernel, only streamed ones the merge."""
    import repro_torch
    from repro_torch.core.leaf import LeafParams
    from repro_torch.core.rbc import RBCParams

    x = _small_sift(4000, seed=1)
    params = repro_torch.PiPNNParams(rbc=RBCParams(c_max=128, c_min=16, fanout=(4, 2)),
                                     leaf=LeafParams(method=method, k=2, max_deg=32),
                                     max_deg=32)
    card, counts = _card_and_cpu(x, params, streaming=streaming)
    streamed = streaming and method != "mst"
    assert card.stats["streaming"] == streamed
    assert (counts["leaf_knn"] > 0) == (method in ("bidirected", "directed", "inverted"))
    assert counts["edge_hash"] > 0 and (counts["segmented_merge"] > 0) == streamed, counts


@pytest.mark.parametrize("metric", ("l2", "mips"))
def test_beam_search_single_on_the_card_equals_cpu(cuda, metric):
    from repro_torch.core.beam_search import beam_search_single, brute_force_knn, medoid

    x = _small_sift(3000, seed=2)
    xt = torch.from_numpy(x)
    graph = torch.from_numpy(brute_force_knn(xt, xt, 17, metric=metric)[:, 1:].astype(np.int32))
    graph[::4, 10:] = -1
    q = torch.from_numpy(_small_sift(300, seed=3))
    for beam in (16, 64):
        kw = dict(start=medoid(x), beam=beam, iters=beam + 4, metric=metric)
        card = beam_search_single(graph.to(cuda), xt.to(cuda), q.to(cuda), **kw)
        cpu = beam_search_single(graph, xt, q, **kw)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu))


def test_leaf_topk_kernel_on_many_stream_chunks_at_once(cuda):
    """The flat build calls the leaf kernel on many stream chunks of leaves
    at once: equal to the plain version, and to the kernel chunk by chunk."""
    rng = np.random.default_rng(30)
    x = torch.from_numpy(_int_points(rng, 20_000, 128)).to(cuda)
    ids = torch.from_numpy(_leaves(rng, 20_000, 3000, 256)).to(cuda)
    got = leaf_knn.leaf_topk(x, ids, 2)
    want = leaf_knn.leaf_topk_plain(x, ids, 2, block=64)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    parts = [leaf_knn.leaf_topk(x, ids[s:s + 8], 2) for s in range(0, 3000, 8)]
    assert torch.equal(got[0], torch.cat([p[0] for p in parts]))
    assert torch.equal(got[1], torch.cat([p[1] for p in parts]))


# ----------------------------------------------------- sharded serving, loop --

def _sharded_fixture(gaussian: bool = False, n: int = 6000, d: int = 32):
    """A CPU-built graph over ``n`` points (integer, or the Gaussian mixture
    they are made from) and 300 queries of the same kind."""
    from repro_torch.core import pipnn
    from repro_torch.data import VectorPipelineConfig, make_queries, make_vectors, sift_like

    cfg = VectorPipelineConfig(n=n, dim=d, n_clusters=32, seed=4)
    x, q = make_vectors(cfg), make_queries(cfg, 300)
    if not gaussian:
        x, q = sift_like(x), sift_like(q)
    idx = pipnn.build(x, pipnn.PiPNNParams(max_deg=32), device="cpu")
    return idx, x, q


@pytest.mark.parametrize("dtype", (None, "int8"), ids=("f32", "int8"))
def test_sharded_serving_on_the_card_equals_cpu(cuda, dtype):
    """S = 8 on integer data: the packing and the ids of both routers are the
    same on the card and on the CPU, and the card search launches the
    gather kernel once a step for every shard that serves."""
    from repro_torch import kernels
    from repro_torch.distributed.serving import ShardedServingIndex

    idx, x, q = _sharded_fixture()
    for kw in ({}, {"router": "leaders", "n_probes": 2}):
        card = ShardedServingIndex.from_index(idx, x, n_shards=8, dtype=dtype, device=cuda,
                                              **kw)
        cpu = ShardedServingIndex.from_index(idx, x, n_shards=8, dtype=dtype, device="cpu",
                                             **kw)
        for name in ("gids", "graph", "points", "norms", "starts", "leaders", "scales"):
            a, b = getattr(card, name), getattr(cpu, name)
            assert (a is None and b is None) or torch.equal(a.cpu(), b), name
        kernels.reset_launch_counts()
        got, stats = card.search(q, k=10, beam=32, with_stats=True)
        counter = "gather_distance_int8" if dtype else "gather_distance"
        assert kernels.launch_counts()[counter] > 0 and stats["kernel_path"] == "hbm"
        want, cstats = cpu.search(q, k=10, beam=32, with_stats=True)
        np.testing.assert_array_equal(got, want)
        for key in ("hops", "dist_comps", "converged"):
            np.testing.assert_array_equal(stats[key], cstats[key])


@pytest.mark.parametrize("dtype", (None, torch.bfloat16), ids=("f32", "bf16"))
def test_sharded_halo_dedup_contract_on_the_card(cuda, dtype):
    """On Gaussian data a ghost row's distance to a query, from the gather
    kernel, is bit-identical in every shard that holds it (its sum order
    does not depend on its slot), and no merged row repeats an id."""
    from repro_torch.distributed.serving import ShardedServingIndex

    idx, x, q = _sharded_fixture(gaussian=True)
    sv = ShardedServingIndex.from_index(idx, x, n_shards=8, dtype=dtype, device=cuda)
    qt = torch.from_numpy(q).to(cuda)
    ids_s, ds_s, *_ = sv._shard_search(qt, None, beam=64, iters=68, expansions=4,
                                       early_exit=True, plain=False)
    ids_s, ds_s = ids_s.cpu().numpy(), ds_s.cpu().numpy()
    seen, repeats = {}, 0
    for s, qi, j in zip(*np.nonzero(ids_s >= 0)):
        key = (int(qi), int(ids_s[s, qi, j]))
        if key in seen:
            repeats += 1
            assert seen[key] == ds_s[s, qi, j].tobytes(), key
        seen[key] = ds_s[s, qi, j].tobytes()
    assert repeats > 0
    for row in sv.search(q, k=10, beam=64):
        live = row[row >= 0]
        assert len(np.unique(live)) == len(live)


def test_forced_xla_search_launches_no_gather_kernel(cuda):
    """``kernel_path="xla"`` runs the plain gather (no launch) and gives the
    kernel's ids on integer data; every other path launches the kernel."""
    from repro_torch import kernels
    from repro_torch.core.serving import ServingIndex

    idx, x, q = _sharded_fixture(n=3000)
    for n_shards in (None, 4):
        for dtype, counter in ((None, "gather_distance"), ("int8", "gather_distance_int8")):
            sv = ServingIndex.from_index(idx, x, dtype=dtype, device=cuda, n_shards=n_shards)
            runs = {}
            for path in (None, "vmem", "hbm", "xla"):
                kernels.reset_launch_counts()
                ids, stats = sv.search(q, k=10, beam=32, kernel_path=path, with_stats=True)
                runs[path] = (ids, stats["kernel_path"], kernels.launch_counts()[counter])
            assert runs["xla"][1:] == ("xla", 0)
            for path in (None, "vmem", "hbm"):
                assert runs[path][1] == "hbm" and runs[path][2] > 0
                np.testing.assert_array_equal(runs[path][0], runs["xla"][0])
            with pytest.raises(ValueError, match="kernel_path"):
                sv.search(q, kernel_path="mosaic")


def test_probe_shard_readmits_through_the_patched_search(cuda):
    """Under ``inject_faults`` the default probe goes through the patched
    ``search``: it fails while the shard's outage is scheduled and re-admits
    the shard once the window has closed; the serving loop counts one
    tombstone and one re-admission."""
    from repro_torch.core.serving import ServingIndex
    from repro_torch.launch.serve_loop import ServeLoop
    from repro_torch.testing.faults import FaultPlan, inject_faults

    idx, x, q = _sharded_fixture(n=3000)
    sv = ServingIndex.from_index(idx, x, device=cuda, n_shards=4)
    with inject_faults(sv, FaultPlan(shard_down={3: (1, 4)})) as inj:
        sv.search(q[:8], k=10)                            # call 0: healthy
        sv.mark_shard_down(3)
        assert not sv.probe_shard(3)                      # call 1: in the window
        assert sv.down_shards == (3,)
        sv.search(q[:8], k=10)                            # call 2: degraded
        assert not sv.probe_shard(3)                      # call 3
        assert sv.probe_shard(3)                          # call 4: window closed
    assert [e[:2] for e in inj.events] == [("shard_failure", 1), ("shard_failure", 3)]
    assert not sv.down_shards and "search" not in vars(sv)
    with inject_faults(sv, FaultPlan(shard_down={1: (1, 3)})):
        loop = ServeLoop(sv, k=10, query_chunk=32, probe_every=1)
        for qi in q[:128]:
            loop.submit(qi)
        res = loop.run_until_drained()
    assert len(res) == 128 and all(r.ok for r in res)
    assert loop.counters["shards_marked_down"] == 1 == loop.counters["shards_readmitted"]


# ------------------------------------------------- the distributed build ---

def _round_trip_points(n, d, seed):
    from _torch_build_reference import round_trip_integers

    return round_trip_integers(n, d, seed)


def _outlier_points(n, d, seed):
    from _torch_build_reference import outlier_points

    return outlier_points(n, d, seed)


BUILD_VARIANTS = {"baseline": {}, "int8": dict(route_dtype="int8"),
                  "bf16": dict(leaf_dtype="bf16"), "flat": dict(merge="flat")}


@pytest.mark.parametrize("n_shards", (1, 8))
@pytest.mark.parametrize("variant", tuple(BUILD_VARIANTS))
def test_tile_step_kernel_route_equals_plain_route(cuda, variant, n_shards):
    """The tile step's kernel route on the card (distance and top-k at
    both levels, the top-k on the leaves, the int8 distance for the
    quantized route, the merge for the segmented fold) equals its plain
    route (the CPU run) exactly: integer points whose int8 round trip is
    exact, dyadic hyperplanes, and a far-away two-point bucket on which
    the CPU tests see both -1 traps fire."""
    from repro_torch import kernels
    from repro_torch.core.hashprune import reservoir_init
    from repro_torch.data import dyadic_hyperplanes
    from repro_torch.launch import build_index as bi

    p = bi.DistBuildParams.tiny(l0=16, **BUILD_VARIANTS[variant])
    x = _outlier_points(p.n_tile, 16, seed=1)
    hp = dyadic_hyperplanes(3, p.m_bits, p.dim)
    step = bi.make_tile_step(n_shards, p)
    want, want_st = step(torch.from_numpy(x), hp, reservoir_init(p.n_tile, p.l_max, device="cpu"))
    kernels.reset_launch_counts()
    got, got_st = step(torch.from_numpy(x).to(cuda), hp,
                       reservoir_init(p.n_tile, p.l_max, device=cuda))
    counts = kernels.launch_counts()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert torch.equal(got_st.cpu(), want_st)
    assert counts["pairwise_distance"] > 0 and counts["rowwise_topk"] > 0
    assert (counts["pairwise_distance_int8"] > 0) == (variant == "int8")
    assert (counts["segmented_merge"] > 0) == (variant != "flat")


def test_build_distributed_on_the_card_equals_cpu(cuda):
    """Two tiles (the second with the far-away filler) at S = 8, final
    prune on and off: the card's graph and dists are the CPU's."""
    from repro_torch.data import dyadic_hyperplanes
    from repro_torch.launch import build_index as bi

    p = bi.DistBuildParams.tiny(l0=16)
    x = _round_trip_points(3000, 16, seed=2)
    hp = dyadic_hyperplanes(4, p.m_bits, p.dim)
    for final_prune in (True, False):
        g, d = bi.build_distributed(x, 8, p, final_prune=final_prune, hyperplanes=hp,
                                    device=cuda)
        wg, wd = bi.build_distributed(x, 8, p, final_prune=final_prune, hyperplanes=hp,
                                      device="cpu")
        np.testing.assert_array_equal(g, wg)
        np.testing.assert_array_equal(d, wd)


def test_knn_graph_on_the_card(cuda):
    """The k-NN-graph task on the card with the reference test's own data,
    parameters and gate (``tests/test_system.py::test_knn_graph_task``):
    the build's and the search's kernels launch, and the recall clears
    0.85."""
    from repro_torch import kernels
    from repro_torch.core import knn_graph, pipnn
    from repro_torch.core.leaf import LeafParams
    from repro_torch.core.rbc import RBCParams

    x = np.random.default_rng(11).standard_normal((4000, 24)).astype(np.float32)
    p = pipnn.PiPNNParams(rbc=RBCParams(c_max=256, c_min=32, fanout=(4, 2)),
                          leaf=LeafParams(k=3), l_max=64, max_deg=32, seed=0)
    kernels.reset_launch_counts()
    knn, times = knn_graph.knn_graph_pipnn(x, k=10, beam=48, params=p, device=cuda)
    counts = kernels.launch_counts()
    assert knn.shape == (4000, 10) and times["total"] > 0
    assert counts["leaf_knn"] > 0 and counts["gather_distance"] > 0
    assert knn_graph.knn_graph_recall(x, knn, k=10, sample=400, device=cuda) > 0.85


def test_hcnng_on_the_card_equals_cpu(cuda):
    from repro_torch.core import baselines

    x = np.random.default_rng(5).integers(0, 6, (800, 8)).astype(np.float32)
    kw = dict(c_max=64, replicas=8, max_deg=6, seed=2)
    g, s, _ = baselines.build_hcnng(x, baselines.HCNNGParams(**kw), device=cuda)
    wg, ws, _ = baselines.build_hcnng(x, baselines.HCNNGParams(**kw), device="cpu")
    np.testing.assert_array_equal(g, wg)
    assert s == ws


# ------------------------------------------------------- the memory audit --

def test_memory_audit_is_clean_on_the_card(cuda):
    """Every registered program measured on the card, swept, held to its
    workspace model and priced at the BigANN-1B envelope: no finding."""
    from repro_torch.analysis import memory_audit as ma

    records = {}
    findings = ma.audit_all(device=cuda, records=records)
    assert findings == [], [f.render() for f in findings]
    assert {"stream_step", "merge_segmented", "merge_flat", "final_prune_step",
            "serving_engine", "serving_engine_int8"} <= set(records)


def test_memory_ledger_matches_each_spec_io_on_the_card(cuda):
    """At each base point the card's ledger counts exactly the argument
    bytes the spec's ``io`` computes, and the donated arguments are
    written in place (the segmented fold's kernel, the prune step)."""
    from repro_torch.analysis import memory_audit as ma

    for spec in ma.default_specs():
        ledger = ma.measure(spec, spec.base, cuda)
        io = spec.io(spec.base)
        assert ledger["argument_bytes"] == io["argument"], spec.name
        assert ledger["alias_bytes"] == ledger["donated_bytes"] == io["donated"], spec.name
        assert ledger["output_bytes"] + ledger["alias_bytes"] == io["output"], spec.name
        assert ledger["temp_bytes"] >= 0, spec.name


# ------------------------------------------------ the contract checker --

def test_kernel_resources_hold_their_launch_bounds_on_the_card(cuda):
    """PIPK001 (and PIPK005's instantiation census): ptxas' report of the
    built library against every kernel's launch bounds, at every swept
    shape's launch plan."""
    from repro_torch.kernels import _build

    text = _build.build().with_suffix(".log").read_text()
    limits = contracts.card_limits(cuda)
    for spec in contracts.REGISTRY:
        rec = {}
        findings = contracts.check_resources(spec, text, cuda, limits, rec)
        assert findings == [], [f.render() for f in findings]
        assert rec, spec.name


@pytest.mark.parametrize("name", [s.name for s in contracts.REGISTRY])
def test_kernel_sweep_equals_plain_on_poisoned_and_misaligned_inputs(cuda, name):
    """PIPK002-004: every swept shape at the edges of the wrapper's range,
    misaligned inputs included, equals the plain version at the registry's
    tolerance on poisoned allocator blocks, and launches its kernel."""
    rec = {}
    findings = contracts.sweep_kernel(contracts.spec_by_name(name), cuda, rec)
    assert findings == [], [f.render() for f in findings]
    assert all(r.get("launches", 1) == 1 for r in rec.values())
    spec = contracts.spec_by_name(name)
    if not spec.in_place:
        assert all(r["poisoned_outputs"] >= 1 for r in rec.values() if "refused" not in r)


def test_sync_counts_agree_with_the_card_debug_mode(cuda):
    """PIPJ001 on the card: each program at its declared budget, and the
    spy's count equal to the sync points ``torch.cuda.set_sync_debug_mode``
    sees."""
    from repro_torch.analysis import hotpath_audit

    records = {}
    findings = hotpath_audit.audit_hot_paths(cuda, records=records)
    assert findings == [], [f.render() for f in findings]
    for name, r in records.items():
        assert r["card_syncs"] == r["syncs"] == r["budget"], (name, r)


def _hot_names():
    from repro_torch.analysis import hotpath_audit

    return [p.name for p in hotpath_audit.default_programs()]


@pytest.mark.parametrize("name", _hot_names())
def test_roofline_walk_on_the_card_equals_the_cpu(cuda, name):
    """The roofline's walker on the card: a hot-path program's operations
    by class, bytes and wire bytes equal its walk on the CPU on the same
    inputs, and every launch of the walk is charged its work model."""
    from repro_torch import kernels
    from repro_torch.analysis import hotpath_audit

    prog = {p.name: p for p in hotpath_audit.default_programs()}[name]
    kernels.reset_launch_counts()
    card = hotpath_audit.program_roofline(prog, cuda)
    assert card.kernel_launches == {k: v for k, v in kernels.launch_counts().items() if v}
    cpu = hotpath_audit.program_roofline(prog, "cpu")
    for key in ("dispatched_ops", "dispatched_bytes", "dispatched_coll_bytes", "work_ops",
                "work_bytes", "coll_bytes", "kernel_launches"):
        assert getattr(card, key) == getattr(cpu, key), key


def test_roofline_of_every_registered_program_on_the_card(cuda):
    """Each memory-audit program at its canonical point and each mesh
    program at S = 8, walked on the card: every launch charged, a complete
    record, and the dispatched bytes at least the work's."""
    from repro_torch import kernels
    from repro_torch.analysis import memory_audit, mesh_audit
    from repro_torch.roofline.analysis import RECORD_KEYS, record

    runs = [lambda s=s: memory_audit.roofline_of(s, device=cuda)
            for s in memory_audit.default_specs()]
    runs += [lambda s=s: mesh_audit.program_roofline(s, cuda)
             for s in mesh_audit.default_specs() if s.program is not None]
    for run in runs:
        kernels.reset_launch_counts()
        r = run()
        assert r.kernel_launches == {k: v for k, v in kernels.launch_counts().items() if v}
        assert all(record(r).get(k) is not None for k in RECORD_KEYS), r.name
        assert r.dispatched_bytes >= r.work_bytes > 0, r.name


# ------------------------------------------------------------- LM serving ---

@pytest.mark.parametrize("arch_id", ["llama3-405b", "internlm2-20b", "qwen2-7b", "qwen3-14b",
                                     "granite-moe-1b-a400m", "grok-1-314b", "qwen2-vl-7b",
                                     "whisper-tiny", "mamba2-130m", "zamba2-2.7b"])
def test_smoke_model_card_logits_equal_cpu(cuda, arch_id):
    """Each smoke model, its weights made on the CPU and copied to the
    card: prefill and three decode steps (fed the CPU's greedy tokens) give
    the CPU's logits within 1e-4 and 2e-3 (float32, TF32 off; the decode
    steps read the bfloat16 KV cache, as in ``tests/test_torch_models.py``;
    the ssm family's float32 state within 1e-4; whisper's frames widened to
    float32, as chip_smoke phase 14d(a)), and ``Server.generate`` the CPU's
    greedy tokens (not whisper's: its ``Server`` encodes bfloat16 frames,
    whose products the card and the CPU round apart)."""
    from repro_torch.device import resolve_device
    from repro_torch.launch.serve import Server
    from repro_torch.models import layers

    resolve_device(cuda)
    host = Server(arch_id, max_len=24, seed=4, device="cpu")
    card = Server(arch_id, max_len=24, seed=4, device=cuda)
    card.params = layers.tree_map(lambda t: t.to(cuda), host.params)
    prompts = np.random.default_rng(4).integers(0, host.vocab, (3, 12)).astype(np.int32)
    caches = {}
    for name, server in (("cpu", host), ("card", card)):
        batch = server.make_batch(prompts)
        if "frames" in batch:
            batch["frames"] = batch["frames"].float()
        caches[name] = server.model.prefill(server.params, batch, server.max_len)
    steps = []
    for _ in range(4):
        (lh, ch), (lc, cc) = caches["cpu"], caches["card"]
        steps.append(float((lc.cpu() - lh).abs().max()))
        tok = torch.argmax(lh, -1)[:, None]
        caches = {"cpu": host.model.decode_step(host.params, tok, ch),
                  "card": card.model.decode_step(card.params, tok.to(cuda), cc)}
    decode_tol = 1e-4 if host.model.family == "ssm" else 2e-3
    assert steps[0] <= 1e-4 and max(steps[1:]) <= decode_tol, steps
    if host.model.family != "encdec":
        np.testing.assert_array_equal(card.generate(prompts, 8)[0], host.generate(prompts, 8)[0])


def test_whisper_bfloat16_frames_card_logits_near_cpu(cuda):
    """whisper-tiny's smoke model on the ``Server``'s bfloat16 frames (the
    encoder in bfloat16, as served), its weights made on the CPU and copied
    to the card: prefill and three decode steps fed the CPU's greedy
    tokens give the CPU's logits within 0.1 of their RMS, as chip_smoke
    holds the bfloat16 paths on the card (``LM_BF16_CARD_TOL``)."""
    from repro_torch.device import resolve_device
    from repro_torch.launch.serve import Server
    from repro_torch.models import layers

    resolve_device(cuda)
    host = Server("whisper-tiny", max_len=24, seed=4, device="cpu")
    card = Server("whisper-tiny", max_len=24, seed=4, device=cuda)
    card.params = layers.tree_map(lambda t: t.to(cuda), host.params)
    prompts = np.random.default_rng(4).integers(0, host.vocab, (3, 12)).astype(np.int32)
    caches = {name: server.model.prefill(server.params, server.make_batch(prompts),
                                         server.max_len)
              for name, server in (("cpu", host), ("card", card))}
    assert caches["card"][1].cross_k.dtype == torch.bfloat16
    want, got = [], []
    for _ in range(4):
        (lh, ch), (lc, cc) = caches["cpu"], caches["card"]
        want.append(lh)
        got.append(lc.cpu())
        tok = torch.argmax(lh, -1)[:, None]
        caches = {"cpu": host.model.decode_step(host.params, tok, ch),
                  "card": card.model.decode_step(card.params, tok.to(cuda), cc)}
    want, got = torch.stack(want), torch.stack(got)
    rms = float(want.pow(2).mean().sqrt())
    assert float((got - want).abs().max()) <= 0.1 * rms


# ------------------------------------------------------------ LM training ---

@pytest.mark.parametrize("arch_id", ["qwen2-7b", "granite-moe-1b-a400m", "qwen2-vl-7b",
                                     "mamba2-130m", "zamba2-2.7b", "whisper-tiny"])
def test_smoke_model_train_step_card_equals_cpu(cuda, arch_id):
    """One train step of each family's smoke model (two microbatches of
    the CLI's batch; whisper's frames widened to float32; the MoE dropless,
    at capacity factor E / k; float32, TF32 off), the state made on the CPU
    and copied to the card: the loss within
    1e-5 relative, the gradient norm within 1e-4, and the parameters after
    the step within 1e-3 of the step's rate where the CPU's gradient is far
    from 0, as chip_smoke phase 15(a) holds the full-width models."""
    from repro_torch.data import TokenPipeline, TokenPipelineConfig
    from repro_torch.device import resolve_device
    from repro_torch.configs import registry
    from repro_torch.launch import steps, train
    from repro_torch.models import model_zoo
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves, tree_map

    resolve_device(cuda)
    arch = registry.get_config(arch_id)
    cfg = arch.smoke_model
    if getattr(cfg, "moe", None) is not None:      # dropless, as the CPU tests hold it
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    model = model_zoo.build(cfg, arch.family)
    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=10)
    host = steps.init_train_state(model, opt, torch.Generator().manual_seed(4), "cpu")
    card = tree_map(lambda t: t.to(cuda), host)
    pipe = TokenPipeline(TokenPipelineConfig(vocab=model.config.vocab, seq_len=32,
                                             global_batch=4, seed=4))
    step = steps.make_train_step(model, opt, 2)
    batches = {}
    for name, dev in (("cpu", "cpu"), ("card", cuda)):
        batches[name] = train.make_batch_fn(model, arch.family, pipe, 32, dev)(0)
        if "frames" in batches[name]:
            batches[name]["frames"] = batches[name]["frames"].float()
    grads = tree_leaves(adamw.value_and_grad(model.loss_fn, host.params, batches["cpu"])[1])
    metrics = {name: {k: float(v) for k, v in step(state, batches[name])[1].items()}
               for name, state in (("cpu", host), ("card", card))}
    for key, tol in (("loss", 1e-5), ("grad_norm", 1e-4)):
        assert abs(metrics["card"][key] - metrics["cpu"][key]) <= tol * abs(metrics["cpu"][key])
    lr = metrics["cpu"]["lr"]
    total = float(torch.cat([g.flatten() for g in grads]).pow(2).mean().sqrt())
    for g, a, b in zip(grads, tree_leaves(host.params), tree_leaves(card.params)):
        rms = float(g.pow(2).mean().sqrt())
        if rms < 1e-6 * total:       # zero in exact arithmetic (whisper's key biases)
            continue
        sure = g.abs() > 0.1 * rms
        diff = (b.cpu()[sure] - a[sure]).abs()
        assert diff.numel() == 0 or float(diff.max()) <= 1e-3 * lr


@pytest.mark.parametrize("arch_id", ["llama3-405b", "qwen2-7b", "granite-moe-1b-a400m"])
def test_smoke_model_mesh_train_step_card_equals_cpu(cuda, arch_id):
    """One mesh train step of each policy's smoke model at ``data 1 x
    model 4`` (two microbatches; the MoE dropless; float32, TF32 off), the
    state made on the CPU and cut onto a CPU mesh and a card mesh: the loss
    within 1e-5 relative, the gradient norm within 1e-4, and the gathered
    parameters after the step within 1e-3 of the step's rate where the
    CPU's gradient is far from 0, as chip_smoke phase 17 holds the
    full-width models."""
    from repro_torch.configs import registry
    from repro_torch.data import TokenPipeline, TokenPipelineConfig
    from repro_torch.device import resolve_device
    from repro_torch.distributed import sharding
    from repro_torch.launch import steps, train
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.models import model_zoo
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves, tree_map

    resolve_device(cuda)
    arch = registry.get_config(arch_id)
    cfg = arch.smoke_model
    if getattr(cfg, "moe", None) is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    one = model_zoo.build(cfg, arch.family)
    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=10)
    host = steps.init_train_state(one, opt, torch.Generator().manual_seed(4), "cpu")
    pipe = TokenPipeline(TokenPipelineConfig(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=4))
    grads = tree_leaves(adamw.accumulate_grads(
        one.loss_fn, host.params, train.make_batch_fn(one, arch.family, pipe, 32, "cpu")(0), 2)[1])
    out = {}
    for name, dev in (("cpu", torch.device("cpu")), ("card", cuda)):
        mesh = make_lm_mesh(4, device=dev)
        model = model_zoo.build(cfg, arch.family, mesh=mesh, policy=arch.parallelism)
        state = steps.shard_train_state(tree_map(lambda t: t.to(dev, copy=True), host), mesh,
                                        arch.family, arch.parallelism)
        step = steps.make_train_step(model, opt, 2, mesh=mesh, policy=arch.parallelism)
        state, met = step(state, train.make_batch_fn(one, arch.family, pipe, 32, dev)(0))
        out[name] = ({k: float(v) for k, v in met.items()},
                     [t.cpu() for t in tree_leaves(sharding.unshard_params(state.params))])
    (cpu_met, cpu_p), (card_met, card_p) = out["cpu"], out["card"]
    for key, tol in (("loss", 1e-5), ("grad_norm", 1e-4)):
        assert abs(card_met[key] - cpu_met[key]) <= tol * abs(cpu_met[key])
    lr = cpu_met["lr"]
    total = float(torch.cat([g.flatten() for g in grads]).pow(2).mean().sqrt())
    for g, a, b in zip(grads, cpu_p, card_p):
        rms = float(g.pow(2).mean().sqrt())
        if rms < 1e-6 * total:
            continue
        sure = g.abs() > 0.1 * rms
        diff = (b[sure] - a[sure]).abs()
        assert diff.numel() == 0 or float(diff.max()) <= 1e-3 * lr
