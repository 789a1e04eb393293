"""The split arithmetic of the leaf top-k kernel, emulated on the CPU.

``csrc/leaf_knn.cu`` forms each leaf's inner products on the tensor cores
from TF32 operands: every float32 ``x`` is split into ``hi = tf32(x)``
(``cvt.rna.tf32.f32``: round to nearest, ties away from zero, keeping 10
explicit mantissa bits) and ``lo = x - hi``, exact in float32, of which the
MMA reads the top 19 bits, and ``hi*hi + hi*lo + lo*hi`` is summed in
float32.  This file emulates that split with bit operations and holds the
result against the plain version:

- on integer data in [0, 255] (``hi = x``, ``lo = 0``) it must be exact;
- on the seeded Gaussian mixture it must stay within the tolerance that
  ``chip_smoke.py`` holds the kernel to, ``1e-5 |d| + 32 eps max|x|^2``.
"""
import numpy as np
import pytest
import torch

from repro_torch.data import VectorPipelineConfig, make_vectors, sift_like
from repro_torch.kernels import leaf_knn
from repro_torch.kernels.topk import topf


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: under six test workers the default (one a core)
    oversubscribes the cores on these small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


EPS32 = 2.0 ** -23


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: keep the top 19 bits, rounding the magnitude to
    nearest with ties away from zero (adding half of the dropped range to
    the bit pattern rounds the magnitude whatever the sign)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """The top 19 bits of a float32, as the MMA reads a TF32 operand."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_truncate(x - hi)


def split_ip(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., n, m] inner products as the kernel forms them: the three
    products of TF32 parts (each exact in float32), summed in float32."""
    ah, al = split(a)
    bh, bl = split(b)
    prod = (ah[..., :, None, :] * bl[..., None, :, :]
            + al[..., :, None, :] * bh[..., None, :, :]
            + ah[..., :, None, :] * bh[..., None, :, :])
    return prod.sum(dim=-1)


def leaf_topk_split(points, leaf_ids, k, metric="l2"):
    """``leaf_topk_plain`` with the kernel's split products in place of the
    float32 ones (norms in float32, as the kernel forms them)."""
    nb, c = leaf_ids.shape
    valid = leaf_ids >= 0
    pts = points[leaf_ids.clamp_min(0).long()]
    ip = split_ip(pts, pts)
    sq = torch.sum(pts * pts, dim=-1)
    if metric == "mips":
        d = -ip
    elif metric == "cosine":
        nrm = torch.sqrt(sq)
        d = 1.0 - ip / torch.clamp_min(nrm[:, :, None] * nrm[:, None, :], 1e-30)
    else:
        d = sq[:, :, None] + sq[:, None, :] - 2.0 * ip
        d = torch.where(d > 0, d, torch.zeros(()))
    mask = valid[:, None, :] & valid[:, :, None] & ~torch.eye(c, dtype=torch.bool)
    d = torch.where(mask, d, torch.full((), float("inf")))
    idx = topf(d, k)
    nd = torch.gather(d, 2, idx.long())
    ok = torch.isfinite(nd)
    return torch.where(ok, idx, -1), torch.where(ok, nd, torch.full((), float("inf")))


def _leaves(rng, n, sizes, c):
    ids = np.full((len(sizes), c), -1, np.int32)
    for i, s in enumerate(sizes):
        ids[i, :s] = rng.choice(n, s, replace=False)
    return torch.from_numpy(ids)


def test_tf32_rounding_rule():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12, 255.0, 1.0 + 2.0 ** -10], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9, -(1.0 + 2.0 ** -10),
                         1.0, 255.0, 1.0 + 2.0 ** -10], dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    hi, lo = split(x)
    assert bool((hi.view(torch.int32) & 0x1FFF == 0).all())
    assert bool((lo.view(torch.int32) & 0x1FFF == 0).all())
    # hi carries 11 significant bits and lo the next 11: x is kept to 2^-21
    assert bool(((hi + lo - x).abs() <= 2.0 ** -21 * x.abs()).all())


@pytest.mark.parametrize("metric", ("l2", "mips", "cosine"))
def test_split_products_exact_on_integer_data(metric):
    rng = np.random.default_rng(20)
    x = torch.from_numpy(rng.integers(0, 256, (600, 128)).astype(np.float32))
    x[10:14] = x[9]                             # tied distances
    ids = _leaves(rng, 600, (1, 2, 17, 64, 100), 100)
    ids[4, :6] = torch.arange(8, 14, dtype=torch.int32)
    hi, lo = split(x)
    assert torch.equal(hi, x) and not bool(lo.any())
    got = leaf_topk_split(x, ids, 4, metric)
    want = leaf_knn.leaf_topk_plain(x, ids, 4, metric)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("metric", ("l2", "mips", "cosine"))
def test_split_products_within_tolerance_on_gaussian_mixture(metric):
    x = torch.from_numpy(make_vectors(VectorPipelineConfig(n=3000, dim=128, n_clusters=64,
                                                           seed=3)))
    rng = np.random.default_rng(21)
    ids = _leaves(rng, 3000, (2, 15, 33, 64, 129), 129)
    got_i, got_d = leaf_topk_split(x, ids, 2, metric)
    want_i, want_d = leaf_knn.leaf_topk_plain(x, ids, 2, metric)
    fin = torch.isfinite(want_d)
    assert torch.equal(torch.isfinite(got_d), fin)
    max_sq = float((x * x).sum(dim=1).max())
    slack = 1e-5 if metric == "cosine" else 32 * EPS32 * max_sq
    err = (got_d[fin] - want_d[fin]).abs()
    assert bool((err <= 1e-5 * want_d[fin].abs() + slack).all()), float(err.max())
    assert float((got_i == want_i).float().mean()) > 0.99


def test_split_products_sift_like_values_are_their_own_split():
    x = torch.from_numpy(sift_like(make_vectors(VectorPipelineConfig(n=500, dim=128))))
    hi, lo = split(x)
    assert torch.equal(hi, x) and not bool(lo.any())
    ip = split_ip(x[:50], x[50:100])
    assert torch.equal(ip, (x[:50].double() @ x[50:100].double().T).float())
