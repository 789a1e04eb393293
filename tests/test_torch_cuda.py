"""The port's CUDA kernels on the card: each against its plain PyTorch
version, the launch counters, and the main path through every kernel.

Every test here needs an NVIDIA card (a CUDA kernel has no CPU mode) and
skips without one.  This file imports neither JAX nor ``repro``, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.hashprune import hashprune_flat
from repro_torch.core.metrics import point_norms
from repro_torch.kernels import edge_hash, gather_distance, leaf_knn, segmented_merge

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


@pytest.mark.parametrize("k", (1, 2, 8))
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


def test_edge_hashes_kernel_matches_plain(cuda):
    rng = np.random.default_rng(9)
    sk = torch.randn(1000, 12, device=cuda)
    src = torch.from_numpy(rng.integers(-1, 1000, 100_000).astype(np.int32)).to(cuda)
    dst = torch.from_numpy(rng.integers(-1, 1000, 100_000).astype(np.int32)).to(cuda)
    assert torch.equal(edge_hash.edge_hashes(sk, src, dst),
                       edge_hash.edge_hashes_plain(sk, src, dst))


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


def test_kernel_launch_counters_count_launches(cuda):
    from repro_torch import kernels

    kernels.reset_launch_counts()
    x = torch.randint(0, 256, (300, 16), device=cuda).float()
    ids = torch.arange(256, device=cuda, dtype=torch.int32).reshape(2, 128)
    leaf_knn.leaf_topk(x, ids, 2)
    leaf_knn.leaf_topk_plain(x, ids, 2)
    assert kernels.launch_counts() == {"leaf_knn": 1, "edge_hash": 0,
                                       "segmented_merge": 0, "gather_distance": 0}


def test_main_path_launches_every_kernel(cuda):
    import repro_torch
    from repro_torch import kernels
    from repro_torch.data import VectorPipelineConfig, make_vectors, sift_like

    x = sift_like(make_vectors(VectorPipelineConfig(n=20_000, dim=128, n_clusters=64)))
    kernels.reset_launch_counts()
    index = repro_torch.build(x)
    repro_torch.search(index, x, x[:100], k=10, beam=32)
    assert all(v > 0 for v in kernels.launch_counts().values()), kernels.launch_counts()
    cpu = repro_torch.build(x, device="cpu")
    assert torch.equal(index.graph.cpu(), cpu.graph) and index.start == cpu.start
