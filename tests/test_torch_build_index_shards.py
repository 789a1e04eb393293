"""The distributed build at S = 4 and 8 shards on one device against the
reference on an 8-device CPU mesh (``_torch_build_reference``, one
subprocess a session): graphs, dists, the tile step's reservoir and stats
are equal exactly, for each variant, over one tile and over two with the
filler; and the exchange functions are the collectives they stand for."""
import numpy as np
import pytest
import torch

from repro_torch.core.hashprune import reservoir_init
from repro_torch.launch import build_index as bi
from _torch_build_reference import CASES, N, build_inputs, reference_dir

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return np.load(reference_dir(tmp_path_factory) / "reference.npz")


@pytest.fixture(scope="module")
def inputs():
    return build_inputs()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_build_distributed_equals_reference(ref, inputs, case):
    tag, s, n, kw, final_prune = case
    p = bi.DistBuildParams.tiny(l0=16, **kw)
    graph, dists = bi.build_distributed(inputs["x"][:n], s, p, seed=0, final_prune=final_prune,
                                        hyperplanes=inputs["hp"], device=CPU)
    np.testing.assert_array_equal(graph, ref[f"{tag}_graph"])
    np.testing.assert_array_equal(dists, ref[f"{tag}_dists"])
    assert (graph >= 0).any(axis=1).mean() > 0.999, "isolated points"


@pytest.mark.parametrize("case", [c for c in CASES if c[2] == N], ids=lambda c: c[0])
def test_tile_step_equals_reference(ref, inputs, case):
    tag, s, n, kw, _ = case
    p = bi.DistBuildParams.tiny(l0=16, **kw)
    res, stats = bi.make_tile_step(s, p)(torch.from_numpy(inputs["x"][:n]), inputs["hp"],
                                         reservoir_init(p.n_tile, p.l_max, device="cpu"))
    for name, got in zip(("ids", "hashes", "dists"), res):
        np.testing.assert_array_equal(got.numpy(), ref[f"{tag}_res_{name}"])
    np.testing.assert_array_equal(stats.numpy(), ref[f"{tag}_stats"])
    assert stats[2] == 0


def test_exchanges_are_the_collectives():
    """``all_to_all`` transposes the shard grid (receiver d's row s is
    sender s's row d), ``all_gather`` concatenates in shard order and
    ``psum`` sums."""
    s, cap = 4, 3
    sends = [torch.arange(s * cap * 2).reshape(s, cap, 2) + 100 * src for src in range(s)]
    recv = bi.all_to_all(sends)
    for dst in range(s):
        assert recv[dst].shape == (s, cap, 2)
        for src in range(s):
            assert torch.equal(recv[dst][src], sends[src][dst])
    assert torch.equal(bi.all_gather([torch.full((2,), i) for i in range(s)]),
                       torch.tensor([0, 0, 1, 1, 2, 2, 3, 3]))
    parts = [torch.tensor([i, 2 * i], dtype=torch.int32) for i in range(s)]
    total = bi.psum(parts)
    assert total.dtype == torch.int32 and total.tolist() == [6, 12]


def test_every_replica_arrives_at_each_shard_count(inputs):
    """S = 1, 2 and 8 on the same tile (the same level-0 leaders, as the
    leader stride is n_tile / l0 at every S): every point's f0 replicas
    arrive and nothing is dropped."""
    p = bi.DistBuildParams.tiny(l0=16)
    for s in (1, 2, 8):
        _, st = bi.make_tile_step(s, p)(torch.from_numpy(inputs["x"][:N]), inputs["hp"],
                                        reservoir_init(p.n_tile, p.l_max, device="cpu"))
        assert st[1] == N * p.f0 and st[2] == 0
