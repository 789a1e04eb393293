"""The port's sharded serving (``repro_torch.distributed.serving``) against
the JAX package on the CPU: the cross-shard top-k, the halo packing and the
sharded search at S = 1 in this process and at S = 4 and 8 through one
subprocess of the reference (``_torch_shard_reference``), then the port's
own contracts (health, routing, transfers, the entry points).

Tolerance: exact everywhere.  The data are integers in [0, 255] of width
16, so every float32 sum is exact in any order; the packings, ids and
telemetry are held bit for bit.  On Gaussian data, where sums round, the
halo's dedup contract is held instead: a ghost row's distance is the same
in every shard that holds it, and no merged row repeats an id."""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from _torch_shard_reference import BEAM, K, SHARDS, reference_dir, shard_inputs
from repro.core.serving import ServingIndex as JServingIndex
from repro.distributed.serving import cross_shard_topk as j_cross_shard_topk
from repro_torch.core import pipnn, transfers
from repro_torch.core.serving import ServingIndex
from repro_torch.core.validation import InvalidQueryError
from repro_torch.distributed.serving import (AllShardsDown, ShardedServingIndex,
                                             cross_shard_topk)

CPU = "cpu"
DTYPES = {"f32": None, "int8": "int8", "bf16": torch.bfloat16}
J_DTYPES = {"f32": None, "int8": "int8", "bf16": jnp.bfloat16}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """These tests run many operations on tiny tensors: torch's intra-op
    threads would only contend with the other test workers' (and the
    reference subprocess's), so this module runs them on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return shard_inputs()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = reference_dir(tmp_path_factory)
    return {s: dict(np.load(out / f"shards{s}.npz")) for s in SHARDS}


def _pack(data, s, dtype=None, **kw):
    return ShardedServingIndex.from_graph(data["graph"], data["x"], int(data["start"]),
                                          n_shards=s, dtype=dtype, device=CPU, **kw)


def _packing(sv) -> dict:
    out = {name: getattr(sv, name).numpy() for name in ("gids", "graph", "norms", "starts",
                                                       "leaders")}
    out["owned"] = np.asarray(sv.owned)
    pts = sv.points
    out["points"] = (pts.view(torch.int16).numpy().view(np.uint16)
                     if pts.dtype == torch.bfloat16 else pts.numpy())
    if sv.scales is not None:
        out["scales"] = sv.scales.numpy()
    return out


def _searched(sv, q, **kw) -> dict:
    ids, st = sv.search(q, k=K, beam=BEAM, with_stats=True, **kw)
    out = {"ids": ids, "n_probes": st.get("n_probes", -1), "healthy": st["healthy_shards"]}
    out.update({key: st[key] for key in ("hops", "dist_comps", "converged")})
    return out


# ------------------------------------------------------- cross-shard top-k ---

def _blocks(rng, s, nq, b, n_ids, *, tie_prob=0.0, drop_prob=0.2):
    """Disjoint per-shard id pools with -1 pads, optionally with equal
    distances inside a query (tie-breaks on the id)."""
    ids = np.full((s, nq, b), -1, np.int64)
    ds = np.full((s, nq, b), np.inf, np.float32)
    pool = rng.permutation(n_ids)
    bounds = np.linspace(0, n_ids, s + 1).astype(int)
    for si in range(s):
        shard_pool = pool[bounds[si]: bounds[si + 1]]
        for qi in range(nq):
            take = min(b, len(shard_pool))
            chosen = rng.choice(shard_pool, size=take, replace=False)
            dd = rng.standard_normal(take).astype(np.float32)
            if tie_prob and take > 1:
                dd[rng.random(take) < tie_prob] = dd[0]
            keep = rng.random(take) >= drop_prob
            ids[si, qi, :take][keep] = chosen[keep]
            ds[si, qi, :take][keep] = dd[keep]
    return ids, ds


def _topk_case(case):
    rng = np.random.default_rng(zlib.crc32(str(case).encode()))
    if case == "tied":
        return np.array([[[7, 3]], [[5, 1]]]), np.zeros((2, 1, 2), np.float32), 4
    if case == "union_short":
        return (np.array([[[4, -1]], [[9, -1]]]),
                np.array([[[0.5, np.inf]], [[0.25, np.inf]]], np.float32), 5)
    if case == "halo_duplicate":
        return (np.array([[[2, 8]], [[2, 5]]]),
                np.array([[[0.125, 0.5]], [[0.125, 0.25]]], np.float32), 4)
    if case == "k_above_b":
        return _blocks(rng, 4, 3, 4, 64, drop_prob=0.0) + (12,)
    if case == "ties_random":
        return _blocks(rng, 5, 4, 6, 30, tie_prob=0.5, drop_prob=0.35) + (9,)
    s, nq, b, k = case
    return _blocks(rng, s, nq, b, s * b * 2) + (k,)


@pytest.mark.parametrize("case", [(2, 3, 4, 4), (4, 5, 8, 6), (8, 2, 4, 16), (3, 4, 6, 1),
                                  "tied", "union_short", "halo_duplicate", "k_above_b",
                                  "ties_random"], ids=str)
def test_cross_shard_topk_equals_reference(case):
    ids, ds, k = _topk_case(case)
    want_i, want_d = j_cross_shard_topk(jnp.asarray(ids), jnp.asarray(ds), k=k)
    got_i, got_d = cross_shard_topk(torch.from_numpy(ids), torch.from_numpy(ds), k=k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))


# ------------------------------------------------------------- S = 1 in process --

@pytest.mark.parametrize("tag", ("f32", "int8", "bf16"))
def test_one_shard_packing_and_search_equal_reference(data, tag):
    """S = 1: the packing, the search ids, the telemetry and the stats keys
    equal the reference's one-device mesh, and the ids equal the
    single-device ``ServingIndex``'s."""
    mesh = Mesh(np.array(jax.devices()[:1]), ("shards",))
    want = JServingIndex.from_graph(data["graph"], data["x"], int(data["start"]), mesh=mesh,
                                    dtype=J_DTYPES[tag])
    got = ServingIndex.from_graph(data["graph"], data["x"], int(data["start"]), n_shards=1,
                                  dtype=DTYPES[tag], device=CPU)
    assert isinstance(got, ShardedServingIndex)
    gp = _packing(got)
    for name, arr in gp.items():
        w = np.asarray(getattr(want, name))
        np.testing.assert_array_equal(arr, w.view(np.uint16) if w.dtype == jnp.bfloat16
                                      else w, err_msg=name)
    q = data["q"]
    wi, ws = want.search(q, k=K, beam=BEAM, with_stats=True)
    gi, gs = got.search(q, k=K, beam=BEAM, with_stats=True)
    np.testing.assert_array_equal(gi, np.asarray(wi))
    for key in ("hops", "dist_comps", "converged"):
        np.testing.assert_array_equal(gs[key], ws[key], err_msg=key)
    assert {k: v for k, v in gs.items() if np.isscalar(v) or isinstance(v, str)} == \
        {k: v for k, v in ws.items() if np.isscalar(v) or isinstance(v, str)}
    single = ServingIndex.from_graph(data["graph"], data["x"], int(data["start"]),
                                     dtype=DTYPES[tag], device=CPU)
    np.testing.assert_array_equal(gi, single.search(q, k=K, beam=BEAM))


# ------------------------------------------- S = 4 and 8, through the subprocess --

PACKINGS = (("f32", {}), ("int8", {"dtype": "int8"}), ("bf16", {"dtype": torch.bfloat16}),
            ("nohalo", {"halo": False}))


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("tag,kw", PACKINGS, ids=[t for t, _ in PACKINGS])
def test_sharded_packing_equals_reference(data, reference, s, tag, kw):
    """Leaders, assignment, owned rows then halo ghosts, local renumbering,
    norms, int8 points and scales (pads 1.0), bfloat16 bits, entry points."""
    ref = reference[s]
    sv = _pack(data, s, **kw)
    for name, arr in _packing(sv).items():
        np.testing.assert_array_equal(arr, ref[f"{tag}_{name}"], err_msg=name)
    assert sv.halo_stats()["halo_fraction"] == float(ref[f"{tag}_halo_fraction"])


def _search_case(data, s, case) -> dict:
    q = data["q"]
    if case in ("all", "chunk", "iters1", "down"):
        sv = _pack(data, s)
        if case == "chunk":
            return _searched(sv, q[:13], query_chunk=5)
        if case == "iters1":
            return _searched(sv, q[:5], iters=1)
        if case == "down":
            sv.mark_shard_down(1)
        return _searched(sv, q)
    if case.startswith("leaders"):
        sv = _pack(data, s, router="leaders", n_probes=int(case[7]))
        if case.endswith("_down"):
            sv.mark_shard_down(0)
        return _searched(sv, q)
    return _searched(_pack(data, s, dtype=DTYPES[case]), q)


SEARCHES = ("all", "chunk", "iters1", "down", "leaders1", "leaders2", "leaders2_down",
            "int8", "bf16")


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("case", SEARCHES)
def test_sharded_search_equals_reference(data, reference, s, case):
    """Ids, hops, dist_comps and converged of both routers (n_probes 1 and
    2), a tombstoned shard under each, ``query_chunk`` padding, the iters
    backstop, and the int8 and bfloat16 packings."""
    ref = reference[s]
    got = _search_case(data, s, case)
    for key, val in got.items():
        np.testing.assert_array_equal(np.asarray(val), ref[f"{case}_{key}"], err_msg=key)


@pytest.mark.parametrize("s", SHARDS)
def test_all_shards_down_raises_as_reference(data, reference, s):
    sv = _pack(data, s)
    for i in range(s):
        sv.mark_shard_down(i)
    with pytest.raises(AllShardsDown):
        sv.search(data["q"][:2], k=K)
    assert bool(reference[s]["all_down_raised"])


# -------------------------------------------------------- the port's contracts --

def test_halo_stats_accounting(data):
    sv = _pack(data, 4)
    hs = sv.halo_stats()
    assert int(hs["members"].sum()) == data["x"].shape[0]
    assert int(hs["ghosts"].sum()) > 0
    np.testing.assert_array_equal(hs["members"] + hs["ghosts"] + hs["pads"],
                                  np.full(4, sv.shard_capacity))
    bd = sv.device_bytes(breakdown=True)
    rows = bd["member_bytes"] + bd["ghost_bytes"] + bd["pad_bytes"]
    assert 0 < rows <= bd["total"] == sv.device_bytes()
    assert sv.device_bytes(per_shard=True) == sv.device_bytes() // 4
    _, stats = sv.search(data["x"][:4], k=5, with_stats=True)
    assert stats["halo_fraction"] == hs["halo_fraction"] > 0.0


def test_bad_arguments_raise(data):
    g, x, st = data["graph"], data["x"], int(data["start"])
    with pytest.raises(ValueError, match="router"):
        _pack(data, 2, router="rr")
    for p in (0, -3):
        with pytest.raises(ValueError, match="n_probes"):
            _pack(data, 2, router="leaders", n_probes=p)
    with pytest.raises(ValueError, match="cannot shard"):
        ShardedServingIndex.from_graph(g[:3], x[:3], 0, n_shards=4, device=CPU)
    with pytest.raises(ValueError, match="n_shards"):
        ShardedServingIndex.from_graph(g, x, st, n_shards=0, device=CPU)
    with pytest.raises(TypeError):          # shard-only option, no n_shards
        ServingIndex.from_graph(g, x, st, router="all", device=CPU)
    sv = _pack(data, 2)
    with pytest.raises(ValueError, match="k must be >= 1"):
        sv.search(x[:2], k=0)
    with pytest.raises(ValueError, match="beam must be >= 1"):
        sv.search(x[:2], k=5, beam=-2)
    with pytest.raises(ValueError, match="query_chunk"):
        sv.search(x[:2], k=5, query_chunk=0)
    with pytest.raises(ValueError, match="kernel_path"):
        sv.search(x[:2], k=5, kernel_path="tpu")
    q = np.array(x[:3])
    q[2, 1] = np.inf
    with pytest.raises(InvalidQueryError) as ei:
        sv.search(q, k=5)
    assert ei.value.reason == "nan_inf" and ei.value.rows == (2,)
    out = sv.search(np.zeros((0, x.shape[1]), np.float32), k=7)
    assert out.shape == (0, 7) and out.dtype == np.int64


def test_transfer_budget(data):
    """The crossings a search declares through ``core.transfers``: one h2d
    and one d2h a chunk, three more d2h with stats, one more h2d after a
    health change (the mask, then cached).  Declared crossings only: torch
    has no transfer guard, so this is no bound on host traffic."""
    sv = _pack(data, 4)
    q = data["q"][:9]
    with transfers.ledger() as counts:
        sv.search(q, k=5, beam=16)
    assert counts == ShardedServingIndex.TRANSFER_BUDGET
    with transfers.ledger() as counts:
        sv.search(q, k=5, beam=16, query_chunk=4)
    assert counts == {"h2d": 3, "d2h": 3}
    with transfers.ledger() as counts:
        sv.search(q, k=5, beam=16, with_stats=True)
    assert counts == {"h2d": 1, "d2h": 4}
    sv.mark_shard_down(2)
    for want in ({"h2d": 2, "d2h": 1}, {"h2d": 1, "d2h": 1}):
        with transfers.ledger() as counts:
            sv.search(q, k=5, beam=16)
        assert counts == want


def test_probe_shard_readmits_and_keeps_tombstone_on_failure(data):
    sv = _pack(data, 2)
    sv.mark_shard_down(0)
    assert sv.down_shards == (0,) and sv.healthy_shards == 1
    assert not sv.probe_shard(0, probe=lambda s: False)
    calls = []

    def raising(s):
        calls.append(s)
        raise RuntimeError("still dead")

    assert not sv.probe_shard(0, probe=raising)
    assert calls == [0] and sv.down_shards == (0,)
    assert sv.probe_shard(0)                       # the default probe searches
    assert not sv.down_shards
    for i in range(2):
        sv.mark_shard_down(i)
    with pytest.raises(AllShardsDown):
        sv.search(data["q"][:2], k=5)


def test_default_probe_goes_through_the_instance_search(data):
    """``probe_shard``'s default probe calls ``self.search`` as it is at call
    time, so a search patched on the instance decides re-admission."""
    sv = _pack(data, 2)
    sv.mark_shard_down(1)
    seen = []

    def patched(queries, **kw):
        seen.append(kw)
        raise RuntimeError("patched")

    object.__setattr__(sv, "search", patched)
    try:
        assert not sv.probe_shard(1)
    finally:
        object.__delattr__(sv, "search")
    assert seen == [{"k": 1, "beam": 4}] and sv.down_shards == (1,)
    assert sv.probe_shard(1)


def test_pipnn_search_n_shards_end_to_end(data):
    from repro_torch.convert import index_from_arrays

    idx = index_from_arrays(data["graph"], np.zeros(data["graph"].shape, np.float32),
                            int(data["start"]), device=CPU)
    x, q = data["x"], data["q"][:16]
    ids, stats = pipnn.search(idx, x, q, k=5, n_shards=4, with_stats=True, device=CPU)
    assert stats["n_shards"] == 4 and isinstance(idx._serving, ShardedServingIndex)
    sv4 = idx._serving
    pipnn.search(idx, x, q, k=5, n_shards=4, device=CPU)
    assert idx._serving is sv4                     # cached per shard count
    np.testing.assert_array_equal(ids, sv4.search(q, k=5))
    pipnn.search(idx, x, q, k=5, device=CPU)
    assert isinstance(idx._serving, ServingIndex)
    with pytest.raises(ValueError, match="n_shards"):
        pipnn.search(idx, x, q, k=5, batch=False, n_shards=4)


@pytest.mark.parametrize("dtype", (None, torch.bfloat16), ids=("f32", "bf16"))
def test_halo_dedup_contract_on_gaussian_data(dtype):
    """On Gaussian data (sums round), every (query, ghost row) pair that
    reaches two shards' beams carries the same distance bits in both, and
    no merged row repeats an id."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1500, 24)).astype(np.float32)
    q = rng.standard_normal((64, 24)).astype(np.float32)
    from repro_torch.core.leaf import LeafParams
    from repro_torch.core.rbc import RBCParams

    idx = pipnn.build(x, pipnn.PiPNNParams(rbc=RBCParams(c_max=128, c_min=16, fanout=(3,)),
                                           leaf=LeafParams(k=2), max_deg=16, seed=1),
                      device=CPU)
    sv = ShardedServingIndex.from_index(idx, x, n_shards=8, dtype=dtype, device=CPU)
    ids_s, ds_s, *_ = sv._shard_search(torch.from_numpy(q), None, beam=32, iters=36,
                                       expansions=4, early_exit=True, plain=True)
    seen, repeats = {}, 0
    for s, qi, j in zip(*np.nonzero(ids_s.numpy() >= 0)):
        key = (int(qi), int(ids_s[s, qi, j]))
        d = ds_s[s, qi, j].numpy().tobytes()
        if key in seen:
            repeats += 1
            assert seen[key] == d, key
        seen[key] = d
    assert repeats > 0                             # the halo really replicates
    ids = sv.search(q, k=10, beam=32)
    for row in ids:
        live = row[row >= 0]
        assert len(np.unique(live)) == len(live)
