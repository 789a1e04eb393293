"""The shard mesh (``repro_torch.launch.mesh``) across processes: the
distributed build and sharded serving over gloo at W = 2 and 4 ranks on
the CPU, against the reference's own mesh results
(``_torch_build_reference``, ``_torch_shard_reference``: one subprocess
each a session, shared with the other tests) and against the one-process
port on the same inputs.

One spawn a world size: ``_torch_dist_worker.py`` started once per rank,
every scenario of the world in that one start, rendezvous through a
``FileStore`` in the test's temporary directory (collectives time out
after 60 s).  The ranks of both worlds run at once, on the helpers'
inputs made here, while this process runs the one-process port; the
references are awaited only then.  A rank that exits nonzero kills the
others and fails the tests with its stderr, as does the hard deadline.

Tolerance: exact everywhere.  The data are integers (every float32 sum is
exact in any order) and the exchanges only move bytes, so every rank's
graph, dists, reservoir rows, stats, packing, ids and telemetry are held
bit for bit."""
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import _torch_build_reference
import _torch_shard_reference
from _torch_dist_worker import (PACKINGS, SEARCHES, TILE_CASES, WORLDS, build_scenarios,
                                serve_scenarios)
from repro_torch.distributed.serving import ShardedServingIndex
from repro_torch.launch import build_index as bi
from repro_torch.launch import mesh as m

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEADLINE_S = 420.0
CPU = "cpu"


def _spawn(world: int, out: pathlib.Path, build_inputs, shard_inputs) -> list:
    out.mkdir()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = []
    for rank in range(world):
        log = open(out / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_torch_dist_worker.py"), str(out),
             str(rank), str(world), str(build_inputs), str(shard_inputs)],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def _wait(procs: list, t_end: float) -> None:
    """Every rank to exit 0; the first that does not, or the deadline,
    kills them all and raises with that rank's output."""
    try:
        while True:
            codes = [p.poll() for p, _ in procs]
            bad = [i for i, c in enumerate(codes) if c not in (None, 0)]
            if bad or time.monotonic() > t_end:
                i = bad[0] if bad else codes.index(None)
                log = pathlib.Path(procs[i][1].name)
                why = f"exited {codes[i]}" if bad else f"passed the {DEADLINE_S} s deadline"
                raise RuntimeError(f"rank {log.stem} of {log.parent.name} {why}:\n"
                                   f"{log.read_text()[-8000:]}")
            if all(c == 0 for c in codes):
                return
            time.sleep(0.05)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()


def _one_process(b: dict, inp: dict) -> dict:
    """The same scenarios with all shards in this process."""
    tags = sorted({t for w in WORLDS.values() for t in w["build"]})
    out = {"build": build_scenarios(lambda s: s, tags, b["x"], b["hp"])}
    for s in sorted({w["serve"] for w in WORLDS.values()}):
        pack = lambda s=s, **kw: ShardedServingIndex.from_graph(
            inp["graph"], inp["x"], int(inp["start"]), n_shards=s, device=CPU, **kw)
        out[s] = serve_scenarios(pack, inp["q"], s)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds' ranks' results ({world: [rank dicts]}), the one-process
    results and the references'."""
    base = tmp_path_factory.mktemp("dist_mesh")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    procs = {}
    try:
        inputs = dict(build=_torch_build_reference.build_inputs(),
                      shard=_torch_shard_reference.shard_inputs())
        for name, arrays in inputs.items():
            np.savez(base / f"{name}_inputs.npz", **arrays)
        for w in WORLDS:
            procs[w] = _spawn(w, base / f"world{w}", base / "build_inputs.npz",
                              base / "shard_inputs.npz")
        t_end = time.monotonic() + DEADLINE_S
        single = _one_process(inputs["build"], inputs["shard"])
        for w in WORLDS:
            _wait(procs[w], t_end)
    finally:
        torch.set_num_threads(threads)
        for world_procs in procs.values():
            for p, log in world_procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
    ranks = {w: [dict(np.load(base / f"world{w}" / f"rank{r}.npz")) for r in range(w)]
             for w in WORLDS}
    # the references ran on the helpers' own copies of the same inputs
    build_ref = _torch_build_reference.reference_dir(tmp_path_factory)
    shard_ref = _torch_shard_reference.reference_dir(tmp_path_factory)
    for name, ref_dir in (("build", build_ref), ("shard", shard_ref)):
        for key, arr in np.load(ref_dir / "inputs.npz").items():
            np.testing.assert_array_equal(inputs[name][key], arr, err_msg=f"{name} {key}")
    ref = dict(np.load(build_ref / "reference.npz"))
    serve_ref = {s: dict(np.load(shard_ref / f"shards{s}.npz"))
                 for s in _torch_shard_reference.SHARDS}
    return dict(ranks=ranks, single=single, ref=ref, serve_ref=serve_ref, inputs=inputs)


def _local(world: int, rank: int, s: int) -> list:
    n_local = s // world
    return list(range(rank * n_local, (rank + 1) * n_local))


# ------------------------------------------------------------- across ranks --

BUILDS = [(w, t) for w in WORLDS for t in WORLDS[w]["build"]]


@pytest.mark.parametrize("world,tag", BUILDS, ids=[f"W{w}-{t}" for w, t in BUILDS])
def test_build_on_every_rank_equals_reference_and_one_process(runs, world, tag):
    """Every rank returns the whole graph and dists: the reference's mesh
    build's and the one-process port's."""
    for rank, got in enumerate(runs["ranks"][world]):
        for name in ("graph", "dists"):
            key = f"{tag}_{name}"
            np.testing.assert_array_equal(got[key], runs["ref"][key], err_msg=f"rank {rank}")
            np.testing.assert_array_equal(got[key], runs["single"]["build"][key],
                                          err_msg=f"rank {rank}")


TILES = [(w, t) for w, t in BUILDS if t in TILE_CASES]


@pytest.mark.parametrize("world,tag", TILES, ids=[f"W{w}-{t}" for w, t in TILES])
def test_tile_step_rows_and_stats_on_every_rank(runs, world, tag):
    """Each rank's reservoir rows are its block of the reference's (and
    the one-process port's) tile-step reservoir; the stats, summed over
    all shards, are the same on every rank."""
    block = bi.DistBuildParams.tiny().n_tile // world
    for rank, got in enumerate(runs["ranks"][world]):
        rows = slice(rank * block, (rank + 1) * block)
        for name in ("ids", "hashes", "dists"):
            key = f"{tag}_res_{name}"
            np.testing.assert_array_equal(got[key], runs["ref"][key][rows], err_msg=f"rank {rank}")
            np.testing.assert_array_equal(got[key], runs["single"]["build"][key][rows])
        np.testing.assert_array_equal(got[f"{tag}_stats"], runs["ref"][f"{tag}_stats"])
        np.testing.assert_array_equal(got[f"{tag}_stats"], runs["single"]["build"][f"{tag}_stats"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("tag", [t for t, _ in PACKINGS])
def test_packing_on_every_rank_is_its_shards(runs, world, tag):
    """A rank packs its own shards: its [L, ...] tensors are the
    reference's (and the one-process port's) rows of its shards; leaders,
    owned counts and the halo fraction cover all S shards."""
    s = WORLDS[world]["serve"]
    ref, single = runs["serve_ref"][s], runs["single"][s]
    for rank, got in enumerate(runs["ranks"][world]):
        mine = _local(world, rank, s)
        for name in ("gids", "graph", "norms", "starts", "points", "scales"):
            key = f"{tag}_{name}"
            if key not in ref:
                assert key not in got
                continue
            np.testing.assert_array_equal(got[key], ref[key][mine], err_msg=f"rank {rank} {name}")
            np.testing.assert_array_equal(got[key], single[key][mine])
        for name in ("leaders", "owned", "halo_fraction"):
            key = f"{tag}_{name}"
            np.testing.assert_array_equal(got[key], ref[key], err_msg=f"rank {rank} {name}")
            np.testing.assert_array_equal(got[key], single[key])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", SEARCHES)
def test_search_on_every_rank_equals_reference_and_one_process(runs, world, case):
    """Ids, hops, dist comps, converged, probes and healthy-shard counts of
    both routers, a tombstoned shard, ``query_chunk``, the iters backstop
    and the int8 and bfloat16 packings: the same on every rank."""
    s = WORLDS[world]["serve"]
    ref, single = runs["serve_ref"][s], runs["single"][s]
    for rank, got in enumerate(runs["ranks"][world]):
        for key in ("ids", "hops", "dist_comps", "converged", "n_probes", "healthy"):
            k = f"{case}_{key}"
            np.testing.assert_array_equal(got[k], ref[k], err_msg=f"rank {rank} {key}")
            np.testing.assert_array_equal(got[k], single[k], err_msg=f"rank {rank} {key}")


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_audit_on_every_rank(runs, world):
    """PIPS002: each rank's packings and tile-step operands hold only its
    S / W shards (its points are 1 / W of the one-process packing's bytes);
    PIPS001: a search over the real group calls ``all_gather`` alone, and
    never inside a shard body."""
    s = WORLDS[world]["serve"]
    whole = runs["single"][s]["f32_points"].nbytes
    for rank, got in enumerate(runs["ranks"][world]):
        assert json.loads(str(got["mesh_pips002"])) == [], rank
        assert json.loads(str(got["mesh_pips002_build"])) == [], rank
        assert int(got["mesh_points_bytes"]) * world == whole, rank
        calls = json.loads(str(got["mesh_pips001_calls"]))
        assert calls and {c for c, _ in calls} == {"all_gather"}, (rank, calls)
        assert not any(inside for _, inside in calls), rank


@pytest.mark.parametrize("world", WORLDS)
def test_all_shards_down_raises_on_every_rank(runs, world):
    s = WORLDS[world]["serve"]
    assert bool(runs["serve_ref"][s]["all_down_raised"])
    assert bool(runs["single"][s]["all_down_raised"])
    assert all(bool(got["all_down_raised"]) for got in runs["ranks"][world])


@pytest.mark.parametrize("world", WORLDS)
def test_entry_points_on_every_rank(runs, world):
    """``pipnn.search(mesh=)`` (its packing cached on the index) and
    ``Retriever(mesh=)`` give every rank the reference's router-"all" ids."""
    want = runs["serve_ref"][WORLDS[world]["serve"]]["all_ids"]
    for rank, got in enumerate(runs["ranks"][world]):
        np.testing.assert_array_equal(got["entry_search_ids"], want, err_msg=f"rank {rank}")
        np.testing.assert_array_equal(got["entry_retriever_ids"], want, err_msg=f"rank {rank}")
        assert bool(got["entry_search_cached"])


@pytest.mark.parametrize("world", WORLDS)
def test_exchanges_equal_the_one_process_functions(runs, world):
    """``all_to_all`` (int32, bool and int8 payloads), ``all_gather`` and
    ``psum`` over gloo give each rank its share of the list functions'
    result, at L = 1 and 2 shards a rank; ``broadcast`` gives every rank
    rank 0's tensors and object."""
    for rank, got in enumerate(runs["ranks"][world]):
        checks = {k: bool(v) for k, v in got.items() if k.split("_", 1)[1] in
                  ("all_to_all_int32", "all_to_all_bool", "all_to_all_int8", "all_gather",
                   "psum", "broadcast")}
        assert len(checks) == 12 and all(checks.values()), (rank, checks)


@pytest.mark.parametrize("world", WORLDS)
def test_refusals_on_every_rank(runs, world):
    """Shards that do not divide over the ranks raise ``ValueError`` and the
    default device ``RuntimeError`` without a card, on every rank and
    before the group is joined (no rank hangs); ``ServeLoop`` runs on rank
    0 and refuses to run on any other rank, which follows it instead."""
    for rank, got in enumerate(runs["ranks"][world]):
        assert bool(got["refused_indivisible"])
        assert bool(got["refused_no_card"])
        assert bool(got["serve_loop_refused"]) if rank > 0 else "serve_loop_refused" not in got


@pytest.fixture(scope="module")
def reference_drill(tmp_path_factory):
    return json.loads((_torch_shard_reference.reference_dir(tmp_path_factory)
                       / "drill.json").read_text())


@pytest.mark.parametrize("world", WORLDS)
def test_serve_loop_drill_on_every_rank(runs, world, reference_drill):
    """The reference's S = 8 shard-failure drill through ``ServeLoop`` over
    W gloo ranks: rank 0's results, counters, events, injected faults and
    ``down_after`` equal ``drill.json`` exactly; every follower followed
    every search, probe and tombstone to rank 0's close, saw the same
    injected faults and health, and returned cleanly."""
    ranks = [json.loads(str(got["drill_json"])) for got in runs["ranks"][world]]
    lead = ranks[0]
    assert lead["drill"] == reference_drill
    rows = reference_drill["poisoned"]
    assert sorted(r[0] for r in lead["drill"]["results"] if r[2]) == rows
    assert len(lead["drill"]["results"]) == len(reference_drill["rids"])
    marked = lead["drill"]["counters"]["shards_marked_down"]
    for rank, got in enumerate(ranks):
        assert got["injector"] == lead["drill"]["injector"], rank
        assert got["calls"] == lead["drill"]["calls"], rank
        assert got["down_after"] == [] and got["search_restored"], rank
        if rank:
            followed = got["followed"]
            # each search and each probe passed the patched search once; the
            # failure each tombstone followed raised on the follower too
            assert followed["search"] + followed["probe_shard"] == got["calls"], rank
            assert followed["mark_shard_down"] == marked == followed["raised"], rank


@pytest.mark.parametrize("world", WORLDS)
def test_follower_drops_shared_errors_and_raises_its_own(runs, world):
    """``serve_follower`` drops an error every rank raises alike before the
    first collective (``AllShardsDown``) and follows on, and raises one of
    its own rank's (a fault on that rank alone) instead of waiting in the
    next broadcast while rank 0 enters a collective."""
    for rank, got in enumerate(runs["ranks"][world]):
        met = str(got["follower_fault"])
        want = ("rank0 AllShardsDown=True" if rank == 0
                else f"RuntimeError: device fault on rank {rank} alone")
        assert met == want, (rank, met)


# ------------------------------------------------------------- in one process --

def test_one_process_mesh_is_the_list_functions():
    """Without a group the mesh's methods are the list functions and every
    shard is local; ``local`` is the rank's contiguous block."""
    mesh = m.ShardMesh(4)
    assert list(mesh.local) == [0, 1, 2, 3] and mesh.n_local == 4
    sends = [torch.arange(24).reshape(4, 3, 2) + 100 * src for src in range(4)]
    for got, want in zip(mesh.all_to_all(sends), m.all_to_all(sends)):
        assert torch.equal(got, want)
    assert torch.equal(mesh.psum([torch.tensor([i]) for i in range(4)]), torch.tensor([6]))
    obj = {"q": np.arange(3)}
    assert mesh.broadcast(obj) is obj
    assert list(m.ShardMesh(8, rank=2, world=4).local) == [4, 5]
    assert bi.all_to_all is m.all_to_all and bi.psum is m.psum


def test_init_mesh_refuses_before_joining(tmp_path):
    store = torch.distributed.FileStore(str(tmp_path / "store"), 2)
    with pytest.raises(ValueError, match="do not divide"):
        m.init_mesh(3, CPU, store=store, rank=0, world=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        m.init_mesh(4, store=store, rank=0, world=2)           # the card, by default
    with pytest.raises(RuntimeError, match="CUDA"):
        m.init_mesh(4, "cuda", store=store, rank=0, world=2)   # no gloo in its place
    env = {k: os.environ.pop(k) for k in ("RANK", "WORLD_SIZE") if k in os.environ}
    try:
        with pytest.raises(ValueError, match="RANK"):
            m.init_mesh(4, CPU, store=store)
    finally:
        os.environ.update(env)
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="divide"):
        m.ShardMesh(6, world=4)
    with pytest.raises(RuntimeError, match="card"):
        m.make_local_mesh(4)


def test_backend_follows_the_device():
    assert m.backend_for(torch.device("cuda", 1)) == "nccl"
    assert m.backend_for(torch.device(CPU)) == "gloo"
    with pytest.raises(ValueError):
        m.backend_for(torch.device("meta"))


def test_a_mesh_takes_no_other_device(runs):
    """On a mesh the tensors live on ``mesh.device``: a ``device=`` or a
    shard count that disagrees raises instead of being used."""
    mesh = m.make_local_mesh(4, CPU)
    x = np.zeros((16, 16), np.float32)
    with pytest.raises(ValueError, match="mesh.device"):
        bi.build_distributed(x, mesh, bi.DistBuildParams.tiny(), device=CPU)
    inp = runs["inputs"]["shard"]
    g, xs, st = inp["graph"], inp["x"], int(inp["start"])
    with pytest.raises(ValueError, match="does not take"):
        ShardedServingIndex.from_graph(g, xs, st, mesh=mesh, device=CPU)
    with pytest.raises(ValueError, match="does not take"):
        ShardedServingIndex.from_graph(g, xs, st, mesh=mesh, n_shards=8)
    with pytest.raises(ValueError, match="n_shards or mesh"):
        ShardedServingIndex.from_graph(g, xs, st)
    sv = ShardedServingIndex.from_graph(g, xs, st, mesh=mesh)
    one = ShardedServingIndex.from_graph(g, xs, st, n_shards=4, device=CPU)
    q = inp["q"][:8]
    np.testing.assert_array_equal(sv.search(q, k=5), one.search(q, k=5))
    assert sv.device_bytes() == one.device_bytes()
    assert sv.device_bytes(breakdown=True) == one.device_bytes(breakdown=True)
