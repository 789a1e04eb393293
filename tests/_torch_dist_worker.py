"""One rank of the port's shard mesh over gloo, for ``test_torch_dist_mesh``.

    python tests/_torch_dist_worker.py OUT RANK WORLD BUILD_INPUTS SHARD_INPUTS

Started once per rank by the test.  It joins a gloo group of WORLD ranks
through a ``FileStore`` in OUT (collectives time out after 60 s), runs
every scenario of that world (the refusals, the exchanges, the
distributed build, sharded serving and the serving loop's S = 8 fault
drill, rank 0 running the loop and the others following it, and a
follower's own fault) on the reference helpers' inputs
(``_torch_build_reference.build_inputs``,
``_torch_shard_reference.shard_inputs``, saved to the two ``.npz``
files), and writes what it got to ``OUT/rank<RANK>.npz``.  Torch runs on one thread.  The scenario
functions take a mesh or a shard count, so the test runs the same ones in
one process for the comparison.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import sys

import numpy as np
import torch

from _torch_build_reference import CASES
from _torch_shard_reference import BEAM, K

TIMEOUT_S = 60.0
# the build cases (``_torch_build_reference.CASES`` tags) and the serving
# shard count each world runs
WORLDS = {4: dict(build=("s4", "s8", "s8_int8"), serve=8),
          2: dict(build=("s4", "s8_two_tiles"), serve=4)}
TILE_CASES = ("s4", "s8", "s8_int8")       # the cases whose tile step is held too
PACKINGS = (("f32", {}), ("int8", {"dtype": "int8"}), ("bf16", {"dtype": torch.bfloat16}),
            ("nohalo", {"halo": False}))
SEARCHES = ("all", "chunk", "iters1", "down", "leaders1", "leaders2", "leaders2_down",
            "int8", "bf16")


def build_scenarios(mesh_for, tags, x, hp) -> dict:
    """The distributed build of each case, and for ``TILE_CASES`` (one
    tile each) its tile step's output on the way: this rank's reservoir
    rows and the stats.  ``mesh_for(s)`` is a mesh of s shards or the
    shard count itself (then on the CPU)."""
    from repro_torch.analysis import mesh_audit
    from repro_torch.launch import build_index as bi

    cases = {c[0]: c for c in CASES}
    make_tile_step, steps, replication = bi.make_tile_step, [], []

    def recorded(mesh, p):
        step = make_tile_step(mesh, p)

        def tile_step(*a):
            if not isinstance(mesh, int):
                # PIPS002: this rank's operands of the step
                replication.extend(f.render()
                                   for f in mesh_audit.audit_replication_tile(mesh, p, *a))
            steps.append(step(*a))
            return steps[-1]
        return tile_step

    out = {}
    bi.make_tile_step = recorded
    try:
        for tag in tags:
            _, s, n, kw, final_prune = cases[tag]
            mesh = mesh_for(s)
            dev = "cpu" if isinstance(mesh, int) else None
            p = bi.DistBuildParams.tiny(l0=16, **kw)
            steps.clear()
            g, d = bi.build_distributed(x[:n], mesh, p, seed=0, final_prune=final_prune,
                                        hyperplanes=hp, device=dev)
            out[f"{tag}_graph"], out[f"{tag}_dists"] = g, d
            if tag in TILE_CASES:
                (res, stats), = steps
                for name, t in zip(("ids", "hashes", "dists"), res):
                    out[f"{tag}_res_{name}"] = t.numpy()
                out[f"{tag}_stats"] = stats.numpy()
    finally:
        bi.make_tile_step = make_tile_step
    out["mesh_pips002_build"] = np.array(json.dumps(replication))
    return out


def _packing(sv, tag: str, out: dict) -> None:
    for name in ("gids", "graph", "norms", "starts", "leaders"):
        out[f"{tag}_{name}"] = getattr(sv, name).numpy()
    out[f"{tag}_owned"] = np.asarray(sv.owned)
    pts = sv.points
    out[f"{tag}_points"] = (pts.view(torch.int16).numpy().view(np.uint16)
                            if pts.dtype == torch.bfloat16 else pts.numpy())
    if sv.scales is not None:
        out[f"{tag}_scales"] = sv.scales.numpy()
    out[f"{tag}_halo_fraction"] = np.float64(sv.halo_stats()["halo_fraction"])


def _searched(sv, case: str, q, out: dict, **kw) -> None:
    ids, st = sv.search(q, k=K, beam=BEAM, with_stats=True, **kw)
    out[f"{case}_ids"] = ids
    for key in ("hops", "dist_comps", "converged"):
        out[f"{case}_{key}"] = st[key]
    out[f"{case}_n_probes"] = np.int64(st.get("n_probes", -1))
    out[f"{case}_healthy"] = np.int64(st["healthy_shards"])


def serve_scenarios(pack, q, n_shards: int) -> dict:
    """The reference helper's sharded-serving scenarios (its tags):
    each packing, each search, and every shard down.  ``pack(**kw)`` packs
    the helper's graph on a mesh or at a shard count."""
    from repro_torch.distributed.serving import AllShardsDown

    out = {}
    for tag, kw in PACKINGS:
        _packing(pack(**kw), tag, out)
    for case in SEARCHES:
        if case in ("all", "chunk", "iters1", "down"):
            sv = pack()
            if case == "down":
                sv.mark_shard_down(1)
            qq, kw = {"chunk": (q[:13], dict(query_chunk=5)),
                      "iters1": (q[:5], dict(iters=1))}.get(case, (q, {}))
            _searched(sv, case, qq, out, **kw)
        elif case.startswith("leaders"):
            sv = pack(router="leaders", n_probes=int(case[7]))
            if case.endswith("_down"):
                sv.mark_shard_down(0)
            _searched(sv, case, q, out)
        else:
            _searched(pack(**dict(PACKINGS)[case]), case, q, out)
    sv = pack()
    for i in range(n_shards):
        sv.mark_shard_down(i)
    try:
        sv.search(q[:2], k=K)
        out["all_down_raised"] = np.bool_(False)
    except AllShardsDown:
        out["all_down_raised"] = np.bool_(True)
    return out


def mesh_audit_scenario(mesh, inp: dict) -> dict:
    """PIPS001 and PIPS002 inside the world: this rank's float32 and int8
    packings hold only its shards, and a search over the real group calls
    ``all_gather`` only, outside its shard bodies."""
    from repro_torch.analysis import mesh_audit
    from repro_torch.distributed.serving import ShardedServingIndex

    rec = mesh_audit.recording(mesh)
    pack = lambda **kw: ShardedServingIndex.from_graph(   # noqa: E731
        inp["graph"], inp["x"], int(inp["start"]), mesh=rec, **kw)
    held, findings = {}, []
    for kw in ({}, {"dtype": "int8"}):
        findings += mesh_audit.audit_replication_serving(pack(**kw), held if not kw else None)
    sv = pack()
    del rec.calls[:]
    with mesh_audit.shard_bodies():
        sv.search(inp["q"][:4], k=K, beam=BEAM)
    return {"mesh_pips002": np.array(json.dumps([f.render() for f in findings])),
            "mesh_points_bytes": np.int64(held["points"]),
            "mesh_pips001_calls": np.array(json.dumps(rec.calls))}


def exchange_scenarios(mesh) -> dict:
    """Each exchange on payloads every rank can form whole (int32, bool
    and int8 sends; int32 parts), against the one-process list functions,
    and the broadcast of rank 0's tensors and object: True where this
    rank's share equals theirs."""
    from repro_torch.launch import mesh as m

    s, cap = mesh.n_shards, 3
    sends = [torch.arange(s * cap * 2, dtype=torch.int32).reshape(s, cap, 2) + 1000 * src
             for src in range(s)]
    out = {}
    for name, conv in (("int32", lambda t: t), ("bool", lambda t: t % 3 == 0),
                       ("int8", lambda t: (t % 251 - 125).to(torch.int8))):
        full = [conv(t) for t in sends]
        want = m.all_to_all(full)
        got = mesh.all_to_all([full[i] for i in mesh.local])
        out[f"all_to_all_{name}"] = np.bool_(all(
            g.dtype == want[i].dtype and torch.equal(g, want[i])
            for g, i in zip(got, mesh.local)))
    parts = [torch.full((2, 3), i, dtype=torch.int32) for i in range(s)]
    out["all_gather"] = np.bool_(torch.equal(mesh.all_gather([parts[i] for i in mesh.local]),
                                             m.all_gather(parts)))
    parts = [torch.tensor([i, 2 * i], dtype=torch.int32) for i in range(s)]
    total = mesh.psum([parts[i] for i in mesh.local])
    out["psum"] = np.bool_(total.dtype == torch.int32 and torch.equal(total, m.psum(parts)))
    # rank 0's tensor (int32 and bool) and object on every rank
    t = mesh.broadcast(torch.full((3,), 7 + mesh.rank, dtype=torch.int32))
    b = mesh.broadcast(torch.tensor([mesh.rank == 0, True]))
    obj = mesh.broadcast({"from": mesh.rank, "q": np.arange(3)} if mesh.rank == 0 else None)
    out["broadcast"] = np.bool_(torch.equal(t, torch.full((3,), 7, dtype=torch.int32))
                                and b.dtype == torch.bool and bool(b.all())
                                and obj["from"] == 0 and obj["q"].tolist() == [0, 1, 2])
    return out


def entry_scenarios(mesh, inp: dict) -> dict:
    """``pipnn.search(mesh=)`` (cached on the index) and
    ``Retriever(mesh=)`` on the helper's graph, router "all"."""
    from repro_torch.convert import index_from_arrays
    from repro_torch.core import pipnn
    from repro_torch.launch.serve import Retriever

    graph, x, q = inp["graph"], inp["x"], inp["q"]
    idx = index_from_arrays(graph, np.zeros(graph.shape, np.float32), int(inp["start"]),
                            device="cpu")
    out = {"search_ids": pipnn.search(idx, x, q, k=K, beam=BEAM, mesh=mesh)}
    out["search_cached"] = np.bool_(pipnn.serving_index(idx, x, mesh=mesh) is idx._serving
                                    and idx._serving.mesh is mesh)
    out["retriever_ids"] = Retriever(x, idx, mesh=mesh).retrieve(q, k=K, beam=BEAM)
    return out


def drill_scenario(mesh, inp: dict) -> dict:
    """The reference's S = 8 shard-failure drill (``_torch_shard_reference``'s
    ``DRILL``) through ``ServeLoop`` over the mesh: rank 0 runs the loop on
    a fake clock, the other ranks ``serve_follower``, each under the same
    fault plan.  Rank 0 records the drill as the reference writes
    ``drill.json``; every rank records its injector's events and calls,
    the shards down at the end, and what it followed."""
    from _torch_shard_reference import DRILL

    from repro_torch.distributed.serving import ShardedServingIndex
    from repro_torch.launch.serve_loop import ServeLoop, serve_follower
    from repro_torch.testing.faults import FaultPlan, inject_faults, poison_queries

    class FakeClock:
        def __init__(self):
            self.t = 0.0

        def __call__(self):
            return self.t

    ssv = ShardedServingIndex.from_graph(inp["graph"], inp["x"], int(inp["start"]), mesh=mesh)
    qp, rows = poison_queries(inp["q"], 0.05, seed=DRILL["poison_seed"])
    out = {}
    with inject_faults(ssv, FaultPlan(**DRILL["plan"])) as inj:
        if mesh.rank == 0:
            log = []
            with ServeLoop(ssv, clock=FakeClock(), on_event=lambda k, d: log.append([k, d]),
                           **DRILL["loop"]) as loop:
                rids = [loop.submit(qi) for qi in qp]
                res = loop.run_until_drained()
                for _ in range(12):
                    res += loop.step()
                    if not loop.index.down_shards:
                        break
            out["drill"] = dict(
                rids=rids, poisoned=rows.tolist(), down_after=list(ssv.down_shards),
                results=[[r.rid, None if r.ids is None else r.ids.tolist(), r.error, r.phase,
                          r.partial, r.op_point] for r in res],
                counters=dict(loop.counters), events=log,
                injector=[[k, c, d] for k, c, d in inj.events], calls=inj.calls)
        else:
            out["followed"] = dict(serve_follower(ssv))
    out.update(injector=[[k, c, d] for k, c, d in inj.events], calls=inj.calls,
               down_after=list(ssv.down_shards), search_restored="search" not in vars(ssv))
    return {"drill_json": np.array(json.dumps(out))}


def follower_fault_scenario(mesh, inp: dict) -> dict:
    """What ``serve_follower`` drops and what it raises.  With every shard
    tombstoned on every rank, rank 0 sends a search: ``AllShardsDown``
    comes on every rank alike before any collective, and the followers
    drop it and follow on.  Then rank 0 sends a tombstone that fails on
    the followers alone (their ``mark_shard_down`` raises, as a device
    fault would): each follower raises it out of ``serve_follower``.  A
    tombstone reaches no collective, so rank 0 is not left waiting.  Each
    rank records what it met."""
    from repro_torch.distributed.serving import AllShardsDown, ShardedServingIndex
    from repro_torch.launch.serve_loop import serve_follower

    ssv = ShardedServingIndex.from_graph(inp["graph"], inp["x"], int(inp["start"]), mesh=mesh)
    for s in range(ssv.n_shards):
        ssv.mark_shard_down(s)
    search = ("search", (inp["q"][:4],), dict(k=K, beam=BEAM))
    if mesh.rank == 0:
        # the commands the loop's ``_call`` sends, sent as they are
        mesh.broadcast(search)
        got = _raises(AllShardsDown, lambda: ssv.search(*search[1], **search[2]))
        mesh.broadcast(("mark_shard_down", (0,), {}))
        ssv.mark_shard_down(0)
        return {"follower_fault": np.array(f"rank0 AllShardsDown={bool(got)}")}

    def fault(shard):
        raise RuntimeError(f"device fault on rank {mesh.rank} alone")

    ssv.mark_shard_down = fault
    try:
        serve_follower(ssv)
        met = "returned"
    except Exception as e:  # noqa: BLE001 (recorded for the test)
        met = f"{type(e).__name__}: {e}"
    return {"follower_fault": np.array(met)}


def _raises(exc, fn) -> np.bool_:
    try:
        fn()
    except exc:
        return np.bool_(True)
    return np.bool_(False)


def main(out_dir: str, rank: int, world: int, build_inputs: str, shard_inputs: str) -> None:
    from repro_torch.distributed.serving import ShardedServingIndex
    from repro_torch.launch.mesh import init_mesh
    from repro_torch.launch.serve_loop import ServeLoop

    torch.set_num_threads(1)
    out_dir = pathlib.Path(out_dir)
    store = torch.distributed.FileStore(str(out_dir / "store"), world)
    res = {}
    # the refusals come before the group is joined, on every rank alike
    res["refused_indivisible"] = _raises(ValueError, lambda: init_mesh(
        2 * world - 1, "cpu", store=store, rank=rank, world=world, timeout_s=TIMEOUT_S))
    res["refused_no_card"] = _raises(RuntimeError, lambda: init_mesh(
        world, store=store, rank=rank, world=world, timeout_s=TIMEOUT_S))
    mesh = init_mesh(world, "cpu", store=store, rank=rank, world=world, timeout_s=TIMEOUT_S)
    try:
        with_shards = lambda s: dataclasses.replace(mesh, n_shards=s)
        for s in sorted({world, 2 * world}):
            res.update({f"s{s}_{k}": v for k, v in exchange_scenarios(with_shards(s)).items()})
        b = np.load(build_inputs)
        res.update(build_scenarios(with_shards, WORLDS[world]["build"], b["x"], b["hp"]))
        inp = np.load(shard_inputs)
        serve_mesh = with_shards(WORLDS[world]["serve"])
        pack = lambda **kw: ShardedServingIndex.from_graph(
            inp["graph"], inp["x"], int(inp["start"]), mesh=serve_mesh, **kw)
        res.update(serve_scenarios(pack, inp["q"], serve_mesh.n_shards))
        res.update({f"entry_{k}": v for k, v in entry_scenarios(serve_mesh, inp).items()})
        res.update(mesh_audit_scenario(serve_mesh, inp))
        # the loop runs on rank 0 only: every other rank follows it
        if mesh.rank > 0:
            res["serve_loop_refused"] = _raises(ValueError, lambda: ServeLoop(pack()))
        res.update(drill_scenario(with_shards(8), inp))
        res.update(follower_fault_scenario(with_shards(8), inp))
    finally:
        mesh.close()
    np.savez(out_dir / f"rank{rank}.npz", **res)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
