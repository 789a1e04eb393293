"""One rank of the port's shard mesh over gloo, for ``test_torch_dist_mesh``.

    python tests/_torch_dist_worker.py OUT RANK WORLD BUILD_INPUTS SHARD_INPUTS

Started once per rank by the test.  It joins a gloo group of WORLD ranks
through a ``FileStore`` in OUT (collectives time out after 60 s), runs
every scenario of that world (the refusals, the exchanges, the
distributed build and sharded serving) on the reference helpers' inputs
(``_torch_build_reference.build_inputs``,
``_torch_shard_reference.shard_inputs``, saved to the two ``.npz``
files), and writes what it got to ``OUT/rank<RANK>.npz``.  Torch runs on one thread.  The scenario
functions take a mesh or a shard count, so the test runs the same ones in
one process for the comparison.
"""
from __future__ import annotations

import dataclasses
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
    from repro_torch.launch import build_index as bi

    cases = {c[0]: c for c in CASES}
    make_tile_step, steps = bi.make_tile_step, []

    def recorded(mesh, p):
        step = make_tile_step(mesh, p)

        def tile_step(*a):
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


def exchange_scenarios(mesh) -> dict:
    """Each exchange on payloads every rank can form whole (int32, bool
    and int8 sends; int32 parts), against the one-process list functions:
    True where this rank's share equals theirs."""
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
        res["serve_loop_refused"] = _raises(ValueError, lambda: ServeLoop(pack()))
    finally:
        mesh.close()
    np.savez(out_dir / f"rank{rank}.npz", **res)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
