"""The reference's sharded serving at S = 4 and 8, run once for the port's
sharded-serving and serving-loop tests.

``jax`` sees one CPU device unless ``XLA_FLAGS`` forces more before it
starts, so the reference's multi-shard paths run in a subprocess with
``--xla_force_host_platform_device_count=8``.  The parent writes the data
and the graph (integer points, so every float32 sum is exact), the
subprocess packs and searches them with ``repro`` and writes its results
to ``.npz`` files and one JSON file (the S = 8 shard-failure drill of the
serving loop), and the collective wire bytes a shard (``hlo_cost``'s
``coll_by_op``) of its compiled S = 8 search program and of the
cross-shard merge over that program's sharded blocks, for the port's
roofline (``coll.json``).  With pytest-xdist the workers share one run
through a lock file in the session's temporary directory.  A failed subprocess
fails the tests that need it.
"""
from __future__ import annotations

import fcntl
import json
import os
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHARDS = (4, 8)
BEAM, K = 24, 10
DRILL = dict(plan=dict(shard_down={7: (1, 6)}, straggle={2: 0.01}), poison_seed=7,
             loop=dict(k=10, query_chunk=16, straggler_chunk=8, max_queue=128,
                       probe_every=1))

SCRIPT = r'''
import json, pathlib, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.distributed.serving import cross_shard_topk
from repro.roofline import hlo_cost
from repro.core.serving import ServingIndex
from repro.distributed.serving import AllShardsDown, ShardedServingIndex
from repro.launch.serve_loop import ServeLoop
from repro.testing.faults import FaultPlan, inject_faults, poison_queries

out = pathlib.Path(sys.argv[1])
cfg = json.loads(sys.argv[2])
inp = np.load(out / "inputs.npz")
x, q, graph, start = inp["x"], inp["q"], inp["graph"], int(inp["start"])
assert len(jax.devices()) >= 8, jax.devices()
BEAM, K = cfg["beam"], cfg["k"]


def mesh(s):
    return Mesh(np.array(jax.devices()[:s]), ("shards",))


def pack(s, **kw):
    return ShardedServingIndex.from_graph(graph, x, start, mesh=mesh(s), **kw)


def packing(sv, tag, res):
    for name in ("gids", "graph", "norms", "starts", "leaders"):
        res[f"{tag}_{name}"] = np.asarray(getattr(sv, name))
    res[f"{tag}_owned"] = np.asarray(sv.owned)
    pts = np.asarray(sv.points)
    res[f"{tag}_points"] = pts.view(np.uint16) if pts.dtype.itemsize == 2 else pts
    if sv.scales is not None:
        res[f"{tag}_scales"] = np.asarray(sv.scales)
    res[f"{tag}_halo_fraction"] = np.float64(sv.halo_stats()["halo_fraction"])


def searched(sv, tag, res, qq=q, **kw):
    ids, st = sv.search(qq, k=K, beam=BEAM, with_stats=True, **kw)
    res[f"{tag}_ids"] = np.asarray(ids)
    for key in ("hops", "dist_comps", "converged"):
        res[f"{tag}_{key}"] = np.asarray(st[key])
    res[f"{tag}_n_probes"] = np.int64(st.get("n_probes", -1))
    res[f"{tag}_healthy"] = np.int64(st["healthy_shards"])


for s in cfg["shards"]:
    res = {}
    sv = pack(s)
    packing(sv, "f32", res)
    searched(sv, "all", res)
    searched(sv, "chunk", res, qq=q[:13], query_chunk=5)
    searched(sv, "iters1", res, qq=q[:5], iters=1)
    sv.mark_shard_down(1)
    searched(sv, "down", res)
    for i in range(s):
        sv.mark_shard_down(i)
    try:
        sv.search(q[:2], k=K)
        res["all_down_raised"] = np.bool_(False)
    except AllShardsDown:
        res["all_down_raised"] = np.bool_(True)
    for p in (1, 2):
        sl = pack(s, router="leaders", n_probes=p)
        searched(sl, f"leaders{p}", res)
    sl.mark_shard_down(0)
    searched(sl, "leaders2_down", res)
    s8 = pack(s, dtype="int8")
    packing(s8, "int8", res)
    searched(s8, "int8", res)
    s16 = pack(s, dtype=jnp.bfloat16)
    packing(s16, "bf16", res)
    searched(s16, "bf16", res)
    packing(pack(s, halo=False), "nohalo", res)
    np.savez(out / f"shards{s}.npz", **res)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


drill = cfg["drill"]
ssv = ServingIndex.from_graph(graph, x, start, mesh=mesh(8))
qp, rows = poison_queries(q, 0.05, seed=drill["poison_seed"])
plan = FaultPlan(shard_down={int(k): tuple(v) for k, v in drill["plan"]["shard_down"].items()},
                 straggle={int(k): v for k, v in drill["plan"]["straggle"].items()})
log = []
with inject_faults(ssv, plan) as inj:
    loop = ServeLoop(ssv, clock=FakeClock(), on_event=lambda k, d: log.append([k, d]),
                     **drill["loop"])
    rids = [loop.submit(qi) for qi in qp]
    res = loop.run_until_drained()
    for _ in range(12):
        res += loop.step()
        if not loop.index.down_shards:
            break
record = dict(
    rids=rids, poisoned=rows.tolist(), down_after=list(ssv.down_shards),
    results=[[r.rid, None if r.ids is None else r.ids.tolist(), r.error, r.phase,
              r.partial, r.op_point] for r in res],
    counters=dict(loop.counters), events=log,
    injector=[[k, c, d] for k, c, d in inj.events], calls=inj.calls)
(out / "drill.json").write_text(json.dumps(record))

# the roofline's collective bytes: the S = 8 search program at the port's
# mesh-audit shapes (4 queries, beam 8, 4 expansions, 12 steps) and the
# merge of its sharded blocks (k = 4)
sv = pack(8)
fn = sv._sharded_search_fn(beam=8, iters=12, expansions=4, early_exit=True,
                           kernel_path="xla", interpret=False)
qj = jax.device_put(q[:4], NamedSharding(sv.mesh, P()))
args = (sv.gids, sv.graph, sv.points, sv.norms, sv.starts, sv._scales_operand(), qj)
coll = {"search": hlo_cost.analyze(fn.lower(*args).compile().as_text(), n_devices=8).coll_by_op}
ids_s, ds_s = fn(*args)[:2]
coll["merge"] = hlo_cost.analyze(cross_shard_topk.lower(ids_s, ds_s, k=4).compile().as_text(),
                                 n_devices=8).coll_by_op
(out / "coll.json").write_text(json.dumps(coll))
'''


def shard_inputs():
    """The data both packages serve: 1,200 integer points of width 16 (a
    seeded Gaussian mixture mapped onto [0, 255]), 96 queries the same
    way, and the port's CPU build of them (its graph is data here)."""
    from repro_torch.core import pipnn
    from repro_torch.core.leaf import LeafParams
    from repro_torch.core.rbc import RBCParams
    from repro_torch.data import VectorPipelineConfig, make_queries, make_vectors, sift_like

    cfg = VectorPipelineConfig(n=1200, dim=16, n_clusters=16, seed=0)
    x, q = sift_like(make_vectors(cfg)), sift_like(make_queries(cfg, 96))
    p = pipnn.PiPNNParams(rbc=RBCParams(c_max=128, c_min=16, fanout=(3,)),
                          leaf=LeafParams(k=2), max_deg=16, seed=1)
    idx = pipnn.build(x, p, device="cpu")
    return dict(x=x, q=q, graph=idx.graph.numpy(), start=np.int64(idx.start))


def _run(out: pathlib.Path) -> None:
    np.savez(out / "inputs.npz", **shard_inputs())
    cfg = dict(shards=list(SHARDS), beam=BEAM, k=K, drill=DRILL)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    p = subprocess.run([sys.executable, "-c", SCRIPT, str(out), json.dumps(cfg)],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    if p.returncode != 0:
        raise RuntimeError(f"reference subprocess failed ({p.returncode}):\n"
                           f"{p.stdout[-4000:]}\n{p.stderr[-8000:]}")
    (out / "done").write_text("ok")


def reference_dir(tmp_path_factory) -> pathlib.Path:
    """The directory holding the reference's results, made once a session
    (once for all xdist workers)."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent            # shared by the session's workers
    out = base / "torch_shard_reference"
    out.mkdir(exist_ok=True)
    with open(base / "torch_shard_reference.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not (out / "done").exists():
                if (out / "failed").exists():
                    raise RuntimeError((out / "failed").read_text())
                try:
                    _run(out)
                except Exception as e:
                    (out / "failed").write_text(str(e))
                    raise
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out
