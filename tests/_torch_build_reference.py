"""The reference's distributed build at S = 4 and 8, run once for the
port's multi-shard build tests.

``jax`` sees one CPU device unless ``XLA_FLAGS`` forces more before it
starts, so the reference's multi-shard build runs in a subprocess with
``--xla_force_host_platform_device_count=8``.  The parent writes the data
(integer points whose int8 quantization is exact, so every float32 sum is
exact on both sides), the subprocess builds it with ``repro`` on 1-D
meshes of 4 and 8 devices, its supersteps jitted (the reference's own
functions, compiled once instead of run op by op), and writes graphs,
dists, tile-step reservoirs and stats to one ``.npz``, and the collective
wire bytes a shard (``hlo_cost``'s ``coll_by_op``) of its compiled S = 8
tile step and final-prune step at ``DistBuildParams.tiny()`` to
``coll.json`` (the port's roofline).  With pytest-xdist
the workers share one run through a lock file in the session's temporary
directory.  A failed subprocess fails the tests that need it.
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
N = 2048          # one tile of DistBuildParams.tiny
N_TWO_TILES = 3000
# (tag, shards, n, params overrides, final_prune); the int8 route is the
# variant whose payloads the exchanges carry differently (int8 vectors and
# scales); bf16 and the flat fold are shard-local and held at one shard
CASES = (("s4", 4, N, {}, True),
         ("s8", 8, N, {}, True),
         ("s8_int8", 8, N, {"route_dtype": "int8"}, True),
         ("s8_two_tiles", 8, N_TWO_TILES, {}, True),
         ("s8_no_prune", 8, N_TWO_TILES, {}, False))

SCRIPT = r'''
import json, pathlib, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from repro.analysis.spmd_audit import _build_avals
from repro.core.hashprune import reservoir_init
from repro.launch import build_index as bi
from repro.roofline import hlo_cost

out = pathlib.Path(sys.argv[1])
cases = json.loads(sys.argv[2])
inp = np.load(out / "inputs.npz")
x, hp = inp["x"], inp["hp"]
assert len(jax.devices()) >= 8, jax.devices()

make_tile, make_prune = bi.make_tile_step, bi.make_final_prune_step
bi.make_tile_step = lambda mesh, p: jax.jit(make_tile(mesh, p))
bi.make_final_prune_step = lambda mesh, p: jax.jit(make_prune(mesh, p))
bi._sketch.make_hyperplanes = lambda key, m, d, dtype=jnp.float32: jnp.asarray(hp)

res = {}
for tag, s, n, kw, final_prune in cases:
    mesh = Mesh(np.array(jax.devices()[:s]), ("shards",))
    p = bi.DistBuildParams.tiny(l0=16, **kw)
    g, d = bi.build_distributed(x[:n], mesh, p, seed=0, final_prune=final_prune)
    res[f"{tag}_graph"], res[f"{tag}_dists"] = g, d
    if n == p.n_tile:
        r, st = bi.make_tile_step(mesh, p)(jnp.asarray(x[:n]), jnp.asarray(hp),
                                           reservoir_init(p.n_tile, p.l_max))
        for name in ("ids", "hashes", "dists"):
            res[f"{tag}_res_{name}"] = np.asarray(getattr(r, name))
        res[f"{tag}_stats"] = np.asarray(st)
np.savez(out / "reference.npz", **res)

pt = bi.DistBuildParams.tiny()
m8 = Mesh(np.array(jax.devices()[:8]), ("data",))
av = _build_avals(pt)
lowered = {"tile": jax.jit(make_tile(m8, pt).shard_step).lower(
               *(av[k] for k in ("points", "hyperplanes", "res_ids", "res_hashes", "res_dists"))),
           "prune": jax.jit(make_prune(m8, pt)).lower(av["points"], av["res_ids"], av["res_dists"])}
coll = {k: hlo_cost.analyze(v.compile().as_text(), n_devices=8).coll_by_op
        for k, v in lowered.items()}
(out / "coll.json").write_text(json.dumps(coll))
'''


def build_inputs():
    """The data both packages build: integers in [0, 127] of width 16,
    each row's largest entry 127 (its int8 scale is exactly 1.0, so the
    quantized route's vectors stay integers), and dyadic hyperplanes."""
    from repro_torch.data import dyadic_hyperplanes

    return dict(x=round_trip_integers(N_TWO_TILES, 16, seed=0),
                hp=dyadic_hyperplanes(3, 12, 16))


def round_trip_integers(n: int, d: int, seed: int) -> np.ndarray:
    """Integer points in [0, 127], one entry of each row set to 127: the
    symmetric int8 scheme's scale is then exactly 1.0 and every float32
    sum of the build is exact."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 128, (n, d)).astype(np.float32)
    x[np.arange(n), rng.integers(0, d, n)] = 127
    return x


def outlier_points(n: int, d: int, seed: int) -> np.ndarray:
    """Integer points in [0, 31], one entry of each row set to 127 (the
    int8 round trip stays exact), and a far-away pair: row 640 (level-0
    leader 5 of ``DistBuildParams.tiny`` at n_tile 2048) and row 641, all
    entries 127 but one.  Bucket 5 then holds just these two points: one
    valid level-1 leader (fewer than f1 = 2) and leaves of two members
    (fewer than k + 1 = 3), so both places where the kernel route's -1
    differs from ``lax.top_k``'s pick are met."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 32, (n, d)).astype(np.float32)
    x[np.arange(n), rng.integers(0, d, n)] = 127
    x[640] = 127
    x[641] = 127
    x[641, 0] = 126
    return x


def _run(out: pathlib.Path) -> None:
    np.savez(out / "inputs.npz", **build_inputs())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    p = subprocess.run([sys.executable, "-c", SCRIPT, str(out), json.dumps(CASES)],
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
    out = base / "torch_build_reference"
    out.mkdir(exist_ok=True)
    with open(base / "torch_build_reference.lock", "w") as lock:
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
