"""The reference's LM runs for the port's LM-mesh tests, made once a
session in one subprocess.

The subprocess (``jax`` with ``--xla_force_host_platform_device_count=8``
on the CPU, as the reference's own ``tests/test_moe_ep.py`` runs it) reads
the parameters the parent wrote (the port's ``init`` carried to the
reference's stacked layout with ``convert.lm_to_arrays``) and writes, for
each case, the reference's unsharded prefill logits, three greedy decode
steps' logits and tokens, and the KV caches after them: the seven transformer-family
smoke configs in float32 (jitted, no mesh), and four of them in their
full-size configs' dtypes (jitted with ``xla_allow_excess_precision`` off,
so XLA rounds after every op as the port does).  It also runs
``moe_apply_ep`` on a ``jax.sharding.Mesh((2, 4))`` of ("data", "model")
(the constructor gives Auto axes; ``jax.make_mesh`` gives Explicit ones,
on which the reference's own multi-device test fails on this jax), on x
[4, 64, 32] split B over data and T over model: at capacity factor 1.0,
where it drops tokens, and at 8.0 with ``moe_apply`` beside it.  With
pytest-xdist the workers share one run through a lock file in the
session's temporary directory; a failed subprocess fails the tests that
need it.
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
# (arch, dtypes): "f32" the smoke config as it is, "pub" in the full-size
# config's activation and parameter dtypes
CASES = (("llama3-405b", ("f32", "pub")), ("grok-1-314b", ("f32", "pub")),
         ("granite-moe-1b-a400m", ("f32", "pub")), ("qwen2-7b", ("f32", "pub")),
         ("qwen2-vl-7b", ("f32",)), ("qwen3-14b", ("f32",)), ("internlm2-20b", ("f32",)))
BATCH, PROMPT, MAX_LEN, STEPS = 4, 13, 20, 3
EP = dict(experts=8, top_k=2, d=32, ff=64, x_shape=(4, 64, 32), drop_cf=1.0, free_cf=8.0)

SCRIPT = r'''
import dataclasses, json, pathlib, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs.registry import get_config
from repro.models import model_zoo, moe

out = pathlib.Path(sys.argv[1])
cfg = json.loads(sys.argv[2])
assert len(jax.devices()) >= 8, jax.devices()
res = {}


def tree(flat, prefix):
    node = {}
    for k, v in flat.items():
        if not k.startswith(prefix + "/"):
            continue
        path = k[len(prefix) + 1:].split("/")
        d = node
        for p in path[:-1]:
            d = d.setdefault(p, {})
        d[path[-1]] = v
    return node


params = dict(np.load(out / "params.npz"))
for arch_id, kinds in cfg["cases"]:
    arch = get_config(arch_id)
    for kind in kinds:
        mcfg = arch.smoke_model
        strict = {}
        if kind == "pub":
            mcfg = dataclasses.replace(mcfg, act_dtype=arch.model.act_dtype,
                                       param_dtype=arch.model.param_dtype)
            strict = {"xla_allow_excess_precision": False}
        m = model_zoo.build(mcfg, arch.family)
        tag = f"{arch_id}:{kind}"
        bf16 = set(str(n) for n in params[f"{tag}:bfloat16"])
        flat_p = {k: jnp.asarray(v, jnp.bfloat16) if k in bf16 else jnp.asarray(v)
                  for k, v in params.items() if k.startswith(tag + "/")}
        p = tree(flat_p, tag)
        toks = params[f"{arch_id}:tokens"]
        batch = {"tokens": jnp.asarray(toks)}
        if arch.family == "vlm":
            b, t = toks.shape
            batch["positions"] = jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32), (3, b, t))
        lg, cache = jax.jit(lambda p, b: m.prefill(p, b, cfg["max_len"]),
                            compiler_options=strict)(p, batch)
        res[f"{tag}:prefill"] = np.asarray(lg, np.float32)
        dec = jax.jit(m.decode_step, compiler_options=strict)
        for i in range(cfg["steps"]):
            tok = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
            res[f"{tag}:tok{i}"] = np.asarray(tok)
            lg, cache = dec(p, tok, cache)
            res[f"{tag}:decode{i}"] = np.asarray(lg, np.float32)
        res[f"{tag}:tok{cfg['steps']}"] = np.asarray(jnp.argmax(lg, -1)[:, None])
        res[f"{tag}:k"] = np.asarray(cache.k, np.float32)
        res[f"{tag}:v"] = np.asarray(cache.v, np.float32)

ep = cfg["ep"]
mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
p = jax.tree.map(jnp.asarray, tree(params, "ep"))
x = jnp.asarray(params["ep:x"])
act = NamedSharding(mesh, P(("data",), "model", None))
xs = jax.device_put(x, act)
kw = dict(top_k=ep["top_k"], n_experts=ep["experts"])
for name, c in (("drop", ep["drop_cf"]), ("free", ep["free_cf"])):
    with mesh:
        y, aux = jax.jit(lambda x: moe.moe_apply_ep(p, x, act_sharding=act, capacity_factor=c,
                                                     **kw))(xs)
    res[f"ep:{name}:y"], res[f"ep:{name}:aux"] = np.asarray(y), np.asarray(aux)
    y, aux = jax.jit(lambda x: moe.moe_apply(p, x, capacity_factor=c, **kw))(x)
    res[f"ep:{name}:moe_apply_y"], res[f"ep:{name}:moe_apply_aux"] = np.asarray(y), np.asarray(aux)
np.savez(out / "reference.npz", **res)
'''


def flat(tree: dict, prefix: str) -> dict:
    """A nested dict of arrays as ``{prefix/key/...: array}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def inputs() -> dict:
    """The parameters and tokens of every case, made with the port's
    ``init`` (seed 11) and carried to the reference's layout; the
    ``moe_apply_ep`` case's parameters and x from numpy."""
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.convert import lm_to_arrays
    from repro_torch.models import model_zoo
    from repro_torch.tree import tree_map

    out = {}
    for arch_id, kinds in CASES:
        arch = registry.get_config(arch_id)
        out[f"{arch_id}:tokens"] = np.random.default_rng(12).integers(
            0, arch.smoke_model.vocab, (BATCH, PROMPT)).astype(np.int32)
        for kind in kinds:
            cfg = arch.smoke_model
            if kind == "pub":
                cfg = dataclasses.replace(cfg, act_dtype=arch.model.act_dtype,
                                          param_dtype=arch.model.param_dtype)
            params = model_zoo.build(cfg, arch.family).init(torch.Generator().manual_seed(11),
                                                            "cpu")
            tag = f"{arch_id}:{kind}"
            arrays = flat(lm_to_arrays(params), tag)
            out.update(arrays)
            # the leaves kept in bfloat16 (lm_to_arrays widens them exactly)
            dtypes = flat(lm_to_arrays(tree_map(lambda t: torch.tensor(
                float(t.dtype == torch.bfloat16)), params)), tag)
            out[f"{tag}:bfloat16"] = np.array([k for k, v in dtypes.items() if v.any()])
    rng = np.random.default_rng(5)
    e, d, ff = EP["experts"], EP["d"], EP["ff"]
    out["ep/router/w"] = (rng.standard_normal((d, e)) * d ** -0.5).astype(np.float32)
    out["ep/w_gate"] = (rng.standard_normal((e, d, ff)) * d ** -0.5).astype(np.float32)
    out["ep/w_up"] = (rng.standard_normal((e, d, ff)) * d ** -0.5).astype(np.float32)
    out["ep/w_down"] = (rng.standard_normal((e, ff, d)) * ff ** -0.5).astype(np.float32)
    out["ep:x"] = rng.standard_normal(EP["x_shape"]).astype(np.float32)
    return out


def _run(out: pathlib.Path) -> None:
    np.savez(out / "params.npz", **inputs())
    cfg = dict(cases=[list(c) for c in CASES], max_len=MAX_LEN, steps=STEPS, ep=EP)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    p = subprocess.run([sys.executable, "-c", SCRIPT, str(out), json.dumps(cfg)],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    if p.returncode != 0:
        raise RuntimeError(f"reference subprocess failed ({p.returncode}):\n"
                           f"{p.stdout[-4000:]}\n{p.stderr[-8000:]}")
    (out / "done").write_text("ok")


def reference_dir(tmp_path_factory) -> pathlib.Path:
    """The directory holding ``params.npz`` and ``reference.npz``, made
    once a session (once for all xdist workers)."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent            # shared by the session's workers
    out = base / "torch_lm_mesh_reference"
    out.mkdir(exist_ok=True)
    with open(base / "torch_lm_mesh_reference.lock", "w") as lock:
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


def bf16_leaves(arrays, tag: str) -> set:
    """The flat names of a case's leaves kept in bfloat16."""
    return set(str(n) for n in arrays[f"{tag}:bfloat16"])


def unflat(arrays, prefix: str) -> dict:
    """The nested dict under ``prefix`` of a ``flat`` mapping."""
    node = {}
    for k in arrays.keys():
        if not k.startswith(prefix + "/"):
            continue
        d = node
        path = k[len(prefix) + 1:].split("/")
        for p in path[:-1]:
            d = d.setdefault(p, {})
        d[path[-1]] = arrays[k]
    return node
