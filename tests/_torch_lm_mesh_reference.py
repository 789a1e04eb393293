"""The reference's LM runs for the port's LM-mesh tests, made once a
session in one subprocess.

The subprocess (``jax`` with ``--xla_force_host_platform_device_count=8``
on the CPU, as the reference's own ``tests/test_moe_ep.py`` runs it) reads
the parameters the parent wrote (the port's ``init`` carried to the
reference's stacked layout with ``convert.lm_to_arrays``) and writes, for
each case, the reference's unsharded prefill logits, three greedy decode
steps' logits and tokens, and the caches after them (each field but the
index: the KV caches; the ssm family's conv windows and SSM states; the
hybrid's both; the encoder-decoder's self and memory keys and values):
the ten smoke configs in float32 (jitted, no mesh; whisper on float32
frames from numpy), and four of them in their full-size configs' dtypes
(jitted with ``xla_allow_excess_precision`` off, so XLA rounds after
every op as the port does).  It also runs
``moe_apply_ep`` on a ``jax.sharding.Mesh((2, 4))`` of ("data", "model")
(the constructor gives Auto axes; ``jax.make_mesh`` gives Explicit ones,
on which the reference's own multi-device test fails on this jax), on x
[4, 64, 32] split B over data and T over model: at capacity factor 1.0,
where it drops tokens, and at 8.0 with ``moe_apply`` beside it.  With
pytest-xdist the workers share one run through a lock file in the
session's temporary directory; a failed subprocess fails the tests that
need it.

A second subprocess (``train_reference_dir``, for
``test_torch_lm_train_mesh``) runs the reference's training on the same
eight forced CPU devices: for each of ``TRAIN_ARCHS`` (granite's MoE
dropless, at capacity factor E / k) ``make_train_step(model, opt, 2,
mesh=, policy=)`` jitted on a ``Mesh((2, 2))`` of Auto axes (where the
reference's ``microbatch_constraint`` runs on this jax; GSPMD computes the
unsharded step's numbers on any mesh) for ``TRAIN["steps"]`` steps from
the port's initial parameters, and the first step's gradient
(``accumulate_grads`` over its two microbatches, unsharded: the MoE aux
is not linear in the token set, so the whole batch's gradient is another); ``jax.grad`` of ``moe_apply_ep`` (the ``EP`` case at capacity
factor 1.0, where it drops) on the ``Mesh((2, 4))``; and
``compression.compressed_psum`` under ``shard_map`` over ``data`` meshes
of 2 and 4 devices for "none", "bf16" and "int8".
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
         ("qwen2-vl-7b", ("f32",)), ("qwen3-14b", ("f32",)), ("internlm2-20b", ("f32",)),
         ("mamba2-130m", ("f32",)), ("zamba2-2.7b", ("f32",)), ("whisper-tiny", ("f32",)))
BATCH, PROMPT, MAX_LEN, STEPS = 4, 13, 20, 3
EP = dict(experts=8, top_k=2, d=32, ff=64, x_shape=(4, 64, 32), drop_cf=1.0, free_cf=8.0)
# the train references: (arch), the CLI's batches of B x T in two
# microbatches (TokenPipeline seed 1), three steps at the port's tests' rate
TRAIN_ARCHS = ("llama3-405b", "qwen2-7b", "granite-moe-1b-a400m", "qwen2-vl-7b",
               "mamba2-130m", "zamba2-2.7b", "whisper-tiny")
TRAIN = dict(batch=4, seq=16, micro=2, steps=3, seed=21,
             opt=dict(lr=3e-3, warmup_steps=2, total_steps=10))
EP_AUX_COEF = 3.0         # the ep gradient's objective: sum(y * cot) + 3 aux
COMPRESS_DATA = (2, 4)

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
        if arch.family == "encdec":
            batch["frames"] = jnp.asarray(params[f"{arch_id}:frames"])
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
        for name in cache._fields:
            if name != "index":
                res[f"{tag}:{name}"] = np.asarray(getattr(cache, name), np.float32)

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


TRAIN_SCRIPT = r'''
import dataclasses, json, pathlib, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs.registry import get_config
from repro.distributed import compression
from repro.distributed.compat import shard_map_norep
from repro.launch import steps
from repro.models import model_zoo, moe
from repro.optim import adamw

out = pathlib.Path(sys.argv[1])
cfg = json.loads(sys.argv[2])
assert len(jax.devices()) >= 8, jax.devices()
inp = dict(np.load(out / "train_inputs.npz"))
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


def flat(node, prefix):
    o = {}
    for k, v in node.items():
        if isinstance(v, dict):
            o.update(flat(v, f"{prefix}/{k}"))
        else:
            o[f"{prefix}/{k}"] = np.asarray(v)
    return o


mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
opt = adamw.AdamWConfig(**cfg["opt"])
for arch_id in cfg["archs"]:
    arch = get_config(arch_id)
    mc = arch.smoke_model
    if getattr(mc, "moe", None) is not None:
        mc = dataclasses.replace(mc, moe=dataclasses.replace(
            mc.moe, capacity_factor=mc.moe.n_experts / mc.moe.top_k))
    m = model_zoo.build(mc, arch.family)
    p = jax.tree.map(jnp.asarray, tree(inp, arch_id))
    batches = [{k[len(f"{arch_id}:b{i}:"):]: jnp.asarray(v) for k, v in inp.items()
                if k.startswith(f"{arch_id}:b{i}:")} for i in range(cfg["steps"])]
    _, g = jax.jit(lambda p, b: adamw.accumulate_grads(m.loss_fn, p, b, cfg["micro"]))(
        p, batches[0])
    res.update(flat(g, f"{arch_id}:grad"))
    step = jax.jit(steps.make_train_step(m, opt, cfg["micro"], mesh=mesh,
                                         policy=arch.parallelism))
    state = steps.TrainState(p, adamw.init(opt, p))
    with mesh:
        for i, b in enumerate(batches):
            state, met = step(state, b)
            for k in ("loss", "grad_norm", "lr"):
                res[f"{arch_id}:{k}{i}"] = np.asarray(met[k])
            if i == 0:
                res.update(flat(state.params, f"{arch_id}:params1"))

ep = cfg["ep"]
mesh8 = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
act = NamedSharding(mesh8, P(("data",), "model", None))
pe = jax.tree.map(jnp.asarray, tree(inp, "ep"))
cot = jnp.asarray(inp["ep:cot"])


def objective(p, x):
    y, aux = moe.moe_apply_ep(p, x, act_sharding=act, capacity_factor=ep["drop_cf"],
                              top_k=ep["top_k"], n_experts=ep["experts"])
    return jnp.sum(y * cot) + cfg["ep_aux_coef"] * aux


with mesh8:
    gp, gx = jax.jit(jax.grad(objective, argnums=(0, 1)))(
        pe, jax.device_put(jnp.asarray(inp["ep:x"]), act))
res.update(flat(gp, "ep:grad"))
res["ep:grad:x"] = np.asarray(gx)

for n in cfg["compress_data"]:
    dm = Mesh(np.array(jax.devices()[:n]), ("data",))
    g = tree(inp, f"cmp{n}:g")
    r = tree(inp, f"cmp{n}:r")
    for method in ("none", "bf16", "int8"):
        def body(g, r, method=method):
            one = lambda t: t[0]
            o, ef = compression.compressed_psum(
                jax.tree.map(one, g), compression.ErrorFeedbackState(jax.tree.map(one, r)),
                axis_name="data", method=method)
            return jax.tree.map(lambda t: t[None], o), jax.tree.map(lambda t: t[None], ef.residual)
        f = shard_map_norep(body, mesh=dm, in_specs=(P("data"), P("data")),
                            out_specs=(P("data"), P("data")))
        o, rr = jax.jit(f)(g, r)
        res.update(flat(o, f"cmp{n}:{method}:mean"))
        res.update(flat(rr, f"cmp{n}:{method}:residual"))
np.savez(out / "train_reference.npz", **res)
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
        if arch.family == "encdec":
            out[f"{arch_id}:frames"] = np.random.default_rng(13).standard_normal(
                (BATCH, PROMPT, arch.smoke_model.d_model)).astype(np.float32)
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
    out.update(_ep_inputs())
    return out


def _ep_inputs() -> dict:
    """The ``moe_apply_ep`` case's parameters and x, from numpy."""
    out = {}
    rng = np.random.default_rng(5)
    e, d, ff = EP["experts"], EP["d"], EP["ff"]
    out["ep/router/w"] = (rng.standard_normal((d, e)) * d ** -0.5).astype(np.float32)
    out["ep/w_gate"] = (rng.standard_normal((e, d, ff)) * d ** -0.5).astype(np.float32)
    out["ep/w_up"] = (rng.standard_normal((e, d, ff)) * d ** -0.5).astype(np.float32)
    out["ep/w_down"] = (rng.standard_normal((e, ff, d)) * ff ** -0.5).astype(np.float32)
    out["ep:x"] = rng.standard_normal(EP["x_shape"]).astype(np.float32)
    return out


def _subprocess(script: str, out: pathlib.Path, cfg: dict) -> None:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    p = subprocess.run([sys.executable, "-c", script, str(out), json.dumps(cfg)],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    if p.returncode != 0:
        raise RuntimeError(f"reference subprocess failed ({p.returncode}):\n"
                           f"{p.stdout[-4000:]}\n{p.stderr[-8000:]}")


def _run(out: pathlib.Path) -> None:
    np.savez(out / "params.npz", **inputs())
    _subprocess(SCRIPT, out, dict(cases=[list(c) for c in CASES], max_len=MAX_LEN, steps=STEPS,
                                  ep=EP))


def train_batches(arch_id: str, model, device="cpu") -> list:
    """The train CLI's first ``TRAIN["steps"]`` batches of B x T for
    ``model`` (``TokenPipeline`` seed 1, the VLM's positions; the encoder's
    bfloat16 frames widened to float32, so both sides run it in float32),
    as torch tensors on ``device``."""
    import torch

    from repro_torch import data
    from repro_torch.configs import registry
    from repro_torch.launch import train

    arch = registry.get_config(arch_id)
    pipe = data.TokenPipeline(data.TokenPipelineConfig(
        vocab=model.config.vocab, seq_len=TRAIN["seq"], global_batch=TRAIN["batch"], seed=1))
    get = train.make_batch_fn(model, arch.family, pipe, TRAIN["seq"], device)
    return [{k: v.float() if v.dtype == torch.bfloat16 else v for k, v in get(i).items()}
            for i in range(TRAIN["steps"])]


def train_model(arch_id: str, mesh=None):
    """The port's smoke model of ``arch_id`` as the train references build
    it (an MoE dropless), on ``mesh`` where one is given."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.models import model_zoo

    arch = registry.get_config(arch_id)
    cfg = arch.smoke_model
    if getattr(cfg, "moe", None) is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    return model_zoo.build(cfg, arch.family, mesh=mesh, policy=arch.parallelism)


def train_inputs() -> dict:
    """Each train arch's parameters (the port's ``init`` from
    ``TRAIN["seed"]``, in the reference's stacked layout) and batches; the
    ``moe_apply_ep`` gradient's cotangent; the compression cases' gradients
    and residuals, one row a device (leaf ``h`` holds exact halves of its
    int8 step, with a zero residual, for the rounding)."""
    import torch

    from repro_torch.convert import lm_to_arrays

    out = {}
    for arch_id in TRAIN_ARCHS:
        model = train_model(arch_id)
        params = model.init(torch.Generator().manual_seed(TRAIN["seed"]), "cpu")
        out.update(flat(lm_to_arrays(params), arch_id))
        for i, b in enumerate(train_batches(arch_id, model)):
            out.update({f"{arch_id}:b{i}:{k}": v.numpy() for k, v in b.items()})
    rng = np.random.default_rng(6)
    out["ep:cot"] = rng.standard_normal(EP["x_shape"]).astype(np.float32)
    for n in COMPRESS_DATA:
        h = np.tile(np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -126.5], np.float32),
                    (n, 1))
        out[f"cmp{n}:g/a"] = (rng.standard_normal((n, 5, 7)) * 3).astype(np.float32)
        out[f"cmp{n}:g/b"] = (rng.standard_normal((n, 11)) * 1e-3).astype(np.float32)
        out[f"cmp{n}:g/h"] = h
        out[f"cmp{n}:r/a"] = (rng.standard_normal((n, 5, 7)) * 1e-2).astype(np.float32)
        out[f"cmp{n}:r/b"] = (rng.standard_normal((n, 11)) * 1e-5).astype(np.float32)
        out[f"cmp{n}:r/h"] = np.zeros_like(h)
    return out


def _run_train(out: pathlib.Path) -> None:
    np.savez(out / "train_inputs.npz", **train_inputs(), **_ep_inputs())
    _subprocess(TRAIN_SCRIPT, out, dict(archs=list(TRAIN_ARCHS), steps=TRAIN["steps"],
                                        micro=TRAIN["micro"], opt=TRAIN["opt"], ep=EP,
                                        ep_aux_coef=EP_AUX_COEF,
                                        compress_data=list(COMPRESS_DATA)))


def _shared(tmp_path_factory, name: str, run) -> pathlib.Path:
    """``run(dir)`` once a session (once for all xdist workers) into the
    directory ``name`` of the session's temporary directory; ``dir``."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent            # shared by the session's workers
    out = base / name
    out.mkdir(exist_ok=True)
    with open(base / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not (out / "done").exists():
                if (out / "failed").exists():
                    raise RuntimeError((out / "failed").read_text())
                try:
                    run(out)
                except Exception as e:
                    (out / "failed").write_text(str(e))
                    raise
                (out / "done").write_text("ok")
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def reference_dir(tmp_path_factory) -> pathlib.Path:
    """The directory holding ``params.npz`` and ``reference.npz``, made
    once a session (once for all xdist workers)."""
    return _shared(tmp_path_factory, "torch_lm_mesh_reference", _run)


def train_reference_dir(tmp_path_factory) -> pathlib.Path:
    """The directory holding ``train_inputs.npz`` and
    ``train_reference.npz``, made once a session."""
    return _shared(tmp_path_factory, "torch_lm_train_reference", _run_train)


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
