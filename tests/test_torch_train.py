"""LM training in the port (``repro_torch.optim.adamw``, the models'
``loss_fn`` with activation checkpointing, ``launch/steps.py``'s train
step, ``data.TokenPipeline`` and ``python -m repro_torch.launch.train``)
against the JAX package on the CPU.

The same inputs, made from a seed with numpy, go through the reference
(jitted once a module: one ``value_and_grad`` of ``Model.loss_fn`` and
one ``make_train_step(model, opt, 2)`` an architecture, no mesh) and the
port, the reference's parameters and AdamW state carried across by
``convert.train_state_from_arrays``.  One architecture a family, smoke
width, float32 activations (whisper's frames float32; granite's MoE
dropless, at capacity factor E / k).  Tolerances:

- ``TokenPipeline`` and the train CLI's batches: bit for bit;
- ``schedule`` 1e-6 relative or 1e-7 of the peak rate (XLA multiplies by
  the reciprocal of a constant divisor and uses its own cosine: a fifth of
  the float32 values 1-4 ulps from the port's true division and libm
  cosine); ``update`` (the clip path and bfloat16
  moments too) 1e-6 relative; ``cross_entropy`` with z-loss 1e-6;
- each family's loss 1e-5 relative and every gradient leaf within 1e-4 of
  that leaf's RMS (a leaf whose reference gradient is below 1e-6 of the
  whole gradient's RMS, the encoder-decoder's key biases, which softmax
  cannot see, holds rounding noise on both sides and is held below that);
  the same for ``accumulate_grads`` at two microbatches;
- three train steps: each step's loss 1e-5 relative; the parameters after
  the first within 1e-3 of the step's rate where the reference's gradient
  exceeds 100 times its leaf's tolerance (AdamW's first step is about
  sign(g) * lr, so a rounding near g = 0 moves an entry by 2 lr: no
  fault; the 1e-8 eps beside a small |g| moves it by up to 2e-4 lr);
- bfloat16 activations (qwen2-7b's published dtype) against the reference
  compiled without excess precision: see ``test_bfloat16_loss_and_grads``;
- activation checkpointing (``remat``, ``remat_group``) changes no bit of
  the gradients; restarts change no bit of the state.
"""
import dataclasses
import re
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.data import pipeline as j_pipeline
from repro.launch import steps as j_steps
from repro.launch import train as j_train
from repro.models import layers as JL
from repro.models import model_zoo as j_zoo
from repro.optim import adamw as j_adamw
from repro_torch import data as t_data
from repro_torch.configs import registry
from repro_torch.convert import lm_from_arrays, lm_to_arrays, train_state_from_arrays
from repro_torch.launch import steps as t_steps
from repro_torch.launch import train as t_train
from repro_torch.models import layers as TL
from repro_torch.models import model_zoo as t_zoo
from repro_torch.optim import adamw as t_adamw
from repro_torch.tree import tree_leaves

CPU = "cpu"
FAMILY_ARCHS = ["qwen2-7b", "granite-moe-1b-a400m", "qwen2-vl-7b", "mamba2-130m",
                "zamba2-2.7b", "whisper-tiny"]
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
B, T = 4, 16
STRICT = {"xla_allow_excess_precision": False}
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _dropless(cfg):
    if getattr(cfg, "moe", None) is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


@pytest.fixture(scope="module")
def reference():
    """Each family's models on both sides, the parameters (made by the
    port's ``init`` from a seed, as the reference's stacked arrays: JAX's
    eager ``init`` takes seconds a model) and the reference's jitted
    ``value_and_grad`` and two-microbatch train step, made once (the jit
    caches key on these functions)."""
    out = {}
    for arch_id in FAMILY_ARCHS:
        ja, ta = j_get_config(arch_id), registry.get_config(arch_id)
        jm = j_zoo.build(_dropless(ja.smoke_model), ja.family)
        tm = t_zoo.build(_dropless(ta.smoke_model), ta.family)
        jp = jax.tree.map(jnp.asarray, lm_to_arrays(tm.init(torch.Generator().manual_seed(5), CPU)))
        out[arch_id] = dict(
            family=ta.family, jm=jm, tm=tm, jp=jp,
            vg=jax.jit(jax.value_and_grad(jm.loss_fn)),
            step=jax.jit(j_steps.make_train_step(jm, j_adamw.AdamWConfig(**OPT), 2)))
    return out


def _carry(tree):
    return lm_from_arrays(jax.tree.map(np.asarray, tree), device=CPU)


def _batch(arch_id: str, tm, family: str, step: int):
    """The train CLI's batch of ``step`` (B x T) for both sides; the
    encoder's frames float32."""
    pipe = t_data.TokenPipeline(t_data.TokenPipelineConfig(
        vocab=tm.config.vocab, seq_len=T, global_batch=B, seed=1))
    tb = t_train.make_batch_fn(tm, family, pipe, T, CPU)(step)
    if "frames" in tb:
        tb["frames"] = tb["frames"].float()
    return {k: jnp.asarray(v.numpy()) for k, v in tb.items()}, tb


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


def _grads_close(got: dict, want, tol: float = GRAD_TOL, norm: str = "max") -> float:
    """Every leaf of ``got`` (the port's, as the reference's stacked numpy
    tree) within ``tol`` of the reference leaf's RMS: its largest error
    (``norm`` "max") or its error's RMS ("rms").  A leaf whose reference
    gradient is below 1e-6 of the whole gradient's RMS is zero in exact
    arithmetic and holds rounding noise: both sides are held below that.
    Returns the largest error over RMS."""
    flat = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, want))[0]
    total = np.sqrt(np.mean(np.concatenate([a.ravel() for _, a in flat]).astype(np.float64) ** 2))
    worst = 0.0
    for path, a in flat:
        b = got
        for p in path:
            b = b[p.key]
        assert b.shape == a.shape, jax.tree_util.keystr(path)
        rms = float(np.sqrt(np.mean(a.astype(np.float64) ** 2)))
        diff = (b - a).astype(np.float64)
        err = float(np.abs(diff).max() if norm == "max" else np.sqrt(np.mean(diff ** 2)))
        if rms < 1e-6 * total:
            assert max(np.abs(a).max(), np.abs(b).max()) < 1e-6 * total, jax.tree_util.keystr(path)
            continue
        assert err <= tol * rms, (jax.tree_util.keystr(path), err, rms)
        worst = max(worst, err / rms)
    return worst


# ----------------------------------------------------------------- pieces ---

def test_token_pipeline_is_bit_identical():
    for vocab, seq, batch, seed, shards in ((256, 32, 8, 0, 1), (50288, 64, 8, 3, 4),
                                            (152064, 17, 6, 1, 3)):
        cfgs = (j_pipeline.TokenPipelineConfig(vocab, seq, batch, seed),
                t_data.TokenPipelineConfig(vocab, seq, batch, seed))
        for shard in range(shards):
            jp = j_pipeline.TokenPipeline(cfgs[0], shard=(shard, shards))
            tp = t_data.TokenPipeline(cfgs[1], shard=(shard, shards))
            for step in (0, 1, 7, 1000):
                want, got = jp.batch(step), tp.batch(step)
                assert want.keys() == got.keys()
                for k in want:
                    assert got[k].dtype == want[k].dtype == np.int32
                    np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError):
        t_data.TokenPipeline(t_data.TokenPipelineConfig(16, 8, 6), shard=(0, 4))


@pytest.mark.parametrize("arch_id", ["whisper-tiny", "qwen2-vl-7b", "qwen2-7b"])
def test_batch_fn_is_bit_identical(arch_id):
    """The CLI's batches: tokens and labels, whisper's bfloat16 frames from
    ``default_rng(step)``, the VLM's broadcast positions."""
    ja, ta = j_get_config(arch_id), registry.get_config(arch_id)
    jm, tm = j_zoo.build(ja.smoke_model, ja.family), t_zoo.build(ta.smoke_model, ta.family)
    cfg = dict(vocab=ta.smoke_model.vocab, seq_len=24, global_batch=4, seed=2)
    jget = j_train.make_batch_fn(jm, ja.family, j_pipeline.TokenPipeline(
        j_pipeline.TokenPipelineConfig(**cfg)), 24)
    tget = t_train.make_batch_fn(tm, ta.family, t_data.TokenPipeline(
        t_data.TokenPipelineConfig(**cfg)), 24, CPU)
    for step in (0, 3):
        want, got = jget(step), tget(step)
        assert set(want) == set(got) == set(tm.train_batch_spec(4, 24))
        for k, w in want.items():
            w = np.asarray(w)
            shape, dtype = tm.train_batch_spec(4, 24)[k]
            assert tuple(got[k].shape) == w.shape == shape and got[k].dtype == dtype
            if dtype == torch.bfloat16:
                np.testing.assert_array_equal(got[k].view(torch.int16).numpy().view(np.uint16),
                                              w.view(np.uint16))
            else:
                np.testing.assert_array_equal(got[k].numpy(), w)


@pytest.mark.parametrize("arch_id", FAMILY_ARCHS)
def test_train_batch_spec_equals_reference(arch_id):
    ja, ta = j_get_config(arch_id), registry.get_config(arch_id)
    want = j_zoo.build(ja.model, ja.family).train_batch_spec(8, 128)
    got = t_zoo.build(ta.model, ta.family).train_batch_spec(8, 128)
    assert list(got) == list(want)
    for k, s in want.items():
        assert got[k][0] == s.shape and str(got[k][1]).split(".")[-1] == s.dtype.name


def test_adamw_config_defaults_equal_reference():
    want = {f.name: f.default for f in dataclasses.fields(j_adamw.AdamWConfig)}
    got = {f.name: f.default for f in dataclasses.fields(t_adamw.AdamWConfig)}
    assert list(got) == list(want)
    for k, v in want.items():
        if k == "moment_dtype":
            assert got[k] == torch.float32 and jnp.dtype(v) == jnp.float32
        else:
            assert got[k] == v and type(got[k]) is type(v), k


def test_schedule_matches_reference():
    for cfg in (dict(), dict(lr=3e-3, warmup_steps=50, total_steps=100),
                dict(warmup_steps=0, total_steps=7, min_lr_frac=0.0)):
        steps = np.arange(0, 12_000 if not cfg else 130, dtype=np.int32)
        want = np.asarray(jax.jit(lambda s: j_adamw.schedule(j_adamw.AdamWConfig(**cfg), s))(
            jnp.asarray(steps)))
        got = t_adamw.schedule(t_adamw.AdamWConfig(**cfg), torch.from_numpy(steps)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7 * cfg.get("lr", 3e-4))
        assert float(t_adamw.schedule(t_adamw.AdamWConfig(**cfg), 3)) == float(got[3])


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1e3, 0.05])
def test_update_matches_reference(moments, clip):
    """One update on identical params (float32 and bfloat16), grads and
    state, at step 4; ``clip`` 0.05 scales the gradients (their norm is
    about 6), 1e3 does not."""
    rng = np.random.default_rng(3)
    shapes = {"a": (5, 7), "b": (3,), "c": (2, 4, 6)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    m = {k: 0.1 * rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    v = {k: rng.random(s).astype(np.float32) for k, s in shapes.items()}
    jdt, tdt = (jnp.float32, torch.float32) if moments == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    kw = dict(lr=1e-2, grad_clip=clip, warmup_steps=2, total_steps=20)
    jcfg = j_adamw.AdamWConfig(moment_dtype=jdt, **kw)
    tcfg = t_adamw.AdamWConfig(moment_dtype=tdt, **kw)
    jparams = {**{k: jnp.asarray(a) for k, a in params.items()},
               "c": jnp.asarray(params["c"]).astype(jnp.bfloat16)}
    jstate = j_adamw.AdamWState(step=jnp.int32(4),
                                m=jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), m),
                                v=jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), v))
    jgrads = {k: jnp.asarray(a) for k, a in grads.items()}
    jp, js, jmet = jax.jit(lambda g, s, p: j_adamw.update(jcfg, g, s, p))(jgrads, jstate, jparams)
    tparams = lm_from_arrays(jax.tree.map(np.asarray, jparams), device=CPU)
    tstate = t_adamw.AdamWState(step=torch.tensor(4, dtype=torch.int32),
                                m=lm_from_arrays(jax.tree.map(np.asarray, jstate.m), device=CPU),
                                v=lm_from_arrays(jax.tree.map(np.asarray, jstate.v), device=CPU))
    tgrads = {k: torch.from_numpy(a.copy()) for k, a in grads.items()}
    tp, ts, tmet = t_adamw.update(tcfg, tgrads, tstate, tparams)
    assert tp is tparams and int(ts.step) == 5 and ts.step.dtype == torch.int32
    assert all(torch.equal(tgrads[k], torch.from_numpy(grads[k])) for k in grads)
    scaled = float(jmet["grad_norm"]) > clip
    assert scaled == (clip < 1)
    for name in ("grad_norm", "lr"):
        assert _rel(tmet[name], jmet[name]) <= 1e-6
    for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        for k in shapes:
            assert got[k].dtype == {jnp.dtype(jnp.bfloat16): torch.bfloat16,
                                    jnp.dtype(jnp.float32): torch.float32}[want[k].dtype]
            np.testing.assert_allclose(got[k].float().numpy(), np.asarray(want[k], np.float32),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy_matches_reference(z_loss):
    rng = np.random.default_rng(4)
    logits = (4 * rng.standard_normal((3, 5, 37))).astype(np.float32)
    targets = rng.integers(0, 37, (3, 5)).astype(np.int32)
    want = jax.jit(lambda a, t: JL.cross_entropy(a, t, z_loss=z_loss))(logits, targets)
    got = TL.cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets), z_loss=z_loss)
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    jg = jax.jit(jax.grad(lambda a, t: JL.cross_entropy(a, t, z_loss=z_loss)))(logits, targets)
    x = torch.from_numpy(logits).requires_grad_()
    TL.cross_entropy(x, torch.from_numpy(targets), z_loss=z_loss).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-9)


# ------------------------------------------------------------- the models ---

@pytest.mark.parametrize("arch_id", FAMILY_ARCHS)
def test_loss_and_grads_match_reference(arch_id, reference):
    r = reference[arch_id]
    jb, tb = _batch(arch_id, r["tm"], r["family"], 0)
    jl, jg = r["vg"](r["jp"], jb)
    tl, tg = t_adamw.value_and_grad(r["tm"].loss_fn, _carry(r["jp"]), tb)
    assert _rel(tl, jl) <= LOSS_RTOL
    _grads_close(lm_to_arrays(tg), jg)


@pytest.mark.parametrize("arch_id", ["qwen2-vl-7b", "whisper-tiny"])
def test_accumulate_grads_matches_reference(arch_id, reference):
    """Two microbatches: the VLM's positions split on their axis 1, the
    encoder's frames on axis 0."""
    r = reference[arch_id]
    jb, tb = _batch(arch_id, r["tm"], r["family"], 1)
    jl, jg = jax.jit(lambda p, b: j_adamw.accumulate_grads(r["jm"].loss_fn, p, b, 2))(
        r["jp"], jb)
    tl, tg = t_adamw.accumulate_grads(r["tm"].loss_fn, _carry(r["jp"]), tb, 2)
    assert _rel(tl, jl) <= LOSS_RTOL
    assert all(g.dtype == torch.float32 for g in tree_leaves(tg))
    _grads_close(lm_to_arrays(tg), jg)
    with pytest.raises(ValueError, match="micro"):
        t_adamw.accumulate_grads(r["tm"].loss_fn, _carry(r["jp"]), tb, 3)


@pytest.mark.parametrize("arch_id", FAMILY_ARCHS)
def test_train_steps_match_reference(arch_id, reference):
    """Three steps of ``make_train_step(model, opt, 2)`` from the same
    state on the CLI's first three batches."""
    r = reference[arch_id]
    jopt = j_adamw.AdamWConfig(**OPT)
    jstate = j_steps.TrainState(r["jp"], j_adamw.init(jopt, r["jp"]))
    tstate = train_state_from_arrays(*(jax.tree.map(np.asarray, t) for t in jstate), device=CPU)
    tstep = t_steps.make_train_step(r["tm"], t_adamw.AdamWConfig(**OPT), 2)
    p0 = _carry(r["jp"])
    for i in range(3):
        jb, tb = _batch(arch_id, r["tm"], r["family"], i)
        jstate, jmet = r["step"](jstate, jb)
        tstate, tmet = tstep(tstate, tb)
        assert _rel(tmet["loss"], jmet["loss"]) <= LOSS_RTOL, i
        assert _rel(tmet["grad_norm"], jmet["grad_norm"]) <= GRAD_TOL, i
        assert float(tmet["lr"]) == pytest.approx(float(jmet["lr"]), rel=1e-7)
        assert int(tstate.opt.step) == int(jstate.opt.step) == i + 1
        if i == 0:
            # the parameters after the first step, where the gradient is
            # far from 0 (its sign decides the step)
            _, jg = r["vg"](r["jp"], jb)
            flat = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jg))[0]
            got = lm_to_arrays(tstate.params)
            want = jax.tree.map(np.asarray, jstate.params)
            before = lm_to_arrays(p0)
            moved = 0
            total = np.sqrt(np.mean(np.concatenate([g.ravel() for _, g in flat]) ** 2))
            step_lr = float(jmet["lr"])
            for path, g in flat:
                rms = np.sqrt(np.mean(g.astype(np.float64) ** 2))
                if rms < 1e-6 * total:       # rounding noise: its sign is arbitrary
                    continue
                sure = np.abs(g) > 100 * GRAD_TOL * rms
                a, b, p = got, want, before
                for k in path:
                    a, b, p = a[k.key], b[k.key], p[k.key]
                np.testing.assert_allclose(a[sure], b[sure], rtol=0, atol=1e-3 * step_lr,
                                           err_msg=jax.tree_util.keystr(path))
                moved += int((a[sure] != p[sure]).sum())
            assert moved > 0


def test_bfloat16_loss_and_grads(reference):
    """qwen2-7b's smoke model in its published bfloat16 activations
    against the reference compiled with ``xla_allow_excess_precision`` off
    (XLA's default skips the bfloat16 roundings inside a fusion; off, it
    rounds after every op as the forward of the port does).  The backward
    rounds other sums and products to bfloat16 than XLA's autodiff does,
    so each leaf is held by its error's RMS over its RMS: read up to
    2.2e-2 (the largest entry's error up to 0.24 of the RMS, in rare
    tokens' embedding rows), the loss up to 2.7e-6 relative, over four
    parameter seeds and two batches; the bounds are under 3x those."""
    ja, ta = j_get_config("qwen2-7b"), registry.get_config("qwen2-7b")
    jm = j_zoo.build(dataclasses.replace(ja.smoke_model, act_dtype=jnp.bfloat16), ja.family)
    tm = t_zoo.build(dataclasses.replace(ta.smoke_model, act_dtype=torch.bfloat16), ta.family)
    jp = reference["qwen2-7b"]["jp"]
    jb, tb = _batch("qwen2-7b", tm, "dense", 0)
    jl, jg = jax.jit(jax.value_and_grad(jm.loss_fn), compiler_options=STRICT)(jp, jb)
    tl, tg = t_adamw.value_and_grad(tm.loss_fn, _carry(jp), tb)
    assert _rel(tl, jl) <= 7e-6
    _grads_close(lm_to_arrays(tg), jg, tol=6e-2, norm="rms")


@pytest.mark.parametrize("arch_id", FAMILY_ARCHS)
def test_remat_changes_no_gradient_bit(arch_id):
    """Checkpointing each layer, each group of two layers (the transformer's
    ``remat_group``) or none gives the same gradients bit for bit."""
    ta = registry.get_config(arch_id)
    variants = [dict(remat=False), dict(remat=True)]
    if ta.family in ("dense", "moe", "vlm"):
        assert ta.smoke_model.n_layers % 2 == 0
        variants.append(dict(remat=True, remat_group=2))
    model0 = t_zoo.build(dataclasses.replace(ta.smoke_model, **variants[0]), ta.family)
    params = model0.init(torch.Generator().manual_seed(1), CPU)
    _, tb = _batch(arch_id, model0, ta.family, 2)
    base = None
    for kw in variants:
        model = t_zoo.build(dataclasses.replace(ta.smoke_model, **kw), ta.family)
        loss, grads = t_adamw.value_and_grad(model.loss_fn, params, tb)
        flat = [loss] + tree_leaves(grads)
        if base is None:
            base = flat
        else:
            assert all(torch.equal(a, b) for a, b in zip(base, flat)), kw


def test_ssd_gradient_is_finite_at_the_published_chunk():
    """mamba2-130m's SSD at its chunk of 128: above the diagonal the
    segment sums' exp overflows, and the reference's ``where(mask,
    exp(li), 0)`` has a gradient of 0 * inf there (NaN in ``A_log``,
    ``dt_bias`` and ``in_proj``; ROADMAP.md section 3).  The port masks
    before the exp: the same forward bits, a finite gradient."""
    from repro_torch.models import mamba2 as TM

    cfg = registry.get_config("mamba2-130m").model.mamba_config()
    g = torch.Generator().manual_seed(0)
    h, n, p = cfg.n_heads, cfg.d_state, cfg.head_dim
    x = torch.randn((1, 128, h, p), generator=g)
    b_, c_ = torch.randn((1, 128, 1, n), generator=g), torch.randn((1, 128, 1, n), generator=g)
    dt = TM.softplus(torch.randn((1, 128, h), generator=g)).requires_grad_()
    a_log = torch.log(torch.rand(h, generator=g) * 15 + 1).requires_grad_()
    y = TM._ssd_chunked(x, b_, c_, dt, a_log, cfg.chunk)
    y.square().sum().backward()
    assert torch.isfinite(dt.grad).all() and torch.isfinite(a_log.grad).all()
    # the reference's form of the decay, forward only: the same bits
    cs = torch.cumsum((-torch.exp(a_log))[None, None, :] * dt, dim=1).detach()[:, None]
    li = cs[:, :, :, None, :] - cs[:, :, None, :, :]
    mask = torch.arange(128)[:, None] >= torch.arange(128)[None, :]
    ref = torch.where(mask[None, None, :, :, None], torch.exp(li), 0.0)
    assert torch.isinf(torch.exp(li)).any()
    assert torch.equal(torch.exp(torch.where(mask[None, None, :, :, None], li, float("-inf"))),
                       ref)


@pytest.mark.parametrize("arch_id", FAMILY_ARCHS)
def test_serving_builds_no_graph(arch_id):
    """``prefill`` and ``decode_step`` return tensors without a graph even
    from parameters that require gradients; ``forward`` and ``loss_fn``
    record one."""
    ta = registry.get_config(arch_id)
    model = t_zoo.build(ta.smoke_model, ta.family)
    params = model.init(torch.Generator().manual_seed(0), CPU)
    for t in tree_leaves(params):
        t.requires_grad_()
    _, tb = _batch(arch_id, model, ta.family, 0)
    logits, cache = model.prefill(params, tb, T + 2)
    assert not logits.requires_grad
    assert not any(t.requires_grad for t in cache if isinstance(t, torch.Tensor))
    logits, cache = model.decode_step(params, tb["tokens"][:, :1].long(), cache)
    assert not logits.requires_grad
    assert model.forward(params, tb).requires_grad and model.loss_fn(params, tb).requires_grad


# -------------------------------------------------------------------- CLI ---

def test_train_cli_loss_falls(capsys):
    """``tests/test_launch.py``'s run: qwen3-14b's smoke model, 12 steps of
    batch 8 in two microbatches; the mean loss of the last three steps is
    below the first three's."""
    assert t_train.main(["--arch", "qwen3-14b", "--smoke", "--steps", "12", "--batch", "8",
                         "--seq", "32", "--micro", "2", "--log-every", "100",
                         "--device", CPU]) == 0
    out = capsys.readouterr().out
    first, last = map(float, re.search(r"done: loss ([\d.]+) -> ([\d.]+)", out).groups())
    assert last < first
    assert re.search(r"step +11 loss +[\d.]+ gnorm +[\d.]+ lr [\d.e+-]+ +[\d.]+ms", out), out


@pytest.mark.parametrize("arch_id", registry.ARCH_IDS)
def test_train_cli_trains_every_arch(arch_id):
    """Two steps of every architecture's smoke model through the CLI: finite
    losses, and every parameter tensor of the state written in place."""
    rec = t_train.run(["--arch", arch_id, "--smoke", "--steps", "2", "--batch", "2", "--seq",
                       "8", "--micro", "2", "--log-every", "100", "--device", CPU])
    assert len(rec["losses"]) == 2 and all(np.isfinite(rec["losses"]))
    model = t_zoo.build(registry.get_config(arch_id).smoke_model,
                        registry.get_config(arch_id).family)
    fresh = model.init(torch.Generator(device=CPU).manual_seed(0), CPU)
    assert int(rec["state"].opt.step) == 2
    assert all(not torch.equal(a, b) for a, b in zip(tree_leaves(rec["state"].params),
                                                     tree_leaves(fresh)))


CKPT = ["--arch", "mamba2-130m", "--smoke", "--batch", "4", "--seq", "32", "--ckpt-every", "4",
        "--log-every", "100", "--device", CPU]


def test_train_checkpoint_restart(tmp_path, capsys):
    common = CKPT + ["--ckpt-dir", str(tmp_path)]
    t_train.main(common + ["--steps", "6"])
    out1 = capsys.readouterr().out
    t_train.main(common + ["--steps", "10", "--resume"])
    out2 = capsys.readouterr().out
    assert "resumed from step 6" in out2, out2
    first = float(re.search(r"done: loss ([\d.]+) ->", out1).group(1))
    last = float(re.search(r"done: loss [\d.]+ -> ([\d.]+)", out2).group(1))
    assert last < first


def test_guard_stop_and_resume_equal_an_uninterrupted_run(tmp_path, monkeypatch, capsys):
    """A SIGTERM during step 5 (``RunGuard``'s path) checkpoints at step 6
    and stops; ``--resume`` to step 10 then ends in the state of an
    uninterrupted 10-step run, bit for bit, with the same losses."""
    whole = t_train.run(CKPT + ["--steps", "10", "--ckpt-dir", str(tmp_path / "whole")])
    make = t_train.make_batch_fn

    def make_stopping(*a, **kw):
        get = make(*a, **kw)

        def stopping(step):
            if step == 5:
                signal.raise_signal(signal.SIGTERM)
            return get(step)

        return stopping

    monkeypatch.setattr(t_train, "make_batch_fn", make_stopping)
    handler = signal.getsignal(signal.SIGTERM)
    common = CKPT + ["--steps", "10", "--ckpt-dir", str(tmp_path / "cut")]
    cut = t_train.run(common)
    assert cut["stopped"] and len(cut["losses"]) == 6
    assert "preemption requested: checkpointed at step 6" in capsys.readouterr().out
    assert signal.getsignal(signal.SIGTERM) is handler
    monkeypatch.setattr(t_train, "make_batch_fn", make)
    rest = t_train.run(common + ["--resume"])
    assert rest["start_step"] == 6 and "resumed from step 6" in capsys.readouterr().out
    assert cut["losses"] + rest["losses"] == whole["losses"]
    for a, b in zip(tree_leaves(rest["state"]), tree_leaves(whole["state"])):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_train_cli_trains_the_ssm_family_on_a_mesh():
    """``--model-parallel 2`` for mamba2-130m trains on the mesh: its
    losses are the one-shard run's within 1e-6 relative (every family
    trains on the mesh: ``tests/test_torch_lm_families_mesh.py``)."""
    argv = ["--arch", "mamba2-130m", "--smoke", "--steps", "2", "--batch", "2", "--seq", "8",
            "--device", CPU]
    one = t_train.run(argv)
    two = t_train.run(argv + ["--model-parallel", "2"])
    assert two["state"].params.mesh.model == 2 and len(two["losses"]) == 2
    for a, b in zip(two["losses"], one["losses"]):
        assert abs(a - b) <= 1e-6 * abs(b)
