"""LM serving on the port's ("data", "model") mesh (``launch.mesh.LMMesh``,
``distributed.sharding``, ``models.transformer.mesh_*``, ``models.moe``'s
mesh dispatches, ``Server(model_parallel=m)``) against the reference and
the port's one-shard run, on the CPU.

The reference runs in one subprocess a session
(``_torch_lm_mesh_reference``): its unsharded smoke models, jitted, on the
parameters carried across (reference arrays -> ``convert.lm_from_arrays``
-> ``sharding.shard_params``), and its ``moe_apply_ep`` on an 8-device
CPU mesh.  Under GSPMD the reference's ``Server`` computes the unsharded
model's function on its mesh, so the sharded port is held to the
unsharded reference.  Tolerances:

- float32: prefill logits 1e-4, the three greedy decode steps' 2e-3 (the
  bfloat16 KV cache), greedy tokens identical, the gathered bfloat16 KV
  caches within one bfloat16 ulp (a projection run on a block of columns
  sums its float32 products in another order, and a 1-ulp float32
  difference can round to the neighbouring bfloat16); the same against
  the port's one-shard run;
- the full-size configs' dtypes (bfloat16 activations; grok's bfloat16
  parameters) against the reference jitted without excess precision:
  under ``fsdp`` and ``ep_dp`` (per-layer gathers: each row's sums as on
  one shard) logits 1e-6, greedy tokens identical and the KV caches bit
  for bit, as ``tests/test_torch_models.py`` holds the one-shard port;
  under ``fsdp_tp`` each row-parallel product (wo, w_down) sums float32
  partial products over the shards, and a sum taken in that other order
  now and then rounds to the neighbouring bfloat16 (llama3-405b's smoke
  model at `model` 4 has one such, read 0.0188 of the logits' RMS after
  it), so logits are held within ``TP_BF16_TOL`` of the logits' RMS and
  the caches' error RMS within it of theirs;
- ``moe_apply_ep``: y and aux within 1e-5 of the reference's on a
  ``data 2 x model 4`` mesh where it drops tokens (its output differs
  from its dropless one there), and within 1e-4 of ``moe_apply`` at
  capacity factor 8.0; the fallback at `model` 1 within 1e-5 of
  ``moe_apply``;
- a gloo world of two ranks (``_torch_lm_mesh_worker``, ``data 1 x
  model 2``) gives the one-process mesh's logits and tokens exactly.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import _torch_lm_mesh_reference as R
import _torch_lm_mesh_worker as W
from repro_torch.configs import registry
from repro_torch.convert import lm_from_arrays
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as lm
from repro_torch.launch import serve
from repro_torch.models import model_zoo, moe
from repro_torch.tree import tree_flatten, tree_map

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"
WORLD = 2
DEADLINE_S = 240.0
# fsdp_tp in bfloat16: logits' largest error and the caches' error RMS over
# their RMS (one flipped rounding read 0.0188 of the logits' RMS)
TP_BF16_TOL = 0.05


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The two gloo ranks, started before the reference is awaited."""
    out = tmp_path_factory.mktemp("lm_mesh_world")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = []
    for rank in range(WORLD):
        log = open(out / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_torch_lm_mesh_worker.py"), str(out),
             str(rank), str(WORLD)], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT), log))
    yield out, procs, time.monotonic() + DEADLINE_S
    for p, log in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
        log.close()


@pytest.fixture(scope="module")
def ref(world, tmp_path_factory):
    d = R.reference_dir(tmp_path_factory)
    return np.load(d / "reference.npz"), np.load(d / "params.npz")


def _cfg(arch, kind: str):
    cfg = arch.smoke_model
    if kind == "pub":
        cfg = dataclasses.replace(cfg, act_dtype=arch.model.act_dtype,
                                  param_dtype=arch.model.param_dtype)
    return cfg


def _params(inp, arch_id: str, kind: str) -> dict:
    """The case's reference arrays (bfloat16 leaves as bfloat16) through
    ``convert.lm_from_arrays``."""
    import ml_dtypes

    tag = f"{arch_id}:{kind}"
    bf16 = R.bf16_leaves(inp, tag)
    arrays = {k: inp[k].astype(ml_dtypes.bfloat16) if k in bf16 else inp[k]
              for k in inp.files if k.startswith(tag + "/")}
    return lm_from_arrays(R.unflat(arrays, tag), device=CPU)


def _batch(arch, toks: np.ndarray) -> dict:
    b, t = toks.shape
    batch = {"tokens": torch.from_numpy(toks).long()}
    if arch.family == "vlm":
        batch["positions"] = torch.arange(t)[None, None].expand(3, b, t)
    return batch


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _full_cache(cache, cfg, mesh, policy: str, batch: int):
    """The KV caches [L, B, S, KV, hd] put together from the shards' (their
    batch rows, the KV heads their q heads read); shards holding the same
    entries must agree."""
    h, kv, m = cfg.n_heads, cfg.n_kv_heads, mesh.model
    g = h // kv
    b_ax = sharding.batch_spec("tokens", torch.empty(batch, 1), mesh.shape, policy)[0]
    full_k = torch.full((cfg.n_layers, batch) + tuple(cache.k[0].shape[2:3]) + (kv, cfg.hd),
                        float("nan"))
    full_v = full_k.clone()
    for k, v, c in zip(cache.k, cache.v, mesh.local):
        idx, n = sharding.block_index(b_ax, mesh.shape, c)
        rows = slice(idx * batch // n, (idx + 1) * batch // n)
        lo, hi = 0, h
        if policy == "fsdp_tp" and h % m == 0:
            lo, hi = c["model"] * h // m, (c["model"] + 1) * h // m
        heads = slice(lo // g, (hi - 1) // g + 1)
        for full, part in ((full_k, k), (full_v, v)):
            seen = full[:, rows, :, heads]
            done = ~torch.isnan(seen)
            assert torch.equal(seen[done], part.float()[done]), "shards disagree on a cache entry"
            full[:, rows, :, heads] = part.float()
    assert not torch.isnan(full_k).any()
    return full_k, full_v


def _mesh_cases():
    """The transformer family's cases (``test_torch_lm_families_mesh``
    holds the other families')."""
    out = []
    for arch_id, kinds in R.CASES:
        if registry.get_config(arch_id).family not in model_zoo.TRANSFORMER_FAMILIES:
            continue
        policy = registry.get_config(arch_id).parallelism
        for kind in kinds:
            for shape in ((1, 2), (1, 4)) + (((2, 2),) if policy == "fsdp" else ()):
                out.append((arch_id, kind, shape))
    return out


@pytest.mark.parametrize("case", _mesh_cases(), ids=lambda c: f"{c[0]}-{c[1]}-{c[2][0]}x{c[2][1]}")
def test_sharded_serving_matches_reference(ref, case):
    """Prefill and three greedy decode steps on the mesh against the
    reference's unsharded run and the port's one-shard run; the shards'
    blocks gathered equal the one-shard parameters bit for bit."""
    arch_id, kind, (d, m) = case
    r, inp = ref
    arch = registry.get_config(arch_id)
    cfg = _cfg(arch, kind)
    params = _params(inp, arch_id, kind)
    mesh = lm.make_lm_mesh(m, data=d, device=CPU)
    mp = sharding.shard_params(params, mesh, arch.family, arch.parallelism)
    for a, b in zip(tree_flatten(sharding.unshard_params(mp))[1], tree_flatten(params)[1]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    model = model_zoo.build(cfg, arch.family, mesh=mesh, policy=arch.parallelism)
    one = model_zoo.build(cfg, arch.family)
    tag = f"{arch_id}:{kind}"
    tp_bf16 = kind == "pub" and arch.parallelism == "fsdp_tp"
    batch = _batch(arch, inp[f"{arch_id}:tokens"])
    lg, cache = model.prefill(mp, batch, R.MAX_LEN)
    lo, co = one.prefill(params, batch, R.MAX_LEN)
    got, ones, want = [lg.gather()], [lo], [r[f"{tag}:prefill"]]
    np.testing.assert_array_equal(lg.greedy().numpy(), r[f"{tag}:tok0"])
    for i in range(R.STEPS):
        tok = torch.from_numpy(r[f"{tag}:tok{i}"]).long()
        lg, cache = model.decode_step(mp, tok, cache)
        lo, co = one.decode_step(params, tok, co)
        got.append(lg.gather())
        ones.append(lo)
        want.append(r[f"{tag}:decode{i}"])
        if not tp_bf16:
            np.testing.assert_array_equal(lg.greedy().numpy(), r[f"{tag}:tok{i + 1}"])
    assert cache.index == co.index == R.PROMPT + R.STEPS
    k, v = _full_cache(cache, cfg, mesh, arch.parallelism, R.BATCH)
    if kind == "f32":
        for i, (g, o, w) in enumerate(zip(got, ones, want)):
            _close(g, w, 1e-4 if i == 0 else 2e-3)
            _close(g, o, 1e-4 if i == 0 else 2e-3)
        for g, w in ((k, co.k.float()), (v, co.v.float()), (k, r[f"{tag}:k"]),
                     (v, r[f"{tag}:v"])):   # one bfloat16 ulp: at most 2^-7 of the value
            w = torch.as_tensor(w)
            bad = (g - w).abs() > 2.0 ** -7 * torch.maximum(g.abs(), w.abs())
            assert not bad.any(), (g[bad][:8], w[bad][:8])
    elif not tp_bf16:
        for g, o, w in zip(got, ones, want):
            _close(g, w, 1e-6)
            _close(g, o, 1e-6)
        for g, w in ((k, co.k), (v, co.v), (k, r[f"{tag}:k"]), (v, r[f"{tag}:v"])):
            assert torch.equal(g, torch.as_tensor(w).float())
    else:
        # the row-parallel sums reassociate bfloat16 products over the
        # shards: now and then one rounds to the neighbouring bfloat16
        for g, o, w in zip(got, ones, want):
            rms = float(torch.as_tensor(w).pow(2).mean().sqrt())
            assert float((g - torch.as_tensor(w)).abs().max()) <= TP_BF16_TOL * rms
            assert float((g - o).abs().max()) <= TP_BF16_TOL * rms
        for g, w in ((k, co.k), (v, co.v), (k, r[f"{tag}:k"]), (v, r[f"{tag}:v"])):
            w = torch.as_tensor(w).float()
            assert float((g - w).pow(2).mean().sqrt()) <= TP_BF16_TOL * float(w.pow(2).mean().sqrt())


def test_tensor_parallel_heads_that_straddle_shards(ref):
    """llama3-405b's smoke config has 2 KV heads of 8 dims: at `model` 4
    ``param_spec`` gives each shard 4 of wk's 16 columns, half a KV head;
    grok's 6 heads of 8 dims at `model` 4 give each shard 12 of wq's 48
    columns, one and a half q heads.  Those projections are gathered
    before they run (checked by the parity cases above); here the blocks
    themselves."""
    _, inp = ref
    arch = registry.get_config("llama3-405b")
    cfg = arch.smoke_model
    mesh = lm.make_lm_mesh(4, device=CPU)
    mp = sharding.shard_params(_params(inp, "llama3-405b", "f32"), mesh, arch.family,
                               arch.parallelism)
    wk = mp.shards[1]["blocks"][0]["attn"]["wk"]["w"]
    assert tuple(wk.shape) == (cfg.d_model, cfg.n_kv_heads * cfg.hd // 4) == (64, 4)
    assert sharding.axes_of(mp.specs["blocks"][0]["attn"]["wk"]["w"][1]) == ("model",)
    grok = registry.get_config("grok-1-314b")
    mp = sharding.shard_params(_params(inp, "grok-1-314b", "f32"), mesh,
                               grok.family, grok.parallelism)
    assert tuple(mp.shards[0]["blocks"][0]["attn"]["wq"]["w"].shape) == (48, 12)
    assert tuple(mp.shards[3]["blocks"][0]["moe"]["w_up"].shape) == (1, 48, 96)   # EP


def _ep_inputs(inp):
    p = {"router": {"w": torch.from_numpy(inp["ep/router/w"])}}
    p.update({k: torch.from_numpy(inp[f"ep/{k}"]) for k in moe.EXPERT_STACKS})
    return p, torch.from_numpy(inp["ep:x"])


@pytest.mark.parametrize("name", ["drop", "free"])
def test_moe_apply_ep_matches_reference(ref, name):
    """x [4, 64, 32] split B over data and T over model on a 2 x 4 mesh, 8
    experts top-2: at capacity factor 1.0 (cap_send 32, cap_e 64, both
    above their floor of 8) the reference drops tokens, and the port drops
    the same ones; at 8.0 both equal ``moe_apply``."""
    r, inp = ref
    p, x = _ep_inputs(inp)
    cf = R.EP["drop_cf"] if name == "drop" else R.EP["free_cf"]
    mesh = lm.make_lm_mesh(4, data=2, device=CPU)
    x_spec = (("data",), "model", None)
    parts = [sharding.shard(x, x_spec, mesh.shape, c) for c in mesh.local]
    pp = [dict(router=p["router"], **{k: sharding.shard(p[k], moe.EP_SPEC, mesh.shape, c)
                                      for k in moe.EXPERT_STACKS}) for c in mesh.local]
    y, aux = moe.moe_apply_ep(pp, parts, top_k=R.EP["top_k"], n_experts=R.EP["experts"],
                              mesh=mesh, x_spec=x_spec, capacity_factor=cf)
    y = sharding.unshard(y, x_spec, mesh.shape)
    _close(y, r[f"ep:{name}:y"], 1e-5)
    _close(aux, r[f"ep:{name}:aux"], 1e-5)
    if name == "drop":
        assert np.abs(r["ep:drop:y"] - r["ep:free:y"]).max() > 1e-2   # it drops here
    else:
        ym, am = moe.moe_apply(p, x, top_k=R.EP["top_k"], n_experts=R.EP["experts"],
                               capacity_factor=cf)
        _close(y, ym, 1e-4)
        _close(y, r["ep:free:moe_apply_y"], 1e-4)
        _close(aux, am, 1e-4)
    # the fallback at `model` 1: moe_apply over the whole token set
    m1 = lm.make_lm_mesh(1, data=2, device=CPU)
    x1 = (("data",), None, None)
    y1, a1 = moe.moe_apply_ep([p, p], [sharding.shard(x, x1, m1.shape, c) for c in m1.local],
                              top_k=R.EP["top_k"], n_experts=R.EP["experts"], mesh=m1,
                              x_spec=x1, capacity_factor=cf)
    _close(sharding.unshard(y1, x1, m1.shape), r[f"ep:{name}:moe_apply_y"], 1e-5)
    _close(a1, r[f"ep:{name}:moe_apply_aux"], 1e-5)


TRANSFORMER_ARCHS = [a for a in registry.ARCH_IDS
                     if registry.get_config(a).family in model_zoo.TRANSFORMER_FAMILIES]


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch_id", TRANSFORMER_ARCHS)
def test_server_model_parallel(arch_id, m):
    """``Server(model_parallel=m)`` draws the one-shard server's parameters,
    each shard holding only its blocks, and generates its tokens, greedy
    and sampled."""
    one = serve.Server(arch_id, max_len=16, seed=7, device=CPU)
    sv = serve.Server(arch_id, model_parallel=m, max_len=16, seed=7, device=CPU)
    assert sv.mesh.model == m and len(sv.params.shards) == m
    full = sharding.unshard_params(sv.params)
    leaves = tree_flatten(one.params)[1]
    for a, b in zip(tree_flatten(full)[1], leaves):
        assert torch.equal(a, b)
    specs = sharding.spec_leaves(one.params, sv.params.specs)
    for tree, c in zip(sv.params.shards, sv.mesh.local):
        want = 0
        for t, s in zip(leaves, specs):
            n = int(np.prod([sharding.block_index(e, sv.mesh.shape, c)[1] for e in s] or [1]))
            want += t.numel() * t.element_size() // n
        assert sharding.shard_bytes(tree) == want
    prompts = np.random.default_rng(1).integers(0, one.vocab, (4, 9)).astype(np.int32)
    a, st = one.generate(prompts, 5)
    b, st_m = sv.generate(prompts, 5)
    np.testing.assert_array_equal(a, b)
    assert set(st_m) == set(st) == {"prefill_s", "decode_s", "decode_tok_per_s"}
    a, _ = one.generate(prompts, 5, temperature=0.8, seed=3)
    b, _ = sv.generate(prompts, 5, temperature=0.8, seed=3)
    np.testing.assert_array_equal(a, b)


def test_mesh_forward_and_the_ep_a2a_prefill():
    """``forward`` on the mesh gives the one-shard hidden states and aux;
    ``moe_impl="ep_a2a"`` runs ``moe_apply_ep`` in the prefill (where
    nothing is dropped it equals the default dispatch), and the decode
    keeps the default dispatch."""
    arch = registry.get_config("granite-moe-1b-a400m")
    cfg = dataclasses.replace(arch.smoke_model, moe=dataclasses.replace(
        arch.smoke_model.moe, capacity_factor=8.0))
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (4, 11)))
    one = model_zoo.build(cfg, arch.family)
    params = one.init(torch.Generator().manual_seed(0), CPU)
    h1, aux1 = __import__("repro_torch.models.transformer", fromlist=["forward"]).forward(
        params, cfg, toks)
    l1, c1 = one.prefill(params, {"tokens": toks}, 14)
    mesh = lm.make_lm_mesh(2, data=2, device=CPU)
    calls = []
    orig = moe.moe_apply_ep

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    for impl in ("gspmd", "ep_a2a"):
        model = model_zoo.build(dataclasses.replace(cfg, moe_impl=impl), arch.family,
                                mesh=mesh, policy=arch.parallelism)
        mp = sharding.shard_params(params, mesh, arch.family, arch.parallelism)
        from repro_torch.models import transformer
        transformer.moe_apply_ep = counted
        try:
            h, aux = transformer.mesh_forward(mp, model.config, toks)
            lg, cache = model.prefill(mp, {"tokens": toks}, 14)
            n_prefill = len(calls)
            lg, cache = model.decode_step(mp, lg.greedy(), cache)
        finally:
            transformer.moe_apply_ep = orig
        assert len(calls) == n_prefill
        assert n_prefill == (0 if impl == "gspmd" else 2 * cfg.n_layers)
        calls.clear()
        _close(h, h1, 1e-5)
        _close(aux, aux1, 1e-5)
        lo, _ = one.prefill(params, {"tokens": toks}, 14)
        _close(one.decode_step(params, lo.argmax(-1)[:, None], c1)[0], lg.gather(), 2e-3)


def test_server_refusals_and_cli(capsys, monkeypatch):
    prompts = np.random.default_rng(3).integers(0, 256, (2, 5)).astype(np.int32)
    sv = serve.Server("mamba2-130m", model_parallel=2, max_len=12, device=CPU)   # serves
    np.testing.assert_array_equal(sv.generate(prompts, 4)[0], serve.Server(
        "mamba2-130m", max_len=12, device=CPU).generate(prompts, 4)[0])
    mesh = lm.make_lm_mesh(2, device=CPU)
    with pytest.raises(ValueError, match="mesh.device"):
        serve.Server("qwen2-7b", mesh=mesh, device=CPU)
    with pytest.raises(ValueError, match="disagrees"):
        serve.Server("qwen2-7b", mesh=mesh, model_parallel=4)
    whisper = model_zoo.build(registry.get_config("whisper-tiny").smoke_model, "encdec",
                              mesh=mesh)                                           # builds
    mp = whisper.init(torch.Generator().manual_seed(0))
    lg, cache = whisper.prefill(mp, {"tokens": torch.from_numpy(prompts).long(),
                                     "frames": serve.stub_frames(2, 5, 48, CPU)}, 8)
    assert tuple(lg.gather().shape) == (2, 256) and cache.index == 5
    rc = serve.main(["--arch", "grok-1-314b", "--requests", "4", "--batch", "2",
                     "--prompt-len", "6", "--max-new", "3", "--model-parallel", "2",
                     "--device", CPU])
    assert rc == 0 and "served 4 requests in 2 batches" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.Server("qwen2-7b", model_parallel=2)


def test_gloo_world_equals_one_process(world, ref):
    """Two gloo ranks, one shard each, against the one-process mesh of two
    shards: every logit and token exactly."""
    out, procs, t_end = world
    want = W.scenarios(lm.make_lm_mesh(WORLD, device=CPU))
    while any(p.poll() is None for p, _ in procs) and time.monotonic() < t_end:
        time.sleep(0.05)
    for rank, (p, log) in enumerate(procs):
        log.flush()
        assert p.poll() == 0, (out / f"rank{rank}.log").read_text()[-6000:]
    for rank in range(WORLD):
        got = np.load(out / f"rank{rank}.npz")
        assert set(got.files) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=f"rank {rank} {k}")


@pytest.mark.cuda
@pytest.mark.parametrize("arch_id", ["llama3-405b", "grok-1-314b", "granite-moe-1b-a400m",
                                     "qwen2-7b"])
def test_card_mesh_against_cpu_mesh(arch_id):
    """The smoke models at `model` 4 on the card against the CPU's mesh, the
    same blocks on both: float32 prefill logits within 1e-4, greedy tokens
    equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cpu = serve.Server(arch_id, model_parallel=4, max_len=16, seed=7, device=CPU)
    card = serve.Server(arch_id, model_parallel=4, max_len=16, seed=7, device="cuda")
    card.params = card.params._replace(shards=[tree_map(lambda t: t.cuda(), s)
                                               for s in cpu.params.shards])
    prompts = np.random.default_rng(1).integers(0, cpu.vocab, (4, 9)).astype(np.int32)
    want = cpu.model.prefill(cpu.params, cpu.make_batch(prompts), 16)[0].gather()
    got = card.model.prefill(card.params, card.make_batch(prompts), 16)[0].gather()
    _close(got.cpu(), want, 1e-4)
    np.testing.assert_array_equal(cpu.generate(prompts, 4)[0], card.generate(prompts, 4)[0])
