"""LM training on the port's ("data", "model") mesh (the mesh train step of
``launch/steps.py``, ``transformer.mesh_loss_fn``, the differentiable
exchanges of ``launch/mesh.py``, ``sharding.reduce_replicated`` /
``global_norm``, ``optim/adamw.py`` over ``MeshParams``,
``distributed/elastic.py``, ``distributed/compression.py`` and the train
CLI's ``--model-parallel``) against the reference and the port's one-shard
run, on the CPU in float32.

The reference runs in one subprocess a session
(``_torch_lm_mesh_reference.train_reference_dir``, started in a thread
when this module starts): ``make_train_step(model, opt, 2, mesh=,
policy=)`` jitted on a ``Mesh((2, 2))`` of Auto axes (the reference's
``microbatch_constraint`` runs on this jax there), ``jax.grad`` of
``moe_apply_ep`` on a ``Mesh((2, 4))``, and ``compressed_psum`` under
``shard_map``.  Tolerances:

- the mesh train step at `model` 2 / 4 and `data` 1 / 2 (llama3-405b
  ``fsdp_tp``, qwen2-7b ``fsdp``, granite-moe-1b-a400m ``ep_dp`` dropless,
  qwen2-vl-7b with M-RoPE positions), three steps from one state:
  against the reference, ``tests/test_torch_train.py``'s rule (each step's
  loss 1e-5 relative, gradient norm 1e-4, the parameters after the first
  step within 1e-3 of the step's rate where the reference's gradient
  exceeds 100 x 1e-4 of its leaf's RMS); against the port's one-shard step
  each step's loss and gradient norm 1e-6 relative, the parameters by the
  same rule;
- the sharing traps: a replicated leaf (one tensor every local shard
  shares) takes exactly the one-card update, bit for bit; two data
  coordinates' copies of a block hold their own storage; the norm over
  blocks is the logical tree's within 1e-6; under ``fsdp_tp`` the loss is
  the one-shard loss within 1e-6 and the reduced gradients the one-shard
  gradients within 1e-5 of each leaf's RMS;
- gloo worlds of 2 and 4 ranks (``_torch_lm_mesh_worker``, a ``data 2 x
  model 2`` mesh: two shards a rank with the data line across ranks, and
  one a rank over four line subgroups) against the one-process mesh: every
  rank's gathered parameters identical; each step's gradient norm exact
  and its loss within 1e-6 relative (the total over ranks sums its terms
  in another order: read 1.7e-7); the parameters after two steps within
  1e-5 of each leaf's largest entry (replicated leaves' gradients are
  summed over the local shards by autograd in another order than over
  the ranks: read 2.4e-6, the tied embedding table), the key biases
  aside (their gradient is zero in exact arithmetic: rounding noise that
  AdamW scales to about the rate);
- ``moe_apply_ep``'s gradient (x, router, expert stacks; the drop case)
  within 1e-5 of ``jax.grad`` of the reference's;
- ``compressed_psum`` at data 2 and 4: every mean exact, "none" and
  "bf16" residuals exact; the "int8" residual is ``g32 - decompress(...)``
  exactly, as the reference's source writes it, and XLA's jit fuses that
  into one multiply-subtract rounded once: the reference's residual is that
  fused value bit for bit (within one ulp of g32 of the port's);
  ``wire_bytes`` the reference's;
- checkpoints: a mesh state's files are a one-card save's bit for bit and
  the reference reads them; ``restore_to_mesh`` of a reference checkpoint
  is ``shard`` of its arrays bit for bit; ``data_shard_slice`` the
  reference's;
- the CLI: ``--model-parallel 2`` losses within 1e-6 relative of m = 1's;
  a run stopped at step 2 on m = 2, resumed onto m = 4 and stopped at 4,
  resumed onto m = 1 to 6, within 1e-5 of an uninterrupted m = 2 run.
"""
import os
import pathlib
import re
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import _torch_lm_mesh_reference as R
import _torch_lm_mesh_worker as W
from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.distributed import compression as j_compression
from repro.distributed import elastic as j_elastic
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import registry
from repro_torch.convert import lm_to_arrays, train_state_from_arrays
from repro_torch.distributed import compression, elastic, sharding
from repro_torch.launch import mesh as lm
from repro_torch.launch import steps, train
from repro_torch.models import moe
from repro_torch.optim import adamw
from repro_torch.tree import tree_flatten, tree_leaves, tree_map

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4          # tests/test_torch_train.py's
ONE_SHARD_RTOL = 1e-6
MESHES = ((2, 1), (4, 1), (2, 2), (4, 2))  # (model, data)
WORLDS = (2, 4)                            # gloo ranks of a data 2 x model 2 mesh
GLOO_LOSS_RTOL, GLOO_PARAM_TOL = 1e-6, 1e-5
DEADLINE_S = 240.0
OPT = R.TRAIN["opt"]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both gloo worlds' ranks, started before anything is awaited."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = {}
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"lm_train_world{world}")
        procs = []
        for rank in range(world):
            log = open(d / f"rank{rank}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, str(ROOT / "tests" / "_torch_lm_mesh_worker.py"), str(d),
                 str(rank), str(world), "2", "2"], cwd=ROOT, env=env, stdout=log,
                stderr=subprocess.STDOUT), log))
        out[world] = (d, procs)
    yield out, time.monotonic() + DEADLINE_S
    for _, procs in out.values():
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()


@pytest.fixture(scope="module")
def _reference_thread(worlds, tmp_path_factory):
    """The reference subprocess, run in a thread while the tests that do
    not need it run."""
    box = {}

    def run():
        try:
            box["dir"] = R.train_reference_dir(tmp_path_factory)
        except Exception as e:   # noqa: BLE001 (raised by the tests that need it)
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, box


@pytest.fixture(scope="module", autouse=True)
def _start(_reference_thread):
    """Start the gloo worlds and the reference before the first test."""


@pytest.fixture(scope="module")
def ref(_reference_thread):
    t, box = _reference_thread
    t.join(timeout=900)
    if "error" in box:
        raise box["error"]
    d = box["dir"]
    return np.load(d / "train_reference.npz"), np.load(d / "train_inputs.npz")


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


def _arch_arrays(inp, arch_id: str) -> dict:
    return R.unflat({k: inp[k] for k in inp.files if k.startswith(arch_id + "/")}, arch_id)


def _batches(inp, arch_id: str) -> list:
    out = []
    for i in range(R.TRAIN["steps"]):
        pre = f"{arch_id}:b{i}:"
        out.append({k[len(pre):]: torch.from_numpy(inp[k]) for k in inp.files if k.startswith(pre)})
    return out


def _state(inp, arch_id: str, mesh=None):
    """The reference's initial train state (the port's init from the seed)
    through ``convert.train_state_from_arrays``, cut onto ``mesh``."""
    params = _arch_arrays(inp, arch_id)
    zeros = tree_map(np.zeros_like, params)
    arch = registry.get_config(arch_id)
    return train_state_from_arrays(params, (np.int32(0), zeros, zeros), device=CPU, mesh=mesh,
                                   family=arch.family, policy=arch.parallelism)


def _params_close(got: dict, want: dict, grads: dict, lr: float, what: str) -> int:
    """The parameters (stacked numpy trees, matched by path) within 1e-3
    of the step's rate where |g| exceeds 100 x GRAD_TOL of its leaf's RMS;
    returns the count compared."""
    got, want, grads = R.flat(got, ""), R.flat(want, ""), R.flat(grads, "")
    total = np.sqrt(np.mean(np.concatenate([g.ravel() for g in grads.values()])
                            .astype(np.float64) ** 2))
    compared = 0
    for name, g in grads.items():
        rms = np.sqrt(np.mean(g.astype(np.float64) ** 2))
        if rms < 1e-6 * total:           # rounding noise: its sign is arbitrary
            continue
        sure = np.abs(g) > 100 * GRAD_TOL * rms
        np.testing.assert_allclose(got[name][sure], want[name][sure], rtol=0, atol=1e-3 * lr,
                                   err_msg=f"{what} {name}")
        compared += int(sure.sum())
    return compared


@pytest.fixture(scope="module")
def one_shard(ref):
    """``run(arch_id)``: the port's one-shard three steps (each step's
    metrics, the parameters after the first), once a module."""
    _, inp = ref
    cache = {}

    def run(arch_id: str):
        if arch_id not in cache:
            model = R.train_model(arch_id)
            state = _state(inp, arch_id)
            step = steps.make_train_step(model, adamw.AdamWConfig(**OPT), R.TRAIN["micro"])
            mets, params1 = [], None
            for i, b in enumerate(_batches(inp, arch_id)):
                state, met = step(state, b)
                mets.append({k: float(v) for k, v in met.items()})
                if i == 0:     # a copy: the next steps write the tensors in place
                    params1 = tree_map(np.copy, lm_to_arrays(state.params))
            cache[arch_id] = mets, params1
        return cache[arch_id]
    return run


# ------------------------------------------------------ the sharing traps ---

def test_replicated_leaf_takes_one_step_and_copies_own_their_storage():
    """On a ``data 2 x model 2`` mesh a norm scale (spec all None) is one
    tensor all four local shards share; granite's (``ep_dp``) attention
    weights are split over `data` only, one copy a `model` coordinate.
    AdamW over the mesh (clip off) gives the one-card update bit for bit:
    the shared scale took one step, not four, and no copy's update wrote
    another's storage."""
    arch = registry.get_config("granite-moe-1b-a400m")
    model = steps.build_model(arch, smoke=True)
    params = model.init(torch.Generator().manual_seed(2), CPU)
    mesh = lm.make_lm_mesh(2, data=2, device=CPU)
    mp = sharding.shard_params(tree_map(torch.clone, params), mesh, arch.family, arch.parallelism)
    scale = [s["final_norm"]["scale"] for s in mp.shards]
    assert all(t is scale[0] for t in scale)
    wq = [s["blocks"][0]["attn"]["wq"]["w"] for s in mp.shards]
    assert torch.equal(wq[0], wq[1]) and wq[0] is not wq[1]
    assert wq[0].untyped_storage().data_ptr() != wq[1].untyped_storage().data_ptr()
    grads = tree_map(lambda t: torch.randn(t.shape, generator=torch.Generator().manual_seed(
        t.numel())), params)
    cfg = adamw.AdamWConfig(lr=1e-2, grad_clip=1e3, warmup_steps=1)
    mg = sharding.shard_params(grads, mesh, arch.family, arch.parallelism)
    state = adamw.init(cfg, mp)
    assert all(s["final_norm"]["scale"] is state.m.shards[0]["final_norm"]["scale"]
               for s in state.m.shards)
    adamw.update(cfg, mg, state, mp)
    one, _, _ = adamw.update(cfg, grads, adamw.init(cfg, params), params)
    for a, b in zip(tree_leaves(sharding.unshard_params(mp)), tree_leaves(one)):
        assert torch.equal(a, b)
    want = sharding.shard_params(one, mesh, arch.family, arch.parallelism)
    for tree, wtree in zip(mp.shards, want.shards):    # every copy, not the first alone
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tree), tree_leaves(wtree)))


@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 2)], ids=lambda s: f"m{s[0]}d{s[1]}")
@pytest.mark.parametrize("arch_id", ["llama3-405b", "qwen2-7b", "granite-moe-1b-a400m"])
def test_global_norm_counts_each_element_once(arch_id, mesh_shape):
    """The norm over the blocks equals the logical tree's; summing every
    local block instead counts the replicated ones once a copy."""
    m, d = mesh_shape
    arch = registry.get_config(arch_id)
    params = steps.build_model(arch, smoke=True).init(torch.Generator().manual_seed(1), CPU)
    mesh = lm.make_lm_mesh(m, data=d, device=CPU)
    mp = sharding.shard_params(params, mesh, arch.family, arch.parallelism)
    got = sharding.global_norm(mp.shards, mp.specs, mesh)
    want = adamw.global_norm(params)
    assert _rel(got, want) <= 1e-6
    naive = torch.sqrt(sum(torch.sum(t.float() ** 2) for s in mp.shards for t in tree_leaves(s)))
    assert float(naive) > float(want) * 1.01


@pytest.mark.parametrize("data", [1, 2])
def test_each_token_counted_once_under_fsdp_tp(data):
    """llama3-405b at `model` 4: the shards of a `model` line share their
    rows and the vocabulary-split logits are gathered over the line; the
    loss is the one-shard loss and the reduced gradients the one-shard
    gradients."""
    arch = registry.get_config("llama3-405b")
    one = steps.build_model(arch, smoke=True)
    params = one.init(torch.Generator().manual_seed(4), CPU)
    mesh = lm.make_lm_mesh(4, data=data, device=CPU)
    model = steps.build_model(arch, smoke=True, mesh=mesh)
    mp = sharding.shard_params(params, mesh, arch.family, arch.parallelism)
    assert mp.specs["embed"]["table"][0] == "model"
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (4, 13)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    l1, g1 = adamw.value_and_grad(one.loss_fn, params, batch)
    lm_, gm = adamw.value_and_grad(model.loss_fn, mp, batch)
    assert _rel(lm_, l1) <= ONE_SHARD_RTOL
    red = gm._replace(shards=sharding.reduce_replicated(gm.shards, mesh, gm.specs))
    for name, a, b in zip(*tree_flatten(sharding.unshard_params(red)), tree_leaves(g1)):
        rms = float(b.pow(2).mean().sqrt())
        assert float((a - b).abs().max()) <= 1e-5 * rms, name


def test_mesh_forward_records_a_graph_and_serving_builds_none():
    arch = registry.get_config("qwen2-7b")
    mesh = lm.make_lm_mesh(2, device=CPU)
    model = steps.build_model(arch, smoke=True, mesh=mesh)
    mp = model.init(torch.Generator().manual_seed(0))
    for t in sharding.distinct_leaves(mp)[0]:
        t.requires_grad_()
    toks = torch.zeros((2, 5), dtype=torch.long)
    assert model.forward(mp, {"tokens": toks}).requires_grad
    assert model.loss_fn(mp, {"tokens": toks, "labels": toks}).requires_grad
    logits, cache = model.prefill(mp, {"tokens": toks}, 8)
    assert not any(p.requires_grad for p in logits.parts + cache.k + cache.v)


def test_train_state_shardings_and_microbatch_constraint():
    """The state's specs are ``param_specs`` (the moments too) and the step
    replicated; each microbatch-stacked leaf is cut by the reference's
    fallback, its batch entry ``batch_spec``'s for the microbatch."""
    for arch_id, (m, d) in (("llama3-405b", (4, 2)), ("qwen2-7b", (2, 2)),
                            ("granite-moe-1b-a400m", (4, 1)), ("qwen2-vl-7b", (2, 2))):
        arch = registry.get_config(arch_id)
        one = steps.build_model(arch, smoke=True)
        mesh = lm.make_lm_mesh(m, data=d, device=CPU)
        like = steps.init_train_state(one, adamw.AdamWConfig(), torch.Generator(), "meta")
        sh = steps.train_state_shardings(like, mesh, arch.family, arch.parallelism)
        specs = sharding.param_specs(like.params, mesh.shape, arch.family, arch.parallelism)
        assert sh.params == sh.opt.m == sh.opt.v == specs and sh.opt.step == ()
        constrain = steps.microbatch_constraint(mesh, arch.parallelism)
        for b in (2, 4, 8):
            batch = {"tokens": torch.arange(b * 2 * 3).reshape(2 * b, 3),
                     "positions": torch.arange(3 * 2 * b * 3).reshape(3, 2 * b, 3)}
            for key, x in batch.items():
                stacked = adamw.stack_micro(key, x, 2)
                laid = constrain(key, stacked)
                bdim = 2 if key == "positions" else 1
                want = sharding.batch_spec(key, stacked[0], mesh.shape, arch.parallelism)
                assert laid.spec[bdim] == want[bdim - 1] and len(laid.spec) == stacked.dim()
                for part, c in zip(laid.parts, mesh.local):
                    assert torch.equal(part, sharding.shard(stacked, laid.spec, mesh.shape, c))
                assert torch.equal(laid.micro(1).parts[-1], laid.parts[-1][1])


# ------------------------------------------------------- process groups ---

@pytest.fixture(scope="module")
def one_process_train():
    return W.train_scenarios(lm.make_lm_mesh(2, data=2, device=CPU))


@pytest.mark.parametrize("world", WORLDS)
def test_gloo_worlds_equal_one_process(worlds, one_process_train, world):
    (runs, t_end), want = worlds, one_process_train
    d, procs = runs[world]
    while any(p.poll() is None for p, _ in procs) and time.monotonic() < t_end:
        time.sleep(0.05)
    for rank, (p, log) in enumerate(procs):
        log.flush()
        assert p.poll() == 0, (d / f"rank{rank}.log").read_text()[-6000:]
    got = [np.load(d / f"rank{rank}.npz") for rank in range(world)]
    for other in got[1:]:
        assert set(other.files) == set(got[0].files)
        for k in got[0].files:
            np.testing.assert_array_equal(other[k], got[0][k], err_msg=k)
    assert set(got[0].files) == set(want)
    for k, v in want.items():
        g, v = got[0][k], np.asarray(v)
        if re.search(r":grad_norm\d$", k):
            assert float(g) == float(v), k
        elif re.search(r":loss\d$", k):
            assert _rel(g, v) <= GLOO_LOSS_RTOL, k
        elif not k.endswith("attn_wk_b"):       # zero gradient in exact arithmetic
            assert float(np.abs(g - v).max()) <= GLOO_PARAM_TOL * float(np.abs(v).max()), k


# ----------------------------------------------------------------- pieces ---

def test_wire_bytes_match_reference():
    tree = {"a": np.zeros((5, 7), np.float32), "b": [np.zeros(11, np.float32)]}
    for method in ("none", "bf16", "int8"):
        assert compression.wire_bytes(tree_map(torch.from_numpy, tree), method) == \
            j_compression.wire_bytes(tree, method)


def test_ef_init_is_float32_zeros_beside_each_leaf():
    grads = {"a": torch.ones(3, dtype=torch.bfloat16), "b": [torch.ones(2, 2)]}
    ef = compression.ef_init(grads)
    assert all(t.dtype == torch.float32 and not t.any() for t in tree_leaves(ef.residual))
    assert [t.shape for t in tree_leaves(ef.residual)] == [t.shape for t in tree_leaves(grads)]


# ------------------------------------------------------------ checkpoints ---

def _as_dict(state) -> dict:
    """A train state as the nested dict the reference's checkpointer names
    alike (``params_...``, ``opt_step``, ``opt_m_...``)."""
    return {"params": state.params, "opt": {"step": state.opt.step, "m": state.opt.m,
                                            "v": state.opt.v}}


def _mesh_state(arch_id: str, m: int, d: int, seed: int = 0):
    arch = registry.get_config(arch_id)
    mesh = lm.make_lm_mesh(m, data=d, device=CPU)
    model = steps.build_model(arch, smoke=True, mesh=mesh)
    opt = adamw.AdamWConfig(**OPT)
    state = steps.init_train_state(model, opt, torch.Generator().manual_seed(seed))
    step = steps.make_train_step(model, opt, 1, mesh=mesh, policy=arch.parallelism)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (4, 9)))
    state, _ = step(state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return arch, mesh, state


def test_mesh_checkpoint_is_the_one_card_checkpoint(tmp_path):
    """A ``fsdp_tp`` state on ``data 2 x model 2`` saved by the port: its
    files equal a one-card save of the same logical state (names, shapes,
    dtypes, bytes), and the reference's ``Checkpointer.restore`` reads the
    logical arrays back (``unshard_params``)."""
    arch, mesh, state = _mesh_state("llama3-405b", 2, 2)
    ck = Checkpointer(str(tmp_path / "mesh"))
    ck.save(1, state, extra={"step": 1}, blocking=True)
    ck.close()
    logical = sharding.logical_tree(state)
    assert isinstance(logical.params, dict)
    ck = Checkpointer(str(tmp_path / "one"))
    ck.save(1, logical, extra={"step": 1}, blocking=True)
    ck.close()
    a, b = tmp_path / "mesh" / "step_00000001", tmp_path / "one" / "step_00000001"
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir()) and "params_blocks_0_attn_wq_w.npy" in names
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    like = tree_map(lambda t: t.numpy(), _as_dict(logical))
    jtree, extra = JCheckpointer(str(tmp_path / "mesh")).restore(1, like)
    assert extra == {"step": 1}
    got = dict(zip(*tree_flatten(jtree)))
    for name, t in zip(*tree_flatten(_as_dict(logical))):
        np.testing.assert_array_equal(np.asarray(got[name]), t.numpy(), err_msg=name)
    full = sharding.unshard_params(state.params)
    for name, t in zip(*tree_flatten(full, "params")):
        np.testing.assert_array_equal(np.asarray(got[name]), t.numpy())


@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2)], ids=lambda s: f"m{s[0]}d{s[1]}")
def test_restore_to_mesh_of_a_reference_checkpoint(tmp_path, mesh_shape):
    """The reference writes a granite (``ep_dp``) train state's arrays; the
    port's ``restore_to_mesh`` gives each local shard ``shard`` of them bit
    for bit, a leaf whose spec splits nothing as one tensor the shards
    share, and the step as it was."""
    m, d = mesh_shape
    arch = registry.get_config("granite-moe-1b-a400m")
    one = steps.build_model(arch, smoke=True)
    opt = adamw.AdamWConfig()
    state = steps.init_train_state(one, opt, torch.Generator().manual_seed(8), CPU)
    state = state._replace(opt=state.opt._replace(
        step=torch.tensor(5, dtype=torch.int32),
        m=tree_map(lambda t: torch.randn(t.shape, generator=torch.Generator().manual_seed(
            t.numel())), state.opt.m)))
    jck = JCheckpointer(str(tmp_path))
    jck.save(5, tree_map(lambda t: t.numpy(), _as_dict(state)), extra={"step": 5}, blocking=True)
    jck.close()
    mesh = lm.make_lm_mesh(m, data=d, device=CPU)
    like = steps.init_train_state(one, opt, torch.Generator(), "meta")
    got, extra = elastic.restore_to_mesh(Checkpointer(str(tmp_path)), 5, like, mesh, arch.family,
                                         arch.parallelism)
    assert extra == {"step": 5} and int(got.opt.step) == 5
    for mine, full in ((got.params, state.params), (got.opt.m, state.opt.m),
                       (got.opt.v, state.opt.v)):
        want = sharding.shard_params(full, mesh, arch.family, arch.parallelism)
        assert mine.specs == want.specs
        for tree, wtree in zip(mine.shards, want.shards):
            for a, b in zip(tree_leaves(tree), tree_leaves(wtree)):
                assert a.dtype == b.dtype and torch.equal(a, b)
        for j, tree in enumerate(mine.shards):    # shared exactly where shard_params shares
            for a, b, a0, b0 in zip(tree_leaves(tree), tree_leaves(want.shards[j]),
                                    tree_leaves(mine.shards[0]), tree_leaves(want.shards[0])):
                assert (a is a0) == (b is b0)


def test_data_shard_slice_matches_reference():
    for d, m in ((1, 2), (2, 2), (4, 2), (2, 4)):
        jm = AbstractMesh((d, m), ("data", "model"))
        mesh = lm.make_lm_mesh(m, data=d, device=CPU)
        for batch in (8, 6, 3):
            try:
                want = j_elastic.data_shard_slice(batch, jm)
            except AssertionError:
                with pytest.raises(ValueError, match="does not split"):
                    elastic.data_shard_slice(batch, mesh)
            else:
                assert elastic.data_shard_slice(batch, mesh) == want


# -------------------------------------------------------------------- CLI ---

CLI = ["--smoke", "--batch", "4", "--seq", "16", "--micro", "2", "--log-every", "100",
       "--device", CPU]


@pytest.mark.parametrize("arch_id", ["qwen2-7b", "llama3-405b", "granite-moe-1b-a400m"])
def test_train_cli_model_parallel_equals_one_shard(arch_id):
    one = train.run(["--arch", arch_id, "--steps", "4"] + CLI)
    two = train.run(["--arch", arch_id, "--steps", "4", "--model-parallel", "2"] + CLI)
    assert len(two["losses"]) == 4 and two["state"].params.mesh.model == 2
    for a, b in zip(two["losses"], one["losses"]):
        assert _rel(a, b) <= ONE_SHARD_RTOL


def test_train_cli_resumes_onto_other_meshes(tmp_path, monkeypatch, capsys):
    """Six steps of qwen2-7b: stopped by ``RunGuard`` after step 2 on
    ``--model-parallel 2`` (a checkpoint at 2), resumed onto 4 and stopped
    after step 4, resumed onto 1 to the end: the losses and the final
    parameters are an uninterrupted m = 2 run's."""
    argv = ["--arch", "qwen2-7b", "--steps", "6", "--ckpt-dir", str(tmp_path)] + CLI
    whole = train.run(["--arch", "qwen2-7b", "--steps", "6", "--model-parallel", "2"] + CLI)
    make = train.make_batch_fn

    def stop_at(n):
        def make_stopping(*a, **kw):
            get = make(*a, **kw)

            def stopping(step):
                if step == n - 1:
                    signal.raise_signal(signal.SIGTERM)
                return get(step)
            return stopping
        return make_stopping

    monkeypatch.setattr(train, "make_batch_fn", stop_at(2))
    a = train.run(argv + ["--model-parallel", "2"])
    monkeypatch.setattr(train, "make_batch_fn", stop_at(4))
    b = train.run(argv + ["--model-parallel", "4", "--resume"])
    monkeypatch.setattr(train, "make_batch_fn", make)
    c = train.run(argv + ["--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 2 onto LMMesh(data=1, model=4" in out
    assert "resumed from step 4 onto cpu" in out
    assert a["stopped"] and b["stopped"] and (b["start_step"], c["start_step"]) == (2, 4)
    losses = a["losses"] + b["losses"] + c["losses"]
    assert len(losses) == 6
    for x, y in zip(losses, whole["losses"]):
        assert _rel(x, y) <= LOSS_RTOL
    final = sharding.unshard_params(whole["state"].params)
    for name, p, q in zip(*tree_flatten(c["state"].params), tree_leaves(final)):
        if not name.endswith("attn_wk_b"):      # zero gradient in exact arithmetic
            assert float((p - q).abs().max()) <= 1e-5 * float(q.abs().max()), name


def test_train_cli_mesh_arguments():
    with pytest.raises(ValueError, match="disagrees"):
        train.run(["--arch", "qwen2-7b", "--model-parallel", "4"] + CLI,
                  mesh=lm.make_lm_mesh(2, device=CPU))
    rec = train.run(["--arch", "qwen2-vl-7b", "--steps", "2"] + CLI,
                    mesh=lm.make_lm_mesh(2, data=2, device=CPU))
    assert rec["state"].params.mesh.data == 2 and all(np.isfinite(rec["losses"]))


# ------------------------- against the reference (its subprocess awaited) ---

# zamba2's mesh steps drift from the one-shard steps by more than
# ONE_SHARD_RTOL by the third step (its gradient norm read 1.6e-6 at m = 2
# and 1.0e-5 at m = 4: AdamW's first update is about lr x sign(g), so an
# element whose gradient is rounding noise moves a whole step either way);
# test_torch_lm_families_mesh holds its steps against the reference
@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: f"m{s[0]}d{s[1]}")
@pytest.mark.parametrize("arch_id", [a for a in R.TRAIN_ARCHS if a != "zamba2-2.7b"])
def test_mesh_train_steps_match_reference_and_one_shard(ref, one_shard, arch_id, mesh_shape):
    r, inp = ref
    m, d = mesh_shape
    arch = registry.get_config(arch_id)
    mesh = lm.make_lm_mesh(m, data=d, device=CPU)
    model = R.train_model(arch_id, mesh=mesh)
    state = _state(inp, arch_id, mesh)
    step = steps.make_train_step(model, adamw.AdamWConfig(**OPT), R.TRAIN["micro"], mesh=mesh,
                                 policy=arch.parallelism)
    one, one_params1 = one_shard(arch_id)
    grads = R.unflat({k: r[k] for k in r.files if k.startswith(f"{arch_id}:grad/")},
                     f"{arch_id}:grad")
    for i, b in enumerate(_batches(inp, arch_id)):
        state, met = step(state, b)
        assert _rel(met["loss"], r[f"{arch_id}:loss{i}"]) <= LOSS_RTOL, i
        assert _rel(met["grad_norm"], r[f"{arch_id}:grad_norm{i}"]) <= GRAD_TOL, i
        assert float(met["lr"]) == pytest.approx(float(r[f"{arch_id}:lr{i}"]), rel=1e-7)
        assert _rel(met["loss"], one[i]["loss"]) <= ONE_SHARD_RTOL, i
        assert _rel(met["grad_norm"], one[i]["grad_norm"]) <= ONE_SHARD_RTOL, i
        assert int(state.opt.step) == i + 1
        if i == 0:
            got = lm_to_arrays(sharding.unshard_params(state.params))
            want = R.unflat({k: r[k] for k in r.files if k.startswith(f"{arch_id}:params1/")},
                            f"{arch_id}:params1")
            lr = float(r[f"{arch_id}:lr0"])
            assert _params_close(got, want, grads, lr, "reference") > 0
            assert _params_close(got, one_params1, grads, lr, "one shard") > 0


def test_moe_apply_ep_gradient_matches_reference(ref):
    """x [4, 64, 32] split B over data and T over model on a 2 x 4 mesh, 8
    experts top-2 at capacity factor 1.0 (tokens drop): the gradients of
    sum(y * cot) + 3 aux through both all-to-alls."""
    r, inp = ref
    mesh = lm.make_lm_mesh(4, data=2, device=CPU)
    x_spec = (("data",), "model", None)
    x = torch.from_numpy(inp["ep:x"])
    cot = torch.from_numpy(inp["ep:cot"])
    router = torch.from_numpy(inp["ep/router/w"]).requires_grad_()
    stacks = {k: torch.from_numpy(inp[f"ep/{k}"]) for k in moe.EXPERT_STACKS}
    xs = [sharding.shard(x, x_spec, mesh.shape, c).requires_grad_() for c in mesh.local]
    blocks = [{k: sharding.shard(v, moe.EP_SPEC, mesh.shape, c).requires_grad_()
               for k, v in stacks.items()} for c in mesh.local]
    pp = [dict(router={"w": router}, **b) for b in blocks]
    y, aux = moe.moe_apply_ep(pp, xs, top_k=R.EP["top_k"], n_experts=R.EP["experts"], mesh=mesh,
                              x_spec=x_spec, capacity_factor=R.EP["drop_cf"])
    cots = [sharding.shard(cot, x_spec, mesh.shape, c) for c in mesh.local]
    (sum(torch.sum(a * b) for a, b in zip(y, cots)) + R.EP_AUX_COEF * aux).backward()
    np.testing.assert_allclose(sharding.unshard([t.grad for t in xs], x_spec, mesh.shape),
                               r["ep:grad:x"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(router.grad, r["ep:grad/router/w"], rtol=1e-5, atol=1e-5)
    for k in moe.EXPERT_STACKS:
        per = [b[k].grad for b in blocks]         # each data coordinate's copy: its rows' part
        summed = mesh.psum_distinct(per, "data")
        np.testing.assert_allclose(sharding.unshard(summed, moe.EP_SPEC, mesh.shape),
                                   r[f"ep:grad/{k}"], rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("method", ["none", "bf16", "int8"])
@pytest.mark.parametrize("n", R.COMPRESS_DATA)
def test_compressed_psum_matches_reference(ref, n, method):
    r, inp = ref
    mesh = lm.make_lm_mesh(1, data=n, device=CPU)
    g_all = R.unflat({k: inp[k] for k in inp.files if k.startswith(f"cmp{n}:g/")}, f"cmp{n}:g")
    r_all = R.unflat({k: inp[k] for k in inp.files if k.startswith(f"cmp{n}:r/")}, f"cmp{n}:r")
    grads = [{k: torch.from_numpy(v[j].copy()) for k, v in g_all.items()} for j in range(n)]
    ef = compression.ErrorFeedbackState(
        residual=[{k: torch.from_numpy(v[j].copy()) for k, v in r_all.items()} for j in range(n)])
    out, new = compression.compressed_psum(grads, ef, mesh, axis="data", method=method)
    for j in range(n):
        for k in g_all:
            np.testing.assert_array_equal(out[j][k].numpy(), r[f"cmp{n}:{method}:mean/{k}"][j],
                                          err_msg=f"mean {k} shard {j}")
            assert out[j][k].dtype == grads[j][k].dtype
            g32 = grads[j][k].float() + ef.residual[j][k]
            want = r[f"cmp{n}:{method}:residual/{k}"][j]
            if method == "int8":
                q, scale = compression.compress_int8(g32)
                assert torch.equal(new.residual[j][k],
                                   g32 - compression.decompress_int8(q, scale))
                fused = (g32.double() - q.double() * scale.double()).float()   # one rounding
                np.testing.assert_array_equal(fused.numpy(), want, err_msg=f"{k} shard {j}")
            else:
                np.testing.assert_array_equal(new.residual[j][k].numpy(), want)
            if method == "bf16":
                deq = compression.decompress_bf16(compression.compress_bf16(g32))
                assert torch.equal(new.residual[j][k], g32 - deq)
    assert np.array_equal(compression.compress_int8(torch.tensor([127.0, 0.5, 1.5, 2.5, -2.5]))[0],
                          np.array([127, 0, 2, 2, -2], np.int8))      # half to even
    with pytest.raises(ValueError, match="unknown compression"):
        compression.compressed_psum(grads, ef, mesh, method="fp8")
