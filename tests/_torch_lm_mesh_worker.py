"""One rank of the port's LM mesh over gloo, for ``test_torch_lm_mesh``
and ``test_torch_lm_train_mesh``.

    python tests/_torch_lm_mesh_worker.py OUT RANK WORLD [DATA MODEL [KIND]]

Started once per rank by a test.  It joins a gloo group of WORLD ranks
through a ``FileStore`` in OUT (collectives time out after 60 s) as an LM
mesh (``launch.mesh.init_lm_mesh``) and writes what it got to
``OUT/rank<RANK>.npz``: without DATA and MODEL a ``data 1 x model WORLD``
mesh, one shard a rank, running ``scenarios`` (serving); with them a
``DATA x MODEL`` mesh running ``train_scenarios``, or with KIND
``families`` ``family_scenarios`` (the hybrid, serving and training).
Torch runs on one thread.  The tests run the same scenarios on a
one-process mesh for the comparison.
"""
from __future__ import annotations

import pathlib
import sys

import numpy as np
import torch

# (arch, moe_impl): fsdp_tp (tensor parallel: the masked embedding, the
# row-parallel sums, V-split greedy), ep_dp with the all-to-all prefill,
# fsdp (per-layer gathers only)
CASES = (("llama3-405b", None), ("granite-moe-1b-a400m", "ep_a2a"), ("qwen2-7b", None))
STEPS = 3
# training: (arch, moe_impl) two steps of two microbatches each: fsdp_tp
# (the vocabulary-split logits gathered, the row-parallel sums), ep_dp
# with the all-to-all dispatch and its reverse in backward, fsdp
TRAIN_CASES = (("llama3-405b", None), ("granite-moe-1b-a400m", "ep_a2a"), ("qwen2-7b", None))
TRAIN_STEPS = 2


def scenarios(mesh) -> dict:
    """Prefill and ``STEPS`` greedy decode steps of each case's smoke model
    on ``mesh`` (the logits gathered), then the ``Server`` on it, greedy and
    sampled."""
    from repro_torch.configs import registry
    from repro_torch.launch import steps
    from repro_torch.launch.serve import Server

    out = {}
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (4, 9)))
    for arch_id, impl in CASES:
        model = steps.build_model(registry.get_config(arch_id), smoke=True, moe_impl=impl,
                                  mesh=mesh)
        params = model.init(torch.Generator().manual_seed(3))
        lg, cache = model.prefill(params, {"tokens": toks}, 16)
        out[f"{arch_id}:prefill"] = lg.gather().numpy()
        for i in range(STEPS):
            tok = lg.greedy()
            out[f"{arch_id}:tok{i}"] = tok.numpy()
            lg, cache = model.decode_step(params, tok, cache)
            out[f"{arch_id}:decode{i}"] = lg.gather().numpy()
    server = Server("llama3-405b", mesh=mesh, max_len=16, seed=5)
    out["greedy"], _ = server.generate(toks.numpy(), 4)
    out["sampled"], _ = server.generate(toks.numpy(), 4, temperature=0.8, seed=2)
    return out


def train_scenarios(mesh) -> dict:
    """``TRAIN_STEPS`` mesh train steps (two microbatches of a batch 4 x 9
    from numpy) of each case's smoke model from its seeded state: each
    step's loss and gradient norm, and the parameters after them gathered
    (``sharding.logical_tree``: a gather on every rank)."""
    from repro_torch.configs import registry
    from repro_torch.distributed.sharding import logical_tree
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_flatten

    out = {}
    rng = np.random.default_rng(9)
    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=10)
    for arch_id, impl in TRAIN_CASES:
        arch = registry.get_config(arch_id)
        model = steps.build_model(arch, smoke=True, moe_impl=impl, mesh=mesh)
        state = steps.init_train_state(model, opt, torch.Generator().manual_seed(3))
        step = steps.make_train_step(model, opt, 2, mesh=mesh, policy=arch.parallelism)
        for i in range(TRAIN_STEPS):
            toks = torch.from_numpy(rng.integers(0, model.config.vocab, (4, 10)))
            state, met = step(state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
            out[f"{arch_id}:loss{i}"] = float(met["loss"])
            out[f"{arch_id}:grad_norm{i}"] = float(met["grad_norm"])
        names, leaves = tree_flatten(logical_tree(state.params))
        out.update({f"{arch_id}:{n}": t.numpy() for n, t in zip(names, leaves)})
    return out


def family_scenarios(mesh) -> dict:
    """zamba2-2.7b's smoke model (``fsdp_tp``: the Mamba2 layers' heads and
    the shared block's over `model`) on ``mesh``: prefill and ``STEPS``
    greedy decode steps, the ``Server`` greedy and sampled, and one train
    step of two microbatches (its loss, gradient norm and the parameters
    after it, gathered)."""
    from repro_torch.configs import registry
    from repro_torch.distributed.sharding import logical_tree
    from repro_torch.launch import steps
    from repro_torch.launch.serve import Server
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_flatten

    arch_id = "zamba2-2.7b"
    arch = registry.get_config(arch_id)
    out = {}
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (4, 9)))
    model = steps.build_model(arch, smoke=True, mesh=mesh)
    params = model.init(torch.Generator().manual_seed(3))
    lg, cache = model.prefill(params, {"tokens": toks}, 16)
    out["prefill"] = lg.gather().numpy()
    for i in range(STEPS):
        tok = lg.greedy()
        out[f"tok{i}"] = tok.numpy()
        lg, cache = model.decode_step(params, tok, cache)
        out[f"decode{i}"] = lg.gather().numpy()
    server = Server(arch_id, mesh=mesh, max_len=16, seed=5)
    out["greedy"], _ = server.generate(toks.numpy(), 4)
    out["sampled"], _ = server.generate(toks.numpy(), 4, temperature=0.8, seed=2)
    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=10)
    state = steps.init_train_state(model, opt, torch.Generator().manual_seed(3))
    step = steps.make_train_step(model, opt, 2, mesh=mesh, policy=arch.parallelism)
    seq = torch.from_numpy(np.random.default_rng(9).integers(0, 256, (4, 10)))
    state, met = step(state, {"tokens": seq[:, :-1], "labels": seq[:, 1:]})
    out["loss"], out["grad_norm"] = float(met["loss"]), float(met["grad_norm"])
    names, leaves = tree_flatten(logical_tree(state.params))
    out.update({f"param:{n}": t.numpy() for n, t in zip(names, leaves)})
    return out


def main(out: str, rank: str, world: str, data: str | None = None,
         model: str | None = None, kind: str = "train") -> int:
    from repro_torch.launch.mesh import init_lm_mesh

    torch.set_num_threads(1)
    out_dir = pathlib.Path(out)
    store = torch.distributed.FileStore(str(out_dir / "store"), int(world))
    train = data is not None
    mesh = init_lm_mesh(int(model) if train else int(world), data=int(data) if train else 1,
                        device="cpu", store=store, rank=int(rank), world=int(world),
                        timeout_s=60.0)
    try:
        got = (scenarios(mesh) if not train else
               family_scenarios(mesh) if kind == "families" else train_scenarios(mesh))
        np.savez(out_dir / f"rank{rank}.npz", **got)
    finally:
        mesh.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:7]))
