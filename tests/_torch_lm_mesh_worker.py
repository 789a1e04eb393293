"""One rank of the port's LM mesh over gloo, for ``test_torch_lm_mesh``.

    python tests/_torch_lm_mesh_worker.py OUT RANK WORLD

Started once per rank by the test.  It joins a gloo group of WORLD ranks
through a ``FileStore`` in OUT (collectives time out after 60 s) as a
``data 1 x model WORLD`` LM mesh (``launch.mesh.init_lm_mesh``), one shard
a rank, runs ``scenarios`` and writes what it got to ``OUT/rank<RANK>.npz``.
Torch runs on one thread.  The test runs the same ``scenarios`` on a
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


def main(out: str, rank: str, world: str) -> int:
    from repro_torch.launch.mesh import init_lm_mesh

    torch.set_num_threads(1)
    out_dir = pathlib.Path(out)
    store = torch.distributed.FileStore(str(out_dir / "store"), int(world))
    mesh = init_lm_mesh(int(world), device="cpu", store=store, rank=int(rank),
                        world=int(world), timeout_s=60.0)
    try:
        np.savez(out_dir / f"rank{rank}.npz", **scenarios(mesh))
    finally:
        mesh.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:4]))
