"""The LM trainer (counterpart of ``repro/launch/train.py``):
``python -m repro_torch.launch.train``.

Runs any ``--arch`` on one card (its full config, or with ``--smoke`` the
reduced config of the same family, which also trains on the CPU with
``--device cpu``), with the reference's substrate wired end to end:

  * the train step (``steps.make_train_step``: microbatched gradients,
    AdamW, activation checkpointing as the config has it);
  * the counter-based data pipeline (``data.TokenPipeline``): a restart
    resumes from the step counter alone;
  * asynchronous committed checkpoints (``checkpoint.Checkpointer``):
    ``--resume`` restarts from the newest committed step
    (``fault_tolerance.resume_or_init``);
  * ``RunGuard`` (SIGTERM -> checkpoint at the step boundary, then stop)
    and ``StepWatchdog`` straggler flagging.

The device is the card unless ``--device`` names another; without a card
it raises.  ``--model-parallel m`` above 1 trains any of the ten
architectures on the one-process LM mesh ``make_lm_mesh(m)`` (data 1,
model m; all shards on the one device) under the arch's policy, as
``Server(model_parallel=m)`` serves it; ``run(argv, mesh=)`` takes an
``LMMesh`` made by the caller instead (``init_lm_mesh`` over a process
group: rank 0 writes the checkpoints).  Checkpoints are saved logical, so
``--resume`` restores the newest onto the current mesh whatever mesh
wrote it (``elastic.restore_to_mesh``).  The mesh runs of the ssm,
hybrid and encdec families are tested on the CPU by ``PYTHONPATH=src
python -m pytest -q tests/test_torch_lm_families_mesh.py`` and on the card
by phase 18 of ``python3 chip_smoke.py``.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b --smoke \\
      --steps 50 --batch 16 --seq 128 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m --smoke \\
      --steps 20 --ckpt-dir /tmp/ck --resume --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b --smoke \\
      --model-parallel 2 --steps 20 --ckpt-dir /tmp/ckm --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b --smoke \\
      --model-parallel 4 --steps 40 --ckpt-dir /tmp/ckm --resume --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b --smoke \\
      --model-parallel 2 --steps 20 --device cpu
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.data import TokenPipeline, TokenPipelineConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import elastic
from repro_torch.distributed.fault_tolerance import RunGuard, StepWatchdog, resume_or_init
from repro_torch.distributed.sharding import logical_tree
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_lm_mesh
from repro_torch.optim import adamw


def make_batch_fn(model, family: str, pipe: TokenPipeline, seq: int, device):
    """Adapt the token pipeline to the family's batch dict on ``device``:
    the encoder's frames are standard normals from ``default_rng(step)``
    rounded to bfloat16 through float32, the VLM's positions the text's
    ``arange`` in all three M-RoPE components."""
    d_model = getattr(model.config, "d_model", 0)

    def get(step: int) -> dict:
        b = pipe.batch(step)
        out = {k: torch.from_numpy(v) for k, v in b.items()}
        if family == "encdec":
            rng = np.random.default_rng(step)
            frames = rng.standard_normal((b["tokens"].shape[0], seq, d_model)).astype(np.float32)
            out["frames"] = torch.from_numpy(frames).to(torch.bfloat16)
        if family == "vlm":
            pos = np.broadcast_to(np.arange(seq, dtype=np.int32)[None], b["tokens"].shape)
            out["positions"] = torch.from_numpy(
                np.ascontiguousarray(np.broadcast_to(pos[None], (3,) + pos.shape)))
        return {k: v.to(device) for k, v in out.items()}

    return get


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="train an LM on the token pipeline")
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, which must be present)")
    return ap.parse_args(argv)


def run(argv=None, mesh=None) -> dict:
    """Train as ``main`` does and return the run's record: ``losses``,
    ``grad_norms``, ``lrs``, ``step_s`` (the seconds of each step run), ``start_step``,
    ``stopped`` (the guard's stop), ``flagged`` (straggler steps) and the
    final ``state`` (on a mesh: ``MeshParams`` of this rank's blocks).
    ``mesh`` (an ``LMMesh``) replaces ``--model-parallel``'s one-process
    mesh; every rank of its group runs ``run`` alike."""
    args = parse_args(argv)
    arch = get_config(args.arch)
    if mesh is not None:
        if args.model_parallel not in (1, mesh.model):
            raise ValueError(f"--model-parallel {args.model_parallel} disagrees with {mesh}")
        dev = mesh.device
    else:
        dev = resolve_device(args.device)
        if args.model_parallel != 1:
            mesh = make_lm_mesh(args.model_parallel, device=dev)
    model = steps.build_model(arch, smoke=args.smoke, mesh=mesh)
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=min(50, args.steps),
                                total_steps=args.steps)
    train_step = steps.make_train_step(model, opt_cfg, args.micro, mesh=mesh,
                                       policy=arch.parallelism)
    pipe = TokenPipeline(TokenPipelineConfig(vocab=model.config.vocab, seq_len=args.seq,
                                             global_batch=args.batch, seed=args.seed))
    get_batch = make_batch_fn(model, arch.family, pipe, args.seq, dev)
    one_card = model if mesh is None else steps.build_model(arch, smoke=args.smoke)

    def init_fn():
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        return steps.init_train_state(model, opt_cfg, gen, dev)

    def like_fn():   # the one-card state's structure, shapes and dtypes; no memory
        return steps.init_train_state(one_card, opt_cfg, torch.Generator(), "meta")

    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    restore = None
    if mesh is not None:
        def restore(step, like):
            return elastic.restore_to_mesh(ckpt, step, like, mesh, arch.family, arch.parallelism)
    writer = mesh is None or mesh.rank == 0
    guard = RunGuard()
    watchdog = StepWatchdog(on_straggler=lambda s, t, mu: print(
        f"[watchdog] step {s} took {t:.2f}s (mean {mu:.2f}s) — straggler flagged", flush=True))
    rec = {"losses": [], "grad_norms": [], "lrs": [], "step_s": [], "stopped": False}
    try:
        start_step = 0
        if ckpt and args.resume:
            state, start_step, extra = resume_or_init(ckpt, init_fn, like_fn, device=dev,
                                                      restore=restore)
            if start_step:
                # the optimizer's step lives in the state; the data resumes by counter
                start_step = int(extra.get("step", start_step))
                print(f"resumed from step {start_step} onto {dev if mesh is None else mesh}",
                      flush=True)
        else:
            state = init_fn()
        rec["start_step"] = start_step
        for step in range(start_step, args.steps):
            t0 = time.perf_counter()
            state, metrics = train_step(state, get_batch(step))
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            rec["losses"].append(loss)
            rec["grad_norms"].append(float(metrics["grad_norm"]))
            rec["lrs"].append(float(metrics["lr"]))
            rec["step_s"].append(dt)
            watchdog.record(step, dt)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss {loss:8.4f} gnorm {rec['grad_norms'][-1]:7.3f} "
                      f"lr {rec['lrs'][-1]:.2e} {dt * 1e3:7.1f}ms", flush=True)
            if ckpt and ((step + 1) % args.ckpt_every == 0 or guard.should_stop
                         or step == args.steps - 1):
                logical = logical_tree(state)    # on a process group: a gather on every rank
                if writer:
                    ckpt.save(step + 1, logical, extra={"step": step + 1},
                              blocking=guard.should_stop)
                del logical
            if guard.should_stop:
                rec["stopped"] = True
                print(f"preemption requested: checkpointed at step {step + 1}, exiting cleanly",
                      flush=True)
                break
        if ckpt:
            ckpt.wait()
    finally:
        guard.restore_handlers()
        if ckpt:
            ckpt.close()
    losses = rec["losses"]
    if losses:
        first = np.mean(losses[:5]) if len(losses) >= 5 else losses[0]
        last = np.mean(losses[-5:])
        print(f"done: loss {first:.4f} -> {last:.4f} "
              f"({len(watchdog.flagged)} straggler step(s) flagged)", flush=True)
    else:
        print(f"done: no step left to run (at step {start_step} of {args.steps})", flush=True)
    rec.update(state=state, flagged=list(watchdog.flagged))
    return rec


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
