"""Time LM serving of several checkouts of the port, each in a fresh process,
in the order given, on one card.

    python scripts/lm_decode_ab.py A B B A [--arch qwen2-7b] [--batches 4]

Each argument is the root of a checkout (for example one unpacked with
``git archive <commit> | tar -x -C <dir>``).  In its own process each
builds ``Server(arch, smoke=False)`` on the card from seed 0, warms it with
one short generate, then serves ``--batches`` batches of 8 prompts of 64
tokens, 32 new tokens each: the shapes of ``chip_smoke.py`` phase 14 (b).
Prints the card's ``nvidia-smi`` name and power limit, then one line a
checkout: its path and a JSON list of [prefill ms, decode tokens/s] a
batch.  Decode is bound by the host, so a comparison is made within one
call, alternating the checkouts (A B B A).
"""
import argparse
import json
import subprocess
import sys

CHILD = r'''
import json, sys
sys.path.insert(0, "src")
import numpy as np
from repro_torch.launch.serve import Server
arch, batches = sys.argv[1], int(sys.argv[2])
sv = Server(arch, smoke=False, max_len=96, seed=0)
prompts = np.random.default_rng(0).integers(0, sv.vocab, (8, 64)).astype(np.int32)
sv.generate(prompts, 4)
out = []
for _ in range(batches):
    _, st = sv.generate(prompts, 32)
    out.append((st["prefill_s"] * 1e3, st["decode_tok_per_s"]))
print("RESULT", json.dumps(out))
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="+")
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--batches", type=int, default=4)
    args = ap.parse_args()
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                   check=True)
    for root in args.checkouts:
        r = subprocess.run([sys.executable, "-c", CHILD, args.arch, str(args.batches)],
                           cwd=root, capture_output=True, text=True)
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
        if r.returncode or not lines:
            print(root, "failed:", r.stderr[-2000:], flush=True)
            return 1
        print(root, lines[0][len("RESULT "):], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
