"""``python -m repro_torch.analysis.lint``: the port's static contract
checker (counterpart of ``repro/analysis/lint.py``).

Five passes, one ``Finding`` type, one rule catalog, one CLI:

  * ``ast``      (``ast_lint``)      PIPA001-003, the source alone;
  * ``kernels``  (``contracts``)     PIPK001-005, the CUDA kernels' contracts;
  * ``hotpath``  (``hotpath_audit``) PIPJ001-004, the hot-path programs;
  * ``mesh``     (``mesh_audit``)    PIPS001-005, the sharded programs;
  * ``memory``   (``memory_audit``)  PIPM001-004, the allocator's ledger.

Findings print as ``file:line: RULE [symbol] message``.  The exit code is
0 iff every finding is in the baseline, which is checked in empty: a
finding is fixed, not baselined; the file is the reviewed escape hatch
for one that cannot be.  Baseline lines are ``RULE path:symbol`` (no line
numbers), ``#`` comments allowed.

The passes run on the card (``device``, default the card; ``run_all``
raises without one unless the CPU is asked for).  On the CPU the rules
that need the card (``CARD_ONLY``: the kernel resources, alignment and
coverage sweeps, PIPJ001's card cross-check and the allocator ledger) are
reported as skipped, with zero findings from them.  The CLI takes the card
when there is one and the CPU otherwise, and says which.

    PYTHONPATH=src python -m repro_torch.analysis.lint              # all passes
    PYTHONPATH=src python -m repro_torch.analysis.lint --pass ast   # one pass
    PYTHONPATH=src python -m repro_torch.analysis.lint --list-rules
    PYTHONPATH=src python -m repro_torch.analysis.lint --json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

RULES: dict[str, str] = {
    # kernel contracts (repro_torch.analysis.contracts)
    "PIPK001": "kernel resources at an admitted swept shape, from ptxas' report and the "
               "launch's own plan: a spill byte, registers x threads x min_blocks past the "
               "SM's 65,536 registers, static + dynamic shared memory past the per-block "
               "opt-in limit, or min_blocks blocks' shared memory past the SM's 228 KB "
               "(the __launch_bounds__ promise; card only)",
    "PIPK002": "kernel silently wrong on an input 4 bytes past a 16-byte boundary or a row "
               "width not a multiple of 4: neither equal to its plain version nor refused "
               "with ValueError (the 16-byte loads; card only)",
    "PIPK003": "swept output differs from the plain version at the registry's tolerance, "
               "keeps the allocator's poison (an element the grid never writes), or lies "
               "outside the poisoned blocks (the case tested nothing), at the edges of the "
               "wrapper's admitted range (card only)",
    "PIPK004": "kernel registry entry not paired: plain version unresolved, C symbol not in "
               "_build.SIGNATURES, counter not in kernels._MODULES, or a swept call that "
               "launched nothing (a stale entry)",
    "PIPK005": "__global__ function, SIGNATURES key, wrapper calling _build.library() or "
               "reference pallas_call site not claimed by exactly one registry entry, or "
               "an entry's symbol missing from the sources",
    # hot-path audit (repro_torch.analysis.hotpath_audit)
    "PIPJ001": "hot-path program forces other than its declared host syncs, a budget of "
               "its shape and the steps the run took (dispatch spy; on the card also counted "
               "by torch.cuda.set_sync_debug_mode, and the two counts must agree)",
    "PIPJ002": "float64/complex128 value inside a hot-path program",
    "PIPJ003": "in-place program's output not written into its donated argument's storage "
               "(the donation silently dropped: the peak holds the buffer twice)",
    "PIPJ004": "simulated serving session launched the gather kernels or the cross-shard "
               "merge at more distinct input shapes than |dtypes| x |beams| x |expansions| "
               "(|beams| for the merge): batch size leaks into the launch shape",
    # AST lint (repro_torch.analysis.ast_lint)
    "PIPA001": "Python if/while on a tensor expression inside a registered hot-path "
               "function (an undeclared implicit host sync)",
    "PIPA002": "host sync call (.item/.tolist/.cpu/.numpy, bool/int/float of a tensor) "
               "inside a registered hot-path function beyond its declared sync sites",
    "PIPA003": "mutable default argument",
    # mesh audit (repro_torch.analysis.mesh_audit)
    "PIPS001": "collective not in the program's declared set (ShardMesh spy); the "
               "per-shard search body must be collective-free",
    "PIPS002": "rank holds more than its S / W shards of a sharded operand (storage "
               "bytes), or a replicated operand not whole",
    "PIPS003": "per-shard halo packing priced at the BigANN-1B envelope over the card's "
               "memory (exact bytes, no tile padding)",
    "PIPS004": "sharded search crossed host <-> device outside transfers.to_device / "
               "to_host, or more often than TRANSFER_BUDGET",
    "PIPS005": "a shard body's op sequence differs across shard counts, or the program "
               "outside the bodies runs other source lines or ops at some S (the shard "
               "count leaked into Python control flow)",
    # memory audit (repro_torch.analysis.memory_audit)
    "PIPM001": "peak device bytes scale past the declared per-parameter exponent bound "
               "(bounded-memory contract: build programs never scale with the edge count E)",
    "PIPM002": "donated argument bytes not written in place (the peak holds the donated "
               "buffer twice)",
    "PIPM003": "program priced at the BigANN-1B per-shard envelope exceeds the card's "
               "memory",
    "PIPM004": "measured temp bytes exceed the program's declared workspace model x "
               "tolerance",
}

# reference rules with no port rule, and why
NOT_PORTED: dict[str, str] = {
    "PIPA004": "eager PyTorch has no static_argnames: no argument is traced, so no "
               "shape-controlling parameter can silently recompile",
    "PIPM005": "a regression gate on a checked-in memory envelope is benchmark work: card "
               "numbers are gated by the port's benchmark, not by the lint",
    "PIPM006": "the checked-in envelope record (ledger, exponents, price, roofline) it "
               "checks belongs to that benchmark as well",
}

# rules (or parts of them) that need the card; on the CPU they are skipped
CARD_ONLY: dict[str, str] = {
    "PIPK001": "ptxas' report and the launch plans come from the card's toolchain",
    "PIPK002": "the kernels run only on the card",
    "PIPK003": "the kernels run only on the card",
    "PIPJ001": "the cross-check against torch.cuda.set_sync_debug_mode (the budget itself "
               "is checked on the CPU)",
    "PIPM001": "torch keeps no allocator ledger on the CPU",
    "PIPM002": "torch keeps no allocator ledger on the CPU",
    "PIPM003": "priced with the ledger's program records",
    "PIPM004": "torch keeps no allocator ledger on the CPU",
}

PASSES = ("ast", "kernels", "hotpath", "mesh", "memory")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str       # e.g. "PIPK001"
    path: str       # repo-relative file
    line: int       # 1-indexed; 0 when the finding is not line-anchored
    symbol: str     # function / kernel / program the finding anchors to
    message: str

    @property
    def key(self) -> str:
        """Baseline key, free of line numbers so that unrelated edits above a
        baselined site cannot un-baseline it."""
        return f"{self.rule} {self.path}:{self.symbol}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} [{self.symbol}] {self.message}"


def repo_root() -> pathlib.Path:
    """The repository root (three levels above src/repro_torch/analysis)."""
    return pathlib.Path(__file__).resolve().parents[3]


def default_baseline_path() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parent / "baseline.txt"


def load_baseline(path: pathlib.Path) -> set[str]:
    if not path.exists():
        return set()
    keys = set()
    for line in path.read_text().splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            keys.add(line)
    return keys


def report(tag: str, msg: str) -> None:
    """Progress and measurement lines go to stderr, so that ``--json``
    output stays machine-readable."""
    print(f"  [{tag}] {msg}", file=sys.stderr, flush=True)


def skipped_rules(device) -> dict[str, str]:
    """The card-only rules skipped on ``device`` (none on the card)."""
    import torch

    return {} if torch.device(device).type == "cuda" else dict(CARD_ONLY)


def run_all(root: pathlib.Path | None = None, passes: tuple[str, ...] = PASSES, *,
            device=None, records: dict | None = None) -> list[Finding]:
    """Run the requested passes on ``device`` (default: the card, raising
    without one); returns the raw findings (no baseline applied).  With
    ``records``, each pass fills in what it measured under its name."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    root = pathlib.Path(root) if root is not None else repo_root()
    records = {} if records is None else records
    findings: list[Finding] = []
    for name in PASSES:
        if name not in passes:
            continue
        rec = records.setdefault(name, {})
        if name == "ast":
            from repro_torch.analysis import ast_lint

            findings += ast_lint.lint_port(root)
        elif name == "kernels":
            from repro_torch.analysis import contracts

            findings += contracts.check_kernel_contracts(root, device=dev, records=rec)
        elif name == "hotpath":
            from repro_torch.analysis import hotpath_audit

            findings += hotpath_audit.audit_all(dev, records=rec)
        elif name == "mesh":
            from repro_torch.analysis import mesh_audit

            findings += mesh_audit.audit_all(dev, records=rec)
        elif name == "memory":
            from repro_torch.analysis import memory_audit

            findings += memory_audit.audit_all(device=dev, records=rec)
    return findings


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="PiPNN port static contract checker (AST lint, kernel contracts, "
                    "hot-path audit, mesh audit, memory audit)")
    ap.add_argument("--pass", dest="passes", action="append", choices=PASSES, default=None,
                    help="run only this pass (repeatable; default: all)")
    ap.add_argument("--device", default=None,
                    help="device the passes run on (default: the card if there is one, "
                         "else the CPU, with the card-only rules skipped)")
    ap.add_argument("--baseline", type=pathlib.Path, default=default_baseline_path(),
                    help="baseline file (default: the checked-in, empty "
                         "src/repro_torch/analysis/baseline.txt)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write the current findings to the baseline file instead of "
                         "failing (escape hatch: fix instead whenever possible)")
    ap.add_argument("--json", action="store_true", help="emit findings as JSON")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule, desc in sorted(RULES.items()):
            print(f"{rule}  {desc}")
        for rule, why in sorted(NOT_PORTED.items()):
            print(f"{rule}  not ported: {why}")
        return 0

    import torch

    device = args.device
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
        if device == "cpu":
            report("lint", "no card: the passes run on the CPU")
    passes = tuple(args.passes) if args.passes else PASSES
    findings = run_all(passes=passes, device=device)
    skipped = skipped_rules(device)

    if args.write_baseline:
        lines = ["# repro_torch.analysis.lint baseline: one 'RULE path:symbol' per line.",
                 "# Keep this EMPTY: fix findings instead of baselining them."]
        lines += sorted({f.key for f in findings})
        args.baseline.write_text("\n".join(lines) + "\n")
        print(f"wrote {len(findings)} finding(s) to {args.baseline}")
        return 0

    baseline = load_baseline(args.baseline)
    fresh = [f for f in findings if f.key not in baseline]
    suppressed = len(findings) - len(fresh)
    if args.json:
        print(json.dumps({"findings": [dataclasses.asdict(f) for f in fresh],
                          "skipped": skipped, "device": str(device)}, indent=2))
    else:
        for f in sorted(fresh, key=lambda f: (f.path, f.line, f.rule)):
            print(f.render())
        for rule, why in sorted(skipped.items()):
            print(f"skipped for want of a card: {rule} ({why})")
        tail = f" ({suppressed} baselined)" if suppressed else ""
        status = "FAIL" if fresh else "OK"
        print(f"repro_torch.analysis.lint: {status}: {len(fresh)} finding(s) across passes "
              f"[{', '.join(passes)}] on {device}{tail}")
    return 1 if fresh else 0


if __name__ == "__main__":
    sys.exit(main())
