"""Bounded-memory audit of the port's hot-path programs on the card
(counterpart of ``repro/analysis/memory_audit.py``): PIPM001-004.

The paper's central build claim is bounded memory: HashPrune streams an
unbounded candidate-edge set through an [n, l_max] reservoir, so no build
program's peak device bytes may grow with the total edge count E, and
every program must fit one card at the BigANN-1B per-shard envelope.  The
reference proves it at compile time from XLA's byte ledger; here each
registered program runs on the card at a lattice of shapes, and the
caching allocator's ledger is read around it (``measure``): the argument
bytes, the new output bytes, the output bytes written into donated
arguments in place (``alias_bytes``), the peak above the arguments, and
temp = peak above the arguments - new outputs.

Registered programs (``default_specs``), each with its own workspace
model next to the function it models:

  * the streaming build's chunk step (``pipnn._stream_step``),
  * the reservoir folds (``hashprune.merge_segmented_edges`` /
    ``merge_flat_edges``),
  * the final-prune step (``robust_prune.final_prune_step``),
  * the static two-level carve (``rbc.static_leaf_ids``),
  * the serving engine (``beam_search._beam_search_multi``, float32 and
    int8 packings; the serving loop's straggler reruns are this engine at
    a smaller batch),
  * the cross-shard merge (``distributed.serving.cross_shard_topk``).

Rules:

  PIPM001  peak bytes (arguments + peak above them) over ``SWEEP_FACTORS``
           of each swept parameter fit a log-log exponent at most the
           spec's bound: build programs' peaks depend on the chunk and
           reservoir shapes only, never on E.
  PIPM002  the reference's donation check: the outputs a program writes
           into its donated arguments in place must cover them, so no
           build program's peak holds a second copy of the [n, l_max]
           reservoir (or of the final prune's [n, max_deg] rows).
  PIPM003  the program priced at the BigANN-1B per-shard envelope (its
           exact argument and output bytes at the envelope shapes, less
           the donated credit, plus its workspace model) fits the card's
           memory (or ``budget``).
  PIPM004  measured temp at every lattice point is at most the workspace
           model x ``WORKSPACE_TOL`` + ``WORKSPACE_SLACK``.

Not ported: PIPM005/006 (a checked-in envelope file and its regression
gate; a gate on card numbers belongs to a benchmark) and the sharded
search body, which needs a mesh of several cards.

On the CPU torch keeps no allocator statistics: ``ledger_available`` is
False there and ``audit_all`` reports a skip with zero findings, as the
reference does without ``memory_analysis()``.  ``Finding`` is the lint's
(``analysis.lint``); ``python -m repro_torch.analysis.lint --pass memory``
runs ``audit_all`` with the other passes' rules beside it.

    python -m repro_torch.analysis.memory_audit [--device cuda:0]
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import sys
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.analysis.lint import Finding

WORKSPACE_TOL = 2.0        # PIPM004: model x tol upper bound on temp
WORKSPACE_SLACK = 2 << 20  # PIPM004: absolute slack for small constants
DEFAULT_EXPONENT_BOUND = 1.15
SWEEP_FACTORS = (1, 2, 4)

# BigANN-1B deployment envelope (the reference's): 2^30 points over S = 256
# shards, the per-shard scale every one-card program is priced at.  Build
# programs run float32; serving programs price the int8 packing.
ENV_SHARDS = 256
ENV_N = (1 << 30) // ENV_SHARDS          # 4,194,304 owned rows per shard
ENV_D = 128
ENV_R = 64
ENV_L_MAX = 64
ENV_HALO = 0.10


def _report(msg: str) -> None:
    print(f"  [mem] {msg}", file=sys.stderr)


@dataclasses.dataclass(frozen=True)
class MemProgram:
    """One runnable instance of a registered program: ``fn(*args,
    **kwargs)`` on the card, with ``donated`` the positions of the
    arguments it writes into in place."""

    fn: Callable
    args: tuple
    kwargs: dict = dataclasses.field(default_factory=dict)
    donated: tuple = ()


@dataclasses.dataclass(frozen=True)
class MemSpec:
    """A registered hot-path program and its audit contract.  ``build(point,
    device)`` makes a ``MemProgram`` at a lattice point; ``io(point)`` gives
    its exact ``argument``, ``output`` and ``donated`` bytes without
    running it (the envelope's price); ``workspace(point)`` its modeled
    temp bytes."""

    name: str
    path: str                      # repo-relative file for findings
    kind: str                      # "build" | "serve"
    base: dict                     # canonical lattice point {param: value}
    build: Callable
    io: Callable | None = None
    sweep: dict = dataclasses.field(default_factory=dict)  # param -> bound
    envelope: dict | None = None
    workspace: Callable | None = None
    note: str = ""


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------

def ledger_available(device=None) -> bool:
    """Whether ``device`` (default: the card) keeps allocator statistics:
    a CUDA device, present."""
    dev = torch.device("cuda" if device is None else device)
    return dev.type == "cuda" and torch.cuda.is_available()


def _tensors(obj) -> list[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in _tensors(o)]
    return []


def _storages(ts) -> dict[int, int]:
    """Each distinct storage of ``ts``: data pointer -> bytes."""
    return {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes() for t in ts}


def io_ledger(prog: MemProgram, out, peak_above_args: float) -> dict:
    """The byte ledger of one run of ``prog`` that returned ``out``: its
    argument bytes (tensor keywords included), its new output bytes (storages that are no argument's),
    the output bytes written into donated arguments, the donated bytes,
    and from ``peak_above_args`` the peak and temp (the peak above the
    arguments less the new outputs).  Storages count once each."""
    args = _storages(_tensors(prog.args) + _tensors(prog.kwargs))
    donated = _storages([t for i in prog.donated for t in _tensors(prog.args[i])])
    outs = _storages(_tensors(out))
    new_out = sum(b for p, b in outs.items() if p not in args)
    ledger = {
        "argument_bytes": float(sum(args.values())),
        "output_bytes": float(new_out),
        "alias_bytes": float(sum(b for p, b in outs.items() if p in donated)),
        "donated_bytes": float(sum(donated.values())),
        "peak_above_args": float(peak_above_args),
        "temp_bytes": float(peak_above_args - new_out),
    }
    ledger["peak"] = ledger["argument_bytes"] + ledger["peak_above_args"]
    return ledger


def measure(spec: MemSpec, point: dict, device="cuda") -> dict:
    """Run ``spec``'s program at ``point`` on ``device`` once to warm up
    (cuBLAS workspaces, first-use buffers), then once more on fresh
    arguments between ``reset_peak_memory_stats`` and
    ``max_memory_allocated``; returns its byte ledger (``io_ledger``)."""
    dev = torch.device(device)
    prog = spec.build(point, dev)
    prog.fn(*prog.args, **prog.kwargs)
    del prog
    prog = spec.build(point, dev)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = prog.fn(*prog.args, **prog.kwargs)
    torch.cuda.synchronize(dev)
    return io_ledger(prog, out, torch.cuda.max_memory_allocated(dev) - base)


def fit_exponent(xs, ys) -> float:
    lx = np.log(np.asarray(xs, dtype=np.float64))
    ly = np.log(np.maximum(np.asarray(ys, dtype=np.float64), 1.0))
    return float(np.polyfit(lx, ly, 1)[0])


def price_envelope(spec: MemSpec) -> dict | None:
    """The program's bytes at the envelope point, computed, not run: its
    exact argument and output bytes, less the outputs written into donated
    arguments, plus the workspace model."""
    if spec.envelope is None or spec.io is None:
        return None
    io = spec.io(spec.envelope)
    credit = min(io["donated"], io["output"])
    temp = int(spec.workspace(spec.envelope)) if spec.workspace else 0
    return {"argument_bytes": int(io["argument"]), "output_bytes": int(io["output"]),
            "donated_credit": int(credit), "workspace_bytes": temp,
            "total": int(io["argument"] + io["output"] - credit + temp)}


def card_budget(device="cuda") -> int:
    """The card's memory in bytes (``total_memory``)."""
    return int(torch.cuda.get_device_properties(torch.device(device)).total_memory)


# ---------------------------------------------------------------------------
# per-spec audit
# ---------------------------------------------------------------------------

def audit_spec(spec: MemSpec, *, budget: int | None = None, device="cuda",
               measure_fn: Callable | None = None) -> tuple[list[Finding], dict]:
    """PIPM001-004 for one registered program.  ``measure_fn(spec, point,
    device)`` replaces ``measure`` (the tests' synthetic ledgers); ``budget``
    defaults to the card's memory.  Returns (findings, record)."""
    measure_fn = measure if measure_fn is None else measure_fn
    budget = card_budget(device) if budget is None else int(budget)
    findings: list[Finding] = []

    def finding(rule: str, msg: str) -> None:
        findings.append(Finding(rule, spec.path, 0, spec.name, msg))

    base_ledger = measure_fn(spec, spec.base, device)

    # -- PIPM002: the donated arguments are written in place ----------------
    donated = base_ledger["donated_bytes"]
    if donated > 0 and base_ledger["alias_bytes"] < donated:
        finding("PIPM002", f"{int(donated)} donated argument bytes but only "
                f"{int(base_ledger['alias_bytes'])} written in place: the program "
                f"returns a new copy while its caller holds the old one, so the "
                f"peak holds the reservoir twice")

    # -- PIPM004: temp within the workspace model ---------------------------
    ratios: dict[str, float] = {}

    def check_workspace(point: dict, ledger: dict) -> None:
        if spec.workspace is None:
            return
        model = float(spec.workspace(point))
        ratios[str(sorted(point.items()))] = ledger["temp_bytes"] / max(model, 1.0)
        limit = model * WORKSPACE_TOL + WORKSPACE_SLACK
        if ledger["temp_bytes"] > limit:
            finding("PIPM004", f"temp bytes {int(ledger['temp_bytes'])} exceed the "
                    f"workspace model {int(model)} x {WORKSPACE_TOL} "
                    f"(+{WORKSPACE_SLACK} slack) at point {point}: an allocation "
                    f"the model does not count")

    check_workspace(spec.base, base_ledger)

    # -- PIPM001: scaling exponents over the sweep lattice ------------------
    exponents: dict[str, float] = {}
    peaks: dict[str, list] = {}
    for param, bound in spec.sweep.items():
        xs, ys = [], []
        for f in SWEEP_FACTORS:
            point = dict(spec.base, **{param: spec.base[param] * f})
            ledger = base_ledger if f == 1 else measure_fn(spec, point, device)
            if f != 1:
                check_workspace(point, ledger)
            xs.append(point[param])
            ys.append(ledger["peak"])
        exponents[param] = exp = fit_exponent(xs, ys)
        peaks[param] = ys
        if exp > bound:
            finding("PIPM001", f"peak bytes scale as {param}^{exp:.2f} over {xs} (bound "
                    f"{bound:.2f}): the bounded-memory contract is broken, the peak "
                    f"must depend on the chunk and reservoir shapes only (build "
                    f"programs: never on the emitted edge count E)")

    # -- PIPM003: the envelope's price fits the card ------------------------
    env = price_envelope(spec)
    if env is not None and env["total"] > budget:
        finding("PIPM003", f"BigANN-1B per-shard envelope prices at "
                f"{env['total'] / 2**30:.2f} GiB (args {env['argument_bytes'] / 2**30:.2f} "
                f"+ workspace {env['workspace_bytes'] / 2**30:.2f}) over the "
                f"{budget / 2**30:.2f} GiB device budget")

    model = float(spec.workspace(spec.base)) if spec.workspace else None
    record = {"path": spec.path, "kind": spec.kind, "canonical_point": dict(spec.base),
              "canonical_ledger": base_ledger, "workspace_model": model,
              "temp_over_model": ratios, "exponents": exponents, "sweep_peaks": peaks,
              "envelope_point": dict(spec.envelope) if spec.envelope else None,
              "envelope_bytes": env, "budget_bytes": budget}
    exps = " ".join(f"{p}^{e:.2f}" for p, e in exponents.items())
    env_s = f" env={env['total'] / 2**30:.2f}GiB" if env else ""
    _report(f"{spec.name}: peak={base_ledger['peak'] / 2**20:.1f}MiB "
            f"temp={base_ledger['temp_bytes'] / 2**20:.1f}MiB [{exps}]{env_s}")
    return findings, record


# ---------------------------------------------------------------------------
# program registry
# ---------------------------------------------------------------------------

def _gen(dev: torch.device, seed: int = 0) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def _leaf_ids(s: int, c: int, n: int, dev) -> torch.Tensor:
    """[s, c] int32 leaves of distinct points: leaf j holds j*c .. j*c+c-1
    (mod n)."""
    return ((torch.arange(s, device=dev)[:, None] * c + torch.arange(c, device=dev)) % n
            ).to(torch.int32)


def _stream_spec() -> MemSpec:
    def build(pt, dev):
        from repro_torch.core import pipnn
        from repro_torch.core.hashprune import reservoir_init
        from repro_torch.core.leaf import LeafParams
        from repro_torch.core.sketch import sketch

        n, d, l, s, c, m = pt["n"], pt["d"], pt["l_max"], pt["s"], pt["c"], pt["m"]
        g = _gen(dev)
        x = torch.randn((n, d), generator=g, device=dev)
        sk = sketch(x, torch.randn((m, d), generator=g, device=dev)).contiguous()
        res = reservoir_init(n, l, dev)
        leaf = LeafParams(k=pt["k"], method="bidirected")
        return MemProgram(pipnn._stream_step, (res, x, sk, _leaf_ids(s, c, n, dev)),
                          dict(leaf=leaf, merge="segmented"), donated=(0,))

    def io(pt):
        n, d, l, s, c, m = pt["n"], pt["d"], pt["l_max"], pt["s"], pt["c"], pt["m"]
        res = n * l * 12
        return {"argument": res + n * d * 4 + n * m * 4 + s * c * 4,
                "output": res + 8, "donated": res}

    def ws(pt):
        from repro_torch.core.pipnn import stream_step_workspace_bytes

        return stream_step_workspace_bytes(pt["n"], pt["l_max"], pt["s"], pt["c"], pt["k"])

    return MemSpec(
        name="stream_step", path="src/repro_torch/core/pipnn.py", kind="build",
        base=dict(n=65536, d=32, l_max=32, s=64, c=256, k=4, m=12),
        sweep=dict(n=DEFAULT_EXPONENT_BOUND, s=DEFAULT_EXPONENT_BOUND,
                   l_max=DEFAULT_EXPONENT_BOUND, d=DEFAULT_EXPONENT_BOUND),
        envelope=dict(n=ENV_N, d=ENV_D, l_max=ENV_L_MAX, s=1024, c=256, k=8, m=12),
        build=build, io=io, workspace=ws)


def _edges(n: int, e: int, dev) -> tuple:
    """``e`` candidate edges over ``n`` points as the fold takes them: one
    in sixteen a padding edge (src = n, dst = -1, +inf)."""
    g = _gen(dev, 1)
    src = torch.randint(0, n, (e,), generator=g, device=dev, dtype=torch.int32)
    dst = torch.randint(0, n, (e,), generator=g, device=dev, dtype=torch.int32)
    h = torch.randint(0, 1 << 12, (e,), generator=g, device=dev, dtype=torch.int32)
    dist = torch.rand((e,), generator=g, device=dev)
    pad = torch.arange(e, device=dev) % 16 == 15
    return (torch.where(pad, n, src), torch.where(pad, -1, dst), torch.where(pad, 0, h),
            torch.where(pad, float("inf"), dist))


def _merge_spec(flavor: str) -> MemSpec:
    def build(pt, dev):
        from repro_torch.core import hashprune as hp

        n, l, e = pt["n"], pt["l_max"], pt["e"]
        res = hp.reservoir_init(n, l, dev)
        fn = hp.merge_segmented_edges if flavor == "segmented" else hp.merge_flat_edges
        return MemProgram(fn, (*res, *_edges(n, e, dev)),
                          donated=(0, 1, 2) if flavor == "segmented" else ())

    def io(pt):
        res = pt["n"] * pt["l_max"] * 12
        return {"argument": res + pt["e"] * 16, "output": res,
                "donated": res if flavor == "segmented" else 0}

    def ws(pt):
        from repro_torch.core import hashprune as hp

        f = (hp.merge_segmented_workspace_bytes if flavor == "segmented"
             else hp.merge_flat_workspace_bytes)
        return f(pt["n"], pt["l_max"], pt["e"])

    return MemSpec(
        name=f"merge_{flavor}", path="src/repro_torch/core/hashprune.py", kind="build",
        base=dict(n=65536, l_max=32, e=262144),
        sweep=dict(n=DEFAULT_EXPONENT_BOUND, l_max=DEFAULT_EXPONENT_BOUND,
                   e=DEFAULT_EXPONENT_BOUND),
        envelope=dict(n=ENV_N, l_max=ENV_L_MAX, e=4 * (1 << 22)),
        build=build, io=io, workspace=ws,
        note="" if flavor == "segmented" else
        "the flat fold (the oracle) returns a new reservoir and leaves its "
        "argument as it is: nothing is donated")


def _final_prune_spec() -> MemSpec:
    def build(pt, dev):
        from repro_torch.core.hashprune import INVALID_ID
        from repro_torch.core.robust_prune import final_prune_step

        n, d, l, md = pt["n"], pt["d"], pt["l_max"], pt["max_deg"]
        g = _gen(dev, 2)
        x = torch.randn((n, d), generator=g, device=dev)
        ids = torch.randint(0, n, (n, l), generator=g, device=dev, dtype=torch.int32)
        dists = torch.rand((n, l), generator=g, device=dev)
        out_ids = torch.full((n, md), INVALID_ID, dtype=torch.int32, device=dev)
        out_d = torch.full((n, md), float("inf"), device=dev)
        return MemProgram(final_prune_step, (x, ids, dists, out_ids, out_d, 0),
                          dict(alpha=1.44, max_deg=md, metric="l2", chunk=pt["chunk"]),
                          donated=(3, 4))

    def io(pt):
        n, d, l, md = pt["n"], pt["d"], pt["l_max"], pt["max_deg"]
        out = n * md * 8
        return {"argument": n * d * 4 + n * l * 8 + out, "output": out, "donated": out}

    def ws(pt):
        from repro_torch.core.robust_prune import final_prune_workspace_bytes

        return final_prune_workspace_bytes(pt["chunk"], pt["l_max"], pt["d"], pt["max_deg"])

    return MemSpec(
        name="final_prune_step", path="src/repro_torch/core/robust_prune.py", kind="build",
        base=dict(n=65536, d=32, l_max=32, chunk=2048, max_deg=32),
        sweep=dict(n=DEFAULT_EXPONENT_BOUND, chunk=DEFAULT_EXPONENT_BOUND, l_max=1.6,
                   d=DEFAULT_EXPONENT_BOUND),
        envelope=dict(n=ENV_N, d=ENV_D, l_max=ENV_L_MAX, chunk=16384, max_deg=ENV_R),
        build=build, io=io, workspace=ws,
        note="l_max bound 1.6: the step's [chunk, L, L] candidate distances grow "
             "as L^2 at fixed chunk")


def _carve_spec() -> MemSpec:
    def build(pt, dev):
        from repro_torch.core.rbc import RBCParams, static_leaf_ids

        x = torch.randn((pt["n"], pt["d"]), generator=_gen(dev, 5), device=dev)
        return MemProgram(static_leaf_ids, (x, RBCParams()), dict(seed=0))

    def io(pt):
        from repro_torch.core.rbc import RBCParams, carve_chunks

        p = RBCParams()
        sh = carve_chunks(pt["n"], p)
        return {"argument": pt["n"] * pt["d"] * 4,
                "output": sh["l0"] * sh["l1"] * p.c_max * 4, "donated": 0}

    def ws(pt):
        from repro_torch.core.rbc import RBCParams, carve_workspace_bytes

        return carve_workspace_bytes(pt["n"], pt["d"], RBCParams())

    return MemSpec(
        name="carve_static", path="src/repro_torch/core/rbc.py", kind="build",
        base=dict(n=65536, d=32), sweep=dict(n=1.35, d=DEFAULT_EXPONENT_BOUND),
        envelope=dict(n=ENV_N, d=ENV_D), build=build, io=io, workspace=ws,
        note="n exponent bound 1.35, the reference's: cap_b rounds up in steps "
             "of 8 and the leader count grows with n")


def _engine_build(pt, dev) -> MemProgram:
    from repro_torch.core import beam_search as bs
    from repro_torch.core.metrics import point_norms
    from repro_torch.kernels.gather_distance_int8 import quantize_symmetric

    n, d, r, nq = pt["n"], pt["d"], pt["r"], pt["nq"]
    g = _gen(dev, 3)
    x = torch.randn((n, d), generator=g, device=dev)
    graph = torch.randint(0, n, (n, r), generator=g, device=dev, dtype=torch.int32)
    q = torch.randn((nq, d), generator=g, device=dev)
    norms = point_norms(x, "l2")
    scales = None
    if pt.get("int8"):
        x, scales = quantize_symmetric(x)
    return MemProgram(bs._beam_search_multi, (graph, x, norms, q, 0),
                      dict(beam=pt["beam"], iters=pt["iters"], metric="l2",
                           expansions=pt["expansions"], early_exit=True, scales=scales))


def _engine_io(pt) -> dict:
    n, d, r, nq, beam = pt["n"], pt["d"], pt["r"], pt["nq"], pt["beam"]
    int8 = bool(pt.get("int8"))
    arg = n * r * 4 + n * d * (1 if int8 else 4) + n * 4 + nq * d * 4 + (n * 4 if int8 else 0)
    # ids and dists are views of the last merge's [nq, beam + 1] rows;
    # hops, dist_comps and converged
    return {"argument": arg, "output": nq * (beam + 1) * 8 + nq * 9, "donated": 0}


def _engine_ws(pt) -> int:
    from repro_torch.core.serving import engine_workspace_bytes

    return engine_workspace_bytes(pt["nq"], pt["n"], pt["d"], pt["r"], pt["beam"],
                                  pt["expansions"])


def _env_shard_rows() -> int:
    """Per-shard rows at the envelope, grown by the halo and pad slack the
    reference's packing model uses."""
    return math.ceil(ENV_N * (1.0 + ENV_HALO) * 1.10)


_ENGINE_BASE = dict(n=65536, d=128, r=32, nq=1024, beam=32, expansions=4, iters=36)
_ENGINE_ENV = dict(n=_env_shard_rows(), d=ENV_D, r=ENV_R, nq=32, beam=32, expansions=4,
                   iters=36, int8=True)


def _engine_spec() -> MemSpec:
    return MemSpec(
        name="serving_engine", path="src/repro_torch/core/serving.py", kind="serve",
        base=dict(_ENGINE_BASE),
        sweep=dict(n=DEFAULT_EXPONENT_BOUND, d=DEFAULT_EXPONENT_BOUND,
                   nq=DEFAULT_EXPONENT_BOUND, beam=DEFAULT_EXPONENT_BOUND),
        envelope=dict(_ENGINE_ENV), build=_engine_build, io=_engine_io, workspace=_engine_ws)


def _engine_int8_spec() -> MemSpec:
    return MemSpec(
        name="serving_engine_int8", path="src/repro_torch/core/serving.py", kind="serve",
        base=dict(_ENGINE_BASE, int8=True), envelope=dict(_ENGINE_ENV),
        build=_engine_build, io=_engine_io, workspace=_engine_ws)


def _topk_spec() -> MemSpec:
    def build(pt, dev):
        from repro_torch.distributed import serving as dserv

        s, nq, b = pt["s"], pt["nq"], pt["b"]
        g = _gen(dev, 4)
        ids = torch.randint(0, 1 << 20, (s, nq, b), generator=g, device=dev,
                            dtype=torch.int32)
        ds = torch.rand((s, nq, b), generator=g, device=dev)
        return MemProgram(dserv.cross_shard_topk, (ids, ds), dict(k=pt["k"]))

    def io(pt):
        s, nq, b, k = pt["s"], pt["nq"], pt["b"], pt["k"]
        return {"argument": s * nq * b * 8, "output": nq * (k + 1) * 8, "donated": 0}

    def ws(pt):
        from repro_torch.distributed.serving import cross_shard_topk_workspace_bytes

        return cross_shard_topk_workspace_bytes(pt["s"], pt["nq"], pt["b"], pt["k"])

    return MemSpec(
        name="cross_shard_topk", path="src/repro_torch/distributed/serving.py", kind="serve",
        base=dict(s=8, nq=4096, b=32, k=10),
        sweep=dict(s=DEFAULT_EXPONENT_BOUND, nq=DEFAULT_EXPONENT_BOUND,
                   b=DEFAULT_EXPONENT_BOUND),
        envelope=dict(s=ENV_SHARDS, nq=32, b=32, k=10), build=build, io=io, workspace=ws,
        note="S enters only the stacked argument blocks")


def default_specs() -> list[MemSpec]:
    return [_stream_spec(), _merge_spec("segmented"), _merge_spec("flat"),
            _final_prune_spec(), _carve_spec(), _engine_spec(), _engine_int8_spec(),
            _topk_spec()]


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------

def audit_all(specs: list[MemSpec] | None = None, *, device="cuda", budget: int | None = None,
              records: dict | None = None, measure_fn: Callable | None = None
              ) -> list[Finding]:
    """Every registered spec on ``device``; returns the findings and, when
    ``records`` is given, fills it with each spec's record.  Without an
    allocator ledger (the CPU) a skip is reported and nothing runs."""
    if measure_fn is None and not ledger_available(device):
        _report(f"no allocator ledger on {device} (torch keeps none on the CPU): "
                "memory audit skipped")
        return []
    specs = default_specs() if specs is None else specs
    findings: list[Finding] = []
    for spec in specs:
        f, record = audit_spec(spec, budget=budget, device=device, measure_fn=measure_fn)
        findings += f
        if records is not None:
            records[spec.name] = record
        if measure_fn is None:
            torch.cuda.empty_cache()
    return findings


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis.memory_audit",
                                 description="PiPNN port memory-bound audit (PIPM001-004)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    findings = audit_all(device=args.device)
    for f in findings:
        print(f.render())
    print(f"repro_torch.analysis.memory_audit: {'FAIL' if findings else 'OK'}: "
          f"{len(findings)} finding(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
