"""The port's bounded-memory audit (``repro_torch.analysis.memory_audit``)
on the CPU: every ported PIPM rule fires on a broken program or contract
and stays quiet on a sound one, over synthetic ledgers (torch keeps no
allocator ledger on the CPU; the card-only run is in
``test_torch_cuda.py``), as the reference's own tests
(``tests/test_memory_audit.py``) do over XLA's.  The registered programs
run on the CPU at small points, their exact argument bytes equal the
specs' ``io``, and each workspace model is held at the BigANN-1B envelope
against a count made by hand."""
import math

import pytest
import torch

from repro_torch.analysis import memory_audit as ma
from repro_torch.analysis.memory_audit import MemProgram, MemSpec


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: under six test workers the default (one a core)
    oversubscribes the cores on these small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


BUDGET = 80 * 10**9       # one H100's 80 GB


def _spec(name, build=None, *, base, sweep=None, envelope=None, io=None, workspace=None):
    return MemSpec(name=name, path=f"tests/{name}.py", kind="build", base=base,
                   build=build or (lambda pt, dev: None), io=io, sweep=sweep or {},
                   envelope=envelope, workspace=workspace)


def _synthetic(peak, temp=None, donated=0.0, alias=0.0):
    """A measure_fn whose ledger at a point is given by functions of it."""
    def fn(spec, point, device):
        p = float(peak(point))
        return {"argument_bytes": 0.0, "output_bytes": 0.0, "alias_bytes": float(alias),
                "donated_bytes": float(donated), "peak_above_args": p, "peak": p,
                "temp_bytes": float(p if temp is None else temp(point))}
    return fn


def _cpu_measure(spec, point, device):
    """Run the program on the CPU: its real argument, output and alias bytes,
    with the outputs standing in for the peak above the arguments."""
    prog = spec.build(point, torch.device("cpu"))
    out = prog.fn(*prog.args, **prog.kwargs)
    return ma.io_ledger(prog, out, ma.io_ledger(prog, out, 0.0)["output_bytes"])


# ------------------------------------------------------------- PIPM001 ---

def test_pipm001_flags_superlinear_peak():
    spec = _spec("quad_peak", base=dict(n=64), sweep=dict(n=ma.DEFAULT_EXPONENT_BOUND))
    findings, record = ma.audit_spec(spec, budget=BUDGET,
                                     measure_fn=_synthetic(lambda pt: 4 * pt["n"] ** 2))
    assert [f.rule for f in findings] == ["PIPM001"]
    assert "n^" in findings[0].message
    assert record["exponents"]["n"] > 1.5


def test_pipm001_quiet_for_linear_peak():
    spec = _spec("lin_peak", base=dict(n=256), sweep=dict(n=ma.DEFAULT_EXPONENT_BOUND))
    findings, record = ma.audit_spec(
        spec, budget=BUDGET, measure_fn=_synthetic(lambda pt: 32 * pt["n"] + 4096))
    assert findings == []
    assert record["exponents"]["n"] <= ma.DEFAULT_EXPONENT_BOUND
    assert record["sweep_peaks"]["n"] == [32 * n + 4096 for n in (256, 512, 1024)]


def test_fit_exponent_recovers_powers():
    xs = [1, 2, 4, 8]
    assert abs(ma.fit_exponent(xs, [3 * x for x in xs]) - 1.0) < 1e-6
    assert abs(ma.fit_exponent(xs, [5 * x * x for x in xs]) - 2.0) < 1e-6
    assert abs(ma.fit_exponent(xs, [7.0] * 4)) < 1e-6


# ------------------------------------------------------------- PIPM002 ---

def _copying(pt, dev):
    """Donates its argument but returns a new tensor: its caller holds both."""
    return MemProgram(lambda x: x * 2.0, (torch.ones((pt["n"], 8), device=dev),),
                      donated=(0,))


def _in_place(pt, dev):
    return MemProgram(lambda x: x.mul_(2.0), (torch.ones((pt["n"], 8), device=dev),),
                      donated=(0,))


def test_pipm002_flags_a_second_copy():
    spec = _spec("copying", _copying, base=dict(n=512))
    findings, record = ma.audit_spec(spec, budget=BUDGET, measure_fn=_cpu_measure)
    assert [f.rule for f in findings] == ["PIPM002"]
    assert "twice" in findings[0].message
    ledger = record["canonical_ledger"]
    assert ledger["donated_bytes"] == ledger["output_bytes"] == 512 * 8 * 4
    assert ledger["alias_bytes"] == 0


def test_pipm002_quiet_when_written_in_place():
    spec = _spec("in_place", _in_place, base=dict(n=512))
    findings, record = ma.audit_spec(spec, budget=BUDGET, measure_fn=_cpu_measure)
    assert findings == []
    ledger = record["canonical_ledger"]
    assert ledger["alias_bytes"] == ledger["donated_bytes"] == 512 * 8 * 4
    assert ledger["output_bytes"] == 0


# ------------------------------------------------------------- PIPM003 ---

def _lin_io(pt):
    return {"argument": pt["n"] * 32, "output": pt["n"] * 32, "donated": 0}


def test_pipm003_envelope_fires_under_tiny_budget():
    spec = _spec("env_priced", base=dict(n=256), envelope=dict(n=4096), io=_lin_io)
    findings, record = ma.audit_spec(spec, budget=1024,
                                     measure_fn=_synthetic(lambda pt: 64 * pt["n"]))
    assert [f.rule for f in findings] == ["PIPM003"]
    assert "device budget" in findings[0].message
    assert record["envelope_bytes"]["total"] == 4096 * 64 > 1024


def test_pipm003_quiet_at_the_card_budget():
    spec = _spec("env_priced_ok", base=dict(n=256), envelope=dict(n=4096), io=_lin_io)
    findings, _ = ma.audit_spec(spec, budget=BUDGET,
                                measure_fn=_synthetic(lambda pt: 64 * pt["n"]))
    assert findings == []


def test_price_envelope_credits_donation_and_workspace():
    spec = _spec("pricer", base=dict(n=256), envelope=dict(n=1024),
                 io=lambda pt: {"argument": pt["n"] * 32, "output": pt["n"] * 32,
                                "donated": pt["n"] * 32},
                 workspace=lambda pt: 7 * pt["n"])
    env = ma.price_envelope(spec)
    arg = out = 1024 * 8 * 4
    assert env == {"argument_bytes": arg, "output_bytes": out, "donated_credit": out,
                   "workspace_bytes": 7 * 1024, "total": arg + out - out + 7 * 1024}
    assert ma.price_envelope(_spec("no_env", base=dict(n=1))) is None


# ------------------------------------------------------------- PIPM004 ---

def test_pipm004_flags_temp_over_workspace_model():
    # the model grants no temp; 16 MiB of it blow through tol x 0 + 2 MiB
    spec = _spec("temp_blowup", base=dict(n=2048), workspace=lambda pt: 0)
    findings, record = ma.audit_spec(
        spec, budget=BUDGET, measure_fn=_synthetic(lambda pt: pt["n"] ** 2 * 4))
    assert [f.rule for f in findings] == ["PIPM004"]
    assert "workspace model" in findings[0].message


def test_pipm004_checks_every_lattice_point():
    # honest at the base point, short at the sweep's 4x point only
    spec = _spec("temp_sweep", base=dict(n=1024), sweep=dict(n=2.5),
                 workspace=lambda pt: pt["n"] * 4096)
    findings, _ = ma.audit_spec(spec, budget=BUDGET, measure_fn=_synthetic(
        lambda pt: pt["n"] ** 2 * 4, temp=lambda pt: pt["n"] * 4096 * (3 if pt["n"] > 2048
                                                                         else 1)))
    assert [f.rule for f in findings] == ["PIPM004"]
    assert "'n': 4096" in findings[0].message


def test_pipm004_quiet_under_honest_model():
    spec = _spec("temp_modeled", base=dict(n=2048), workspace=lambda pt: pt["n"] ** 2 * 4)
    findings, record = ma.audit_spec(
        spec, budget=BUDGET, measure_fn=_synthetic(lambda pt: pt["n"] ** 2 * 4))
    assert findings == []
    assert list(record["temp_over_model"].values()) == [1.0]


# --------------------------------------------------------- graceful skip ---

def test_audit_all_skips_without_ledger(monkeypatch):
    monkeypatch.setattr(ma, "ledger_available", lambda device=None: False)
    calls = []
    monkeypatch.setattr(ma, "default_specs", lambda: calls.append("built") or [])
    assert ma.audit_all() == []
    assert calls == []       # no spec built, let alone run


def test_the_cpu_keeps_no_ledger():
    assert not ma.ledger_available("cpu")
    records = {}
    assert ma.audit_all(device="cpu", records=records) == [] and records == {}


def test_audit_all_collects_findings_and_records():
    specs = [_spec("quad", base=dict(n=64), sweep=dict(n=1.15)),
             _spec("lin", base=dict(n=64), sweep=dict(n=1.15))]
    peaks = {"quad": lambda pt: pt["n"] ** 2, "lin": lambda pt: pt["n"]}

    def measure_fn(spec, point, device):
        return _synthetic(peaks[spec.name])(spec, point, device)

    records = {}
    findings = ma.audit_all(specs, budget=BUDGET, records=records, measure_fn=measure_fn)
    assert [(f.rule, f.symbol) for f in findings] == [("PIPM001", "quad")]
    assert sorted(records) == ["lin", "quad"]
    assert findings[0].render().startswith("tests/quad.py:0: PIPM001 [quad]")


# ---------------------------------------------------- the registered specs ---

SPECS = {s.name: s for s in ma.default_specs()}
REQUIRED = ("stream_step", "merge_segmented", "merge_flat", "final_prune_step",
            "serving_engine", "serving_engine_int8")


def test_registry_covers_the_required_programs():
    assert set(REQUIRED) <= set(SPECS)
    for spec in SPECS.values():
        assert spec.workspace is not None and spec.io is not None and spec.envelope
        assert spec.path.startswith("src/repro_torch/")


def _small(spec):
    """The base point cut down for the CPU."""
    cut = dict(n=2048, e=4096, s=4, c=64, nq=16, chunk=256, d=16)
    return {k: min(v, cut[k]) if k in cut else v for k, v in spec.base.items()}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_registered_program_runs_and_io_is_exact(name):
    """Each registered program runs on the CPU at a small point; the bytes
    of its arguments and new outputs are what its ``io`` computes (the
    envelope's price uses them)."""
    spec = SPECS[name]
    pt = _small(spec)
    ledger = _cpu_measure(spec, pt, "cpu")
    io = spec.io(pt)
    assert ledger["argument_bytes"] == io["argument"]
    assert ledger["donated_bytes"] == io["donated"]
    # on the CPU the segmented fold's plain merge returns new rows; on the
    # card it writes into the donated reservoir (alias) instead
    assert ledger["output_bytes"] + ledger["alias_bytes"] == io["output"]


# the workspace models at the envelope, counted by hand
N, L, D, R = 4_194_304, 64, 128, 64
E_STREAM = 2 * 1024 * 256 * 8                   # bidirected: 2 s c k
ROWS = math.ceil(N * 1.1 * 1.1)                 # halo and pad slack
HAND = {
    # masked edges 16 B + chunk reservoir 12 B a slot + four columns and a sort, 64 B
    "stream_step": 16 * E_STREAM + 12 * N * L + 64 * E_STREAM,
    "merge_segmented": 12 * N * L + 64 * 4 * 2 ** 22,
    # the source column, the concatenation and its sort, over n l + e entries
    "merge_flat": 4 * N * L + (16 + 64) * (N * L + 4 * 2 ** 22),
    # the leaf routing leads: l0 1000 buckets of cap_b 62,920 at f1 3,
    # 79 B a placement, the buckets' ids and mask, the leaves' mask
    # (l1 336, c_max 1024)
    "carve_static": 79 * (1000 * 62920 * 3) + 5 * 1000 * 62920 + 1000 * 336 * 1024,
    # gathered vectors, four [B, L, L] buffers, the greedy, the rows out
    "final_prune_step": 16384 * L * D * 4 + 4 * 16384 * L * L * 4 + 16384 * L * 96
                        + 16384 * R * 12,
    # per query: E R candidates at 13 B + 28 B an expansion; merge_block
    # of R = 64 candidates into a beam of 32: max(10 beam R, 24 R) + 13 R
    # = 10 beam R + 13 R; the beam state twice
    "serving_engine": 32 * (13 * 4 * R + 28 * 4 + 10 * 32 * R + 13 * R + 18 * 33 + 16),
    "serving_engine_int8": 32 * (13 * 4 * R + 28 * 4 + 10 * 32 * R + 13 * R + 18 * 33 + 16),
    # merge_block of a shard's 32 entries into the 10-wide carry: 10 k b + 13 b
    "cross_shard_topk": 32 * (10 * 10 * 32 + 13 * 32 + 18 * 11),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_workspace_model_at_the_envelope_by_hand(name):
    spec = SPECS[name]
    assert spec.workspace(spec.envelope) == HAND[name]
    env = ma.price_envelope(spec)
    assert env["workspace_bytes"] == HAND[name]
    # every program fits one 80 GB card at the envelope: the bounded-memory
    # claim priced (PIPM003)
    assert env["total"] <= BUDGET, (name, env)


def test_envelope_arguments_by_hand():
    env = {n: ma.price_envelope(s) for n, s in SPECS.items()}
    res = 12 * N * L
    assert env["stream_step"]["argument_bytes"] == res + N * D * 4 + N * 12 * 4 + 1024 * 256 * 4
    assert env["stream_step"]["donated_credit"] == res
    assert env["merge_flat"]["donated_credit"] == 0
    assert env["serving_engine"]["argument_bytes"] == (ROWS * R * 4 + ROWS * D + ROWS * 4
                                                      + 32 * D * 4 + ROWS * 4)


def test_merge_block_model_by_hand():
    from repro_torch.core.serving import merge_block_workspace_bytes

    # the [l, m] cross counts lead from a beam of 3 up, the rank sort's
    # keys and orders at a beam of 1 or 2; no [m, m] buffer, so linear in m
    assert merge_block_workspace_bytes(128, 10) == 10 * 10 * 128 + 13 * 128
    assert merge_block_workspace_bytes(32, 32) == 10 * 32 * 32 + 13 * 32
    assert merge_block_workspace_bytes(32, 2) == 24 * 32 + 13 * 32
    assert merge_block_workspace_bytes(256, 10) == 2 * merge_block_workspace_bytes(128, 10)


def test_build_models_never_see_the_edge_total():
    """The build programs' models take the chunk and reservoir shapes only:
    a stream step's model is the same for any number of chunks, and the
    fold's grows by its own chunk's edges, not by the edges folded
    before."""
    from repro_torch.core.hashprune import merge_segmented_workspace_bytes
    from repro_torch.core.pipnn import stream_step_workspace_bytes

    one = stream_step_workspace_bytes(1 << 20, 64, 256, 512, 2)
    assert one == stream_step_workspace_bytes(1 << 20, 64, 256, 512, 2, method="bidirected")
    assert (stream_step_workspace_bytes(1 << 20, 64, 256, 512, 2, method="directed")
            < one)
    grow = merge_segmented_workspace_bytes(1 << 20, 64, 2000) - merge_segmented_workspace_bytes(
        1 << 20, 64, 1000)
    assert grow == 1000 * 64
