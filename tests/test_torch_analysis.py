"""The port's static contract checker (``repro_torch.analysis``): the CLI,
the rule catalog against the reference's, and every ported rule firing on
a fixture and staying quiet on the port, on the CPU.  The card-only halves
(PIPK001-003, PIPJ001's cross-check) are in ``tests/test_torch_cuda.py``.

The reference's own traced passes are not run here (two of them fail under
the installed jax); the reference is read for its catalog, its declared
collective contracts and its pure-AST pass only.
"""
import ast
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from repro.analysis import ast_lint as ref_ast_lint
from repro.analysis import lint as ref_lint
from repro.analysis import spmd_audit as ref_spmd
from repro_torch.analysis import ast_lint, contracts, hotpath_audit, lint, mesh_audit
from repro_torch.analysis import memory_audit


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: under six test workers the default (one a core)
    oversubscribes the cores on these small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


ROOT = pathlib.Path(__file__).resolve().parents[1]


def _rules(findings):
    return sorted(f.rule for f in findings)


# ---------------------------------------------------------------------------
# the CLI and the catalog
# ---------------------------------------------------------------------------

def test_cpu_lint_of_the_port_is_clean_and_names_its_skips(capsys):
    assert lint.main(["--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["findings"] == [] and out["device"] == "cpu"
    assert {"PIPK001", "PIPK002", "PIPK003", "PIPJ001"} <= set(out["skipped"])


def test_list_rules_prints_every_port_rule_and_the_unported(capsys):
    assert lint.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in list(lint.RULES) + list(lint.NOT_PORTED):
        assert rule in out
    assert out.count("not ported") == len(lint.NOT_PORTED)


def test_catalog_covers_every_reference_rule():
    ref = set(ref_lint.RULES)
    assert set(lint.RULES) | set(lint.NOT_PORTED) == ref
    assert not set(lint.RULES) & set(lint.NOT_PORTED)
    assert set(lint.NOT_PORTED) == {"PIPA004", "PIPM005", "PIPM006"}
    assert set(lint.CARD_ONLY) <= set(lint.RULES)


def test_checked_in_baseline_is_empty(tmp_path):
    path = lint.default_baseline_path()
    assert path.exists() and lint.load_baseline(path) == set()
    p = tmp_path / "b.txt"
    p.write_text("# comment\n\nPIPA003 src/x.py:f\n")
    assert lint.load_baseline(p) == {"PIPA003 src/x.py:f"}


def test_run_all_defaults_to_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lint.run_all(passes=("ast",))
    with pytest.raises(RuntimeError):
        lint.main(["--device", "cuda", "--pass", "ast"])


def test_memory_audit_shares_the_lint_finding():
    assert memory_audit.Finding is lint.Finding


# ---------------------------------------------------------------------------
# ast_lint: PIPA001-003
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src", [
    "def f(a, out=[], cfg={}):\n    return out\n",
    "def g(x, *, seen=set(), opts=dict(a=1), ok=None):\n    return x\n",
    "class C:\n    def m(self, xs=list()):\n        return xs\n",
])
def test_mutable_defaults_match_the_reference(src):
    def key(fs):
        return [(f.rule, f.path, f.line, f.symbol, f.message) for f in fs]

    assert key(ast_lint.lint_source(src, "fx.py")) == key(ref_ast_lint.lint_source(src, "fx.py"))
    assert ast_lint.lint_source(src, "fx.py")


def test_tensor_branch_and_undeclared_sync_fire():
    src = ("import torch\n"
           "def step(x, k: int, *, beam):\n"
           "    y = torch.relu(x)\n"
           "    if y.sum() > 0:\n"
           "        y = y + 1\n"
           "    if bool(y.any()):\n"
           "        pass\n"
           "    n = y.shape[0]\n"
           "    if n > k and beam:\n"
           "        pass\n"
           "    y[:, 0] = 1\n"
           "    y[x.argmax()] = 0\n"
           "    return y.max().item()\n")
    fs = ast_lint.lint_source(src, "fx.py", {"step": ("bool",)})
    assert [(f.rule, f.line) for f in fs] == [("PIPA001", 4), ("PIPA002", 12),
                                              ("PIPA002", 13)]
    fs = ast_lint.lint_source(src, "fx.py", {"step": ("bool", ".item", "[]=number", "int")})
    assert [(f.rule, f.line) for f in fs] == [("PIPA001", 4), ("PIPA002", 2)]   # stale int
    assert "stale" in fs[1].message


def test_port_hot_functions_match_their_declarations():
    assert ast_lint.lint_port(ROOT) == []
    beam = ast_lint.HOT_FUNCTIONS["src/repro_torch/core/beam_search.py"]
    assert beam["_beam_search_multi"] == ("bool", "[]=number")
    # every hot-path program's function is a registered hot function
    for prog in hotpath_audit.default_programs():
        assert prog.symbol in ast_lint.HOT_FUNCTIONS[prog.path], prog.name


def test_ast_pass_imports_nothing_it_reads():
    tree = ast.parse((ROOT / "src/repro_torch/analysis/ast_lint.py").read_text())
    mods = {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert mods <= {"__future__", "repro_torch.analysis.lint"}


# ---------------------------------------------------------------------------
# contracts: PIPK001, PIPK004, PIPK005
# ---------------------------------------------------------------------------

_MANGLED = "_ZN12_GLOBAL__N_116leaf_topk_kernelILi16ELi4EEEvPKfPKiiiiiiPiPf"
_REPORT = f"""== leaf_knn.cu ==
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{_MANGLED}' for 'sm_90a'
ptxas info    : Function properties for {_MANGLED}
    {{stack}} bytes stack frame, {{stores}} bytes spill stores, {{loads}} bytes spill loads
ptxas info    : Used {{regs}} registers, used 1 barriers, 16 bytes smem, 400 bytes cmem[0]
"""


def _report(regs=96, stores=0, loads=0, stack=0):
    return _REPORT.format(regs=regs, stores=stores, loads=loads, stack=stack)


def test_ptxas_report_parses():
    got = contracts.parse_ptxas(_report(regs=120, stores=8, loads=4, stack=24))
    assert got == {_MANGLED: dict(registers=120, stack=24, spill_stores=8, spill_loads=4,
                                  smem=16)}
    assert contracts.demangle(_MANGLED, ["leaf_topk_kernel"]) == ("leaf_topk_kernel", (16, 4))
    bf16 = "_ZN12_GLOBAL__N_122gather_distance_kernelI13__nv_bfloat16Li8ELi16EEEvPKT_PKfS6_"
    assert contracts.demangle(bf16, ["gather_distance_kernel"]) == (
        "gather_distance_kernel", ("__nv_bfloat16", 8, 16))
    assert contracts.demangle("_ZN12_GLOBAL__N_112merge_kernelEPiS0_", ["merge_kernel"]) == (
        "merge_kernel", ())


@pytest.mark.parametrize("report, fires", [
    (_report(), False),
    (_report(stores=8, loads=8), True),       # a spill
    (_report(regs=176), True),                # 176 x 128 x 3 > 65,536 registers
])
def test_resources_rule_on_captured_reports(report, fires):
    spec = contracts.spec_by_name("leaf_topk")
    (mangled, res), = contracts.parse_ptxas(report).items()
    name, inst = contracts.demangle(mangled, spec.kernels)
    fs = contracts.check_function(spec, name, inst, res, (128, 3), contracts.CardLimits())
    assert _rules(fs) == (["PIPK001"] if fires else [])


@pytest.mark.parametrize("spill, fires", [(642, False), (643, True)])
def test_reviewed_spill_bound(spill, fires):
    """The leaf kernel's K = 8 register lists spill 642 bytes under the
    launch bound (reviewed); one byte more fires."""
    spec = contracts.spec_by_name("leaf_topk")
    res = dict(registers=160, stack=0, spill_stores=spill // 2, spill_loads=spill - spill // 2,
               smem=16)
    fs = contracts.check_function(spec, "leaf_topk_kernel", (8, 4), res, (128, 3),
                                  contracts.CardLimits())
    assert _rules(fs) == (["PIPK001"] if fires else [])


def test_shared_memory_rule_against_promised_blocks():
    spec = contracts.spec_by_name("merge_sorted_reservoirs")
    res = dict(registers=32, stack=0, spill_stores=0, spill_loads=0, smem=0)
    case = contracts.Case("l=128", dict(l=128, n=8), None)
    limits = contracts.CardLimits()
    ok, rec = contracts.check_shape(spec, "merge_kernel", (), res, (256, 8), 21_120, case,
                                    limits)
    assert ok == [] and rec["blocks_by_smem"] >= 8
    over, _ = contracts.check_shape(spec, "merge_kernel", (), res, (256, 8), 42_000, case,
                                    limits)
    assert _rules(over) == ["PIPK001"] and "promises 8" in over[0].message
    optin, _ = contracts.check_shape(spec, "merge_kernel", (), res, (256, 8), 240_000, case,
                                     limits)
    assert _rules(optin) == ["PIPK001"] and "opt-in" in optin[0].message
    # the leaf kernel's reviewed floor: 3 blocks at the build's shape, 1 deeper
    leaf = contracts.spec_by_name("leaf_topk")
    deep = contracts.Case("deep", dict(c=1024, d=736, k=1), None)
    build = contracts.Case("build", dict(c=1024, d=128, k=2), None)
    assert contracts.check_shape(leaf, "leaf_topk_kernel", (1, 4), res, (128, 3), 200_000,
                                 deep, limits)[0] == []
    assert _rules(contracts.check_shape(leaf, "leaf_topk_kernel", (2, 4), res, (128, 3),
                                        100_000, build, limits)[0]) == ["PIPK001"]
    # the wide list at the build's leaves runs 2 blocks today; losing one fires
    wide = contracts.Case("wide", dict(c=1024, d=128, k=16), None)
    assert contracts.check_shape(leaf, "leaf_topk_kernel", (16, 4), res, (128, 3), 96_640,
                                 wide, limits)[0] == []
    assert _rules(contracts.check_shape(leaf, "leaf_topk_kernel", (16, 4), res, (128, 3),
                                        120_000, wide, limits)[0]) == ["PIPK001"]


def test_leaf_floor_names_only_swept_cases():
    swept = {(c.params["c"], c.params["d"], c.params["k"])
             for c in contracts.spec_by_name("leaf_topk").cases()}
    assert set(contracts.LEAF_BLOCKS) <= swept
    assert all(1 <= b < 3 for b in contracts.LEAF_BLOCKS.values())


def test_poisoned_span_holds_only_outputs_inside_it():
    buf = torch.empty(64, dtype=torch.uint8)
    spans = [(buf.data_ptr(), buf.data_ptr() + 64)]
    assert contracts._in_poison(buf[:16].view(torch.int32), spans)
    assert contracts._in_poison(buf[48:].view(torch.int32), spans)
    assert not contracts._in_poison(torch.empty(4, dtype=torch.int32), spans)
    assert [s.name for s in contracts.REGISTRY if s.in_place] == ["merge_sorted_reservoirs"]


def test_launch_bounds_are_read_from_the_sources():
    src = contracts.parse_csrc(ROOT / contracts.CSRC)
    bounds = {k: v["bounds"] for k, v in src["globals"].items()}
    assert bounds == {"leaf_topk_kernel": (128, 3), "edge_hash_kernel": (128, 8),
                      "merge_kernel": (256, 8), "gather_distance_kernel": (128, 8),
                      "gather_distance_int8_kernel": (128, 8),
                      "pairwise_distance_kernel": (256, 1),
                      "pairwise_distance_int8_kernel": (512, 1),
                      "rowwise_topk_kernel": (256, 4)}


def test_census_and_pairing_of_the_port_are_clean():
    assert contracts.check_census(ROOT) == []
    assert contracts.check_pairing() == []
    replaced = sorted(s for spec in contracts.REGISTRY for s in spec.replaces)
    assert len(replaced) == 10 == len(set(replaced))


def test_census_fires_on_an_unclaimed_global(tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for cu in (ROOT / contracts.CSRC).glob("*.cu*"):
        (csrc / cu.name).write_text(cu.read_text())
    (csrc / "extra.cu").write_text(
        '#include "common.cuh"\n__global__ void __launch_bounds__(64, 2)\n'
        "stray_kernel(float* x) { x[0] = 0.f; }\n"
        "PIPNN_EXPORT int pipnn_stray(void* x) { return 0; }\n")
    fs = contracts.check_census(ROOT, csrc=csrc)
    assert _rules(fs) == ["PIPK005", "PIPK005"]
    assert {f.symbol for f in fs} == {"stray_kernel", "pipnn_stray"}


def test_pairing_fires_on_an_entry_without_a_counter():
    spec = dataclasses.replace(contracts.spec_by_name("rowwise_topk"), counter="no_counter",
                               plain="repro_torch.kernels.topk:no_plain")
    fs = contracts.check_pairing((spec,))
    assert _rules(fs) == ["PIPK004", "PIPK004"]


def test_tolerance_statements_are_the_ones_chip_smoke_reads():
    src = (ROOT / "chip_smoke.py").read_text()
    for name in ("TF32_TOL", "GATHER_TOL", "GATHER8_TOL", "EXACT", "tf32_limit",
                 "gather_limit"):
        assert f"contracts.{name}" in src, name
    assert "32 * EPS32 * max_sq" not in src and "16 * EPS32 * scale" not in src


# ---------------------------------------------------------------------------
# hotpath_audit: PIPJ001-004
# ---------------------------------------------------------------------------

def _program(fn, *, budget=0, donated=(), in_place_on=frozenset()):
    def build(dev):
        g = torch.Generator(device=dev).manual_seed(0)
        return fn, (torch.rand((8, 4), generator=g, device=dev),
                    torch.rand((8, 4), generator=g, device=dev)), {}, {}
    return hotpath_audit.HotProgram("fixture", "fx.py", "fixture", build, lambda s, _: budget,
                                    "fixture", donated=donated, in_place_on=in_place_on)


def test_extra_item_fires_pipj001():
    prog = _program(lambda a, b: (a + b, (a.sum() > 0).item()))
    assert _rules(hotpath_audit.audit_program(prog, "cpu")[0]) == ["PIPJ001"]
    assert hotpath_audit.audit_program(dataclasses.replace(prog, budget=lambda s, _: 1),
                                       "cpu")[0] == []
    # a sync fewer than declared is a stale declaration
    stale = dataclasses.replace(prog, budget=lambda s, _: 2)
    assert _rules(hotpath_audit.audit_program(stale, "cpu")[0]) == ["PIPJ001"]


def test_one_more_sync_a_step_in_the_engine_fires_pipj001(monkeypatch):
    """The engine's budget follows the steps the run took, so a boolean-mask
    read planted once a step fires, however early the search converged."""
    from repro_torch.core import beam_search

    prog = next(p for p in hotpath_audit.default_programs() if p.name == "engine[f32,kernel]")
    findings, rec = hotpath_audit.audit_program(prog, "cpu")
    assert findings == [] and rec["syncs"] == rec["budget"]
    steps = rec["step_calls"] // min(hotpath_audit._ENGINE["expansions"],
                                     hotpath_audit._ENGINE["beam"])
    assert 0 < steps < hotpath_audit._ENGINE["iters"]
    topf = beam_search.topf

    def planted(masked, e):
        masked[torch.isfinite(masked)]            # one boolean-mask read a step
        return topf(masked, e)

    monkeypatch.setattr(beam_search, "topf", planted)
    findings, rec2 = hotpath_audit.audit_program(prog, "cpu")
    assert _rules(findings) == ["PIPJ001"]
    assert rec2["syncs"] == rec["syncs"] + steps and rec2["budget"] == rec["budget"]


def test_float64_op_fires_pipj002():
    prog = _program(lambda a, b: (a.double() @ b.double().T).float())
    assert _rules(hotpath_audit.audit_program(prog, "cpu")[0]) == ["PIPJ002"]


def test_out_of_place_fold_fires_pipj003_and_the_cpu_route_is_not_checked():
    copy = _program(lambda a, b: (a + b, b), donated=(0,), in_place_on=frozenset({"cpu"}))
    assert _rules(hotpath_audit.audit_program(copy, "cpu")[0]) == ["PIPJ003"]
    inplace = dataclasses.replace(copy, build=lambda dev: (
        lambda a, b: (a.add_(b), b), *copy.build(dev)[1:]))
    assert hotpath_audit.audit_program(inplace, "cpu")[0] == []
    card_only = dataclasses.replace(copy, in_place_on=frozenset({"cuda"}))
    findings, rec = hotpath_audit.audit_program(card_only, "cpu")
    assert findings == [] and "not checked" in rec["donation"]


def test_unpadded_batches_fire_pipj004():
    fs = hotpath_audit.audit_launch_shapes("cpu", query_chunk=None)
    assert _rules(fs) == ["PIPJ004"]
    fs = hotpath_audit.audit_launch_shapes_sharded("cpu", query_chunk=None)
    assert _rules(fs) == ["PIPJ004", "PIPJ004"]
    assert {f.symbol for f in fs} == {"ShardedServingIndex.search", "cross_shard_topk"}


# ---------------------------------------------------------------------------
# mesh_audit: PIPS001-005
# ---------------------------------------------------------------------------

def test_declared_collectives_equal_the_reference():
    ref = {s.name: {prim for prim, _axis in s.collectives} for s in ref_spmd.default_specs()}
    port = {s.reference: s for s in mesh_audit.default_specs() if s.reference}
    assert set(port) == set(ref)
    for name, spec in port.items():
        # the per-shard search body is the reference's collective-free
        # shard_map body; the port gathers the blocks outside it
        declared = spec.body_collectives if name == "sharded_search" else spec.collectives
        assert declared == ref[name], name


def test_undeclared_collective_fires_pipS001():
    def run(mesh, dev):
        mesh.psum([torch.ones(2) for _ in mesh.local])
        mesh_audit._run_topk(mesh, dev)

    spec = mesh_audit.MeshSpec("fixture", "fx.py", "fixture", run, frozenset())
    fs = mesh_audit.audit_collectives("cpu", specs=(spec,))
    assert _rules(fs) == ["PIPS001"] and "'psum'" in fs[0].message


def test_replicated_shard_fires_pips002():
    sv = mesh_audit.tiny_packing(mesh_audit.mesh_mod.make_local_mesh(4, "cpu"))
    assert mesh_audit.audit_replication_serving(sv) == []
    whole = torch.cat([sv.points, sv.points])        # a rank holding twice its rows
    sv.points = whole[: sv.points.shape[0]]
    assert _rules(mesh_audit.audit_replication_serving(sv)) == ["PIPS002"]
    sv.leaders = sv.leaders[:2]
    assert _rules(mesh_audit.audit_replication_serving(sv)) == ["PIPS002", "PIPS002"]


def test_envelope_over_the_card_fires_pips003():
    assert mesh_audit.audit_footprint("cpu") == []
    price = mesh_audit.price_shard_packing(1 << 30, 128, 64, 256, int8=True)
    assert price["rows"] == int(np.ceil((1 << 22) * 1.1))
    assert price["total"] == price["rows"] * (128 + 64 * 4 + 12)
    assert _rules(mesh_audit.audit_footprint("cpu", budget=10 ** 9)) == ["PIPS003"]


def test_host_bounce_fires_pips004():
    def bounce(sv, q):
        sv.points.cpu().numpy()
        return sv.search(q, k=4, beam=8)

    assert _rules(mesh_audit.audit_transfers("cpu", search_call=bounce)) == ["PIPS004"]
    tight = mesh_audit.audit_transfers("cpu", budget={"h2d": 0, "d2h": 1})
    assert _rules(tight) == ["PIPS004"] and "h2d=1 > 0" in tight[0].message


def test_shard_count_branch_fires_pips005():
    def branchy(mesh, dev):
        mesh_audit._run_search(mesh, dev, early_exit=False)
        if mesh.n_shards > 1:
            torch.zeros(3).cumsum(0)

    fs = mesh_audit.audit_mesh_stability("cpu", run=branchy, counts=(1, 2))
    assert _rules(fs) == ["PIPS005"]
