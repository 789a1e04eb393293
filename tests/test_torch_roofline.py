"""The port's roofline (``repro_torch.roofline``) on the CPU, held against
the reference's (``repro.roofline``): the same functions give the same
numbers on the same counts; the dispatch walker counts what
``tests/test_hlo_cost.py`` holds the HLO walker to; operation counts equal
``hlo_cost``'s on the same inputs; the S = 8 collective bytes a shard equal
the reference's compiled programs'; a program's work does not depend on
what implements its kernels; every registered program gets a complete
record; and the kernels' work models give ``PERF.md``'s shape-only bounds.
"""
import functools
import json

import jax
import numpy as np
import pytest
import torch

from repro.roofline import analysis as ref_analysis
from repro.roofline import hlo_cost
from repro_torch.analysis import hotpath_audit, memory_audit, mesh_audit
from repro_torch.roofline import H100, HW, CellRoofline, Work, analysis, op_cost
from _torch_build_reference import reference_dir as build_reference_dir
from _torch_shard_reference import reference_dir as shard_reference_dir

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


@pytest.fixture(autouse=True)
def _one_thread():
    # tiny tensors: more threads than one only oversubscribe the xdist workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hlo_flops(fn, *args) -> float:
    return hlo_cost.analyze(jax.jit(fn).lower(*args).compile().as_text(), n_devices=1).flops


def _walk(fn, *args, **kwargs):
    with op_cost.walk() as w:
        out = fn(*args, **kwargs)
    return w, out


# ------------------------------------------ the reference's own functions ---

@pytest.mark.parametrize("op", COLLECTIVES)
def test_wire_model_is_the_reference(op):
    for g in (1, 2, 4, 8):
        for nbytes in (0, 100, 12345):
            assert analysis.wire_bytes_for(op, nbytes, g) == hlo_cost.wire_bytes_for(
                op, nbytes, g)


def test_collective_log_is_priced_as_the_reference_prices_hlo():
    hlo = "\n".join([
        "  %ag = f32[8,16]{1,0} all-gather(f32[1,16]{1,0} %p), "
        "replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}",
        "  %a2a = s32[8,40]{1,0} all-to-all(s32[8,40]{1,0} %q), "
        "replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}",
        "  %ar = s32[3]{0} all-reduce(s32[3]{0} %r), replica_groups={{0,1,2,3,4,5,6,7}}",
        "  %ar1 = s32[3]{0} all-reduce(s32[3]{0} %r), replica_groups={{0}}"])
    ref = ref_analysis.collective_bytes(hlo, n_devices=8)
    port = analysis.collective_bytes([("all_gather", 8 * 16 * 4, 8), ("all_to_all", 8 * 40 * 4, 8),
                                      ("psum", 12, 8), ("psum", 12, 1)])
    assert port["by_op"] == ref["by_op"] and port["total"] == ref["total"]
    assert port["count"] == ref["count"] == 3
    assert [(o, w) for o, w, _ in port["ops"]] == [(o, w) for o, w, _ in ref["ops"]]


# raw counts: (flops, bytes, collective bytes, resident bytes), each term leading once
RAW = [(3.1e12, 2.0e9, 1.0e6, 4.0e9), (1.0e9, 8.0e11, 0.0, 2.0e10),
       (5.0e6, 1.0e7, 9.0e9, 1.7e10), (0.0, 0.0, 0.0, 0.0)]


def _pair(flops, nbytes, coll, resident):
    v5e = ref_analysis.V5E
    hw = HW(peak_ops={c: v5e.peak_flops for c in analysis.CLASSES}, hbm_bw=v5e.hbm_bw,
            link_bw=v5e.link_bw, hbm_bytes=v5e.hbm_bytes)
    ref = ref_analysis.CellRoofline(
        name="cell", mesh="host", n_devices=1, kind="build", hlo_flops=flops, hlo_bytes=nbytes,
        coll_bytes=coll, coll_by_op={"all-gather": coll}, bytes_per_device=resident
    ).finalize(v5e)
    port = CellRoofline(
        name="cell", mesh="host", n_devices=1, kind="build", work_ops={"f32": flops},
        work_bytes=nbytes, coll_bytes=coll, coll_by_op={"all-gather": coll},
        bytes_per_device=resident).finalize(hw)
    return ref, port


@pytest.mark.parametrize("raw", RAW)
def test_terms_bound_and_json_are_the_reference(raw):
    ref, port = _pair(*raw)
    for key in ("t_compute", "t_memory", "t_collective", "dominant", "fits_hbm", "coll_by_op"):
        assert port.to_json()[key] == ref.to_json()[key], key
    assert port.bound_seconds() == ref.bound_seconds()
    assert port.dispatched_over_work == ref.useful_ratio == 0.0
    for s in (0.0, -1.0, 3.2e-7, 4.5e-4, 0.0123, 0.9999, 1.0, 12.5):
        assert analysis.fmt_seconds(s) == ref_analysis.fmt_seconds(s)


def test_markdown_table_is_the_reference():
    pairs = [_pair(*raw) for raw in RAW]
    ref = ref_analysis.markdown_table([r for r, _ in pairs]).splitlines()
    port = analysis.markdown_table([p for _, p in pairs]).splitlines()
    # the rows are identical; the header names the ratio honestly: the
    # dispatched counts over the work, where the reference has useful / HLO
    assert port[1:] == ref[1:]
    assert port[0] == ref[0].replace("useful/HLO", "dispatched/work")


def test_h100_is_the_data_sheet():
    assert dict(H100.peak_ops) == {"f32": 67e12, "tf32": 495e12, "bf16": 989e12,
                                   "int8": 1979e12}
    assert (H100.hbm_bw, H100.link_bw) == (3.35e12, 450e9)
    assert H100.memory() == 80e9          # no card here: the data sheet's
    with pytest.raises(KeyError):
        H100.terms({"fp8": 1.0}, 0.0)


# ---------------------------------- the walker, as test_hlo_cost tests hlo_cost ---

def test_plain_matmul_ops_and_bytes():
    w, _ = _walk(torch.matmul, torch.randn(64, 256), torch.randn(256, 32))
    assert w.ops == {"f32": 2 * 64 * 256 * 32}
    io_bytes = (64 * 256 + 256 * 32 + 64 * 32) * 4
    assert io_bytes <= w.bytes <= 3 * io_bytes
    assert w.mem_ops[0] == ("aten.mm.default", io_bytes)


def test_byte_movers_keep_the_top_forty_largest():
    def many(x):
        for i in range(1, 61):
            x[:i].clone()
    w, _ = _walk(many, torch.zeros(64, 16))
    assert len(w.mem_ops) == op_cost.TOP == 40
    assert [b for _, b in w.mem_ops] == [2.0 * i * 16 * 4 for i in range(60, 20, -1)]


def test_batched_matmul_ops():
    w, _ = _walk(torch.einsum, "bik,bkj->bij", torch.randn(4, 32, 64), torch.randn(4, 64, 16))
    assert w.ops == {"f32": 4 * 2 * 32 * 64 * 16}


def test_python_loop_is_counted_every_iteration():
    wt, x = torch.randn(128, 128), torch.randn(128, 128)

    def scanned(wt, x):
        for _ in range(17):
            y = x
            for _ in range(5):
                y = torch.tanh(y @ wt)
            x = y
        return x

    w, _ = _walk(scanned, wt, x)
    assert w.ops == {"f32": 17 * 5 * 2 * 128 ** 3}


def test_slicing_charges_the_window_only():
    big = torch.randn(4096, 128)
    w, _ = _walk(lambda b: b[5:13].clone(), big)
    assert 0 < w.bytes < 4096 * 128 * 4 / 2
    assert w.bytes == 2 * 8 * 128 * 4


def test_views_are_free():
    big = torch.randn(4096, 128)
    w, _ = _walk(lambda b: (b.view(128, 4096).t(), b[:, :3], b.reshape(-1), b.T.unsqueeze(0)),
                 big)
    assert w.bytes == 0 and w.ops == {}


def test_product_classes_and_unknown_dtypes():
    a8 = torch.randint(-8, 8, (32, 64), dtype=torch.int8)
    w, _ = _walk(torch._int_mm, a8, a8.T.contiguous())
    assert w.ops == {"int8": 2 * 32 * 64 * 32}
    bf = torch.randn(8, 16).to(torch.bfloat16)
    assert _walk(torch.mm, bf, bf.T)[0].ops == {"bf16": 2 * 8 * 16 * 8}
    with pytest.raises(op_cost.UncountedOp):
        _walk(torch.mm, torch.randn(4, 4, dtype=torch.float64), torch.randn(4, 4,
                                                                            dtype=torch.float64))


def test_every_kernel_counter_has_a_model():
    from repro_torch import kernels

    assert set(op_cost.kernel_models()) == set(kernels._MODULES)


# -------------------------------- operations held against hlo_cost's ---

def test_sketch_ops_equal_hlo_cost():
    from repro.core import sketch as ref_sketch
    from repro_torch.core import sketch

    rng = np.random.default_rng(0)
    x, hp = rng.normal(size=(300, 24)).astype(np.float32), rng.normal(size=(12, 24)).astype(
        np.float32)
    w, _ = _walk(sketch.sketch, torch.from_numpy(x), torch.from_numpy(hp))
    assert w.ops == {"f32": _hlo_flops(ref_sketch.sketch, x, hp)}


@pytest.mark.parametrize("metric", ("l2", "cosine"))
def test_leader_assign_ops_equal_hlo_cost(metric):
    from repro.core import leader_assign as ref_la
    from repro_torch.core.leader_assign import leader_assign

    rng = np.random.default_rng(1)
    x, lead = rng.normal(size=(500, 16)).astype(np.float32), rng.normal(size=(40, 16)).astype(
        np.float32)
    w, _ = _walk(leader_assign, torch.from_numpy(x), torch.from_numpy(lead), 3, metric=metric)
    ref = _hlo_flops(functools.partial(ref_la.leader_assign, f=3, metric=metric), x, lead)
    assert w.ops == {"f32": ref}


def test_pairwise_distance_models_against_the_oracles():
    """#8 forms each float32 product as three TF32 products (3xTF32): its
    TF32 operations are three times the oracle's products.  #9 counts the
    oracle's int32 products as int8 operations, exactly."""
    from repro.kernels import ref
    from repro_torch.kernels import distance

    rng = np.random.default_rng(2)
    a, b = rng.normal(size=(3, 70, 37)).astype(np.float32), rng.normal(size=(3, 50, 37)).astype(
        np.float32)
    w = distance.work(torch.from_numpy(a), torch.from_numpy(b))
    assert w["ops"] == {"tf32": 3 * _hlo_flops(ref.pairwise_distance_ref, a, b)}
    a8, b8 = (rng.integers(-127, 128, size=t.shape).astype(np.int8) for t in (a, b))
    w8 = distance.work_int8(torch.from_numpy(a8), torch.from_numpy(b8))
    assert w8["ops"] == {"int8": _hlo_flops(ref.pairwise_distance_int8_ref, a8, b8)}


def test_gather_int8_model_against_its_core_oracle():
    """#6: every id valid, so the oracle's einsum over all [Q, C] slots is
    the model's valid products."""
    from repro.kernels import ref
    from repro_torch.kernels import gather_distance_int8

    rng = np.random.default_rng(3)
    n, d, nq, c = 200, 32, 6, 40
    pts = rng.integers(-127, 128, size=(n, d)).astype(np.int8)
    ids = rng.integers(0, n, size=(nq, c)).astype(np.int32)
    sc, nr = rng.random(n).astype(np.float32), rng.random(n).astype(np.float32)
    q8 = rng.integers(-127, 128, size=(nq, d)).astype(np.int8)
    sq, qn = rng.random(nq).astype(np.float32), rng.random(nq).astype(np.float32)
    flops = _hlo_flops(functools.partial(ref.gather_distance_int8_core, metric="l2"),
                       pts, sc, nr, q8, sq, qn, ids)
    t = torch.from_numpy
    w = gather_distance_int8.work(t(pts), t(sc), t(nr), t(q8.astype(np.float32)), t(qn), t(ids))
    assert w["ops"] == {"int8": flops}


def test_leaf_model_counts_each_unordered_pair_once():
    """#1: the oracle forms each padded c x c leaf matrix (B c^2 d
    products); the model counts one d-long product for each unordered pair
    of valid points (2d operations), at three TF32 products each."""
    from repro.kernels import ref
    from repro_torch.kernels import leaf_knn

    rng = np.random.default_rng(4)
    n, d, nb, c = 300, 16, 5, 24
    x = rng.normal(size=(n, d)).astype(np.float32)
    ids = np.full((nb, c), -1, np.int32)
    sizes = [24, 17, 3, 1, 0]
    for i, s in enumerate(sizes):
        ids[i, :s] = rng.choice(n, s, replace=False)
    pts = x[np.maximum(ids, 0)]
    oracle = _hlo_flops(functools.partial(ref.leaf_topk_ref, k=2), pts, ids >= 0)
    assert oracle == 2 * nb * c * c * d
    w = leaf_knn.work(torch.from_numpy(x), torch.from_numpy(ids), 2)
    pairs = sum(s * (s - 1) // 2 for s in sizes)
    assert w["ops"] == {"tf32": 3 * 2 * d * pairs}
    rows = len({int(i) for i in ids.ravel() if i >= 0})
    assert w["bytes"] == ids.size * 4 + rows * d * 4 + nb * c * 2 * 8


def test_gather_model_counts_the_products_the_oracle_leaves_elementwise():
    """#4: the float32 oracle multiplies elementwise, which hlo_cost does
    not count (0 operations); the model counts 2d float32 operations for
    each valid slot, against a count by hand."""
    from repro.kernels import ref
    from repro_torch.kernels import gather_distance

    rng = np.random.default_rng(5)
    n, d, nq, c = 100, 24, 5, 30
    x = rng.normal(size=(n, d)).astype(np.float32)
    ids = rng.integers(-1, n, size=(nq, c)).astype(np.int32)
    q, nr = rng.normal(size=(nq, d)).astype(np.float32), (x * x).sum(1)
    assert _hlo_flops(ref.gather_distance_ref, x, nr, q, ids) == 0
    t = torch.from_numpy
    w = gather_distance.work(t(x), t(nr), t(q), t(ids))
    valid = int((ids >= 0).sum())
    assert w["ops"] == {"f32": 2.0 * valid * d}
    rows = len({int(i) for i in ids.ravel() if i >= 0})
    assert w["bytes"] == rows * (d * 4 + 4) + ids.size * 8 + nq * d * 4


# ---------------------- collective bytes at S = 8 against the reference ---

def _mesh_roofline(name):
    spec = {s.name: s for s in mesh_audit.default_specs()}[name]
    return mesh_audit.program_roofline(spec, "cpu")


def test_tile_and_prune_wire_bytes_equal_the_reference(tmp_path_factory):
    """The wire bytes the shapes declare (the work) and those the walk
    logged (dispatched) both equal the reference's compiled programs'."""
    coll = json.loads((build_reference_dir(tmp_path_factory) / "coll.json").read_text())
    for name, tag in (("build_tile_step", "tile"), ("build_final_prune", "prune")):
        r = _mesh_roofline(name)
        assert r.coll_by_op == coll[tag], name
        assert r.coll_bytes == r.dispatched_coll_bytes == sum(coll[tag].values()) > 0, name
        assert r.t_collective > 0


def test_search_wire_bytes_against_the_reference(tmp_path_factory):
    """The reference's search program leaves the shards' [S, Q, B] ids and
    dists sharded (its out_specs) and its merge gathers them; the port's
    search gathers them itself, and with them the [S, Q] telemetry blocks
    (hops and dist_comps int32, converged one byte): that difference, by
    name, is the port's extra all-gather."""
    coll = json.loads((shard_reference_dir(tmp_path_factory) / "coll.json").read_text())
    assert coll["search"] == {}
    r = _mesh_roofline("sharded_search")
    s, nq = 8, 4
    telemetry = s * nq * (4 + 4 + 1)
    assert set(r.coll_by_op) == set(coll["merge"]) == {"all-gather"}
    # the work: the [S, Q, B] blocks alone, the reference's merge
    assert r.coll_bytes == coll["merge"]["all-gather"] == s * nq * 8 * 8 * (s - 1) / s
    assert r.dispatched_coll_bytes - r.coll_bytes == telemetry * (s - 1) / s


def test_an_added_exchange_raises_the_dispatch_and_not_the_work(monkeypatch):
    """The work's wire bytes come from the program's shapes: an extra
    exchange that the implementation makes is dispatched, not work."""
    before = _mesh_roofline("build_final_prune")
    real = mesh_audit.RecordingMesh.all_to_all

    def twice(mesh, local_sends):
        real(mesh, local_sends)
        return real(mesh, local_sends)

    monkeypatch.setattr(mesh_audit.RecordingMesh, "all_to_all", twice)
    after = _mesh_roofline("build_final_prune")
    assert after.coll_bytes == before.coll_bytes
    assert after.bound_seconds() == before.bound_seconds()
    assert after.dispatched_coll_bytes > before.dispatched_coll_bytes


# ----------------------------- the same work whatever implements it ---

def _slow_leaf_plain(real):
    def slow(points, leaf_ids, k, metric="l2", **kw):
        pts = points.clone() * 1.0 + 0.0
        return real(pts.contiguous(), leaf_ids.clone(), k, metric, block=1)
    return slow


def test_a_slower_plain_version_changes_no_work_bound_or_dispatch(monkeypatch):
    from repro_torch.kernels import leaf_knn

    prog = {p.name: p for p in hotpath_audit.default_programs()}["stream_step"]
    before = hotpath_audit.program_roofline(prog, "cpu")
    monkeypatch.setattr(leaf_knn, "leaf_topk_plain", _slow_leaf_plain(leaf_knn.leaf_topk_plain))
    with op_cost.walk() as w:        # the slow version runs, and costs more unwalked
        leaf_knn.leaf_topk_plain(torch.zeros(4, 2), torch.zeros((1, 4), dtype=torch.int32), 1)
    after = hotpath_audit.program_roofline(prog, "cpu")
    assert w.bytes > 0
    for key in ("work_ops", "work_bytes", "coll_bytes", "dispatched_ops", "dispatched_bytes",
                "kernel_launches"):
        assert getattr(after, key) == getattr(before, key), key
    assert after.bound_seconds() == before.bound_seconds()


# ---------------------------- every registered program's record ---

def _small(spec):
    """The base point cut down for the CPU, as the memory audit's tests cut it."""
    cut = dict(n=2048, e=4096, s=4, c=64, nq=16, chunk=256, d=16)
    return {k: min(v, cut[k]) if k in cut else v for k, v in spec.base.items()}


def _cpu_measure(spec, point, device):
    prog = spec.build(point, torch.device("cpu"))
    out = prog.fn(*prog.args, **prog.kwargs)
    return memory_audit.io_ledger(prog, out, 0.0)


def _at_least_the_work(r, elementwise=False):
    assert r.dispatched_bytes >= r.work_bytes > 0
    if elementwise:        # the plain gathers' products are elementwise: uncounted
        assert r.dispatched_ops == {} and r.work_ops
    else:
        for c, v in r.work_ops.items():
            assert r.dispatched_ops.get(c, 0.0) >= v, c
    assert r.dispatched_over_work >= 1.0


@pytest.mark.parametrize("name", sorted(s.name for s in memory_audit.default_specs()))
def test_memory_audit_record_carries_the_roofline(name):
    import dataclasses

    spec = {s.name: s for s in memory_audit.default_specs()}[name]
    spec = dataclasses.replace(spec, base=_small(spec), sweep={})
    findings, rec = memory_audit.audit_spec(spec, budget=80 * 10**9, device="cpu",
                                            measure_fn=_cpu_measure)
    roof = rec["roofline"]
    assert all(roof.get(k) is not None for k in analysis.RECORD_KEYS)
    assert roof["dominant"] in ("compute", "memory", "collective")
    assert roof["bound_seconds"] == max(roof["t_compute"], roof["t_memory"],
                                        roof["t_collective"]) > 0
    r = memory_audit.roofline_of(spec, device="cpu")
    _at_least_the_work(r)
    assert r.to_json()["t_memory"] == roof["t_memory"]


@pytest.mark.parametrize("name", [p.name for p in hotpath_audit.default_programs()])
def test_hotpath_programs_walk_at_least_their_work(name):
    prog = {p.name: p for p in hotpath_audit.default_programs()}[name]
    r = hotpath_audit.program_roofline(prog, "cpu")
    assert all(analysis.record(r).get(k) is not None for k in analysis.RECORD_KEYS)
    _at_least_the_work(r, elementwise=name.endswith(",plain]"))
    if name.startswith("engine["):
        # the engine's work is its gathers' models (each distinct row read
        # once a call) plus the graph row of every hop, the queries and the
        # outputs; on the kernel route those gathers are the charged launches
        graph, q = r.walk.args[0], r.walk.args[3]
        hops, comps = r.walk.out[2], r.walk.out[3]
        gathers = [c for c in r.walk.calls if c.counter.startswith("gather_distance")]
        assert all(c.launched == name.endswith(",kernel]") for c in r.walk.calls)
        own = (float(hops.sum()) * graph.shape[1] * 4 + q.numel() * 4
               + sum(t.numel() * t.element_size() for t in r.walk.out))
        assert r.work_bytes == sum(c.work.bytes for c in gathers) + own
        assert r.work_ops == {("int8" if "int8" in name else "f32"):
                              2.0 * q.shape[1] * float(comps.sum())}


def test_engine_work_is_the_same_on_either_route():
    progs = {p.name: p for p in hotpath_audit.default_programs()}
    for dt in ("f32", "bf16", "int8"):
        a, b = (hotpath_audit.program_roofline(progs[f"engine[{dt},{r}]"], "cpu")
                for r in ("kernel", "plain"))
        assert (a.work_ops, a.work_bytes) == (b.work_ops, b.work_bytes), dt


# ------------------------------------------- PERF.md's shape-only bounds ---

def _sig(printed: str) -> int:
    return len(printed.replace(".", "").lstrip("0"))


def _same(value: float, printed: str) -> bool:
    return float(f"{value:.{_sig(printed)}g}") == float(printed)


@pytest.mark.parametrize("kernel,shape,k,printed,by", [
    ("dist", (1, 32768, 16, 128), None, "0.0056366", "bytes"),
    ("dist", (34, 15008, 80, 128), None, "0.12715", "bytes"),
    ("dist", (2, 2048, 1152, 128), None, "0.0073210", "operations"),
    ("topk", (1, 32768, 16), 10, "0.0014085", "bytes"),
    ("topk", (1, 10**6, 1000), 12, "1.2227", "bytes"),
    ("topk", (8, 1024, 1024), 2, "0.010055", "bytes"),
    ("dist8", (8, 1024, 1024, 128), None, "0.010642", "bytes"),
])
def test_work_models_give_the_printed_bounds(kernel, shape, k, printed, by):
    from repro_torch.kernels import distance, topk

    if kernel == "topk":
        w = topk.work(torch.empty(shape, device="meta"), k)
    else:
        b, m, n, d = shape
        dt = torch.int8 if kernel == "dist8" else torch.float32
        a, bb = torch.empty((b, m, d), dtype=dt, device="meta"), torch.empty(
            (b, n, d), dtype=dt, device="meta")
        w = distance.work_int8(a, bb) if kernel == "dist8" else distance.work(a, bb)
    bound = H100.bound(w)
    assert _same(bound["bound_ms"], printed) and bound["bound_by"] == by
    if shape == (34, 15008, 80, 128):     # and its TF32 products alone
        assert _same(1e3 * H100.terms(w["ops"], 0.0)["compute"], "0.063")


def test_work_adds_by_class():
    w = Work({"f32": 1.0}, 2.0) + {"ops": {"f32": 3.0, "int8": 4.0}, "bytes": 5.0, "wire": 6.0}
    assert (w.ops, w.bytes, w.wire) == ({"f32": 4.0, "int8": 4.0}, 7.0, 6.0)
