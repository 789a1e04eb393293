"""The port's serving loop, fault injection and ``Retriever``
(``repro_torch.launch``, ``repro_torch.testing.faults``) against the JAX
package on the CPU.

Every scenario of the reference's own loop tests (``tests/test_serve_loop.py``)
runs on both packages with the same requests, a fake clock and the same
fault plans, and the two records must be equal: each ``Result`` (rid, ids,
error, phase, partial, operating point), the loop's ``counters``, its
``on_event`` log and the injector's events.  The S = 8 shard-failure drill
runs on the port here and on the reference in the subprocess of
``_torch_shard_reference``.  Tolerance: exact; the data are integers (the
chain graph too), so every float32 sum is exact in any order."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve_loop as j_loop
import repro.testing.faults as j_faults
import repro_torch.launch.serve_loop as t_loop
import repro_torch.testing.faults as t_faults
from _torch_shard_reference import DRILL, reference_dir, shard_inputs
from repro.core import sketch as jsketch
from repro.core.serving import ServingIndex as JServingIndex
from repro.core.validation import InvalidQueryError as JInvalidQueryError
from repro.launch.serve import Retriever as JRetriever
from repro_torch.core import sketch as tsketch
from repro_torch.core.beam_search import brute_force_knn, recall_at_k
from repro_torch.core.serving import ServingIndex
from repro_torch.core.validation import InvalidQueryError
from repro_torch.data import (VectorPipelineConfig, dyadic_hyperplanes, make_queries,
                              make_vectors, sift_like)
from repro_torch.distributed.fault_tolerance import (RollingPercentile, RunGuard,
                                                     StepWatchdog)
from repro_torch.launch.serve import Retriever

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """These tests run many operations on tiny tensors: torch's intra-op
    threads would only contend with the other test workers' (and the
    reference subprocess's), so this module runs them on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def data():
    return shard_inputs()


def _chain():
    """A path graph with the entry at one end (integer coordinates, 8 apart
    on the first axis): a query at the far end cannot converge in any
    reasonable cap, queries near the entry converge at once."""
    n, d = 512, 8
    rng = np.random.default_rng(5)
    x = np.zeros((n, d), np.float32)
    x[:, 0] = 8 * np.arange(n)
    x[:, 1:] = rng.integers(-1, 2, (n, d - 1))
    graph = np.full((n, 2), -1, np.int32)
    graph[:, 0] = np.arange(n) - 1
    graph[: n - 1, 1] = np.arange(1, n)
    q = np.concatenate([x[:6] + 1, x[n - 1:] + 1]).astype(np.float32)
    return graph, x, q


PACKAGES = {
    "ref": (j_loop, j_faults, lambda g, x, s: JServingIndex.from_graph(g, x, s)),
    "port": (t_loop, t_faults, lambda g, x, s: ServingIndex.from_graph(g, x, s, device=CPU)),
}


def _results(res) -> list:
    return [(r.rid, None if r.ids is None else np.asarray(r.ids).tolist(), r.error, r.phase,
             r.partial, r.op_point) for r in res]


def _loop(loopmod, sv, events=None, **kw):
    log = [] if events is None else events
    return loopmod.ServeLoop(sv, clock=kw.pop("clock", FakeClock()),
                             on_event=lambda k, d: log.append((k, d)), **kw)


def _record(loop, res, events, **extra) -> dict:
    return dict(results=_results(res), counters=dict(loop.counters), events=events,
                rung=loop.operating_point.name, **extra)


# -------------------------------------------------------------- scenarios --
# each takes (loop module, faults module, the served index, the data of
# that index, the chain index and its data) and returns its record

def _queue_full(L, F, sv, data, chain):
    x = data["x"]
    ev = []
    loop = _loop(L, sv, ev, k=4, query_chunk=4, max_queue=6)
    for i in range(6):
        loop.submit(x[i])
    with pytest.raises(L.QueueFull) as ei:
        loop.submit(x[6])
    res = loop.step()
    loop.submit(x[6])
    res += loop.run_until_drained()
    return _record(loop, res, ev, full=(ei.value.depth, ei.value.retry_after))


def _admission_errors(L, F, sv, data, chain):
    loop = _loop(L, sv, k=4)
    with pytest.raises((InvalidQueryError, JInvalidQueryError)) as ei:
        loop.submit(np.zeros(7, np.float32))
    errs = [ei.value.reason, loop.queue_depth]
    for kw in (dict(k=0), dict(k=4, ladder=(L.OperatingPoint("bad", beam=0),))):
        with pytest.raises(ValueError) as ei:
            L.ServeLoop(sv, **kw)
        errs.append(str(ei.value))
    return dict(errors=errs)


def _poison(L, F, sv, data, chain):
    rng = np.random.default_rng(3)
    q = rng.integers(0, 256, (8, 16)).astype(np.float32)
    q[3, 0] = np.nan
    ev = []
    loop = _loop(L, sv, ev, k=5, query_chunk=8)
    for qi in q:
        loop.submit(qi)
    res = loop.run_until_drained()
    clean = np.delete(q, 3, axis=0)
    want = sv.search(clean, k=5, beam=loop.operating_point.beam,
                     expansions=loop.operating_point.expansions, iters=loop.backstop_iters)
    got = [r.ids for r in sorted(res, key=lambda r: r.rid) if r.ok]
    assert np.array_equal(np.stack(got), want)     # batchmates are served as if clean
    return _record(loop, res, ev)


def _two_phase(L, F, sv, data, chain):
    csv, q = chain
    kw = dict(k=4, query_chunk=8, straggler_chunk=2,
              ladder=(L.OperatingPoint("b8", beam=8, expansions=4),), drain_iters=8,
              backstop_iters=32)
    out = {}
    for two in (True, False):
        ev = []
        loop = _loop(L, csv, ev, two_phase=two, **kw)
        for qi in q:
            loop.submit(qi)
        out[str(two)] = _record(loop, loop.run_until_drained(), ev)
    two, one = out["True"]["results"], out["False"]["results"]
    assert out["True"]["counters"]["rerun_phase2"] >= 1
    assert two[-1][3] == 2                              # the far-end straggler
    for a, b in zip(sorted(two), sorted(one)):
        # drained rows bit-identical, and a straggler's rerun runs the same
        # search to the same cap as the single-phase batch
        assert a[1] == b[1]
    return out


def _partial(L, F, sv, data, chain):
    csv, q = chain
    clock = FakeClock()
    ev = []
    loop = _loop(L, csv, ev, k=4, query_chunk=8, drain_iters=8,
                 ladder=(L.OperatingPoint("b8", beam=8, expansions=4),), backstop_iters=32,
                 clock=clock)
    orig = loop._search

    def ticking(*a, **kw):
        clock.t += 1.0
        return orig(*a, **kw)

    loop._search = ticking
    for qi in q:
        loop.submit(qi)
    loop._queue[-1].deadline = 0.5
    res = loop.run_until_drained()
    assert sum(r.partial for r in res) == 1
    return _record(loop, res, ev)


def _timeout(L, F, sv, data, chain):
    x = data["x"]
    clock = FakeClock()
    ev = []
    loop = _loop(L, sv, ev, k=4, clock=clock)
    loop.submit(x[0], deadline_s=0.5)
    loop.submit(x[1])
    clock.t = 1.0
    res = loop.step()
    assert res[0].error == "timeout"
    return _record(loop, res, ev)


def _depth_shift(L, F, sv, data, chain):
    ev = []
    loop = _loop(L, sv, ev, k=4, query_chunk=4, max_queue=64, queue_high=8, shift_cooldown=1)
    q = np.random.default_rng(11).integers(0, 256, (32, 16)).astype(np.float32)
    for qi in q:
        loop.submit(qi)
    res = loop.step()
    assert loop.operating_point.name == loop.ladder[1].name
    res += loop.run_until_drained()
    res += loop.step()
    assert loop.counters["downshift"] >= 1 and loop.counters["upshift"] >= 1
    return _record(loop, res, ev)


def _p99_shift(L, F, sv, data, chain):
    ev = []
    loop = _loop(L, sv, ev, k=4, query_chunk=4, slo_p99=0.5, queue_high=10**6,
                 min_p99_samples=4, shift_cooldown=0)
    for _ in range(8):
        loop._p99.record(2.0)
    loop.submit(data["x"][0])
    res = loop.step()
    assert loop.operating_point.name == loop.ladder[1].name
    return _record(loop, res, ev)


BENCH = """[{"records": [
  {"engine": "serve_E4", "beam": 32, "recall": 0.95, "qps": 1000},
  {"engine": "serve_E2", "beam": 16, "recall": 0.90, "qps": 3000},
  {"engine": "serve_E2", "beam": 24, "recall": 0.88, "qps": 2000},
  {"engine": "serve_E1", "beam": 8,  "recall": 0.80, "qps": 9000},
  {"engine": "serve_i8", "beam": 24, "recall": 0.93, "qps": 8000},
  {"engine": "single",   "beam": 32, "recall": 0.96, "qps": 100},
  {"engine": "np_oracle","beam": 24, "recall": 0.94}
]}]"""


def _pareto(L, F, sv, data, chain, tmp_path):
    path = tmp_path / "qps.json"
    path.write_text(BENCH)
    ladder = L.ladder_from_bench(path)
    assert [p.name for p in ladder] == ["serve_b32_E4", "serve_b16_E2", "serve_b8_E1"]
    ev = []
    loop = _loop(L, sv, ev, k=4, query_chunk=4, ladder=ladder, queue_high=4,
                 shift_cooldown=1)
    for qi in data["q"][:24]:
        loop.submit(qi)
    res = loop.run_until_drained()
    return _record(loop, res, ev, ladder=[tuple(vars(p).values()) for p in ladder],
                   missing=L.ladder_from_bench(tmp_path / "missing.json"),
                   default=[tuple(vars(p).values()) for p in L.default_ladder(32)])


def _patch_restore(L, F, sv, data, chain):
    x = data["x"]
    orig = sv.search
    with pytest.raises(F.InjectedShardFailure) as ei:
        with F.inject_faults(sv, F.FaultPlan(shard_down={0: (0, None)})) as inj:
            sv.search(x[:2], k=4, beam=8)
    assert sv.search == orig and "search" not in vars(sv)
    return dict(failure=(ei.value.shard, ei.value.call, str(ei.value)), events=inj.events,
                ids=sv.search(x[:2], k=4, beam=8).tolist())


def _forced_xla(L, F, sv, data, chain):
    x = data["x"]
    plan = F.FaultPlan(straggle={1: 0.01}, force_kernel_path={0: "xla"})
    with F.inject_faults(sv, plan) as inj:
        ids0, stats = sv.search(x[:2], k=4, beam=8, with_stats=True)
        ids1 = sv.search(x[:2], k=4, beam=8)
    assert stats["kernel_path"] == "xla"
    return dict(events=inj.events, calls=inj.calls, ids=[ids0.tolist(), ids1.tolist()],
                path=stats["kernel_path"])


def _poison_queries(L, F, sv, data, chain):
    q = np.zeros((40, 4), np.float32)
    out = []
    for frac, seed, value in ((0.05, 9, np.nan), (0.001, 1, np.inf), (0.3, 2, np.nan),
                              (0.0, 0, np.nan)):
        p, rows = F.poison_queries(q, frac, seed=seed, value=value)
        out.append((rows.tolist(), np.isnan(p).sum().item(), np.isinf(p).sum().item()))
    return dict(out=out)


SCENARIOS = {"queue_full": _queue_full, "admission_errors": _admission_errors,
             "poison": _poison, "two_phase_drain": _two_phase,
             "partial_on_deadline": _partial, "timeout": _timeout,
             "ladder_shift_on_depth": _depth_shift, "ladder_shift_on_p99": _p99_shift,
             "pareto_ladder": _pareto, "patch_restore": _patch_restore,
             "forced_xla": _forced_xla, "poison_queries": _poison_queries}


@pytest.mark.parametrize("name", SCENARIOS)
def test_loop_scenario_equals_reference(data, name, tmp_path):
    records = {}
    for pkg, (L, F, pack) in PACKAGES.items():
        sv = pack(data["graph"], data["x"], int(data["start"]))
        graph, x, q = _chain()
        chain = (pack(graph, x, 0), q)
        fn = SCENARIOS[name]
        args = (L, F, sv, data, chain) + ((tmp_path / pkg,) if name == "pareto_ladder" else ())
        if name == "pareto_ladder":
            (tmp_path / pkg).mkdir()
        records[pkg] = fn(*args)
    assert records["port"] == records["ref"]


# ------------------------------------------------- the S = 8 shard-failure drill --

@pytest.fixture(scope="module")
def reference_drill(tmp_path_factory):
    return json.loads((reference_dir(tmp_path_factory) / "drill.json").read_text())


def test_shard_failure_drill_equals_reference(data, reference_drill):
    """One of 8 shards killed for search calls [1, 6), 5% NaN queries, one
    injected straggler: every request is answered, exactly the poisoned
    rows get ``invalid:nan_inf``, the shard is tombstoned once and
    re-admitted once, degraded recall holds 0.85 of healthy, and results,
    counters, events and injected faults equal the reference's."""
    x, q = data["x"], data["q"]
    ssv = ServingIndex.from_graph(data["graph"], x, int(data["start"]), n_shards=8,
                                  device=CPU)
    truth = brute_force_knn(torch.from_numpy(x), torch.from_numpy(q), 10)
    r_healthy = recall_at_k(ssv.search(q, k=10, beam=32), truth, 10)
    qp, rows = t_faults.poison_queries(q, 0.05, seed=DRILL["poison_seed"])
    plan = t_faults.FaultPlan(**DRILL["plan"])
    log = []
    with t_faults.inject_faults(ssv, plan) as inj:
        loop = t_loop.ServeLoop(ssv, clock=FakeClock(), on_event=lambda k, d: log.append([k, d]),
                                **DRILL["loop"])
        rids = [loop.submit(qi) for qi in qp]
        res = loop.run_until_drained()
        for _ in range(12):
            res += loop.step()
            if not loop.index.down_shards:
                break
    got = dict(rids=rids, poisoned=rows.tolist(), down_after=list(ssv.down_shards),
               results=[[r.rid, None if r.ids is None else r.ids.tolist(), r.error, r.phase,
                         r.partial, r.op_point] for r in res],
               counters=dict(loop.counters), events=log,
               injector=[[k, c, d] for k, c, d in inj.events], calls=inj.calls)
    assert json.loads(json.dumps(got)) == reference_drill
    assert len(res) == len(qp) and ["shard_failure", 1, 7] in got["injector"]
    assert sorted(r.rid for r in res if r.error) == rows.tolist()
    assert all(r.error == "invalid:nan_inf" for r in res if not r.ok)
    assert loop.counters["shards_marked_down"] == 1 == loop.counters["shards_readmitted"]
    assert not ssv.down_shards and "search" not in vars(ssv)
    ids = np.full((len(qp), 10), -1, np.int64)
    for r in res:
        if r.ok:
            ids[r.rid] = r.ids
    ok_rows = np.setdiff1d(np.arange(len(qp)), rows)
    assert recall_at_k(ids[ok_rows], truth[ok_rows], 10) >= 0.85 * r_healthy


# ------------------------------------------------------------ fault tolerance --

def test_rolling_percentile_and_watchdog_equal_reference():
    from repro.distributed import fault_tolerance as jft

    vals = np.random.default_rng(1).exponential(1.0, 300)
    mine, ref = RollingPercentile(window=64), jft.RollingPercentile(window=64)
    assert mine.percentile() == ref.percentile() == 0.0
    for v in vals:
        mine.record(v)
        ref.record(v)
    assert len(mine) == len(ref) == 64
    for pct in (50, 90, 99):
        assert mine.percentile(pct) == ref.percentile(pct)
    times = [1.0] * 12 + [1.1, 9.0, 1.0, 0.9, 7.5]
    a, b = StepWatchdog(min_samples=10), jft.StepWatchdog(min_samples=10)
    assert [a.record(i, t) for i, t in enumerate(times)] == \
        [b.record(i, t) for i, t in enumerate(times)]
    assert a.flagged == b.flagged == [(13, 9.0)]
    guard = RunGuard(install_handlers=False)
    guard._handler(15, None)
    assert guard.should_stop


# ------------------------------------------------------------------ Retriever --

@pytest.fixture(scope="module")
def retrievers():
    """Each package's default MIPS ``Retriever`` on the same integer corpus
    with the same dyadic hyperplanes (the one random state the two draw
    differently)."""
    cfg = VectorPipelineConfig(n=1536, dim=16, n_clusters=16, seed=2)
    corpus, q = sift_like(make_vectors(cfg)), sift_like(make_queries(cfg, 48))
    hp = dyadic_hyperplanes(3, 12, 16)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jsketch, "make_hyperplanes",
                   lambda key, m, d, dtype=jnp.float32: jnp.asarray(hp))
        mp.setattr(tsketch, "make_hyperplanes", lambda seed, m, d: hp)
        want = JRetriever(corpus)
        got = Retriever(corpus, device=CPU)
    finally:
        mp.undo()
    return corpus, q, want, got


@pytest.mark.parametrize("points_dtype", ("f32", "bf16", "int8"))
def test_retriever_equals_reference(retrievers, points_dtype):
    corpus, q, want, got = retrievers
    assert got.index.params.metric == "mips" and not got.index.params.final_prune
    np.testing.assert_array_equal(got.index.graph.numpy(), want.index.graph)
    assert got.index.start == want.index.start
    w = JRetriever(corpus, want.index, points_dtype=points_dtype)
    g = Retriever(corpus, got.index, points_dtype=points_dtype, device=CPU)
    np.testing.assert_array_equal(g.retrieve(q, k=5, beam=32), w.retrieve(q, k=5, beam=32))
    assert g.device_bytes() == w.device_bytes()


def test_retriever_checks_and_shards(retrievers):
    corpus, q, _, got = retrievers
    with pytest.raises(ValueError, match="points_dtype"):
        Retriever(corpus, got.index, points_dtype="fp8", device=CPU)
    with pytest.raises(ValueError, match="does not match"):
        Retriever(corpus, got.index, metric="l2", device=CPU)
    with pytest.raises(ValueError, match="does not match"):
        Retriever(corpus, build_params=got.index.params, metric="l2", device=CPU)
    bad = np.array(q[:3])
    bad[1, 0] = np.nan
    with pytest.raises(InvalidQueryError):
        got.retrieve(bad)
    with pytest.raises(ValueError, match="k must be >= 1"):
        got.retrieve(q, k=0)
    sharded = Retriever(corpus, got.index, n_shards=4, device=CPU)
    want = ServingIndex.from_index(got.index, corpus, n_shards=4, device=CPU)
    np.testing.assert_array_equal(sharded.retrieve(q, k=5), want.search(q, k=5, beam=32))
