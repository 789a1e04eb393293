"""Resilient ANN serving loop (counterpart of ``repro/launch/serve_loop.py``):
continuous batching with a straggler drain, SLO-aware degradation and
shard-failure survival, over a ``ServingIndex`` or a
``ShardedServingIndex``.

  * **Bounded admission.**  ``submit`` enqueues into a bounded queue; when
    it is full it raises :class:`QueueFull` with a ``retry_after`` estimate
    (queue depth x the measured service time a request).
  * **Two-phase straggler drain.**  ``step`` takes up to ``query_chunk``
    requests and searches them with a reduced iteration cap
    (``drain_iters``).  A query the ``converged`` telemetry marks done is
    at its fixed point, so its ids equal a full single-phase run's; only
    the stragglers run again, in chunks of ``straggler_chunk``, under the
    full ``backstop_iters`` cap.
  * **Deadlines.**  An expired request is answered ``timeout`` without a
    search; a straggler whose deadline has passed after phase 1 gets its
    phase-1 beam back flagged ``partial``.
  * **Poison isolation.**  A NaN/Inf request gets an ``invalid:nan_inf``
    result and its batchmates are served.
  * **Degradation.**  A ladder of operating points (beam, expansions; from
    measurements through :func:`ladder_from_bench` where there are some) is
    walked down when the queue depth or the rolling p99
    (``distributed.fault_tolerance.RollingPercentile``) crosses its
    threshold, and back up after a recovery.
  * **Shard failures.**  A search failure that names a shard (the
    exception's ``.shard``) tombstones it (``mark_shard_down``) and the
    same batch is retried on the survivors; tombstoned shards are probed
    every ``probe_every`` steps and re-admitted when ``probe_shard``
    succeeds.

The injected ``clock`` is the loop's only time source; with it and the
schedules of ``testing.faults`` a drill replays exactly.

**Over a multi-rank shard mesh** (a ``ShardedServingIndex`` whose
``mesh`` has a process group) rank 0 runs the loop and every other rank
runs :func:`serve_follower` on its own copy of the index.  Rank 0 alone
reads the clock and the queue, so it alone takes every decision: the
deadlines, which requests are live or poisoned, the phase-2 stragglers
and their chunks, the ladder's shifts and the probes.  Each call of the
index that reaches a collective (``search``, ``probe_shard``) or changes
its health (``mark_shard_down``) is first sent to the followers
(``ShardMesh.broadcast``), and then made on rank 0; the followers make the
same call with the same arguments, in the same order, and drop its
result.  The exceptions raised before the first collective come from
state that every rank holds: ``AllShardsDown`` (the health mask),
``InvalidQueryError`` (the arguments) and a failure that names a shard
(``.shard``, as an injected fault's schedule raises it).  Every rank
raises those alike; a follower drops them and waits for rank 0's next
call, which is the tombstone that follows or the retry.  Any other
exception on a follower (a device error, a collective's timeout) is its
own, so :func:`serve_follower` raises it and the group fails instead of
parting ways.  :meth:`ServeLoop.close` (or leaving ``with
ServeLoop(...)``) sends the followers the stop.  A follower waits in the
broadcast between calls, so the group's timeout (``init_mesh(timeout_s=)``)
bounds how long rank 0 may stay idle.  A rank that dies is not survived:
the others' collectives time out and raise.  In one process (no mesh, or
a mesh without a group) nothing is sent and the loop is as it was.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import time
from typing import Callable

import numpy as np

from repro_torch.core.beam_search import default_iters
from repro_torch.core.validation import (InvalidQueryError, validate_queries,
                                         validate_search_params)
from repro_torch.distributed.fault_tolerance import RollingPercentile
from repro_torch.distributed.serving import AllShardsDown

__all__ = ["OperatingPoint", "QueueFull", "Request", "Result", "ServeLoop",
           "default_ladder", "ladder_from_bench", "serve_follower"]


class QueueFull(RuntimeError):
    """Admission rejected: the bounded request queue is at capacity.

    ``retry_after`` (seconds) estimates when a slot frees up: the queue
    depth times the measured service time a request."""

    def __init__(self, depth: int, retry_after: float):
        super().__init__(f"request queue full ({depth} pending); retry in "
                         f"~{retry_after:.3f}s")
        self.depth = int(depth)
        self.retry_after = float(retry_after)


@dataclasses.dataclass(frozen=True)
class OperatingPoint:
    """One rung of the degradation ladder.  ``recall_bound`` is the
    measured recall at this rung (None = not measured): what a downshift
    trades away, logged at the shift."""

    name: str
    beam: int
    expansions: int = 4
    recall_bound: float | None = None
    qps: float | None = None


@dataclasses.dataclass
class Request:
    rid: int
    query: np.ndarray                 # [d] float32
    deadline: float | None            # absolute, on the loop's clock
    enqueued_at: float


@dataclasses.dataclass
class Result:
    """One request's outcome.  ``error`` is None on success, else
    "invalid:nan_inf" or "timeout"; ``partial`` marks a straggler answered
    with its phase-1 beam because its deadline could not afford phase 2."""

    rid: int
    ids: np.ndarray | None            # [k] int64 global ids, -1 pad
    error: str | None = None
    latency: float = 0.0
    op_point: str = ""
    phase: int = 0                    # 1 = drained, 2 = straggler rerun
    partial: bool = False

    @property
    def ok(self) -> bool:
        return self.error is None


def default_ladder(beam: int = 32) -> tuple[OperatingPoint, ...]:
    """The ladder without measurements: full quality, then half the beam
    with narrower expansion, then a floor rung at minimum cost."""
    return (
        OperatingPoint(f"full_b{beam}", beam=beam, expansions=4),
        OperatingPoint(f"degraded_b{max(8, beam // 2)}", beam=max(8, beam // 2),
                       expansions=2),
        OperatingPoint(f"floor_b{max(4, beam // 4)}", beam=max(4, beam // 4),
                       expansions=1),
    )


def ladder_from_bench(path, *, max_rungs: int = 4) -> tuple[OperatingPoint, ...] | None:
    """The degradation ladder from measurements in ``BENCH_qps.json``'s
    record format: serving-engine records (``engine`` "serve_E{n}" or
    "serve", with ``beam``, ``recall`` and ``qps``) reduced to the
    recall/QPS Pareto frontier by descending recall, so every downshift
    trades a measured recall for a measured throughput.  None when the file
    is missing or holds no usable record (callers take
    :func:`default_ladder`)."""
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    entries = data if isinstance(data, list) else [data]
    points: dict[tuple[int, int], OperatingPoint] = {}
    for entry in entries:
        for rec in entry.get("records", ()):
            engine = str(rec.get("engine", ""))
            if not engine.startswith("serve"):
                continue
            beam, recall = rec.get("beam"), rec.get("recall")
            if beam is None or recall is None:
                continue
            exp = 4
            if "_E" in engine:
                try:
                    exp = int(engine.rsplit("_E", 1)[1])
                except ValueError:
                    continue
            elif engine != "serve":
                continue            # serve_i8 etc.: another packing
            key = (int(beam), exp)
            prev = points.get(key)
            if prev is None or float(recall) > (prev.recall_bound or 0.0):
                points[key] = OperatingPoint(
                    f"serve_b{beam}_E{exp}", beam=int(beam), expansions=exp,
                    recall_bound=float(recall),
                    qps=None if rec.get("qps") is None else float(rec["qps"]))
    if not points:
        return None
    ladder, best_qps = [], -np.inf
    for p in sorted(points.values(), key=lambda p: (-(p.recall_bound or 0.0), -(p.qps or 0.0))):
        if (p.qps or 0.0) > best_qps or not ladder:
            ladder.append(p)
            best_qps = p.qps or 0.0
    return tuple(ladder[:max_rungs])


class ServeLoop:
    """The resilient serving loop over a ``ServingIndex`` or
    ``ShardedServingIndex`` (anything with their ``search`` signature and
    ``converged`` telemetry).

    ``clock`` is the loop's only time source (tests pass a fake): deadlines,
    latencies and the p99 window all read it.  ``two_phase=False`` is plain
    single-phase batching, the baseline of the drain.  Over a mesh with a
    process group the loop runs on rank 0 only (``ValueError`` elsewhere)
    and the other ranks run :func:`serve_follower` until :meth:`close`."""

    def __init__(self, index, *, k: int = 10, query_chunk: int = 32,
                 straggler_chunk: int = 8, max_queue: int = 256,
                 drain_iters: int | None = None, backstop_iters: int | None = None,
                 ladder: tuple[OperatingPoint, ...] | None = None,
                 slo_p99: float | None = None, queue_high: int | None = None,
                 min_p99_samples: int = 20, shift_cooldown: int = 4, probe_every: int = 4,
                 max_retries: int | None = None, two_phase: bool = True,
                 clock: Callable[[], float] = time.monotonic,
                 on_event: Callable[[str, dict], None] | None = None):
        mesh = getattr(index, "mesh", None)
        if mesh is not None and mesh.rank != 0:
            # each rank's clock would take its own straggler and ladder
            # decisions, and the collectives would part ways
            raise ValueError(f"ServeLoop runs on rank 0 of the mesh; rank {mesh.rank} runs "
                             "serve_follower(index)")
        self.index = index
        # the group rank 0 sends each index call over (None in one process)
        self._mesh = mesh if mesh is not None and mesh.group is not None else None
        self._closed = False
        self.k = int(k)
        self.query_chunk = int(query_chunk)
        self.straggler_chunk = max(1, min(int(straggler_chunk), self.query_chunk))
        self.max_queue = int(max_queue)
        self.ladder = tuple(ladder) if ladder else default_ladder()
        for p in self.ladder:
            validate_search_params(k=self.k, beam=p.beam)
        max_beam = max(p.beam for p in self.ladder)
        # phase 1 drains at about half the backstop: low enough that a
        # straggler cannot hold the batch to the full cap, high enough that
        # typical queries converge inside it
        self.drain_iters = int(drain_iters if drain_iters is not None
                               else max(4, default_iters(max_beam) // 2))
        self.backstop_iters = int(backstop_iters if backstop_iters is not None
                                  else default_iters(max_beam))
        self.slo_p99 = slo_p99
        self.queue_high = int(queue_high if queue_high is not None else 2 * self.query_chunk)
        self.min_p99_samples = int(min_p99_samples)
        self.shift_cooldown = int(shift_cooldown)
        self.probe_every = int(probe_every)
        # a retry per shard survives even the every-shard-but-one drill
        n_shards = getattr(index, "n_shards", 1)
        self.max_retries = int(max_retries if max_retries is not None else n_shards)
        self.two_phase = bool(two_phase)
        self.clock = clock
        self.on_event = on_event

        self._dim = int(index.points.shape[-1])
        self._queue: collections.deque[Request] = collections.deque()
        self._next_rid = 0
        self._rung = 0                 # index into self.ladder (0 = best)
        self._steps = 0
        self._last_shift_step = -10**9
        self._p99 = RollingPercentile(window=256)
        self._service_ema = 0.0        # seconds a request, smoothed
        self.counters = collections.Counter()

    # ---------------------------------------------------------- admission --
    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def operating_point(self) -> OperatingPoint:
        return self.ladder[self._rung]

    def submit(self, query: np.ndarray, *, deadline_s: float | None = None) -> int:
        """Enqueue one request; returns its rid.

        Raises :class:`QueueFull` (with ``retry_after``) at capacity and
        :class:`InvalidQueryError` for a query of the wrong width at once;
        non-finite values are accepted here and answered with a structured
        error result when served."""
        if len(self._queue) >= self.max_queue:
            self.counters["rejected"] += 1
            retry = max(0.001, len(self._queue) * max(self._service_ema, 1e-4))
            raise QueueFull(len(self._queue), retry)
        q = np.asarray(query, dtype=np.float32).reshape(-1)
        if q.shape[0] != self._dim:
            raise InvalidQueryError(f"query width {q.shape[0]} does not match the index "
                                    f"dimension {self._dim}", reason="shape")
        rid = self._next_rid
        self._next_rid += 1
        now = self.clock()
        self._queue.append(Request(rid=rid, query=q,
                                   deadline=None if deadline_s is None else now + deadline_s,
                                   enqueued_at=now))
        return rid

    # ------------------------------------------------------------ serving --
    def step(self) -> list[Result]:
        """Serve one batch: form it from the head of the queue, screen
        poison, run the two-phase search, adapt the operating point.
        Returns a Result for each request taken off the queue (none when
        the queue was empty)."""
        self._steps += 1
        if self.probe_every and self._steps % self.probe_every == 0:
            self._probe_tombstones()
        batch: list[Request] = []
        while self._queue and len(batch) < self.query_chunk:
            batch.append(self._queue.popleft())
        if not batch:
            return []
        now = self.clock()
        results: list[Result] = []
        live: list[Request] = []
        for r in batch:
            if r.deadline is not None and now >= r.deadline:
                self.counters["timeout"] += 1
                results.append(Result(r.rid, None, error="timeout",
                                      latency=now - r.enqueued_at))
            elif not np.isfinite(r.query).all():
                self.counters["invalid"] += 1
                results.append(Result(r.rid, None, error="invalid:nan_inf",
                                      latency=now - r.enqueued_at))
            else:
                live.append(r)
        if live:
            results.extend(self._serve(live))
        self._adapt()
        return results

    def run_until_drained(self, *, max_steps: int = 10**6) -> list[Result]:
        out: list[Result] = []
        steps = 0
        while self._queue and steps < max_steps:
            out.extend(self.step())
            steps += 1
        return out

    # ------------------------------------------------------------ internal --
    def _emit(self, kind: str, **detail) -> None:
        if self.on_event is not None:
            self.on_event(kind, detail)

    def close(self) -> None:
        """Send the followers the stop (a no-op in one process and after the
        first call).  A closed loop calls its index no more."""
        if self._mesh is not None and not self._closed:
            self._mesh.broadcast(None)
        self._closed = True

    def __enter__(self) -> "ServeLoop":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _call(self, name: str, *args, **kw):
        """The index's ``name`` on this rank, sent to the followers first
        over a mesh's group."""
        if self._closed:
            raise RuntimeError("the serving loop is closed")
        if self._mesh is not None:
            self._mesh.broadcast((name, args, kw))
        return getattr(self.index, name)(*args, **kw)

    def _search(self, queries: np.ndarray, *, iters: int, chunk: int):
        """One search with shard-failure survival: an exception carrying
        ``.shard`` tombstones that shard and the same batch is retried on
        the survivors (at most ``max_retries`` times)."""
        op = self.operating_point
        for attempt in range(self.max_retries + 1):
            try:
                return self._call("search", queries, k=self.k, beam=op.beam,
                                  expansions=op.expansions, iters=iters,
                                  query_chunk=chunk, with_stats=True)
            except Exception as e:  # noqa: BLE001 (filtered just below)
                shard = getattr(e, "shard", None)
                if (shard is None or attempt >= self.max_retries
                        or not hasattr(self.index, "mark_shard_down")):
                    raise
                self._call("mark_shard_down", int(shard))
                self.counters["shards_marked_down"] += 1
                self._emit("shard_down", shard=int(shard), step=self._steps)
        raise AssertionError("unreachable")  # pragma: no cover

    def _probe_tombstones(self) -> None:
        if not hasattr(self.index, "probe_shard"):
            return
        for s in getattr(self.index, "down_shards", ()):
            if self._call("probe_shard", s):
                self.counters["shards_readmitted"] += 1
                self._emit("shard_up", shard=int(s), step=self._steps)

    def _serve(self, live: list[Request]) -> list[Result]:
        q = validate_queries(np.stack([r.query for r in live]), dim=self._dim)
        t0 = self.clock()
        if not self.two_phase:
            ids, _ = self._search(q, iters=self.backstop_iters, chunk=self.query_chunk)
            return [self._finish(r, ids[i], phase=1, t0=t0) for i, r in enumerate(live)]
        ids1, stats1 = self._search(q, iters=self.drain_iters, chunk=self.query_chunk)
        conv = np.asarray(stats1["converged"], bool)
        results = []
        t1 = self.clock()
        stragglers, s_rows = [], []
        for i, r in enumerate(live):
            if conv[i]:
                results.append(self._finish(r, ids1[i], phase=1, t0=t0, now=t1))
            elif r.deadline is not None and t1 >= r.deadline:
                # phase 2 cannot make the deadline: the valid, possibly
                # unconverged phase-1 beam, flagged
                self.counters["partial"] += 1
                results.append(self._finish(r, ids1[i], phase=1, t0=t0, now=t1,
                                            partial=True))
            else:
                stragglers.append(r)
                s_rows.append(i)
        self.counters["drained_phase1"] += len(results)
        if stragglers:
            self.counters["rerun_phase2"] += len(stragglers)
            for c0 in range(0, len(stragglers), self.straggler_chunk):
                part = stragglers[c0: c0 + self.straggler_chunk]
                qs = q[np.asarray(s_rows[c0: c0 + self.straggler_chunk])]
                ids2, _ = self._search(qs, iters=self.backstop_iters,
                                       chunk=self.straggler_chunk)
                results.extend(self._finish(r, ids2[j], phase=2, t0=t0)
                               for j, r in enumerate(part))
        return results

    def _finish(self, r: Request, ids, *, phase: int, t0: float, now: float | None = None,
                partial: bool = False) -> Result:
        now = self.clock() if now is None else now
        latency = now - r.enqueued_at
        self._p99.record(latency)
        service = now - t0
        self._service_ema = (0.2 * service + 0.8 * self._service_ema
                             if self._service_ema else service)
        self.counters["served"] += 1
        return Result(r.rid, np.asarray(ids), latency=latency,
                      op_point=self.operating_point.name, phase=phase, partial=partial)

    def _adapt(self) -> None:
        """Walk the ladder: down when the queue depth or the rolling p99
        crosses its threshold, up after a recovery (half the thresholds,
        and a cooldown between shifts)."""
        if self._steps - self._last_shift_step < self.shift_cooldown:
            return
        p99 = (self._p99.percentile(99.0)
               if len(self._p99) >= self.min_p99_samples else None)
        depth = self.queue_depth
        overloaded = depth > self.queue_high or (
            self.slo_p99 is not None and p99 is not None and p99 > self.slo_p99)
        recovered = depth <= self.queue_high // 2 and (
            self.slo_p99 is None or p99 is None or p99 < 0.5 * self.slo_p99)
        if overloaded and self._rung + 1 < len(self.ladder):
            self._shift(self._rung + 1, "downshift", depth=depth, p99=p99)
        elif recovered and self._rung > 0:
            self._shift(self._rung - 1, "upshift", depth=depth, p99=p99)

    def _shift(self, rung: int, kind: str, **detail) -> None:
        old, new = self.ladder[self._rung], self.ladder[rung]
        self._rung = rung
        self._last_shift_step = self._steps
        self.counters[kind] += 1
        self._emit(kind, from_point=old.name, to_point=new.name,
                   recall_bound_from=old.recall_bound, recall_bound_to=new.recall_bound,
                   step=self._steps, **detail)


def serve_follower(index) -> collections.Counter:
    """Follow rank 0's ``ServeLoop`` on another rank of ``index``'s mesh:
    make each index call rank 0 sends (``search``, ``probe_shard``,
    ``mark_shard_down``), with its arguments, until rank 0 closes the loop.
    A call's exception that every rank raises alike before the first
    collective (:func:`_raised_on_every_rank`) is dropped: rank 0 met the
    same one from the same state and decides what follows.  Any other
    exception is this rank's own and is raised.  Returns the calls made,
    by name, and ``"raised"``: the calls that raised and were dropped.
    ``ValueError`` on rank 0 or without a process group."""
    mesh = getattr(index, "mesh", None)
    if mesh is None or mesh.group is None or mesh.rank == 0:
        raise ValueError("serve_follower runs on ranks 1..W-1 of a mesh with a process "
                         "group; rank 0 runs ServeLoop(index)")
    calls = collections.Counter()
    while True:
        cmd = mesh.broadcast(None)
        if cmd is None:
            return calls
        name, args, kw = cmd
        calls[name] += 1
        try:
            getattr(index, name)(*args, **kw)
        except Exception as e:  # noqa: BLE001 (filtered just below)
            if not _raised_on_every_rank(e):
                raise
            calls["raised"] += 1


def _raised_on_every_rank(e: BaseException) -> bool:
    """Whether ``e`` is decided before the search's first collective from
    state every rank holds, so that rank 0 raised it too: a failure that
    names a shard, ``AllShardsDown`` or ``InvalidQueryError``."""
    return (getattr(e, "shard", None) is not None
            or isinstance(e, (AllShardsDown, InvalidQueryError)))
