"""Deterministic fault injection for serving drills (counterpart of
``repro/testing/faults.py``; pure numpy and the standard library, copied so
the port imports nothing of the JAX package).

The faults the serving loop (``launch.serve_loop``) must survive are
injected on an exact schedule keyed to the search-call counter, so a drill
replays the same way on every run:

  * **Shard failure**: while a scheduled outage is open, a ``search`` that
    still counts the dead shard healthy raises
    :class:`InjectedShardFailure` (the loop's cue to ``mark_shard_down``
    and retry); once the index has tombstoned the shard, serving goes on
    degraded.  ``probe_shard`` fails until the window closes.
  * **Stragglers**: scheduled calls sleep an injected extra latency.
  * **Poisoned payloads**: :func:`poison_queries` plants NaN/Inf rows at
    seeded positions.
  * **Kernel-path fallback**: scheduled calls are forced down the kernel
    ladder (``kernel_path="xla"``: the plain gather, no kernel launch).

``inject_faults`` patches the instance's ``search`` (the class and every
other index stay untouched) and restores it on exit; the yielded
:class:`FaultInjector` logs every injected fault.

Over a multi-rank shard mesh every rank installs the injector on its own
index with the same plan: the serving loop's followers
(``launch.serve_loop.serve_follower``) make the same ``search`` and
``probe_shard`` calls as rank 0, so each rank's call counter advances
alike, and the health mask a failure is checked against is the same on
every rank.  Every rank then raises the same ``InjectedShardFailure``
before the search's first collective, and sleeps the same straggles.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Mapping

import numpy as np


class InjectedShardFailure(RuntimeError):
    """A scheduled-dead shard was reached while still counted healthy."""

    def __init__(self, shard: int, call: int):
        super().__init__(f"injected failure: shard {shard} is down (search call {call}) "
                         "and has not been tombstoned")
        self.shard = int(shard)
        self.call = int(call)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A fault schedule keyed on the patched instance's search-call counter
    (0-based; probes through the patched ``search`` advance it too).

    ``shard_down`` maps a shard to its outage window ``(first_call,
    last_call)``, half-open, ``None`` = forever.  ``straggle`` maps a call
    to injected extra seconds.  ``force_kernel_path`` maps a call to the
    kernel path forced on it ("hbm" | "xla": down the ladder only)."""

    shard_down: Mapping[int, tuple[int, int | None]] = dataclasses.field(default_factory=dict)
    straggle: Mapping[int, float] = dataclasses.field(default_factory=dict)
    force_kernel_path: Mapping[int, str] = dataclasses.field(default_factory=dict)

    def dead_shards(self, call: int) -> tuple[int, ...]:
        """Shards whose outage window covers ``call``."""
        out = []
        for s, (a, b) in self.shard_down.items():
            if int(a) <= call and (b is None or call < int(b)):
                out.append(int(s))
        return tuple(sorted(out))


def poison_queries(queries: np.ndarray, frac: float = 0.05, *, seed: int = 0,
                   value: float = np.nan) -> tuple[np.ndarray, np.ndarray]:
    """Plant a non-finite ``value`` (NaN by default) in a seeded subset of
    query rows.  Returns ``(poisoned_copy, rows)``; at least one row is
    poisoned whenever ``frac > 0`` and the batch is non-empty."""
    q = np.array(queries, dtype=np.float32, copy=True)
    nq = q.shape[0]
    if nq == 0 or frac <= 0:
        return q, np.empty((0,), np.int64)
    n_bad = max(1, int(round(frac * nq)))
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.choice(nq, size=min(n_bad, nq), replace=False))
    q[rows, 0] = value
    return q, rows.astype(np.int64)


class FaultInjector:
    """The live injector yielded by :func:`inject_faults`.

    ``calls`` counts the intercepted ``search`` calls; ``events`` logs every
    injected fault as ``(kind, call, detail)`` with kinds "shard_failure",
    "straggle" and "kernel_path"."""

    def __init__(self, index: Any, plan: FaultPlan):
        self.index = index
        self.plan = plan
        self.calls = 0
        self.events: list[tuple[str, int, Any]] = []
        self._orig_search = index.search

    def _shard_is_trusted(self, shard: int) -> bool:
        health = getattr(self.index, "_health_np", None)
        if health is None:
            return True     # single-device index: no tombstone to honour
        return bool(health()[shard])

    def search(self, queries, **kw):
        call = self.calls
        self.calls += 1
        for s in self.plan.dead_shards(call):
            if self._shard_is_trusted(s):
                self.events.append(("shard_failure", call, s))
                raise InjectedShardFailure(s, call)
        delay = float(self.plan.straggle.get(call, 0.0))
        if delay > 0:
            self.events.append(("straggle", call, delay))
            time.sleep(delay)
        path = self.plan.force_kernel_path.get(call)
        if path is not None:
            self.events.append(("kernel_path", call, path))
            kw["kernel_path"] = path
        return self._orig_search(queries, **kw)


@contextlib.contextmanager
def inject_faults(index, plan: FaultPlan):
    """Run ``index`` under the fault schedule ``plan``: shadow the
    instance's ``search`` (this object only) and restore it on exit, also
    when the block exits through an injected exception."""
    injector = FaultInjector(index, plan)
    object.__setattr__(index, "search", injector.search)
    try:
        yield injector
    finally:
        try:
            object.__delattr__(index, "search")
        except AttributeError:
            pass
