"""Straggler detection, preemption and the serving loop's latency window
(counterpart of ``repro/distributed/fault_tolerance.py``; pure numpy and
the standard library, copied so the port imports nothing of the JAX
package).

  * ``RunGuard`` flips ``should_stop`` on SIGTERM/SIGINT, so a loop can
    finish its step and stop cleanly.
  * ``StepWatchdog`` keeps a rolling window of step times and flags a step
    slower than ``sigma`` standard deviations (and 1.5x the mean).
  * ``RollingPercentile`` is the serving loop's SLO signal: request
    latencies stream in and the loop reads ``percentile(99)``.

Each of these is one process's state.  The sharded index's health mask
(``distributed.serving.ShardedServingIndex``) is the state ranks share: on
a mesh of several ranks every rank holds it whole and changes it alike
(``mark_shard_down`` / ``probe_shard`` with the same arguments), so every
rank raises ``AllShardsDown`` together, before any collective.  A rank
that dies is not survived: the shard failures here are simulated, as in
the reference.

``resume_or_init`` restores a trainer's newest committed checkpoint
(``checkpoint.Checkpointer``; onto a mesh through a given ``restore``) or
initializes it fresh.
"""
from __future__ import annotations

import collections
import dataclasses
import signal
from typing import Any, Callable

import numpy as np


class RunGuard:
    """Cooperative preemption: flips ``should_stop`` on SIGTERM/SIGINT."""

    def __init__(self, install_handlers: bool = True):
        self.should_stop = False
        self._prev = {}
        if install_handlers:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._prev[sig] = signal.signal(sig, self._handler)
                except ValueError:  # not the main thread
                    pass

    def _handler(self, signum, frame):
        self.should_stop = True

    def restore_handlers(self):
        for sig, h in self._prev.items():
            signal.signal(sig, h)


@dataclasses.dataclass
class StepWatchdog:
    """Rolling straggler detector over synchronous step times."""

    window: int = 50
    sigma: float = 4.0
    min_samples: int = 10
    on_straggler: Callable[[int, float, float], None] | None = None
    _times: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=50))
    flagged: list[tuple[int, float]] = dataclasses.field(default_factory=list)

    def record(self, step: int, seconds: float) -> bool:
        """Returns True if this step is flagged as a straggler."""
        is_straggler = False
        if len(self._times) >= self.min_samples:
            mu = float(np.mean(self._times))
            sd = float(np.std(self._times)) + 1e-9
            if seconds > mu + self.sigma * sd and seconds > 1.5 * mu:
                is_straggler = True
                self.flagged.append((step, seconds))
                if self.on_straggler:
                    self.on_straggler(step, seconds, mu)
        self._times.append(seconds)
        return is_straggler


@dataclasses.dataclass
class RollingPercentile:
    """Rolling percentile over a bounded sample window (the latest
    ``window`` values)."""

    window: int = 256
    _values: collections.deque = dataclasses.field(default_factory=collections.deque)

    def __post_init__(self):
        self._values = collections.deque(self._values, maxlen=int(self.window))

    def __len__(self) -> int:
        return len(self._values)

    def record(self, seconds: float) -> None:
        self._values.append(float(seconds))

    def percentile(self, pct: float = 99.0) -> float:
        """Percentile over the current window (0.0 while empty: callers
        check ``len() >= min_samples`` before acting on it)."""
        if not self._values:
            return 0.0
        return float(np.percentile(np.fromiter(self._values, dtype=float), pct))


def resume_or_init(checkpointer, init_fn: Callable[[], Any], like_fn: Callable[[], Any],
                   device=None, restore: Callable | None = None) -> tuple[Any, int, dict]:
    """Restore the newest committed checkpoint into ``like_fn()``'s
    structure, or ``init_fn()`` when there is none.  ``restore(step,
    like) -> (state, extra)`` reads it (``elastic.restore_to_mesh`` onto a
    mesh); by default ``checkpointer.restore`` on ``device`` (default each
    like leaf's).  Returns (state, start_step, extra)."""
    latest = checkpointer.latest_step()
    if latest is None:
        return init_fn(), 0, {}
    if restore is None:
        state, extra = checkpointer.restore(latest, like_fn(), device=device)
    else:
        state, extra = restore(latest, like_fn())
    return state, latest, extra
