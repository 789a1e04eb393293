"""Declared host <-> device crossings of the serving paths (counterpart of
``repro/core/transfers.py``).

A search call declares two crossings a chunk: queries in, ids out.
``to_device`` and ``to_host`` are those two crossings, and ``ledger()``
counts them per scope, so a test can hold a search's declared crossings
to ``ShardedServingIndex.TRANSFER_BUDGET``.

PyTorch has no counterpart of ``jax.transfer_guard``: nothing stops a
crossing that does not go through these functions, and the ledger counts
the declared crossings only, as the reference's does.  It is no bound on
host traffic: a read-back such as ``.item()`` or ``torch.nonzero`` goes
uncounted.  Counting is thread-local and costs nothing when no ledger is
open.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

_LOCAL = threading.local()


def _active() -> dict | None:
    return getattr(_LOCAL, "counts", None)


def _bump(kind: str) -> None:
    counts = _active()
    if counts is not None:
        counts[kind] += 1


@contextlib.contextmanager
def ledger():
    """Count declared crossings: yields a live ``{"h2d": int, "d2h": int}``
    dict that ``to_device`` / ``to_host`` update inside the scope.  Scopes
    nest; the inner one shadows the outer."""
    prev = _active()
    _LOCAL.counts = {"h2d": 0, "d2h": 0}
    try:
        yield _LOCAL.counts
    finally:
        _LOCAL.counts = prev


def to_device(x, device) -> torch.Tensor:
    """One declared host -> device crossing: ``x`` (a numpy array) as a
    tensor on ``device``."""
    out = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    _bump("h2d")
    return out


def to_host(t: torch.Tensor) -> np.ndarray:
    """One declared device -> host crossing."""
    out = t.cpu().numpy()
    _bump("d2h")
    return out
