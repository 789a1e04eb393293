"""Input hardening at the public serving boundary (a copy of
``repro/core/validation.py``, kept here so the port imports nothing of the
JAX package).

A NaN query row poisons every distance it touches, a ``k <= 0`` is an
opaque shape error deep in the engine, and a query matrix of the wrong
width gathers out-of-range rows.  None of those get past the boundary, and
the error says which rows are at fault.
"""
from __future__ import annotations

import numpy as np


class InvalidQueryError(ValueError):
    """A query batch failed boundary validation.

    ``rows`` lists the offending row indices (empty for batch-level
    failures such as a wrong shape or a non-numeric dtype), ``reason`` is a
    machine-usable tag ("nan_inf" | "shape" | "dtype").
    """

    def __init__(self, message: str, *, rows=(), reason: str = "invalid"):
        super().__init__(message)
        self.rows = tuple(int(r) for r in rows)
        self.reason = reason


def nonfinite_rows(queries: np.ndarray) -> np.ndarray:
    """Indices of rows containing any NaN/Inf entry."""
    q = np.asarray(queries)
    bad = ~np.isfinite(q).all(axis=tuple(range(1, q.ndim)))
    return np.nonzero(bad)[0]


def validate_queries(queries, dim: int | None = None) -> np.ndarray:
    """Validate a query batch; returns it as a C-contiguous float32 [Q, d]
    array, or raises :class:`InvalidQueryError` for a non-castable dtype
    (``"dtype"``), a shape other than [Q, dim] (``"shape"``) or rows with
    NaN/Inf (``"nan_inf"``, ``rows`` set)."""
    try:
        q = np.ascontiguousarray(queries, dtype=np.float32)
    except (TypeError, ValueError) as e:
        raise InvalidQueryError(
            f"queries are not castable to float32: {e}",
            reason="dtype") from e
    if q.ndim != 2:
        raise InvalidQueryError(
            f"queries must be a 2-D [Q, d] batch, got shape {q.shape} "
            f"(a single query is queries[None, :])", reason="shape")
    if dim is not None and q.shape[0] and q.shape[1] != dim:
        raise InvalidQueryError(
            f"query width {q.shape[1]} does not match the index "
            f"dimension {dim}", reason="shape")
    rows = nonfinite_rows(q)
    if rows.size:
        head = ", ".join(str(r) for r in rows[:8])
        more = "" if rows.size <= 8 else f", ... ({rows.size} total)"
        raise InvalidQueryError(
            f"query rows [{head}{more}] contain NaN/Inf — a non-finite "
            f"query poisons every distance it touches; drop or fix the "
            f"rows (InvalidQueryError.rows lists them)",
            rows=rows, reason="nan_inf")
    return q


def validate_search_params(*, k: int, beam: int) -> None:
    """``k`` / ``beam`` guards shared by every search entry."""
    if int(k) <= 0:
        raise ValueError(f"k must be >= 1, got {k}")
    if int(beam) <= 0:
        raise ValueError(f"beam must be >= 1, got {beam}")
