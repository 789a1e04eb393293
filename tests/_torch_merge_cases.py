"""Edge-case reservoir pairs for the reservoir merge, R(A u B), as numpy.

Each side of a row is a valid HashPrune reservoir: live slots a prefix
sorted by (dist, id), ids and hashes unique within the side, the tail
padded with (-1, 0, +inf).  The kinds stress what the merge kernel's
design depends on: empty sides, full rows, rows past one 32-slot warp
chunk, exact cross-side (dist, id) ties (in one bucket: A must win; in two:
both stay, A first), and the same id on both sides.  Distances are
multiples of 1/4 of both signs, so equal keys are common.
"""
from __future__ import annotations

import numpy as np

KINDS = ("empty", "full", "partial", "ties", "same_id", "random")
L_VALUES = (1, 17, 32, 33, 64, 100)


def _sizes(kind: str, l: int, rng, r: int) -> tuple[int, int]:
    if kind == "empty":
        live = int(rng.integers(1, l + 1))
        return ((0, 0), (0, live), (live, 0))[r % 3]
    if kind == "full":
        return l, l
    if kind == "partial":   # 33-63 live slots where l allows
        lo, hi = min(33, l), min(63, l)
        return int(rng.integers(lo, hi + 1)), int(rng.integers(lo, hi + 1))
    if kind == "random":
        return int(rng.integers(0, l + 1)), int(rng.integers(0, l + 1))
    return int(rng.integers(1, l + 1)), int(rng.integers(1, l + 1))


def reservoir_pair(kind: str, l: int, n: int = 96, seed: int = 0):
    """(a_ids, a_hashes, a_dists, b_ids, b_hashes, b_dists), each [n, l]
    (int32, int32, float32)."""
    rng = np.random.default_rng([seed, KINDS.index(kind), l])
    arrays = []
    for _ in range(2):
        arrays += [np.full((n, l), -1, np.int32), np.zeros((n, l), np.int32),
                   np.full((n, l), np.inf, np.float32)]
    n_ids, n_hashes = 4 * l + 8, 2 * l + 4
    for r in range(n):
        na, nb = _sizes(kind, l, rng, r)
        a_id = rng.choice(n_ids, na, replace=False)
        a_h = rng.choice(n_hashes, na, replace=False)
        a_d = rng.integers(-8, 9, na) / 4.0
        b_id = rng.choice(n_ids, nb, replace=False)
        b_h = rng.choice(n_hashes, nb, replace=False)
        b_d = rng.integers(-8, 9, nb) / 4.0
        m = min(na, nb)
        if kind in ("ties", "same_id") and m:
            # B's first slots copy A's ids (with A's dists for ties), some in
            # A's bucket and some in a bucket of their own
            k = int(rng.integers(1, m + 1))
            pick = rng.choice(na, k, replace=False)
            others = np.setdiff1d(np.arange(n_ids), a_id[pick])
            b_id = np.concatenate([a_id[pick], rng.choice(others, nb - k, replace=False)])
            if kind == "ties":
                b_d[:k] = a_d[pick]
            else:
                b_d[:k] = a_d[pick] + rng.choice([-0.25, 0.25], k)
            same = rng.random(k) < 0.5
            b_h = np.empty(nb, np.int64)
            b_h[:k][same] = a_h[pick][same]
            fresh = np.flatnonzero(np.r_[~same, np.ones(nb - k, bool)])
            free = np.setdiff1d(np.arange(n_hashes), a_h[pick][same])
            b_h[fresh] = rng.choice(free, fresh.size, replace=False)
        for off, (ids, hs, ds) in ((0, (a_id, a_h, a_d)), (3, (b_id, b_h, b_d))):
            order = np.lexsort((ids, ds))
            live = len(ids)
            arrays[off][r, :live] = ids[order]
            arrays[off + 1][r, :live] = hs[order]
            arrays[off + 2][r, :live] = ds[order]
    return tuple(arrays)
