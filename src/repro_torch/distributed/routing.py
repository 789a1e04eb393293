"""Capacity-routed group-by (counterpart of ``repro/distributed/routing.py``):
stable-sort flat entries by key, rank each within its key's run, drop the
ranks at or past ``cap`` (overflow) and scatter the rest into
[n_groups, cap, ...] buckets.  The static Stage-1 carve groups points into
buckets and placements into leaves with it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.topk import stable_argsort

INVALID_ID = -1
WEYL = 2654435761          # odd: i * WEYL mod 2^32 is a permutation of [0, 2^32)


def weyl_order(e: int, device) -> torch.Tensor:
    """The fixed permutation ``argsort(arange(e, uint32) * WEYL)`` of the
    reference (the product wraps modulo 2^32).  Formed in int64 and masked
    to 32 bits, as torch has no wrapping uint32 product; the keys are
    distinct, so the sort needs no stability."""
    key = (torch.arange(e, dtype=torch.int64, device=device) * WEYL) & 0xFFFFFFFF
    return torch.sort(key).indices


def group_by_capacity(keys: torch.Tensor, valid: torch.Tensor, n_groups: int, cap: int,
                      payloads: list[torch.Tensor], shuffle: bool = False
                      ) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Scatter flat entries into [n_groups, cap, ...] buckets.

    Returns (grouped payloads, valid mask [n_groups, cap]); int payloads
    pad with -1, float payloads with +inf.  Entries keep their order
    within a key (the sort is stable), so a key's first ``cap`` entries
    are kept.  ``shuffle=True`` first permutes the entries by the fixed
    Weyl order (``weyl_order``), so overflow drops are not always the
    highest-index entries."""
    e = keys.shape[0]
    dev = keys.device
    if shuffle:
        perm = weyl_order(e, dev)
        keys, valid = keys[perm], valid[perm]
        payloads = [p[perm] for p in payloads]
    skey = torch.where(valid, keys.to(torch.int32), n_groups)
    order = stable_argsort(skey)
    skey = skey[order]
    # rank within the key's run: its position less the run's first position
    rank = torch.arange(e, dtype=torch.int64, device=dev) - torch.searchsorted(skey, skey)
    ok = (rank < cap) & (skey < n_groups)
    row, col = skey[ok].long(), rank[ok]
    out_valid = torch.zeros((n_groups, cap), dtype=torch.bool, device=dev)
    out_valid[row, col] = True
    outs = []
    for pay in payloads:
        pad = INVALID_ID if not pay.dtype.is_floating_point else float("inf")
        buf = torch.full((n_groups, cap) + tuple(pay.shape[1:]), pad, dtype=pay.dtype,
                         device=dev)
        buf[row, col] = pay[order[ok]]
        outs.append(buf)
    return outs, out_valid
