"""Bounded per-row merge of two sorted HashPrune reservoirs, R(A u B).

Replaces the Pallas kernel
``repro/kernels/segmented_merge.py::merge_sorted_reservoirs``
(``pallas_call`` at ``:104``).  Both inputs are [n, l] reservoirs whose
live slots (id != -1) are a prefix sorted by (dist, id) with one slot per
hash bucket, and every slot past it holds the padding (-1, 0, +inf):
``reservoir_init``, ``hashprune_flat`` and this merge all keep that
invariant, and the CUDA kernel relies on it.  The kernel
(``csrc/segmented_merge.cu``) gives each row one warp: live counts by
ballot, then cross-side bucket dedup (the strictly smaller key wins, exact
ties keep A) and rank placement (own-side survivor rank plus the other
side's smaller keys) over the live slots only, held in registers and
broadcast by shuffles; truncation to l.  It writes the result over A in
place, as the reference's fused step donates the reservoir, and only slots
[0, max(n_out, nA)): the merged prefix, then padding over A's leftover
live slots; the slots past them already hold the padding.

Bound on the card: bytes, each id row read up to its first -1 (B's first
id alone where B is empty), the live prefixes of hashes and dists read and
the written slots.  Only comparisons and copies: bit-exact.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.topk import lex_key, ordered, stable_argsort

launches = 0   # kernel launches since the last reset
_PLAIN_ROWS = 65536   # rows per step of the plain version ([rows, l, l] compares)


def merge_sorted_reservoirs_plain(a_ids, a_hashes, a_dists,
                                  b_ids, b_hashes, b_dists):
    """Plain PyTorch version (sort-based, after
    ``repro/kernels/ref.py::merge_sorted_reservoirs_ref``); returns new
    (ids, hashes, dists) and runs on any device, ``_PLAIN_ROWS`` rows at a time."""
    rows = _PLAIN_ROWS
    n, l = a_ids.shape
    out = (torch.empty_like(a_ids), torch.empty_like(a_hashes),
           torch.empty_like(a_dists))
    inf = torch.full((), float("inf"), device=a_dists.device)
    for s in range(0, n, rows):
        ai, ah, ad = a_ids[s:s + rows], a_hashes[s:s + rows], a_dists[s:s + rows]
        bi, bh, bd = b_ids[s:s + rows], b_hashes[s:s + rows], b_dists[s:s + rows]
        va, vb = ai != -1, bi != -1
        b_lt_a = ((bd[:, None, :] < ad[:, :, None])
                  | ((bd[:, None, :] == ad[:, :, None])
                     & (bi[:, None, :] < ai[:, :, None])))          # [r, lA, lB]
        collide = ((ah[:, :, None] == bh[:, None, :])
                   & va[:, :, None] & vb[:, None, :])
        keep_a = va & ~torch.any(collide & b_lt_a, dim=2)
        keep_b = vb & ~torch.any(collide & ~b_lt_a, dim=1)
        keep = torch.cat([keep_a, keep_b], dim=1)
        ids = torch.where(keep, torch.cat([ai, bi], dim=1), -1)
        hs = torch.where(keep, torch.cat([ah, bh], dim=1), 0)
        ds = torch.where(keep, torch.cat([ad, bd], dim=1), inf)
        order = stable_argsort(lex_key(ordered(ds), ids), dim=1)[:, :l]
        out[0][s:s + rows] = torch.gather(ids, 1, order)
        out[1][s:s + rows] = torch.gather(hs, 1, order)
        out[2][s:s + rows] = torch.gather(ds, 1, order)
    return out


def merge_sorted_reservoirs(a_ids, a_hashes, a_dists, b_ids, b_hashes, b_dists):
    """R(A u B) for two per-row-sorted [n, l] reservoirs (int32 ids, int32
    hashes, float32 dists) whose live slots are a sorted prefix padded with
    (-1, 0, +inf).  Returns (ids, hashes, dists).  CPU tensors take the
    plain version; CUDA tensors launch the kernel, which merges into the A
    arrays in place, writing only slots [0, max(n_out, nA)) (the slots past
    them already hold the padding), and returns them."""
    global launches
    if a_ids.device.type == "cpu":
        return merge_sorted_reservoirs_plain(a_ids, a_hashes, a_dists,
                                             b_ids, b_hashes, b_dists)
    arrays = (a_ids, a_hashes, a_dists, b_ids, b_hashes, b_dists)
    if any(t.shape != a_ids.shape for t in arrays):
        raise ValueError("merge_sorted_reservoirs: all six arrays must be [n, l]")
    if (a_ids.dtype != torch.int32 or b_ids.dtype != torch.int32
            or a_hashes.dtype != torch.int32 or b_hashes.dtype != torch.int32
            or a_dists.dtype != torch.float32 or b_dists.dtype != torch.float32):
        raise TypeError("merge_sorted_reservoirs takes int32 ids/hashes, float32 dists")
    _build.require_cuda("merge_sorted_reservoirs", *arrays)
    n, l = a_ids.shape
    rc = _build.library().pipnn_merge_sorted_reservoirs(
        *(t.data_ptr() for t in arrays), n, l, _build.stream_ptr(a_ids))
    _build.check(rc, "merge_sorted_reservoirs")
    launches += 1
    return a_ids, a_hashes, a_dists


def launch_plan(l: int) -> dict:
    """The kernel's launch plan at reservoir width ``l``, from the C function
    the launch uses (``pipnn_merge_sorted_reservoirs_plan``): the dynamic
    shared memory in bytes.  Launches nothing; needs the built library."""
    return {"smem": _build.plan_value("pipnn_merge_sorted_reservoirs_plan", l)[0]}


def work(a_ids: torch.Tensor, b_ids: torch.Tensor, out_ids: torch.Tensor) -> dict:
    """The bytes the merge must move on these rows, in whole 32-byte sectors
    of each row (``a_ids`` as they were before the merge, ``out_ids`` the
    merged ids).  Live slots are a sorted prefix, so a side's live count is
    known from its id row up to the first -1: slots [0, min(n + 1, l)).  A
    row whose B side is empty is R(A) already: B's first id is all it
    reads.  Any other row reads both id rows that far, the live prefixes of
    A's and B's hashes and dists, and writes slots [0, max(n_out, nA)) of
    the three arrays.  Only comparisons and copies: no product."""
    n, l = a_ids.shape
    start = torch.arange(n, device=a_ids.device, dtype=torch.int64) * l * 4

    def sectors(count):
        end = start + count.long() * 4
        return torch.where(count > 0, (end - 1) // 32 - start // 32 + 1, 0)

    na, nb = (a_ids >= 0).sum(1), (b_ids >= 0).sum(1)
    n_out = (out_ids >= 0).sum(1)
    touched = nb > 0
    per_row = torch.where(
        touched, sectors(torch.clamp(na + 1, max=l)) + sectors(torch.clamp(nb + 1, max=l))
        + 2 * sectors(na) + 2 * sectors(nb) + 3 * sectors(torch.maximum(n_out, na)),
        sectors(torch.ones_like(nb)))
    return {"ops": {}, "bytes": 32.0 * float(per_row.sum())}
