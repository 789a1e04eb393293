"""Residual edge hashes, with the sketch-row gather fused.

Replaces the Pallas kernel ``repro/kernels/edge_hash.py::edge_hashes``
(``pallas_call`` at ``:58``) together with the gather in
``repro/core/sketch.py::edge_hashes_from_ids`` that feeds it.  The CUDA
kernel (``csrc/edge_hash.cu``) reads the two sketch rows of ``max(src, 0)``
and ``max(dst, 0)`` of each edge and packs bit i of
``Sketch(dst) - Sketch(src) >= 0`` with weight 2^i.  A thread takes four
edges (16-byte id loads and hash stores where the arrays are 16-byte
aligned), loads their sketch rows in program order before the compares
(16-byte row loads where m % 4 == 0), and reads no global memory for a
negative id: the block keeps row 0 in shared memory.  128-thread blocks
at 64 registers, 8 an SM: occupancy keeps the loads in flight.

Bound on the card: bytes.  Per edge 8 bytes of ids in and 4 bytes of hash
out; the [n, m] sketch matrix is read through L2.  The kernel does one
rounded subtraction per bit, exactly as the plain version, so it is
bit-exact (also where row 0 is not finite).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_BITS = 16

launches = 0   # kernel launches since the last reset


def edge_hashes_plain(sketches: torch.Tensor, src: torch.Tensor,
                      dst: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``edge_hashes``; runs on any device."""
    s_sk = sketches[src.clamp_min(0).long()]
    d_sk = sketches[dst.clamp_min(0).long()]
    bits = (d_sk - s_sk) >= 0.0
    m = bits.shape[-1]
    pow2 = 2 ** torch.arange(m, dtype=torch.int32, device=bits.device)
    return torch.sum(bits.to(torch.int32) * pow2, dim=-1, dtype=torch.int32)


def edge_hashes(sketches: torch.Tensor, src: torch.Tensor,
                dst: torch.Tensor) -> torch.Tensor:
    """Residual hashes h_src(dst) [E] int32 from sketches [n, m] float32 and
    edge ids [E] int32 (negative ids read row 0).  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    global launches
    if sketches.device.type == "cpu":
        return edge_hashes_plain(sketches, src, dst)
    m = sketches.shape[1]
    if not 1 <= m <= MAX_BITS:
        raise ValueError(f"edge_hashes supports 1 <= m <= {MAX_BITS}, got {m}")
    if (sketches.dtype != torch.float32 or src.dtype != torch.int32
            or dst.dtype != torch.int32 or src.shape != dst.shape):
        raise TypeError("edge_hashes takes float32 sketches and equal-shape int32 ids")
    _build.require_cuda("edge_hashes", sketches, src, dst)
    out = torch.empty(src.shape, dtype=torch.int32, device=src.device)
    rc = _build.library().pipnn_edge_hashes(
        sketches.data_ptr(), src.data_ptr(), dst.data_ptr(), src.numel(), m,
        out.data_ptr(), _build.stream_ptr(src))
    _build.check(rc, "edge_hashes")
    launches += 1
    return out


def work(sketches: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> dict:
    """The least work of ``edge_hashes``: the [n, m] sketches read once,
    8 bytes of ids in and 4 of hash out an edge; no product."""
    e = src.numel()
    return {"ops": {}, "bytes": float(sketches.numel() * 4 + e * 8 + e * 4)}
