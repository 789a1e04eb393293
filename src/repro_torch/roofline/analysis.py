"""Three-term roofline of a port program on one H100 (counterpart of
``repro/roofline/analysis.py``).

Consumed by the memory audit (``repro_torch.analysis.memory_audit``) and
the mesh audit (``repro_torch.analysis.mesh_audit``): every registered
hot-path program gets a compute / memory / collective estimate beside its
byte ledger, and chip_smoke's kernel bounds are the same arithmetic.

The reference reads its counts from the compiled HLO.  Eager PyTorch has
no HLO: a program runs once under the dispatch walker (``op_cost``), which
counts what this implementation dispatches, and the program declares its
least work (``Work``: operations by class, bytes with each input read once
and each output written once, wire bytes a shard), from which the terms
come:

  compute term    = sum over classes of work operations / that class's peak
  memory term     = work bytes / the card's memory rate
  collective term = work wire bytes a shard / the link rate

``bound_seconds`` is the largest term: the least time the card could take.
``dispatched_over_work`` is the dispatched counts' roofline time over that
bound, the counterpart of the reference's ``useful_ratio`` read the other
way up (1.0: the implementation moves no more than the work needs).

Collective bytes come from a log of mesh exchanges (``op_cost`` notes each
``ShardMesh.all_gather`` / ``all_to_all`` / ``psum``), one entry (op,
payload bytes a shard, group size) each, priced with the reference's ring
model (``wire_bytes_for``).  The group is the S logical shards, whatever
number of processes carries them: the traffic a deployment with one card a
shard would pay, as the reference's ``replica_groups`` give at S devices.

Hardware: NVIDIA's H100 SXM data sheet, dense: f32 67e12 op/s on the CUDA
cores, TF32 495e12, bf16 989e12 and int8 1979e12 on the tensor cores,
3.35e12 B/s of memory, 450e9 B/s one direction of NVLink 4, and the card's
memory (80 GB where no card is present).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping

CLASSES = ("f32", "tf32", "bf16", "int8")
H100_PEAK_OPS = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12, "int8": 1979e12}
H100_MEMORY_BYTES = 80e9          # the data sheet's, where no card is present

# the mesh's exchanges and the HLO collectives they stand for
HLO_NAMES = {"all_gather": "all-gather", "all_to_all": "all-to-all", "psum": "all-reduce"}


def _default_hbm_bytes() -> float:
    import torch

    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(0).total_memory)
    return H100_MEMORY_BYTES


@dataclasses.dataclass(frozen=True)
class HW:
    """One card's peaks.  ``hbm_bytes`` None: the card's own memory
    (its ``total_memory``), or the data sheet's 80 GB without one;
    read through ``memory()``, so that importing this module touches no
    card."""

    peak_ops: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: dict(H100_PEAK_OPS))
    hbm_bw: float = 3.35e12           # bytes/s
    link_bw: float = 450e9            # bytes/s, one direction of NVLink 4
    hbm_bytes: float | None = None

    def memory(self) -> float:
        return _default_hbm_bytes() if self.hbm_bytes is None else float(self.hbm_bytes)

    def terms(self, ops: Mapping[str, float], nbytes: float, wire: float = 0.0) -> dict:
        """Seconds of each term for ``ops`` (by class), ``nbytes`` and
        ``wire`` bytes; a class without a peak raises ``KeyError``."""
        return {"compute": sum(v / self.peak_ops[c] for c, v in ops.items()),
                "memory": nbytes / self.hbm_bw, "collective": wire / self.link_bw}

    def bound(self, work) -> dict:
        """``work``'s least time in ms and the term that sets it, as
        chip_smoke's kernel rows give it: ``bound_ms`` and ``bound_by``
        ("operations" or "bytes"; "wire" for a collective term)."""
        w = Work.of(work)
        t = self.terms(w.ops, w.bytes, w.wire)
        by = max(t, key=t.get)
        return {"bound_ms": 1e3 * t[by], "bound_by": {"compute": "operations", "memory": "bytes",
                                                       "collective": "wire"}[by]}


H100 = HW()


@dataclasses.dataclass
class Work:
    """Operations by class, bytes, and wire bytes a shard."""

    ops: dict = dataclasses.field(default_factory=dict)
    bytes: float = 0.0
    wire: float = 0.0

    @classmethod
    def of(cls, w) -> "Work":
        """A ``Work`` from itself or a kernel model's dict (``ops``,
        ``bytes``, optional ``wire``)."""
        if isinstance(w, Work):
            return w
        return cls(dict(w.get("ops", {})), float(w.get("bytes", 0.0)), float(w.get("wire", 0.0)))

    def __add__(self, other) -> "Work":
        o = Work.of(other)
        ops = dict(self.ops)
        for c, v in o.ops.items():
            ops[c] = ops.get(c, 0.0) + v
        return Work(ops, self.bytes + o.bytes, self.wire + o.wire)


def wire_bytes_for(opcode: str, nbytes: int, g: int) -> float:
    """Ring / bidirectional wire bytes a device of one collective over a
    group of ``g`` (the reference's ``hlo_cost.wire_bytes_for``)."""
    if g <= 1:
        return 0.0
    frac = (g - 1) / g
    if opcode.startswith("all-reduce"):
        return 2.0 * nbytes * frac
    if opcode.startswith("all-gather"):
        return nbytes * frac              # result is the gathered tensor
    if opcode.startswith("reduce-scatter"):
        return nbytes * (g - 1)           # result is 1/g of the input
    if opcode.startswith("all-to-all"):
        return nbytes * frac
    return float(nbytes)                  # collective-permute


def collective_bytes(log) -> dict[str, Any]:
    """Sum the wire bytes a shard of a log of mesh exchanges, each entry
    (op, payload bytes a shard, group size); ``op`` is a mesh method
    (``all_gather``, ``all_to_all``, ``psum``) or its HLO name.

    Returns {"total": bytes, "by_op": {hlo op: bytes}, "count": int,
             "ops": [(hlo op, bytes, group)] top-40 largest}."""
    by_op: dict[str, float] = {}
    ops: list[tuple[str, float, int]] = []
    count = 0
    for op, nbytes, g in log:
        op = HLO_NAMES.get(op, op)
        if g <= 1 or nbytes == 0:
            continue
        wire = wire_bytes_for(op, nbytes, g)
        by_op[op] = by_op.get(op, 0.0) + wire
        ops.append((op, wire, g))
        count += 1
    ops.sort(key=lambda t: -t[1])
    return {"total": sum(by_op.values()), "by_op": by_op, "count": count, "ops": ops[:40]}


# ---------------------------------------------------------------------------
# Roofline assembly
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CellRoofline:
    name: str
    mesh: str
    n_devices: int
    kind: str
    # the program's least work: the terms come from it
    work_ops: dict                   # operations by class
    work_bytes: float
    coll_bytes: float                # wire bytes a shard
    # what this implementation dispatched (the reference's hlo_flops / hlo_bytes)
    dispatched_ops: dict = dataclasses.field(default_factory=dict)
    dispatched_bytes: float = 0.0
    dispatched_coll_bytes: float = 0.0
    coll_by_op: dict = dataclasses.field(default_factory=dict)   # dispatched, by op
    kernel_launches: dict = dataclasses.field(default_factory=dict)   # charged, by counter
    bytes_per_device: float = 0.0    # device bytes the run held (see analyze_program)
    # terms (seconds)
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    dominant: str = ""
    dispatched_over_work: float = 0.0
    fits_hbm: bool = True
    note: str = ""

    def finalize(self, hw: HW = H100) -> "CellRoofline":
        t = hw.terms(self.work_ops, self.work_bytes, self.coll_bytes)
        self.t_compute, self.t_memory, self.t_collective = (
            t["compute"], t["memory"], t["collective"])
        self.dominant = max(t, key=t.get)
        if self.dispatched_ops or self.dispatched_bytes or self.dispatched_coll_bytes:
            seen = hw.terms(self.dispatched_ops, self.dispatched_bytes,
                            self.dispatched_coll_bytes)
            self.dispatched_over_work = max(seen.values()) / max(self.bound_seconds(), 1e-30)
        self.fits_hbm = self.bytes_per_device <= hw.memory()
        return self

    def bound_seconds(self) -> float:
        """Roofline lower bound on the program's time (max of the three terms)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["coll_by_op"] = {k: float(v) for k, v in self.coll_by_op.items()}
        return d


def analyze_program(fn, args=(), kwargs=None, *, name: str, kind: str, n_shards: int = 1,
                    work, device, hw: HW = H100) -> CellRoofline:
    """Run ``fn(*args, **kwargs)`` once under the dispatch walker
    (``op_cost.walk``) and give its roofline: the dispatched counts, the
    program's least work ``work(walk)`` (a ``Work`` or a kernel model's
    dict; ``walk.out`` holds what ``fn`` returned), the bound taken from
    the work and the dispatched-over-work ratio.  ``n_shards`` > 1: a
    sharded program run as S shards in one process (the mesh audit's
    one-process model).  ``device`` only sets where the peak bytes are
    read: on the card the allocator's peak above the arguments plus the
    arguments, elsewhere the arguments and outputs."""
    import torch

    from repro_torch.roofline import op_cost

    kwargs = kwargs or {}
    ts = op_cost.tensors(args) + op_cost.tensors(kwargs)
    dev = torch.device(device)
    card = dev.type == "cuda"
    arg_bytes = float(sum(op_cost.nbytes(t) for t in ts))
    if card:
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    with op_cost.walk() as w:
        w.args, w.kwargs = args, kwargs
        w.out = fn(*args, **kwargs)
    if card:
        torch.cuda.synchronize(dev)
        held = arg_bytes + torch.cuda.max_memory_allocated(dev) - base
    else:
        held = arg_bytes + sum(op_cost.nbytes(t) for t in op_cost.tensors(w.out))
    wk = Work.of(work(w))
    coll = w.collectives()
    r = CellRoofline(
        name=name, mesh="one card" if n_shards == 1 else f"S={n_shards} (one-process model)",
        n_devices=int(n_shards), kind=kind,
        work_ops=dict(wk.ops), work_bytes=wk.bytes, coll_bytes=wk.wire,
        dispatched_ops=dict(w.ops), dispatched_bytes=w.bytes,
        dispatched_coll_bytes=coll["total"], coll_by_op=coll["by_op"],
        kernel_launches=dict(w.launches), bytes_per_device=float(held))
    r.walk = w
    return r.finalize(hw)


def record(r: CellRoofline) -> dict:
    """The keys the memory and mesh audits keep (the reference's
    ``_roofline_record`` with the dispatched counts for its HLO ones, and
    the work beside them)."""
    return {"t_compute": r.t_compute, "t_memory": r.t_memory,
            "t_collective": r.t_collective, "dominant": r.dominant,
            "dispatched_ops": dict(r.dispatched_ops), "dispatched_bytes": r.dispatched_bytes,
            "coll_bytes": r.coll_bytes, "bound_seconds": r.bound_seconds(),
            "work_ops": dict(r.work_ops), "work_bytes": r.work_bytes,
            "dispatched_coll_bytes": r.dispatched_coll_bytes,
            "dispatched_over_work": r.dispatched_over_work,
            "kernel_launches": dict(r.kernel_launches)}


RECORD_KEYS = ("t_compute", "t_memory", "t_collective", "dominant", "dispatched_ops",
               "dispatched_bytes", "coll_bytes", "bound_seconds")


def dump(rooflines: list[CellRoofline], path: str) -> None:
    with open(path, "w") as f:
        json.dump([r.to_json() for r in rooflines], f, indent=1)


def fmt_seconds(s: float) -> str:
    if s <= 0:
        return "0"
    if s < 1e-3:
        return f"{s * 1e6:.1f}us"
    if s < 1:
        return f"{s * 1e3:.2f}ms"
    return f"{s:.3f}s"


def markdown_table(rooflines: list[CellRoofline]) -> str:
    hdr = ("| cell | mesh | kind | compute | memory | collective | dominant "
           "| dispatched/work | HBM/chip | fits |\n"
           "|---|---|---|---|---|---|---|---|---|---|\n")
    rows = []
    for r in rooflines:
        rows.append(
            f"| {r.name} | {r.mesh} | {r.kind} | {fmt_seconds(r.t_compute)} "
            f"| {fmt_seconds(r.t_memory)} | {fmt_seconds(r.t_collective)} "
            f"| **{r.dominant}** | {r.dispatched_over_work:.2f} "
            f"| {r.bytes_per_device / 1e9:.2f}GB "
            f"| {'yes' if r.fits_hbm else 'NO'} |"
        )
    return hdr + "\n".join(rows)
