"""Mesh audit of the port's sharded programs (counterpart of
``repro/analysis/spmd_audit.py``): rules PIPS001-005.

The reference audits ``shard_map`` programs traced on forced host meshes.
The port's shards meet only in ``launch.mesh.ShardMesh``'s methods, so a
spy mesh (``RecordingMesh``) records every collective a program calls
(``all_gather``, ``all_to_all`` (``exchange`` is one a payload), ``psum``,
``broadcast``).  Its one-process model (``group=MODEL_GROUP``, one rank)
takes the multi-rank code paths (the search's gather of the shard blocks,
the loop's broadcasts) with the one-process list functions behind them;
over a real group it records and forwards.

The programs are the sharded search (``ShardedServingIndex.search``), the
cross-shard merge (``cross_shard_topk``), the distributed build's tile
step and final-prune step (``launch.build_index``), and, port-only, the
serving loop over a mesh (``launch.serve_loop.ServeLoop``).

  PIPS001  each program declares the collectives it may call, here at its
           registration (``default_specs``).  The tile step and the final
           prune declare the reference's contracts ({all_gather,
           all_to_all, psum} and {all_to_all}); the per-shard search body
           calls none, and the search as a whole gathers the shards'
           blocks (``all_gather``, the reference's ``out_specs`` gather made
           explicit: one call a result block); ``cross_shard_topk`` calls
           none; the loop adds ``broadcast`` (each index call, then the
           stop) to the search's.
  PIPS002  replication: each rank holds only its S / W shards of every
           sharded operand (its leading dimension, and a storage of no
           more bytes than the tensor: not a view of a larger buffer),
           and the replicated ones whole (the router's leaders, the
           hyperplanes).  Checked in one process here and inside the gloo
           worlds of ``tests/test_torch_dist_mesh.py``.
  PIPS003  the ``[S, m, ...]`` halo packing priced byte-exactly at the
           reference's ``PRODUCTION_ENVELOPE`` (2^30 points, d 128, R 64,
           S 256, int8) with the worst halo fraction measured on the tiny
           packings at S in {2, 4, 8}, held against the card's memory
           (``H100_MEMORY_BYTES`` on the CPU).  The reference pads every
           array to the TPU's (sublane, lane) tiles; the card has no tiles,
           so the price is the exact bytes.
  PIPS004  transfers: one sharded search under ``core.transfers.ledger()``
           stays within ``TRANSFER_BUDGET``, and no copy between the card
           and the host happens outside ``transfers.to_device`` /
           ``to_host`` (on the card the dispatch spy sees every cross-device
           copy; on the CPU, where there is none, the host reads
           ``.cpu()``, ``.numpy()`` and ``.tolist()`` stand for them): the
           counterpart of ``jax.transfer_guard("disallow")``.  Read-backs
           of a flag (``bool(t)``) are syncs, PIPJ001's, not transfers.
  PIPS005  shard-count stability: a rank runs its shards one after another
           (the reference fuses them; the port's loop is its batched
           engine's future work), so across S in {1, 2, 4, 8} on the
           one-process model every shard body (``_beam_search_multi``,
           without early exit so that its length is the data's no more)
           must run the same aten-op sequence, and the program outside the
           bodies must run the same (source line, op) pairs: loops over the
           shards repeat them, a Python branch on S adds or drops some.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.analysis.lint import Finding, report
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import ShardMesh

SWEEP = (1, 2, 4, 8)
MESH_SHARDS = 4                    # shards of the one-process mesh the passes run on
PAD_FRACTION = 0.10                # the packing's pad-to-max slack over the owned rows
H100_MEMORY_BYTES = 80 * 10**9     # an H100 SXM's 80 GB, where no card is present
PRODUCTION_ENVELOPE = dict(name="bigann-1B/int8/S=256", n_points=1 << 30, dim=128,
                           degree=64, n_shards=256, int8=True)
_SERVING = "src/repro_torch/distributed/serving.py"
_BUILD = "src/repro_torch/launch/build_index.py"


class _OneProcessGroup:
    def __repr__(self) -> str:
        return "MODEL_GROUP"


MODEL_GROUP = _OneProcessGroup()     # a one-rank "group": the multi-rank code paths, in one process
_BODY = [0]                          # > 0 inside a shard body


@dataclasses.dataclass(frozen=True)
class RecordingMesh(ShardMesh):
    """A ``ShardMesh`` that records each collective it is called for in
    ``calls`` as (name, inside a shard body).  With ``group=MODEL_GROUP``
    it is one rank running the multi-rank code paths on the one-process
    list functions; with a real group it forwards to it."""

    calls: list = dataclasses.field(default_factory=list, compare=False, repr=False)

    def _note(self, name: str) -> bool:
        self.calls.append((name, _BODY[0] > 0))
        return self.group is MODEL_GROUP

    def all_gather(self, local_parts):
        if self._note("all_gather"):
            return mesh_mod.all_gather(local_parts)
        return super().all_gather(local_parts)

    def all_to_all(self, local_sends):
        if self._note("all_to_all"):
            return mesh_mod.all_to_all(local_sends)
        return super().all_to_all(local_sends)

    def psum(self, local_parts):
        if self._note("psum"):
            return mesh_mod.psum(local_parts)
        return super().psum(local_parts)

    def broadcast(self, obj):
        if self._note("broadcast"):
            return obj
        return super().broadcast(obj)

    def close(self) -> None:
        if self.group is not MODEL_GROUP:
            super().close()


def recording(mesh: ShardMesh) -> RecordingMesh:
    """A recording twin of a real mesh (same shards, group, rank, world)."""
    return RecordingMesh(mesh.n_shards, group=mesh.group, rank=mesh.rank, world=mesh.world,
                         device=mesh.device)


def model_mesh(n_shards: int, device) -> RecordingMesh:
    return RecordingMesh(int(n_shards), group=MODEL_GROUP, device=torch.device(device))


@contextlib.contextmanager
def shard_bodies(on_enter: Callable | None = None, on_exit: Callable | None = None):
    """Mark every ``beam_search._beam_search_multi`` call as a shard body
    (``_BODY``), calling ``on_enter()`` / ``on_exit()`` around it."""
    from repro_torch.analysis.hotpath_audit import patched_everywhere
    from repro_torch.core import beam_search as bs

    orig = bs._beam_search_multi

    @functools.wraps(orig)
    def body(*args, **kwargs):
        _BODY[0] += 1
        if on_enter:
            on_enter()
        try:
            return orig(*args, **kwargs)
        finally:
            if on_exit:
                on_exit()
            _BODY[0] -= 1

    with patched_everywhere({orig: body}):
        yield


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def _tiny_data(seed: int = 0, n: int = 192, d: int = 16, r: int = 4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    graph = rng.integers(0, n, size=(n, r)).astype(np.int32)
    q = rng.standard_normal((4, d)).astype(np.float32)
    return x, graph, q


def tiny_packing(mesh: ShardMesh, dtype=None):
    """A tiny ``ShardedServingIndex`` on ``mesh`` (its shards and device)."""
    from repro_torch.distributed.serving import ShardedServingIndex

    x, graph, _ = _tiny_data()
    return ShardedServingIndex.from_graph(graph, x, 0, mesh=mesh, dtype=dtype)


def _run_search(mesh, dev, early_exit=True):
    _, _, q = _tiny_data()
    tiny_packing(mesh).search(q, k=4, beam=8, early_exit=early_exit)


def _run_topk(mesh, dev):
    from repro_torch.distributed.serving import cross_shard_topk

    g = torch.Generator(device=dev).manual_seed(0)
    s = mesh.n_shards
    cross_shard_topk(torch.randint(0, 100, (s, 4, 8), generator=g, device=dev,
                                   dtype=torch.int32),
                     torch.rand((s, 4, 8), generator=g, device=dev), k=10)


def _tile_inputs(mesh, dev):
    from repro_torch.core import sketch
    from repro_torch.core.hashprune import reservoir_init
    from repro_torch.launch import build_index as bi

    p = bi.DistBuildParams.tiny()
    rows = p.n_tile // mesh.world
    g = torch.Generator(device=dev).manual_seed(0)
    pts = torch.randn((rows, p.dim), generator=g, device=dev)
    hp = torch.as_tensor(sketch.make_hyperplanes(0, p.m_bits, p.dim), device=dev)
    return p, pts, hp, reservoir_init(rows, p.l_max, dev)


def _run_tile(mesh, dev):
    from repro_torch.launch import build_index as bi

    p, pts, hp, res = _tile_inputs(mesh, dev)
    bi.make_tile_step(mesh, p)(pts, hp, res)


def _run_prune(mesh, dev):
    from repro_torch.launch import build_index as bi

    p, pts, hp, res = _tile_inputs(mesh, dev)
    g = torch.Generator(device=dev).manual_seed(1)
    ids = torch.randint(0, p.n_tile, res.ids.shape, generator=g, device=dev,
                        dtype=torch.int32)
    bi.make_final_prune_step(mesh, p)(pts, ids, torch.rand(res.ids.shape, generator=g,
                                                           device=dev))


def _run_loop(mesh, dev):
    from repro_torch.launch.serve_loop import ServeLoop

    _, _, q = _tiny_data()
    with ServeLoop(tiny_packing(mesh), k=4, query_chunk=4) as loop:
        for row in q:
            loop.submit(row)
        loop.run_until_drained()


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A registered sharded program and its declared collectives.
    ``collectives`` bounds the program as a whole, ``body_collectives``
    its shard bodies (None: it has none)."""

    name: str
    path: str
    symbol: str
    run: Callable                   # (mesh, device) -> None
    collectives: frozenset
    body_collectives: frozenset | None = None
    reference: str | None = None    # the reference's spmd_audit program it answers to


def default_specs() -> tuple[MeshSpec, ...]:
    """The registry.  The collective contracts are declared here: a change
    of a program's communication is a diff of this tuple."""
    return (
        # each shard searches alone; the shards' blocks are gathered once
        # a result block (the reference's out_specs), then merged
        MeshSpec("sharded_search", _SERVING, "ShardedServingIndex.search", _run_search,
                 frozenset({"all_gather"}), body_collectives=frozenset(),
                 reference="sharded_search"),
        MeshSpec("cross_shard_topk", _SERVING, "cross_shard_topk", _run_topk, frozenset(),
                 reference="cross_shard_topk"),
        # leaders gather + two capacity-routed exchanges + the stats sum
        MeshSpec("build_tile_step", _BUILD, "make_tile_step", _run_tile,
                 frozenset({"all_gather", "all_to_all", "psum"}), reference="build_tile_step"),
        # request/response candidate-vector exchange only
        MeshSpec("build_final_prune", _BUILD, "make_final_prune_step", _run_prune,
                 frozenset({"all_to_all"}), reference="build_final_prune"),
        # port-only: rank 0 sends each index call and the stop to the followers
        MeshSpec("serve_loop", "src/repro_torch/launch/serve_loop.py", "ServeLoop", _run_loop,
                 frozenset({"broadcast", "all_gather"}), body_collectives=frozenset()),
    )


# ---------------------------------------------------------------------------
# PIPS001
# ---------------------------------------------------------------------------

def collectives_of(spec: MeshSpec, mesh: RecordingMesh, device) -> tuple[set, set]:
    """(collectives of the whole program, those inside shard bodies)."""
    del mesh.calls[:]
    with shard_bodies():
        spec.run(mesh, device)
    return {c for c, _ in mesh.calls}, {c for c, body in mesh.calls if body}


def audit_collectives(device, specs=None, records: dict | None = None) -> list[Finding]:
    specs = default_specs() if specs is None else specs
    findings = []
    for spec in specs:
        mesh = model_mesh(MESH_SHARDS, device)
        whole, body = collectives_of(spec, mesh, device)
        if records is not None:
            records[spec.name] = dict(collectives=sorted(whole), body=sorted(body),
                                      calls=len(mesh.calls))
        for c in sorted(whole - spec.collectives):
            findings.append(Finding(
                "PIPS001", spec.path, 0, spec.symbol,
                f"[S={MESH_SHARDS}] undeclared collective '{c}': the program's contract allows "
                f"{sorted(spec.collectives) or 'none'}; remove it or extend the contract at "
                f"mesh_audit.default_specs"))
        if spec.body_collectives is not None:
            for c in sorted(body - spec.body_collectives):
                findings.append(Finding(
                    "PIPS001", spec.path, 0, spec.symbol,
                    f"[S={MESH_SHARDS}] collective '{c}' inside a per-shard body: the body "
                    f"must be collective-free (each shard searches alone)"))
    return findings


# ---------------------------------------------------------------------------
# PIPS002
# ---------------------------------------------------------------------------

SHARDED_OPERANDS = ("gids", "graph", "points", "norms", "starts", "scales")
REPLICATED_OPERANDS = ("leaders",)


def _held(t: torch.Tensor) -> int:
    return t.untyped_storage().nbytes()


def audit_replication_serving(sv, records: dict | None = None) -> list[Finding]:
    """This rank's packing holds L = S / W shards of every sharded operand
    (and no larger storage) and every replicated operand whole."""
    mesh = sv._mesh
    findings, held = [], {}
    for name in SHARDED_OPERANDS + REPLICATED_OPERANDS:
        t = getattr(sv, name)
        if t is None:
            continue
        held[name] = _held(t)
        want = mesh.n_local if name in SHARDED_OPERANDS else mesh.n_shards
        own = t.numel() * t.element_size()
        if t.shape[0] != want or held[name] > own:
            kind = "sharded" if name in SHARDED_OPERANDS else "replicated"
            findings.append(Finding(
                "PIPS002", _SERVING, 0, "ShardedServingIndex.from_graph",
                f"[rank {mesh.rank} of {mesh.world}, S={mesh.n_shards}] {kind} operand "
                f"'{name}' has {t.shape[0]} rows (want {want}) in a storage of {held[name]} "
                f"bytes for {own}: the rank holds more than its shards"
                if kind == "sharded" else
                f"[rank {mesh.rank}] replicated operand '{name}' has {t.shape[0]} rows, "
                f"not the whole {want}"))
    if records is not None:
        records.update(held)
    return findings


def audit_replication_tile(mesh: ShardMesh, p, points, hyperplanes, res) -> list[Finding]:
    """The tile step's operands on this rank: its L shards' rows of the
    points and the reservoir (and no larger storage), the hyperplanes
    whole."""
    findings = []
    rows = mesh.n_local * p.derived(mesh.n_shards)["n_loc"]
    for name, t in (("points", points), ("res_ids", res.ids), ("res_hashes", res.hashes),
                    ("res_dists", res.dists)):
        if t.shape[0] != rows or _held(t) > t.numel() * t.element_size():
            findings.append(Finding(
                "PIPS002", _BUILD, 0, "make_tile_step",
                f"[rank {mesh.rank} of {mesh.world}] sharded operand '{name}' has "
                f"{t.shape[0]} rows (want {rows}) in {_held(t)} bytes: more than the rank's "
                f"shards"))
    if tuple(hyperplanes.shape) != (p.m_bits, p.dim):
        findings.append(Finding("PIPS002", _BUILD, 0, "make_tile_step",
                                f"replicated operand 'hyperplanes' is "
                                f"{tuple(hyperplanes.shape)}, not the whole "
                                f"({p.m_bits}, {p.dim})"))
    return findings


# ---------------------------------------------------------------------------
# PIPS003
# ---------------------------------------------------------------------------

def price_shard_packing(n_points: int, dim: int, degree: int, n_shards: int, *,
                        int8: bool = False, halo_fraction: float = 0.0) -> dict:
    """Per-device bytes of the ``[S, m, ...]`` packing at a scale: ``m``
    owned rows grown by ``halo_fraction`` ghosts and ``PAD_FRACTION``
    pad-to-max slack, each array at its exact bytes (no tile padding on
    the card: the reference's TPU-tile pricing is dropped)."""
    owned = math.ceil(n_points / n_shards)
    m = math.ceil(owned * (1.0 + halo_fraction) * (1.0 + PAD_FRACTION))
    parts = {"points": m * dim * (1 if int8 else 4), "graph": m * degree * 4,
             "gids": m * 4, "norms": m * 4}
    if int8:
        parts["scales"] = m * 4
    total = sum(parts.values())
    return dict(parts, rows=m, total=total)


def _packing_bytes(sv) -> int:
    return sum(_held(getattr(sv, n)) for n in SHARDED_OPERANDS if getattr(sv, n) is not None)


def audit_footprint(device, budget: int | None = None,
                    records: dict | None = None) -> list[Finding]:
    dev = torch.device(device)
    if budget is None:
        budget = (int(torch.cuda.get_device_properties(dev).total_memory)
                  if dev.type == "cuda" else H100_MEMORY_BYTES)
    envelope = PRODUCTION_ENVELOPE
    findings, worst, halos = [], 0.0, {}
    for s in (2, 4, 8):
        sv = tiny_packing(mesh_mod.make_local_mesh(s, dev))
        h = float(sv.halo_stats()["halo_fraction"])
        halos[s] = h
        worst = max(worst, h)
        per_shard = _packing_bytes(sv) // s
        if per_shard > budget:
            findings.append(Finding("PIPS003", _SERVING, 0, "ShardedServingIndex.from_graph",
                                    f"[S={s}] a shard's packing is {per_shard} bytes, over "
                                    f"the {budget}-byte card"))
    priced = price_shard_packing(envelope["n_points"], envelope["dim"], envelope["degree"],
                                 envelope["n_shards"], int8=envelope.get("int8", False),
                                 halo_fraction=worst)
    if records is not None:
        records.update(halo_fraction=halos, envelope=envelope["name"], priced=priced,
                       budget=budget)
    report("mesh", f"halo fraction {halos}; envelope {envelope['name']} prices "
           f"{priced['total']} bytes a shard ({priced['rows']} rows) against {budget}")
    if priced["total"] > budget:
        findings.append(Finding(
            "PIPS003", _SERVING, 0, "ShardedServingIndex.from_graph",
            f"the envelope {envelope['name']} prices at {priced['total']} bytes a card "
            f"(halo fraction {worst:.3f}), over the {budget}-byte card: raise n_shards or "
            f"shrink the halo"))
    return findings


# ---------------------------------------------------------------------------
# PIPS004
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def host_reads(log: list):
    """Record the host reads (``Tensor.cpu``, ``.numpy``, ``.tolist``) made
    outside ``transfers.to_device`` / ``to_host``, and mark those two as
    the declared crossings (``log`` gets ``"declared"`` markers)."""
    from repro_torch.analysis.hotpath_audit import patched_everywhere
    from repro_torch.core import transfers

    inside = [0]
    originals = {name: getattr(torch.Tensor, name) for name in ("cpu", "numpy", "tolist")}

    def method(name):
        orig = originals[name]

        @functools.wraps(orig)
        def read(self, *a, **kw):
            if not inside[0]:
                log.append(f"Tensor.{name}() on {self.device}")
            return orig(self, *a, **kw)
        return read

    def declared(fn):
        @functools.wraps(fn)
        def crossing(*a, **kw):
            inside[0] += 1
            try:
                return fn(*a, **kw)
            finally:
                inside[0] -= 1
        return crossing

    for name in originals:
        setattr(torch.Tensor, name, method(name))
    try:
        with patched_everywhere({transfers.to_device: declared(transfers.to_device),
                                 transfers.to_host: declared(transfers.to_host)}):
            yield inside
    finally:
        for name, orig in originals.items():
            setattr(torch.Tensor, name, orig)


def audit_transfers(device, budget: dict | None = None, search_call: Callable | None = None,
                    records: dict | None = None) -> list[Finding]:
    """One sharded search under the transfer ledger; ``search_call(sv, q)``
    is injectable so that a positive fixture can bounce through the host."""
    from repro_torch.analysis.hotpath_audit import OpSpy
    from repro_torch.core import transfers
    from repro_torch.distributed.serving import ShardedServingIndex

    sv = tiny_packing(mesh_mod.make_local_mesh(MESH_SHARDS, device))
    budget = dict(ShardedServingIndex.TRANSFER_BUDGET if budget is None else budget)
    _, _, q = _tiny_data()
    call = search_call or (lambda s, qq: s.search(qq, k=4, beam=8))
    call(sv, q)                                  # warm-up: the kernels' build
    reads: list[str] = []
    with host_reads(reads) as inside:
        spy = OpSpy(declared=lambda: inside[0] > 0)
        with transfers.ledger() as counted, spy:
            call(sv, q)
    path, symbol = _SERVING, "ShardedServingIndex.search"
    findings = []
    undeclared = reads + [c for c, ok in spy.crossings if not ok]
    if records is not None:
        records.update(ledger=dict(counted), budget=budget, undeclared=undeclared)
    report("mesh", f"S={MESH_SHARDS}: transfer ledger {dict(counted)} (budget {budget}), "
           f"undeclared crossings {len(undeclared)}")
    if undeclared:
        findings.append(Finding("PIPS004", path, 0, symbol,
                                f"[S={MESH_SHARDS}] {len(undeclared)} host crossing(s) outside "
                                f"to_device/to_host: {undeclared[:3]}"))
    over = {k: (counted.get(k, 0), v) for k, v in budget.items() if counted.get(k, 0) > v}
    if over:
        findings.append(Finding("PIPS004", path, 0, symbol,
                                f"[S={MESH_SHARDS}] the search crossed the host boundary more "
                                f"than its declared budget: " + ", ".join(
                                    f"{k}={got} > {bound}"
                                    for k, (got, bound) in sorted(over.items()))))
    return findings


# ---------------------------------------------------------------------------
# PIPS005
# ---------------------------------------------------------------------------

def fingerprint(run: Callable, n_shards: int, device) -> dict:
    """Run ``run(mesh, device)`` on the one-process model of ``n_shards``
    shards: each shard body's aten-op sequence, and the (source line, op)
    pairs run outside the bodies."""
    from repro_torch.analysis.hotpath_audit import OpSpy, spy_kernels

    spy = OpSpy(where=True)
    marks: list[tuple[int, int]] = []
    starts: list[int] = []
    mesh = model_mesh(n_shards, device)
    with shard_bodies(lambda: starts.append(len(spy.ops)),
                      lambda: marks.append((starts.pop(), len(spy.ops)))):
        with spy_kernels(spy), spy:
            run(mesh, device)
    inside = set()
    bodies = []
    for a, b in marks:
        bodies.append(tuple(op for op, _ in spy.ops[a:b]))
        inside.update(range(a, b))
    outside = {(loc, op) for i, (op, loc) in enumerate(spy.ops) if i not in inside}
    return dict(bodies=bodies, outside=outside)


def audit_mesh_stability(device, run: Callable | None = None, counts=SWEEP,
                         records: dict | None = None) -> list[Finding]:
    run = run or functools.partial(_run_search, early_exit=False)
    path, symbol = _SERVING, "ShardedServingIndex.search"
    fps = {s: fingerprint(run, s, device) for s in counts}
    findings = []
    base = counts[0]
    body0 = fps[base]["bodies"][0] if fps[base]["bodies"] else ()
    diverged = sorted({s for s in counts for b in fps[s]["bodies"] if b != body0})
    if diverged:
        findings.append(Finding("PIPS005", path, 0, symbol,
                                f"a shard body's op sequence at S={diverged} differs from "
                                f"S={base}'s: the shard count leaks into the body"))
    for s in counts[1:]:
        extra = fps[s]["outside"] ^ fps[base]["outside"]
        if extra:
            where = sorted({f"{loc[0]}:{loc[1]} {op}" for loc, op in extra})[:3]
            findings.append(Finding("PIPS005", path, 0, symbol,
                                    f"outside the shard bodies S={s} and S={base} run "
                                    f"different source lines or ops ({where}): the shard "
                                    f"count leaks into Python control flow"))
    if records is not None:
        records.update({f"S{s}": dict(bodies=len(fp["bodies"]),
                                      body_ops=len(fp["bodies"][0]) if fp["bodies"] else 0,
                                      outside_pairs=len(fp["outside"]))
                        for s, fp in fps.items()})
    return findings


def audit_all(device, records: dict | None = None) -> list[Finding]:
    records = {} if records is None else records
    findings = audit_collectives(device, records=records.setdefault("collectives", {}))
    rec = records.setdefault("replication", {})
    findings += audit_replication_serving(tiny_packing(mesh_mod.make_local_mesh(MESH_SHARDS, device)),
                                          rec)
    findings += audit_replication_serving(
        tiny_packing(mesh_mod.make_local_mesh(MESH_SHARDS, device), dtype="int8"))
    p, pts, hp, res = _tile_inputs(mesh_mod.make_local_mesh(MESH_SHARDS, device), device)
    findings += audit_replication_tile(mesh_mod.make_local_mesh(MESH_SHARDS, device), p, pts, hp, res)
    findings += audit_footprint(device, records=records.setdefault("footprint", {}))
    findings += audit_transfers(device, records=records.setdefault("transfers", {}))
    findings += audit_mesh_stability(device, records=records.setdefault("stability", {}))
    return findings
