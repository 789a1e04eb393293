"""Hot-path audit of the port (counterpart of ``repro/analysis/
jaxpr_audit.py``): rules PIPJ001-004.

No jaxpr to trace: each registered program (``default_programs``) runs
at a tiny shape under a recording ``TorchDispatchMode`` (``OpSpy``) that
sees every aten op it runs.  The CUDA kernels are ctypes calls, not aten
ops, so a spy on their wrappers (``spy_kernels``) records their launch
shapes; on the CPU, where a wrapper takes its kernel's plain version, the
ops inside it stand for the kernel and are not counted.

The programs are the reference's: the serving engine
(``beam_search._beam_search_multi``: float32, bfloat16 and int8 packings,
the kernel route and the plain one), the streaming build's chunk step
(``pipnn._stream_step``), both reservoir folds
(``hashprune.merge_segmented_edges`` / ``merge_flat_edges``), the
cross-shard merge (``distributed.serving.cross_shard_topk``) and the final
prune's step (``robust_prune.final_prune_step``).

  PIPJ001  host syncs.  The reference forbids host callbacks; the port's
           programs sync by design (the engine's early-exit test reads a
           flag back once a step), so each program declares its budget as a
           function of its shape and of the steps the run took, with the
           reason, here at its registration; ``ast_lint.HOT_FUNCTIONS``
           holds the sites.  The count must equal the budget: one sync
           more, or one fewer, is a reviewed change of the declaration.  The
           spy counts the ops that force a sync on the card:
           ``_local_scalar_dense`` (``.item()``, ``bool(t)``), ``nonzero``,
           ``masked_select``, ``unique``, an index by a boolean mask,
           ``repeat_interleave`` without ``output_size`` and a blocking copy
           between the card and the host.  On the card the same run also
           goes under ``torch.cuda.set_sync_debug_mode("warn")`` and the
           two counts must agree: the CPU model counts what the card does.
  PIPJ002  no float64/complex128 value in any op of a program.
  PIPJ003  donation: a program that updates in place must return its
           outputs in its donated arguments' storage (storage identity,
           ``untyped_storage().data_ptr()``).  Checked on the card always,
           and on the CPU where the CPU route is in place too; elsewhere
           the record says so and nothing fires.
  PIPJ004  launch-shape stability: a simulated serving session (beams x
           expansions x batch sizes over the float32 and int8
           ``ServingIndex`` with ``query_chunk=4``, then over a
           ``ShardedServingIndex``) may show the gather kernels at most
           |dtypes| x |beams| x |expansions| distinct input shapes and the
           cross-shard merge at most |beams|: the padded chunk keeps the
           batch size out of every launch shape, as a CUDA graph of the
           engine would need.  ``query_chunk=None`` must fire.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import Counter
import functools
import pathlib
import sys
import warnings
from typing import Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.lint import Finding, report

WIDE_DTYPES = (torch.float64, torch.complex128)
SYNC_OPS = frozenset({"aten._local_scalar_dense.default", "aten.nonzero.default",
                      "aten.masked_select.default", "aten._unique.default",
                      "aten._unique2.default", "aten.unique_dim.default",
                      "aten.unique_consecutive.default"})
INDEX_OPS = frozenset({"aten.index.Tensor", "aten.index_put.default",
                       "aten.index_put_.default", "aten._index_put_impl_.default"})
COPY_OPS = frozenset({"aten._to_copy.default", "aten.copy_.default"})
_TORCH = str(pathlib.Path(torch.__file__).resolve().parent)
_ANALYSIS = str(pathlib.Path(__file__).resolve().parent)


def _flat_tensors(obj) -> list[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in _flat_tensors(o)]
    return []


def _source_line() -> tuple[str, int]:
    """(file, line) of the innermost frame outside torch and this package:
    the source line that ran the op, for PIPS005's census."""
    f = sys._getframe(2)
    while f is not None:
        p = f.f_code.co_filename
        if not (p.startswith(_TORCH) or p.startswith(_ANALYSIS)):
            return p, f.f_lineno
        f = f.f_back
    return "", 0


SYNC_WARNING = "called a synchronizing CUDA operation"   # set_sync_debug_mode("warn")'s


def _sync_warnings(caught, start: int) -> int:
    return sum(SYNC_WARNING in str(w.message) for w in caught[start:])


class OpSpy(TorchDispatchMode):
    """Records every aten op run under it: names (and with ``where`` the
    source line that ran each), the ops that force a host sync on the card,
    float64/complex128 values and copies across devices, each as (what,
    ``declared()`` at the time).  ``paused`` > 0 (inside a kernel wrapper on
    the CPU) records nothing.

    With ``caught`` (the list of a ``warnings.catch_warnings(record=True)``
    around a run under ``torch.cuda.set_sync_debug_mode("warn")``) each op
    or wrapped host call during which the card warned is one
    ``card_events`` entry (one host sync point, however often it syncs
    inside); sync warnings outside any of them are ``stray``, one event
    each.  A warning raised in C++ reaches Python when the outermost C++
    call returns, so the sync of an op reached from C++ (``bool(t)``'s
    ``_local_scalar_dense``) arrives after the op and counts as stray."""

    def __init__(self, where: bool = False, declared: Callable | None = None,
                 caught: list | None = None):
        super().__init__()
        self.where = where
        self.declared = declared
        self.caught = caught
        self.ops: list = []
        self.syncs: list[str] = []
        self.wide: list[str] = []
        self.crossings: list[tuple[str, bool]] = []
        self.card_events: list[str] = []
        self.attributed = 0
        self.paused = 0
        self.ctor = 0           # > 0 inside a host constructor (its own event)

    def attribute(self, name: str, start: int) -> None:
        """One card event for ``name`` if the card warned since ``start``."""
        if self.caught is not None:
            n = _sync_warnings(self.caught, start)
            if n:
                self.card_events.append(name)
                self.attributed += n

    @property
    def stray(self) -> int:
        return (_sync_warnings(self.caught, 0) - self.attributed) if self.caught is not None \
            else 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        start = len(self.caught) if self.caught is not None else 0
        out = func(*args, **kwargs)
        if self.paused:
            return out
        name = str(func)
        if not self.ctor:
            self.attribute(name, start)
        self.ops.append((name, _source_line()) if self.where else name)
        ins = _flat_tensors(args) + _flat_tensors(kwargs)
        if name in SYNC_OPS:
            self.syncs.append(name)
        elif name in INDEX_OPS and any(t.dtype in (torch.bool, torch.uint8)
                                       for t in _flat_tensors(args[1:2])):
            self.syncs.append(name + "[bool mask]")
        elif name == "aten.repeat_interleave.Tensor" and kwargs.get("output_size") is None:
            self.syncs.append(name)
        elif name in COPY_OPS:
            src = args[1] if name == "aten.copy_.default" else args[0]
            dst = args[0] if name == "aten.copy_.default" else out
            if isinstance(src, torch.Tensor) and isinstance(dst, torch.Tensor) \
                    and src.device != dst.device:
                self.crossings.append((f"{name} {src.device} -> {dst.device}",
                                       bool(self.declared and self.declared())))
                pinned = src.device.type == "cpu" and src.is_pinned()
                if not (kwargs.get("non_blocking") and pinned):
                    self.syncs.append(name + f" {src.device.type}->{dst.device.type}")
        for t in ins + _flat_tensors(out):
            if t.dtype in WIDE_DTYPES:
                self.wide.append(f"{name} {t.dtype}")
                break
        return out


def _scalar_through_tensor_index(index, value) -> bool:
    """``t[idx] = v`` with ``v`` a Python number and ``idx`` holding an
    integer tensor: on the card the number becomes a host tensor that the
    indexed write copies to the device."""
    if not isinstance(value, (bool, int, float)):
        return False
    parts = index if isinstance(index, tuple) else (index,)
    tensors = [i for i in parts if isinstance(i, torch.Tensor)]
    # a boolean mask is counted by the dispatch spy (its nonzero)
    return bool(tensors) and not any(t.dtype in (torch.bool, torch.uint8) for t in tensors)


@contextlib.contextmanager
def host_crossings(spy: OpSpy, device):
    """Count the host syncs made inside a call that no aten op the spy sees
    shows: ``torch.tensor`` / ``torch.as_tensor`` of host data given an
    explicit ``device`` of the program's type (a blocking host-to-device
    copy on the card) and ``t[int_tensor] = number`` (the number's copy to
    the device).  Each such call is one card event."""
    kind = torch.device(device).type
    originals = {name: getattr(torch, name) for name in ("tensor", "as_tensor")}
    setitem = torch.Tensor.__setitem__

    def counted(what: str, fn, is_sync: Callable):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            start = len(spy.caught) if spy.caught is not None else 0
            spy.ctor += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                spy.ctor -= 1
            if spy.paused or spy.ctor:
                return out
            if is_sync(args, kwargs, out):
                spy.syncs.append(what)
            spy.attribute(what, start)
            return out
        return call

    def ctor_sync(args, kwargs, out):
        dev = kwargs.get("device")
        return (dev is not None and not isinstance(args[0], torch.Tensor)
                and torch.device(dev).type == kind)

    for name, orig in originals.items():
        setattr(torch, name, counted(f"torch.{name}(host data, device=)", orig, ctor_sync))
    torch.Tensor.__setitem__ = counted(
        "t[int tensor] = number", setitem,
        lambda args, kwargs, out: _scalar_through_tensor_index(args[1], args[2]))
    try:
        yield
    finally:
        for name, orig in originals.items():
            setattr(torch, name, orig)
        torch.Tensor.__setitem__ = setitem


@contextlib.contextmanager
def patched_everywhere(replacements: dict):
    """Replace each function ``old`` by ``new`` (``{old: new}``) wherever a
    port module holds it as a module attribute; restored on exit."""
    done = []
    for mod in list(sys.modules.values()):
        if not getattr(mod, "__name__", "").startswith("repro_torch"):
            continue
        for attr, val in list(vars(mod).items()):
            try:
                new = replacements.get(val)
            except TypeError:           # an unhashable module attribute
                continue
            if new is not None:
                setattr(mod, attr, new)
                done.append((mod, attr, val))
    try:
        yield
    finally:
        for mod, attr, val in done:
            setattr(mod, attr, val)


def _shape_key(args) -> tuple:
    return tuple((tuple(t.shape), str(t.dtype)) for t in _flat_tensors(args))


# kernel wrappers, and the plain versions that stand for them on the CPU:
# family -> [(module, function, is the kernel wrapper)]
GATHER_FAMILIES = {
    "gather_distance": [("repro_torch.kernels.gather_distance", "gather_distance", True),
                        ("repro_torch.kernels.gather_distance", "gather_distance_plain",
                         False)],
    "gather_distance_int8": [
        ("repro_torch.kernels.gather_distance_int8", "gather_distance_int8", True),
        ("repro_torch.kernels.gather_distance_int8", "gather_distance_int8_plain", False)],
    "cross_shard_topk": [("repro_torch.distributed.serving", "cross_shard_topk", False)],
}


@contextlib.contextmanager
def spy_kernels(spy: OpSpy | None = None):
    """Spy on every kernel wrapper of ``contracts.REGISTRY`` and on the
    families of ``GATHER_FAMILIES``: yields ``shapes``, where each call's
    input shapes go to ``shapes[family or kernel]`` (a set); inside a
    wrapper given CPU tensors, ``spy`` is paused (the plain version stands
    for the kernel)."""
    import importlib

    from repro_torch.analysis import contracts

    shapes: dict = {}
    targets: dict[Callable, tuple[str, bool]] = {}
    for spec in contracts.REGISTRY:
        targets[contracts._resolve(spec.wrapper)] = (spec.name, True)
    for fam, members in GATHER_FAMILIES.items():
        for mod, fn, is_kernel in members:
            targets[getattr(importlib.import_module(mod), fn)] = (fam, is_kernel)

    def wrap(fn, key, is_kernel):
        @functools.wraps(fn)
        def spied(*args, **kwargs):
            shapes.setdefault(key, set()).add(_shape_key(args))
            ts = _flat_tensors(args)
            pause = spy is not None and is_kernel and bool(ts) and ts[0].device.type == "cpu"
            if pause:
                spy.paused += 1
            try:
                return fn(*args, **kwargs)
            finally:
                if pause:
                    spy.paused -= 1
        return spied

    with patched_everywhere({fn: wrap(fn, key, k) for fn, (key, k) in targets.items()}):
        yield shapes


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HotProgram:
    """A registered hot-path program: ``build(device)`` gives (fn, args,
    kwargs, shape); ``budget(shape, calls)`` its declared host syncs, where
    ``calls`` is how often the run called ``step`` ("module:function", a
    function the program calls a fixed number of times a step; 0 without
    one); ``donated`` the argument positions it writes in place on
    ``in_place_on`` devices."""

    name: str
    path: str
    symbol: str
    build: Callable
    budget: Callable
    why: str
    donated: tuple = ()
    in_place_on: frozenset = frozenset()
    step: str | None = None


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


_ENGINE = dict(n=96, d=16, r=8, nq=4, beam=8, iters=12, expansions=2)


def _engine_build(dtype: str, plain: bool):
    def build(dev):
        from repro_torch.core import beam_search as bs
        from repro_torch.core.metrics import point_norms
        from repro_torch.kernels.gather_distance_int8 import quantize_symmetric

        s = dict(_ENGINE)
        g = _gen(dev)
        x = torch.randn((s["n"], s["d"]), generator=g, device=dev)
        graph = torch.randint(0, s["n"], (s["n"], s["r"]), generator=g, device=dev,
                              dtype=torch.int32)
        q = torch.randn((s["nq"], s["d"]), generator=g, device=dev)
        norms = point_norms(x, "l2")
        scales = None
        if dtype == "int8":
            x, scales = quantize_symmetric(x)
        elif dtype == "bf16":
            x = x.to(torch.bfloat16)
        kw = dict(beam=s["beam"], iters=s["iters"], metric="l2", expansions=s["expansions"],
                  early_exit=True, scales=scales, plain=plain)
        return bs._beam_search_multi, (graph, x, norms, q, 0), kw, s
    return build


def _stream_build(dev):
    from repro_torch.core import pipnn
    from repro_torch.core.hashprune import reservoir_init
    from repro_torch.core.leaf import LeafParams
    from repro_torch.core.sketch import sketch

    s = dict(n=256, d=16, l_max=16, m=12, leaves=8, c=32, k=4)
    g = _gen(dev, 1)
    x = torch.randn((s["n"], s["d"]), generator=g, device=dev)
    sk = sketch(x, torch.randn((s["m"], s["d"]), generator=g, device=dev)).contiguous()
    ids = torch.stack([torch.randperm(s["n"], generator=g, device=dev)[: s["c"]]
                       for _ in range(s["leaves"])]).to(torch.int32)
    ids[-1, s["c"] // 2:] = -1
    res = reservoir_init(s["n"], s["l_max"], dev)
    kw = dict(leaf=LeafParams(k=s["k"], method="bidirected"), merge="segmented")
    return pipnn._stream_step, (res, x, sk, ids), kw, s


def _edges(n, e, dev, seed=2):
    g = _gen(dev, seed)
    src = torch.randint(0, n, (e,), generator=g, device=dev, dtype=torch.int32)
    dst = torch.randint(0, n, (e,), generator=g, device=dev, dtype=torch.int32)
    h = torch.randint(0, 1 << 12, (e,), generator=g, device=dev, dtype=torch.int32)
    dist = torch.rand((e,), generator=g, device=dev)
    pad = torch.arange(e, device=dev) % 16 == 15
    return (torch.where(pad, n, src), torch.where(pad, -1, dst), torch.where(pad, 0, h),
            torch.where(pad, float("inf"), dist))


def _fold_build(flavor: str):
    def build(dev):
        from repro_torch.core import hashprune as hp

        s = dict(n=128, l_max=16, e=1024)
        res = hp.reservoir_init(s["n"], s["l_max"], dev)
        first = _edges(s["n"], s["e"], dev, 3)
        res = hp.merge_flat_edges(*res, *first)      # a reservoir with live slots
        fn = hp.merge_segmented_edges if flavor == "segmented" else hp.merge_flat_edges
        return fn, (*(t.clone() for t in res), *_edges(s["n"], s["e"], dev)), {}, s
    return build


def _topk_build(dev):
    from repro_torch.distributed.serving import cross_shard_topk

    s = dict(shards=4, nq=4, b=8, k=10)
    g = _gen(dev, 4)
    ids = torch.randint(0, 1000, (s["shards"], s["nq"], s["b"]), generator=g, device=dev,
                        dtype=torch.int32)
    ds = torch.rand((s["shards"], s["nq"], s["b"]), generator=g, device=dev)
    return cross_shard_topk, (ids, ds), dict(k=s["k"]), s


def _prune_build(dev):
    from repro_torch.core.hashprune import INVALID_ID
    from repro_torch.core.robust_prune import final_prune_step

    s = dict(n=128, d=16, l_max=16, max_deg=8, chunk=64)
    g = _gen(dev, 5)
    x = torch.randn((s["n"], s["d"]), generator=g, device=dev)
    ids = torch.randint(0, s["n"], (s["n"], s["l_max"]), generator=g, device=dev,
                        dtype=torch.int32)
    dists = torch.rand((s["n"], s["l_max"]), generator=g, device=dev)
    out_ids = torch.full((s["n"], s["max_deg"]), INVALID_ID, dtype=torch.int32, device=dev)
    out_d = torch.full((s["n"], s["max_deg"]), float("inf"), device=dev)
    kw = dict(alpha=1.44, max_deg=s["max_deg"], metric="l2", chunk=s["chunk"])
    return final_prune_step, (x, ids, dists, out_ids, out_d, 0), kw, s


_BS = "src/repro_torch/core/beam_search.py"
_HP = "src/repro_torch/core/hashprune.py"
# hashprune_flat's five boolean-mask reads (the ranked edges under l_max):
# each sizes its output from the mask, so each reads a count back
_FLAT_SYNCS = 5


def _engine_budget(per_step: int, once: int) -> Callable:
    """The engine's syncs after ``calls`` merge_block calls (``expansions``
    a step): one early-exit test a step, and one more that ends the loop
    when it converged before ``iters``; ``per_step`` more a step and
    ``once`` more a run."""
    def budget(s: dict, calls: int) -> int:
        steps = calls // max(1, min(s["expansions"], s["beam"]))
        tests = steps + 1 if steps < s["iters"] else steps
        return tests + per_step * steps + once
    return budget


def default_programs() -> tuple[HotProgram, ...]:
    """The registry.  Each budget is declared here, with why each sync
    exists; its sites are ``ast_lint.HOT_FUNCTIONS``."""
    engine_why = ("the early-exit test reads one flag back a step (and once more where "
                  "it ends the loop), and each step's vis[rows, pos] = True copies the "
                  "number to the device (beam_search.py)")
    int8_why = (engine_why + "; the plain int8 gather's quantize_symmetric moves 1/127 to "
                "the device (torch.tensor) at each of its 1 + a step calls")
    progs = [HotProgram(f"engine[{dt},{'plain' if plain else 'kernel'}]", _BS,
                        "_beam_search_multi", _engine_build(dt, plain),
                        _engine_budget(2, 1) if (dt, plain) == ("int8", True)
                        else _engine_budget(1, 0),
                        int8_why if (dt, plain) == ("int8", True) else engine_why,
                        step="repro_torch.core.beam_search:merge_block")
             for dt in ("f32", "bf16", "int8") for plain in (False, True)]
    progs += [
        HotProgram("stream_step", "src/repro_torch/core/pipnn.py", "_stream_step",
                   _stream_build, lambda s, _: _FLAT_SYNCS,
                   "the chunk's hashprune_flat sizes its scatter from five boolean masks",
                   donated=(0,), in_place_on=frozenset({"cuda"})),
        HotProgram("merge_segmented", _HP, "merge_segmented_edges", _fold_build("segmented"),
                   lambda s, _: _FLAT_SYNCS, "the chunk's hashprune_flat (five boolean masks)",
                   donated=(0, 1, 2), in_place_on=frozenset({"cuda"})),
        HotProgram("merge_flat", _HP, "merge_flat_edges", _fold_build("flat"),
                   lambda s, _: _FLAT_SYNCS, "hashprune_flat over the reservoir and the chunk"),
        HotProgram("cross_shard_topk", "src/repro_torch/distributed/serving.py",
                   "cross_shard_topk", _topk_build, lambda s, _: 0, "none: a device fold"),
        HotProgram("final_prune_step", "src/repro_torch/core/robust_prune.py",
                   "final_prune_step", _prune_build, lambda s, _: 1,
                   "robust_prune_mask moves alpha to the device (torch.tensor): one copy",
                   donated=(3, 4), in_place_on=frozenset({"cpu", "cuda"})),
    ]
    return tuple(progs)


@contextlib.contextmanager
def counted_calls(ref: str | None):
    """Count the calls of ``ref`` ("module:function") wherever a port
    module holds it; yields a one-element list with the count."""
    count = [0]
    if ref is None:
        yield count
        return
    import importlib

    mod, _, name = ref.partition(":")
    fn = getattr(importlib.import_module(mod), name)

    @functools.wraps(fn)
    def counting(*args, **kwargs):
        count[0] += 1
        return fn(*args, **kwargs)

    with patched_everywhere({fn: counting}):
        yield count


# ---------------------------------------------------------------------------
# PIPJ001-003
# ---------------------------------------------------------------------------

def _storages(ts) -> set[int]:
    return {t.untyped_storage().data_ptr() for t in ts}


def audit_program(prog: HotProgram, device) -> tuple[list[Finding], dict]:
    """PIPJ001-003 for one program on ``device``; returns (findings, record)."""
    dev = torch.device(device)
    findings: list[Finding] = []

    def finding(rule, msg):
        findings.append(Finding(rule, prog.path, 0, prog.symbol, f"[{prog.name}] {msg}"))

    card = dev.type == "cuda"
    if card:        # warm up: the kernels' build, first-launch attributes
        fn, args, kw, _ = prog.build(dev)
        fn(*args, **kw)
        torch.cuda.synchronize(dev)
    fn, args, kw, shape = prog.build(dev)
    if card:
        torch.cuda.synchronize(dev)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        spy = OpSpy(caught=caught if card else None)
        if card:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            with counted_calls(prog.step) as calls, spy_kernels(spy), \
                    host_crossings(spy, dev), spy:
                out = fn(*args, **kw)
        finally:
            if card:
                torch.cuda.set_sync_debug_mode(0)
    budget = int(prog.budget(shape, calls[0]))
    n_sync = len(spy.syncs)
    warned = len(spy.card_events) + spy.stray
    rec = dict(syncs=n_sync, budget=budget, card_syncs=warned if card else None,
               ops=len(spy.ops), why=prog.why, sync_ops=dict(Counter(spy.syncs)),
               step_calls=calls[0])
    if card:
        rec.update(card_ops=dict(Counter(spy.card_events)), stray=spy.stray)
    # -- PIPJ001 ---------------------------------------------------------
    if n_sync != budget:
        finding("PIPJ001", f"{n_sync} host syncs at {shape} after {calls[0]} step calls, "
                f"declared {budget} ({prog.why}); ops {sorted(set(spy.syncs))}")
    if card and warned != n_sync:
        finding("PIPJ001", f"the card's sync debug mode counted {warned} syncs, the spy "
                f"{n_sync}: the CPU model does not count what the card does")
    # -- PIPJ002 ---------------------------------------------------------
    if spy.wide:
        finding("PIPJ002", f"double-width values in the program: {sorted(set(spy.wide))[:4]}")
    # -- PIPJ003 ---------------------------------------------------------
    if prog.donated:
        if dev.type in prog.in_place_on:
            outs = _storages(_flat_tensors(out))
            lost = [i for i in prog.donated
                    if not _storages(_flat_tensors(args[i])) <= outs]
            rec["donation"] = "kept" if not lost else f"dropped at {lost}"
            if lost:
                finding("PIPJ003", f"donated argument(s) {lost} not in the outputs' "
                        f"storage: the program returned a copy, so the peak holds the "
                        f"buffer twice")
        else:
            rec["donation"] = (f"not checked: the {dev.type} route is not in place "
                               f"(in place on {sorted(prog.in_place_on)})")
    return findings, rec


def audit_hot_paths(device, records: dict | None = None) -> list[Finding]:
    findings = []
    for prog in default_programs():
        f, rec = audit_program(prog, device)
        findings += f
        if records is not None:
            records[prog.name] = rec
        report("hotpath", f"{prog.name}: {rec['syncs']} syncs (budget {rec['budget']}"
               + (f", card {rec['card_syncs']}" if rec["card_syncs"] is not None else "")
               + f"), {rec['ops']} ops" + (f", donation {rec['donation']}"
                                           if "donation" in rec else ""))
    return findings


# ---------------------------------------------------------------------------
# PIPJ004
# ---------------------------------------------------------------------------

SESSION = dict(beams=(4, 8), expansions=(1, 2), batch_sizes=(1, 3, 7, 12))


def _session_data(seed=0):
    rng = np.random.default_rng(seed)
    n, d = 96, 16
    x = rng.normal(size=(n, d)).astype(np.float32)
    graph = rng.integers(0, n, size=(n, 4)).astype(np.int32)
    return rng, x, graph


def _replay(index, rng, d, query_chunk) -> None:
    for beam in SESSION["beams"]:
        for e in SESSION["expansions"]:
            for nq in SESSION["batch_sizes"]:
                q = rng.normal(size=(nq, d)).astype(np.float32)
                index.search(q, k=4, beam=beam, expansions=e, query_chunk=query_chunk)


def audit_launch_shapes(device, query_chunk: int | None = 4,
                        records: dict | None = None) -> list[Finding]:
    """PIPJ004 over ``ServingIndex``: float32 and int8 packings."""
    from repro_torch.core.serving import ServingIndex

    rng, x, graph = _session_data()
    indexes = (ServingIndex.from_graph(graph, x, 0, device=device),
               ServingIndex.from_graph(graph, x, 0, dtype="int8", device=device))
    with spy_kernels() as shapes:
        for sv in indexes:
            _replay(sv, rng, x.shape[1], query_chunk)
    got = len(shapes.get("gather_distance", ())) + len(shapes.get("gather_distance_int8", ()))
    bound = len(indexes) * len(SESSION["beams"]) * len(SESSION["expansions"])
    if records is not None:
        records["single"] = dict(gather_shapes=got, bound=bound, query_chunk=query_chunk)
    if got > bound:
        return [Finding("PIPJ004", "src/repro_torch/core/serving.py", 0, "ServingIndex.search",
                        f"the session launched the gather kernels at {got} distinct input "
                        f"shapes, bound {bound} (|dtypes| x |beams| x |expansions|): the "
                        f"batch size leaks into the launch shape (query_chunk="
                        f"{query_chunk})")]
    return []


SESSION_SHARDS = 4


def audit_launch_shapes_sharded(device, query_chunk: int | None = 4,
                                records: dict | None = None) -> list[Finding]:
    """PIPJ004 over ``ShardedServingIndex`` on a one-process mesh of
    ``SESSION_SHARDS`` shards."""
    from repro_torch.distributed.serving import ShardedServingIndex

    rng, x, graph = _session_data()
    ssv = ShardedServingIndex.from_graph(graph, x, 0, n_shards=SESSION_SHARDS,
                                         device=device)
    with spy_kernels() as shapes:
        _replay(ssv, rng, x.shape[1], query_chunk)
    path, findings = "src/repro_torch/distributed/serving.py", []
    gather = len(shapes.get("gather_distance", ()))
    merge = len(shapes.get("cross_shard_topk", ()))
    bound = len(SESSION["beams"]) * len(SESSION["expansions"])
    if records is not None:
        records["sharded"] = dict(gather_shapes=gather, bound=bound, merge_shapes=merge,
                                  merge_bound=len(SESSION["beams"]), query_chunk=query_chunk)
    if gather > bound:
        findings.append(Finding(
            "PIPJ004", path, 0, "ShardedServingIndex.search",
            f"the sharded session launched the gather kernel at {gather} distinct input "
            f"shapes, bound {bound} (|beams| x |expansions|): the batch size leaks into "
            f"the launch shape (query_chunk={query_chunk})"))
    if merge > len(SESSION["beams"]):
        findings.append(Finding(
            "PIPJ004", path, 0, "cross_shard_topk",
            f"the cross-shard merge ran at {merge} distinct input shapes, bound "
            f"{len(SESSION['beams'])} (one a beam width): the batch size leaks into it"))
    return findings


def audit_all(device, records: dict | None = None) -> list[Finding]:
    records = {} if records is None else records
    prog_rec, shape_rec = records.setdefault("programs", {}), records.setdefault("shapes", {})
    return (audit_hot_paths(device, records=prog_rec)
            + audit_launch_shapes(device, records=shape_rec)
            + audit_launch_shapes_sharded(device, records=shape_rec))
