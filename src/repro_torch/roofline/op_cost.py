"""Dispatch-level cost walker (counterpart of ``repro/roofline/hlo_cost.py``).

The reference walks compiled HLO text.  Eager PyTorch has none; a program
runs once under ``walk()``, a ``TorchDispatchMode`` that sees every aten
op, and is charged so:

  * operations  -- the products of ``mm``, ``bmm``, ``addmm``, ``baddbmm``,
                   ``_int_mm``, ``matmul``, ``dot``, ``mv`` and ``cdist``
                   (``_euclidean_dist``, ``_cdist_forward``): 2 * the
                   result's elements * the contracted length, by class:
                   float32 is ``f32`` unless
                   ``torch.backends.cuda.matmul.allow_tf32`` is on
                   (``device.py`` turns it off), then ``tf32``; bfloat16
                   and float16 ``bf16``; int8 ``int8``.  Elementwise work is
                   not counted, as the reference does not count it.
  * bytes       -- each op that moves memory is charged its tensor operands
                   and results (elements x element size).  Views and
                   aliases are free (``bitcast``, ``get-tuple-element``);
                   windowed reads (``index``, ``index_select``, ``gather``,
                   ``take``, ``embedding``) charge twice their result, as
                   the reference's ``_op_bytes`` charges ``gather`` and
                   ``dynamic-slice`` (a copy of a slice charges its window
                   and its result alike); an op that writes into an argument
                   charges what it writes and what it reads beside it (an
                   indexed write the indexed window, not the whole tensor).
                   ``empty`` writes nothing.
  * loops       -- eager loops dispatch every iteration, so there is no trip
                   count to recover.
  * kernels     -- every call of a kernel wrapper (``kernels._MODULES``'
                   counters) is charged its kernel's work model
                   (``work`` beside each wrapper) and nothing else: the
                   walker is paused inside the wrapper on every device, so
                   on the CPU the plain version's ops are not counted and a
                   program reads the same count on the CPU and on the card.
                   A plain version that a program calls itself (the
                   engine's plain route) dispatches its own ops and is
                   noted with the same model as its kernel's least work,
                   not charged.  A counter without a model raises.
  * collectives -- each ``ShardMesh`` exchange (``launch.mesh.observers``)
                   is logged as (op, payload bytes a shard, group): an
                   ``all_gather``'s payload is its gathered result, an
                   ``all_to_all``'s one sender's [S, cap, ...] buffer, a
                   ``psum``'s one part, and the group is the S shards.

The ``TOP`` (40) byte movers and collectives are kept, as ``HloCost`` keeps
them.  An op whose product class is unknown raises ``UncountedOp``: no
program is walked with a part left out.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import heapq
import itertools
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch._patch import patched_everywhere
from repro_torch.roofline.analysis import HLO_NAMES, Work, collective_bytes


class UncountedOp(RuntimeError):
    """An op the walker cannot charge."""


_aten = torch.ops.aten
# products: op -> position of the left operand (its last dim is contracted)
_PRODUCTS = {_aten.mm.default: 0, _aten.bmm.default: 0, _aten.addmm.default: 1,
             _aten.baddbmm.default: 1, _aten._int_mm.default: 0, _aten.matmul.default: 0,
             _aten.dot.default: 0, _aten.mv.default: 0, _aten.addmv.default: 1,
             _aten._euclidean_dist.default: 0, _aten._cdist_forward.default: 0}
_WINDOWED = {_aten.index.Tensor, _aten.index_select.default, _aten.gather.default,
             _aten.take.default, _aten.embedding.default}
_NO_WRITE = {_aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
             _aten.new_empty.default, _aten.new_empty_strided.default}
_INDEXED_WRITES = {_aten.index_put_.default, _aten._index_put_impl_.default}
_SCATTERS = {_aten.scatter_.src, _aten.scatter_.value, _aten.scatter_add_.default,
             _aten.scatter_reduce_.two, _aten.index_add_.default, _aten.index_copy_.default,
             _aten.index_fill_.int_Scalar, _aten.index_fill_.int_Tensor}


def op_class(dtype: torch.dtype) -> str:
    """The peak class of a product of ``dtype`` operands."""
    if dtype == torch.float32:
        return "tf32" if torch.backends.cuda.matmul.allow_tf32 else "f32"
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if dtype in (torch.int8, torch.uint8):
        return "int8"
    raise UncountedOp(f"no peak class for products of {dtype}")


def tensors(obj) -> list[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in tensors(o)]
    return []


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _indexed_write_bytes(self: torch.Tensor, indices) -> float:
    """Bytes an ``index_put_`` writes: the positions its integer indices
    broadcast to times the unindexed dims (a boolean mask: all of ``self``,
    the most it can write)."""
    idx = [(d, i) for d, i in enumerate(indices) if i is not None]
    if not idx or any(i.dtype in (torch.bool, torch.uint8) for _, i in idx):
        return float(nbytes(self))
    npos = math.prod(torch.broadcast_shapes(*(i.shape for _, i in idx)))
    rest = math.prod(s for d, s in enumerate(self.shape) if d not in {d for d, _ in idx})
    return float(npos * rest * self.element_size())


def _op_bytes(func, args, kwargs, out) -> float:
    ins = tensors(args) + tensors(kwargs)
    outs = tensors(out)
    if func in _NO_WRITE:
        return 0.0
    if func in _WINDOWED:
        return 2.0 * sum(nbytes(t) for t in outs)
    schema = func._schema
    if schema.is_mutable:
        written = [a for a, s in zip(args, schema.arguments)
                   if s.alias_info is not None and s.alias_info.is_write
                   and isinstance(a, torch.Tensor)]
        written += [v for k, v in kwargs.items() if isinstance(v, torch.Tensor) and any(
            s.name == k and s.alias_info is not None and s.alias_info.is_write
            for s in schema.arguments)]
        mutated = {id(t) for t in written}
        read = sum(nbytes(t) for t in ins if id(t) not in mutated)
        if func in _INDEXED_WRITES:
            return read + _indexed_write_bytes(args[0], args[1])
        if func in _SCATTERS:
            # what the index addresses: the index (or the source) elements
            src = [t for t in ins if id(t) not in mutated]
            return read + float(max((t.numel() for t in src), default=0)
                                * args[0].element_size())
        return read + sum(nbytes(t) for t in written)
    if getattr(func, "is_view", False):
        return 0.0
    src = {_storage(t) for t in ins}
    if outs and all(_storage(t) in src for t in outs):
        return 0.0          # an alias of an input (``_unsafe_view``, ``contiguous``)
    return float(sum(nbytes(t) for t in ins) + sum(nbytes(t) for t in outs))


TOP = 40          # byte movers kept, as ``HloCost`` keeps them


@dataclasses.dataclass
class KernelCall:
    counter: str
    work: Work
    shapes: tuple        # the wrapper's tensor arguments' shapes
    out_shapes: tuple    # its outputs' shapes
    launched: bool       # False: a plain version called outside its wrapper


class OpCost(TorchDispatchMode):
    """The walk of one run: ``ops`` (by class) and ``bytes`` dispatched,
    the kernel launches charged (``launches`` by counter), every call of a
    kernel's function with its work and shapes (``calls``: the launches and
    the plain versions a program calls itself) and the mesh exchanges
    (``coll_log``)."""

    def __init__(self):
        super().__init__()
        self.ops: dict[str, float] = {}
        self.bytes = 0.0
        self.mem_ops: list = []          # the top byte movers: (op, bytes) once the walk ends
        self.coll_log: list = []         # (op, payload bytes a shard, group)
        self.launches: dict[str, int] = {}
        self.calls: list[KernelCall] = []
        self.paused = 0
        self.args, self.kwargs, self.out = (), {}, None   # the walked call's
        self._seq = itertools.count()

    def _moved(self, what, b: float) -> None:
        """Keep ``what`` (an op, or a kernel's counter) among the ``TOP``
        largest byte movers (a min-heap while the walk runs)."""
        item = (b, next(self._seq), what)
        if len(self.mem_ops) < TOP:
            heapq.heappush(self.mem_ops, item)
        elif b > self.mem_ops[0][0]:
            heapq.heapreplace(self.mem_ops, item)

    @contextlib.contextmanager
    def pause(self):
        """Count nothing inside (a launch's plain version, a work model)."""
        self.paused += 1
        try:
            yield
        finally:
            self.paused -= 1

    def top_movers(self) -> None:
        self.mem_ops = [(str(what), b) for b, _, what in sorted(self.mem_ops, reverse=True)]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.paused:
            return out
        if func in _PRODUCTS:
            lhs = args[_PRODUCTS[func]]
            for o in tensors(out)[:1]:
                c = op_class(lhs.dtype)
                self.ops[c] = self.ops.get(c, 0.0) + 2.0 * o.numel() * lhs.shape[-1]
        b = _op_bytes(func, args, kwargs, out)
        if b:
            self.bytes += b
            self._moved(func, b)
        return out

    # -- kernels ------------------------------------------------------------
    def charge(self, call: KernelCall) -> None:
        """A launch: its model is what it dispatched."""
        self.launches[call.counter] = self.launches.get(call.counter, 0) + 1
        self.calls.append(call)
        for c, v in call.work.ops.items():
            self.ops[c] = self.ops.get(c, 0.0) + v
        self.bytes += call.work.bytes
        self._moved(f"kernel {call.counter}", call.work.bytes)

    def kernel_work(self) -> Work:
        """The kernels' least work of every call: each launch and each
        plain version a program called itself (the same function)."""
        total = Work()
        for call in self.calls:
            total = total + call.work
        return total

    # -- collectives --------------------------------------------------------
    def note(self, mesh, op: str, parts) -> None:
        """One exchange of ``mesh`` with this rank's ``parts``: its payload
        bytes a shard, in the reference's convention for its HLO op."""
        if self.paused:
            return
        total = float(sum(nbytes(t) for t in tensors(parts)))
        if op == "all_gather":
            payload = total * mesh.world            # the gathered result
        else:
            payload = total / mesh.n_local          # one shard's buffer / part
        self.coll_log.append((HLO_NAMES[op], payload, mesh.n_shards))

    def collectives(self) -> dict:
        return collective_bytes(self.coll_log)


def kernel_models() -> dict:
    """Launch counter -> (wrapper module, wrapper name, model(args, kwargs,
    out, before), before(args, kwargs) or None): each kernel's work model
    on the wrapper's arguments.  The merge writes into its first arguments
    on the card, so its model reads A's ids from a copy taken before."""
    from repro_torch.kernels import (distance, edge_hash, gather_distance,
                                     gather_distance_int8, leaf_knn, segmented_merge, topk)

    def same(model):
        return lambda args, kwargs, out, before: model(*args, **kwargs)

    return {
        "leaf_knn": (leaf_knn, "leaf_topk", same(leaf_knn.work), None),
        "edge_hash": (edge_hash, "edge_hashes", same(edge_hash.work), None),
        "segmented_merge": (segmented_merge, "merge_sorted_reservoirs",
                            lambda args, kwargs, out, before: segmented_merge.work(
                                before, args[3], out[0]),
                            lambda args, kwargs: args[0].clone()),
        "gather_distance": (gather_distance, "gather_distance", same(gather_distance.work), None),
        "gather_distance_int8": (gather_distance_int8, "gather_distance_int8",
                                 same(gather_distance_int8.work), None),
        "pairwise_distance": (distance, "pairwise_distance", same(distance.work), None),
        "pairwise_distance_int8": (distance, "pairwise_distance_int8",
                                   same(distance.work_int8), None),
        "rowwise_topk": (topk, "rowwise_topk", same(topk.work), None),
    }


def _modelled(cost: OpCost, counter: str, fn, model, before, launched: bool):
    """``fn`` (a kernel's wrapper, or its plain version) noting each call
    with its kernel's model.  A wrapper is charged its model, with the
    walker paused inside it; a plain version that a program calls itself
    outside a wrapper (the engine's plain route) dispatches its own ops and
    is noted, not charged, so that the program's least work reads the same
    on either route."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        if cost.paused and not launched:     # the plain version inside its wrapper
            return fn(*args, **kwargs)
        with cost.pause():
            pre = before(args, kwargs) if before is not None else None
        with cost.pause() if launched else contextlib.nullcontext():
            out = fn(*args, **kwargs)
        with cost.pause():
            kc = KernelCall(counter, Work.of(model(args, kwargs, out, pre)),
                            tuple(tuple(t.shape) for t in tensors(args)),
                            tuple(tuple(t.shape) for t in tensors(out)), launched)
        if launched:
            cost.charge(kc)
        else:
            cost.calls.append(kc)
        return out
    return call


@contextlib.contextmanager
def walk():
    """Walk what runs inside: yields the ``OpCost``.  Every kernel wrapper
    is replaced, wherever a port module holds it, by one that charges its
    model, and its plain version by one that notes it; the mesh's
    exchanges are logged."""
    from repro_torch import kernels
    from repro_torch.launch import mesh as mesh_mod

    cost = OpCost()
    models = kernel_models()
    missing = set(kernels._MODULES) - set(models)
    if missing:
        raise UncountedOp(f"kernel counters without a work model: {sorted(missing)}")
    wrapped = {}
    for counter, (mod, name, model, before) in models.items():
        for fname, launched in ((name, True), (f"{name}_plain", False)):
            fn = getattr(mod, fname)
            wrapped[fn] = _modelled(cost, counter, fn, model, before, launched)
    observer = cost.note
    mesh_mod.observers.append(observer)
    try:
        with patched_everywhere(wrapped), cost:
            yield cost
    finally:
        mesh_mod.observers.remove(observer)
        cost.top_movers()
