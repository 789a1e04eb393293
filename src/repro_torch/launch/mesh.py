"""The shard mesh: S shards over W processes, one device each (the
counterpart of ``repro/launch/mesh.py``, built on ``torch.distributed``).

The reference lays S shards on a jax mesh of S devices and lets
``shard_map`` run one body a device.  Here a ``ShardMesh`` gives each of W
ranks the contiguous block of ``L = S / W`` shards ``local = [rank*L,
(rank+1)*L)``, and the rank runs its shards' bodies one after another.
Its methods are the only places where shards meet:

  * ``all_gather(local_parts)``: every shard's parts in shard order
    (``lax.all_gather(tiled=True)`` over dim 0);
  * ``all_to_all(local_sends)``: each local sender's ``[S_dst, cap, ...]``
    buffer goes out and each local receiver gets ``[S_src, cap, ...]``,
    row ``src`` being sender ``src``'s row for it
    (``lax.all_to_all(split_axis=0, concat_axis=0, tiled=True)``);
  * ``psum(local_parts)``: the shards' values summed (``lax.psum``);
  * ``broadcast(obj)``: rank 0's object or tensor on every rank (the
    serving loop's decisions, ``launch.serve_loop``).

**One process** (``make_local_mesh``, or a mesh of ``world == 1`` without
a group) holds all S shards, and the methods are plain list functions: a
concatenation, the transpose of the shard grid and a stacked sum
(``all_gather``, ``all_to_all`` and ``psum`` below); ``broadcast`` returns
its argument.

**W processes** (``init_mesh``) run one collective a payload: the local
sends are packed into one contiguous ``[W_dst, L_src, L_dst, cap, ...]``
tensor for ``all_to_all_single`` and unpacked into ``[S_src, cap, ...]``
for each local receiver; ``all_gather`` is the local concatenation and
one ``all_gather``; ``psum`` the local sum and one ``all_reduce``;
``broadcast`` one ``broadcast`` (a tensor) or ``broadcast_object_list``.  Bool
masks travel as ``uint8``; every other dtype travels as it is.  The
backend follows the device: NCCL on the card, gloo on the CPU (which the
CPU tests use).

The SPMD contract: every rank calls every method in the same order with
parts of the same shapes, so every argument that can raise is checked
before the first collective, on every rank alike.

The LM mesh (``LMMesh``) trains through its exchanges.  In one process
they are the list functions above, so autograd runs through them as
through any torch op.  Over a process group the collectives record no
graph, and each exchange that a graph runs through is an
``autograd.Function`` with its conjugate: the gradient of a train loss
that is the sum of every shard's part (each shard's tokens counted once,
``models.transformer.mesh_loss_fn``) is, for ``all_gather``, the
gradients of every consumer of the gathered tensor summed over the line
and cut back to each part (a reduce-scatter, here an ``all_reduce`` and a
slice: gloo has no reduce-scatter); for ``psum``, the consumers'
gradients summed over the line, given to each part; for ``all_to_all``,
the reverse ``all_to_all``.  Every rank runs the same graph, so the
backward runs the collectives in one order on every rank.
"""
from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import MeshShape


# ---------------------------------------------------------------------------
# The one-process exchanges
# ---------------------------------------------------------------------------

def all_gather(parts: list[torch.Tensor]) -> torch.Tensor:
    """``lax.all_gather(tiled=True)`` over dim 0: the shards' parts in
    shard order."""
    return torch.cat(parts, 0)


def all_to_all(sends: list[torch.Tensor]) -> list[torch.Tensor]:
    """``lax.all_to_all(split_axis=0, concat_axis=0, tiled=True)``:
    ``sends[src]`` is [S_dst, cap, ...]; receiver ``dst`` gets
    [S_src, cap, ...] with row ``src`` = ``sends[src][dst]``."""
    return [torch.stack([s[dst] for s in sends]) for dst in range(len(sends))]


def psum(parts: list[torch.Tensor]) -> torch.Tensor:
    """``lax.psum``: the shards' values summed."""
    return torch.stack(parts).sum(0, dtype=parts[0].dtype)


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

# callables ``(mesh, op, parts)`` told of every exchange before it runs, with
# this rank's parts (the roofline's walker, ``roofline.op_cost``, prices it)
observers: list = []


def observe(mesh, op: str, parts) -> None:
    for fn in observers:
        fn(mesh, op, parts)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A tensor as it travels: contiguous, bool as uint8."""
    return (t.to(torch.uint8) if t.dtype == torch.bool else t).contiguous()


def _unwire(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.to(torch.bool) if dtype == torch.bool else t


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """S shards over ``world`` ranks; this process is ``rank`` and holds
    shards ``local``.  ``group`` is the process group, or None in one
    process.  ``device`` is where this rank's tensors live; a one-process
    mesh made by ``make_tile_step(n_shards, ...)`` has None and follows its
    tensors."""

    n_shards: int
    group: object = None
    rank: int = 0
    world: int = 1
    device: torch.device | None = None

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        if self.n_shards % self.world != 0:
            raise ValueError(f"{self.n_shards} shards do not divide over {self.world} ranks")
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} outside a world of {self.world}")

    @property
    def n_local(self) -> int:
        """L = S / W, the shards each rank holds."""
        return self.n_shards // self.world

    @property
    def local(self) -> range:
        """The global ids of this rank's shards, ``[rank*L, (rank+1)*L)``."""
        return range(self.rank * self.n_local, (self.rank + 1) * self.n_local)

    # ---------------------------------------------------------- exchanges --
    def all_gather(self, local_parts: list[torch.Tensor]) -> torch.Tensor:
        """Every shard's parts in shard order, on every rank.  Each rank's
        parts together have one shape on every rank."""
        observe(self, "all_gather", local_parts)
        mine = all_gather(local_parts)
        if self.group is None:
            return mine
        w = _wire(mine)
        out = [torch.empty_like(w) for _ in range(self.world)]
        dist.all_gather(out, w, group=self.group)
        return _unwire(torch.cat(out, 0), mine.dtype)

    def all_to_all(self, local_sends: list[torch.Tensor]) -> list[torch.Tensor]:
        """Local sender ``j``'s [S_dst, cap, ...] buffer out; each local
        receiver's [S_src, cap, ...] back, row ``src`` being what shard
        ``src`` sent it."""
        observe(self, "all_to_all", local_sends)
        if self.group is None:
            return all_to_all(local_sends)
        w, ln = self.world, self.n_local
        dtype = local_sends[0].dtype
        tail = tuple(local_sends[0].shape[1:])            # (cap, ...)
        # [L_src, S_dst, cap, ...] -> [W_dst, L_src, L_dst, cap, ...]
        packed = torch.stack([_wire(s) for s in local_sends])
        packed = packed.reshape((ln, w, ln) + tail).transpose(0, 1).contiguous()
        out = torch.empty_like(packed)                    # [W_src, L_src, L_dst, ...]
        dist.all_to_all_single(out, packed, group=self.group)
        del packed
        return [_unwire(out[:, :, j].reshape((self.n_shards,) + tail).contiguous(), dtype)
                for j in range(ln)]

    def psum(self, local_parts: list[torch.Tensor]) -> torch.Tensor:
        """The shards' values summed, on every rank."""
        observe(self, "psum", local_parts)
        total = psum(local_parts)
        if self.group is not None:
            total = total.contiguous()
            dist.all_reduce(total, group=self.group)
        return total

    def broadcast(self, obj):
        """Rank 0's ``obj`` on every rank: a tensor (every rank passes one of
        the same shape and dtype on its device and gets rank 0's values
        back) or any picklable object (the other ranks pass a placeholder).
        One ``torch.distributed`` call over the group; in one process
        ``obj`` itself."""
        if self.group is None:
            return obj
        if isinstance(obj, torch.Tensor):
            w = _wire(obj)
            dist.broadcast(w, src=0, group=self.group)
            return _unwire(w, obj.dtype)
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.group, device=self.device)
        return box[0]

    def exchange(self, per_local: list[list[torch.Tensor]]) -> list[list[torch.Tensor]]:
        """``all_to_all`` of each payload of the local senders' payload
        lists (one collective a payload); a payload list for each local
        receiver."""
        cols = [self.all_to_all([pay[i] for pay in per_local]) for i in range(len(per_local[0]))]
        return [[col[j] for col in cols] for j in range(len(per_local))]

    def close(self) -> None:
        """Destroy the process group (no-op in one process)."""
        if self.group is not None:
            dist.destroy_process_group(self.group)


def make_local_mesh(n_shards: int, device=None) -> ShardMesh:
    """All ``n_shards`` shards in this process on ``device`` (default: the
    card, raising without one)."""
    return ShardMesh(int(n_shards), device=resolve_device(device))


def backend_for(device: torch.device) -> str:
    """The collective backend a device's tensors need: NCCL for the card,
    gloo for the CPU."""
    if device.type == "cuda":
        return "nccl"
    if device.type == "cpu":
        return "gloo"
    raise ValueError(f"no collective backend for device {device}")


def _env_int(name: str, given: int | None) -> int:
    if given is not None:
        return int(given)
    if name not in os.environ:
        raise ValueError(f"{name} is not set: run under torchrun or pass rank= and world=")
    return int(os.environ[name])


def init_mesh(n_shards: int, device=None, *, store=None, rank: int | None = None,
              world: int | None = None, timeout_s: float = 60.0) -> ShardMesh:
    """Join a process group of ``world`` ranks and return this rank's mesh.

    ``rank`` and ``world`` default to torchrun's ``RANK`` and
    ``WORLD_SIZE``.  The rendezvous is ``store`` (e.g. a
    ``torch.distributed.FileStore``) or, without one, torchrun's
    ``MASTER_ADDR`` / ``MASTER_PORT``.  ``device`` defaults to the card
    ``cuda:LOCAL_RANK`` (``LOCAL_RANK`` defaulting to ``rank``) and raises
    without one; ``device="cpu"`` runs gloo.  Collectives time out after
    ``timeout_s``.  ``ValueError`` when the shards do not divide over the
    ranks; both checks come before the group is joined, so every rank
    raises alike and none waits for the others."""
    rank, world = _env_int("RANK", rank), _env_int("WORLD_SIZE", world)
    if n_shards % world != 0:
        raise ValueError(f"{n_shards} shards do not divide over {world} ranks")
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', rank))}"
    dev = resolve_device(device)
    backend = backend_for(dev)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    kw = dict(store=store) if store is not None else dict(init_method="env://")
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return ShardMesh(int(n_shards), group=dist.group.WORLD, rank=rank, world=world,
                     device=dev)


# ---------------------------------------------------------------------------
# Exchanges over a process group that autograd runs through
# ---------------------------------------------------------------------------

def _recording(line) -> bool:
    return torch.is_grad_enabled() and any(p.requires_grad for p in line)


def _all_reduce(t: torch.Tensor, sm: ShardMesh) -> torch.Tensor:
    t = t.contiguous().clone()
    dist.all_reduce(t, group=sm.group)
    return t


class _Gather(torch.autograd.Function):
    """``all_gather`` of a line's local parts along ``dim``; backward: the
    gathered tensor's gradient summed over the line's ranks, each local
    part's slice."""

    @staticmethod
    def forward(ctx, sm: ShardMesh, dim: int, *line):
        ctx.sm, ctx.dim, ctx.size = sm, dim, line[0].shape[dim]
        return sm.all_gather([p.movedim(dim, 0) for p in line]).movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        total = _all_reduce(grad, ctx.sm)
        return (None, None) + tuple(total.narrow(ctx.dim, i * ctx.size, ctx.size)
                                    for i in ctx.sm.local)


class _Psum(torch.autograd.Function):
    """``psum`` of a line's local parts; backward: the result's gradient
    summed over the line's ranks, given to every local part."""

    @staticmethod
    def forward(ctx, sm: ShardMesh, *line):
        ctx.sm, ctx.n = sm, len(line)
        return sm.psum(list(line))

    @staticmethod
    def backward(ctx, grad):
        total = _all_reduce(grad, ctx.sm)
        return (None,) + (total,) * ctx.n


class _AllToAll(torch.autograd.Function):
    """``all_to_all`` of a line's local sends; backward: the reverse
    ``all_to_all`` of the receivers' gradients (the exchange is its own
    transpose)."""

    @staticmethod
    def forward(ctx, sm: ShardMesh, *sends):
        ctx.sm = sm
        return tuple(sm.all_to_all(list(sends)))

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + tuple(ctx.sm.all_to_all([g.contiguous() for g in grads]))


# ---------------------------------------------------------------------------
# The LM mesh: ("data", "model")
# ---------------------------------------------------------------------------

LM_AXES = ("data", "model")


class LMMesh:
    """The reference's ("data", "model") mesh (``make_local_mesh(model_parallel)``
    there) for LM serving: ``data x model`` shards, shard (d, m) at index
    ``d * model + m``, over ``world`` ranks, each holding the contiguous
    block ``local`` of ``data * model / world`` shards (one process: all of
    them).  Each exchange runs along one axis: the shards that differ only
    in that axis's coordinate form a line, and each line is a ``ShardMesh``
    (its group: None where the line lies in this process, unless the whole
    world is one rank of a group; else the line's ranks), so the packing, the
    SPMD contract and the ``observers`` are ``ShardMesh``'s.  A layout is
    accepted where the shards a rank holds are whole rows of ``model`` or a
    part of one row (``n_local`` divides ``model`` or ``model`` divides it).

    The exchanges take and return one tensor a local shard, in the order of
    ``local``; in one process the shards of a line share the result of a
    gather or a sum (one tensor, not copies), so autograd sums the
    gradients of the line's consumers there, as the process group's
    conjugates (``_Gather``, ``_Psum``) sum them over the ranks."""

    def __init__(self, data: int, model: int, *, group=None, rank: int = 0, world: int = 1,
                 device=None, line_groups: dict | None = None):
        check_lm_layout(data, model, world)
        n = data * model
        ln = n // world
        self.data, self.model = int(data), int(model)
        self.group, self.rank, self.world = group, int(rank), int(world)
        self.device = device
        self.shape = MeshShape(LM_AXES, (self.data, self.model))
        self.n_shards, self.n_local = n, ln
        self.local = [dict(data=s // model, model=s % model)
                      for s in range(rank * ln, (rank + 1) * ln)]
        groups = line_groups or {}
        self._lines = {}
        for axis in LM_AXES:
            lines = {}
            for j, c in enumerate(self.local):
                key = c["model" if axis == "data" else "data"]
                lines.setdefault(key, []).append(j)
            meshes = {}
            for key in lines:
                ranks = line_ranks(axis, key, self.data, self.model, self.world)
                if group is not None and len(ranks) == world:
                    g = group
                elif len(ranks) == 1:
                    g = None
                else:
                    g = groups[(axis, tuple(ranks))]
                size = self.shape.shape[axis]
                meshes[key] = ShardMesh(size, group=g, rank=ranks.index(rank) if g else 0,
                                        world=len(ranks) if g else 1, device=device)
            self._lines[axis] = [(meshes[k], idxs) for k, idxs in sorted(lines.items())]

    def __repr__(self) -> str:
        return (f"LMMesh(data={self.data}, model={self.model}, rank={self.rank}, "
                f"world={self.world}, group={self.group is not None}, device={self.device})")

    # ---------------------------------------------------------- exchanges --
    def _each_line(self, axis: str, parts: list, fn) -> list:
        """``fn(line_mesh, line_parts)`` for each line of ``axis`` this
        process holds, its result given to each of the line's shards; lines
        with the very same parts share one result."""
        if len(parts) != self.n_local:
            raise ValueError(f"{len(parts)} parts for {self.n_local} local shards")
        out, memo = [None] * len(parts), {}
        for sm, idxs in self._lines[axis]:
            line = [parts[j] for j in idxs]
            ident = tuple(id(p) for p in line)
            if ident not in memo:
                memo[ident] = fn(sm, line)
            for j in idxs:
                out[j] = memo[ident]
        return out

    def all_gather(self, parts: list, axis: str, dim: int = 0) -> list:
        """Each shard's part concatenated along ``dim`` in the order of the
        ``axis`` coordinate, over the shards of its line."""
        def gather(sm, line):
            if sm.n_shards == 1:
                return line[0]
            if sm.group is None:
                observe(sm, "all_gather", line)
                return torch.cat(line, dim)
            if _recording(line):
                return _Gather.apply(sm, dim, *line)
            return sm.all_gather([p.movedim(dim, 0) for p in line]).movedim(0, dim).contiguous()
        return self._each_line(axis, parts, gather)

    def psum(self, parts: list, axis: str) -> list:
        """The parts summed over each shard's line of ``axis``."""
        def line_sum(sm, line):
            if sm.n_shards == 1:
                return line[0]
            if sm.group is not None and _recording(line):
                return _Psum.apply(sm, *line)
            return sm.psum(line)
        return self._each_line(axis, parts, line_sum)

    def psum_distinct(self, parts: list, axis: str) -> list:
        """``psum`` where a tensor that several shards of a line share (one
        object) counts once: a gradient that autograd has already summed
        over the local shards sharing its parameter.  No graph."""
        def line_sum(sm, line):
            if sm.n_shards == 1:
                return line[0]
            uniq = list({id(p): p for p in line}.values())
            return psum(uniq) if sm.group is None else sm.psum(uniq)
        return self._each_line(axis, parts, line_sum)

    def total(self, value: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of a value each rank holds (itself in one
        process).  No graph."""
        if self.group is None:
            return value
        out = value.detach().contiguous().clone()
        dist.all_reduce(out, group=self.group)
        return out

    def all_to_all(self, sends: list, axis: str = "model") -> list:
        """Each shard's [n_axis, cap, ...] buffer out along ``axis``; each
        gets [n_axis, cap, ...] back, row ``i`` what the line's shard ``i``
        sent it (``lax.all_to_all(split_axis=0, concat_axis=0,
        tiled=True)``)."""
        if len(sends) != self.n_local:
            raise ValueError(f"{len(sends)} sends for {self.n_local} local shards")
        out = [None] * len(sends)
        for sm, idxs in self._lines[axis]:
            got = [sends[j] for j in idxs]
            if sm.n_shards > 1 and sm.group is not None and _recording(got):
                got = list(_AllToAll.apply(sm, *got))
            elif sm.n_shards > 1:
                got = sm.all_to_all(got)
            for j, g in zip(idxs, got):
                out[j] = g
        return out

    def pmean(self, parts: list) -> list:
        """The mean over every shard of the mesh (``lax.pmean`` over all
        axes)."""
        total = self.psum(self.psum(parts, "model"), "data")
        return [t / self.n_shards for t in total]

    def close(self) -> None:
        """Destroy the process group (no-op in one process)."""
        if self.group is not None:
            dist.destroy_process_group()


def check_lm_layout(data: int, model: int, world: int) -> None:
    """``ValueError`` unless ``data x model`` shards lay out over ``world``
    ranks as ``LMMesh`` takes them."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data}, model={model}")
    if (data * model) % world:
        raise ValueError(f"{data} x {model} shards do not divide over {world} ranks")
    ln = data * model // world
    if model % ln and ln % model:
        raise ValueError(f"{ln} shards a rank neither divide model={model} nor are whole "
                         "rows of it")


def line_ranks(axis: str, key: int, data: int, model: int, world: int) -> list[int]:
    """The ranks holding the line of ``axis`` at the other axis's
    coordinate ``key``, in order."""
    ln = data * model // world
    if axis == "model":
        shards = [key * model + m for m in range(model)]
    else:
        shards = [d * model + key for d in range(data)]
    return sorted({s // ln for s in shards})


def make_lm_mesh(model_parallel: int, data: int = 1, device=None) -> LMMesh:
    """All ``data x model_parallel`` shards in this process on ``device``
    (default: the card, raising without one): the one-card counterpart of
    the reference's ``make_local_mesh(model_parallel)``."""
    return LMMesh(int(data), int(model_parallel), device=resolve_device(device))


def init_lm_mesh(model_parallel: int, data: int = 1, device=None, *, store=None,
                 rank: int | None = None, world: int | None = None,
                 timeout_s: float = 60.0) -> LMMesh:
    """Join a process group of ``world`` ranks (as ``init_mesh``: torchrun's
    env by default, NCCL on the card, gloo on the CPU) and return this
    rank's part of a ``data x model_parallel`` LM mesh, with one subgroup
    for each line of an axis that spans some but not all ranks (every rank
    creates every subgroup, in one order).  The layout is checked before
    the group is joined, so every rank raises alike."""
    rank, world = _env_int("RANK", rank), _env_int("WORLD_SIZE", world)
    check_lm_layout(data, model_parallel, world)
    sm = init_mesh(data * model_parallel, device, store=store, rank=rank, world=world,
                   timeout_s=timeout_s)
    groups = {}
    for axis, n_keys in (("model", data), ("data", model_parallel)):
        for key in range(n_keys):
            ranks = tuple(line_ranks(axis, key, data, model_parallel, world))
            if 1 < len(ranks) < world and (axis, ranks) not in groups:
                groups[(axis, ranks)] = dist.new_group(list(ranks))
    return LMMesh(data, model_parallel, group=sm.group, rank=rank, world=world,
                  device=sm.device, line_groups=groups)
