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
"""
from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


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
