"""Asynchronous checkpoints with atomic commits (counterpart of
``repro/checkpoint/checkpointer.py``; the same on-disk contract).

Layout: ``<dir>/step_<n:08d>/``, one ``.npy`` per tree leaf (named by its
path, ``tree.tree_flatten``) and ``manifest.json`` (step, each leaf's
shape and dtype, the caller's ``extra``).  ``save`` snapshots every leaf
to host memory at once, so training may go on writing its tensors, and a
background thread writes the snapshot from a bounded queue; a write error
surfaces at the next ``save`` (or ``wait``).  A checkpoint is written to
``step_<n>.tmp``, ends with a ``COMMIT`` marker, and is renamed into place,
so a failure mid-write never leaves a directory ``restore`` would read.
The newest ``keep`` committed checkpoints are kept.

numpy has no bfloat16: a bfloat16 leaf is stored bit for bit as uint16
and its manifest entry says ``bfloat16``.  ``restore`` places each leaf on
its ``like`` leaf's device (or on ``device``), or hands it to the
reference's ``shard_fn`` (``distributed.elastic.restore_to_mesh`` cuts it
onto an LM mesh there).  A state on a mesh is saved as its logical arrays
under the one-card state's names (``sharding.logical_tree``), as the
reference's ``device_get`` of sharded arrays saves them: a checkpoint
taken on any mesh is the one-card checkpoint of the same state.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.distributed.sharding import logical_tree
from repro_torch.tree import tree_flatten, tree_unflatten

COMMIT = "COMMIT"
MANIFEST = "manifest.json"


def _to_host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host copy of ``t`` as numpy (bfloat16 as its uint16 bits) and the
    dtype's name."""
    t = t.detach().to("cpu", copy=True)
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._error: Exception | None = None
        self._worker = threading.Thread(target=self._drain, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------- write --
    def save(self, step: int, tree: Any, extra: dict | None = None,
             blocking: bool = False) -> None:
        """Snapshot ``tree`` to host memory now; write it to disk on the
        background thread (before returning with ``blocking``).  Each
        ``MeshParams`` in ``tree`` is saved logical (a gather: on a process
        group every rank makes it, ``sharding.logical_tree``)."""
        if self._error:
            raise self._error
        names, leaves = tree_flatten(logical_tree(tree))
        host = [_to_host(t) for t in leaves]
        self._q.put((step, names, host, extra or {}))
        if blocking:
            self._q.join()

    def _drain(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            try:
                self._write(*item)
            except Exception as e:  # noqa: BLE001 (surfaced at the next save)
                self._error = e
            finally:
                self._q.task_done()

    def _write(self, step: int, names, host, extra):
        path = os.path.join(self.dir, f"step_{step:08d}")
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra, "leaves": {}}
        for name, (arr, dtype) in zip(names, host):
            np.save(os.path.join(tmp, name + ".npy"), arr)
            manifest["leaves"][name] = {"shape": list(arr.shape), "dtype": dtype}
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, COMMIT), "w") as f:
            f.write("ok")
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
        self._gc()

    def _gc(self):
        for s in self.committed_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    def wait(self):
        """Block until every queued checkpoint is written; raise a write
        error."""
        self._q.join()
        if self._error:
            raise self._error

    def close(self):
        self._q.put(None)
        self._q.join()

    # -------------------------------------------------------------- read --
    def committed_steps(self) -> list[int]:
        out = []
        for d in sorted(os.listdir(self.dir)):
            full = os.path.join(self.dir, d)
            if d.startswith("step_") and not d.endswith(".tmp") \
                    and os.path.exists(os.path.join(full, COMMIT)):
                out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, shard_fn=None, device=None):
        """The checkpoint of ``step`` in the structure of ``like`` (a tree of
        tensors, or of anything with ``shape`` and ``dtype``): each leaf in
        its stored dtype on ``device`` (default: the ``like`` leaf's), or
        ``shard_fn(name, tensor)`` of the leaf as a host tensor where one is
        given (elastic restore).  A leaf whose shape or dtype differs from
        ``like``'s raises.  Returns (tree, extra)."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        if not os.path.exists(os.path.join(path, COMMIT)):
            raise FileNotFoundError(f"no committed checkpoint at {path}")
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
        names, leaves = tree_flatten(like)
        out = []
        for name, leaf in zip(names, leaves):
            dtype = manifest["leaves"][name]["dtype"]
            t = _from_host(np.load(os.path.join(path, name + ".npy")), dtype)
            if tuple(t.shape) != tuple(leaf.shape) or t.dtype != leaf.dtype:
                raise ValueError(f"leaf {name}: checkpoint {tuple(t.shape)} {t.dtype} != "
                                 f"{tuple(leaf.shape)} {leaf.dtype}")
            if shard_fn is not None:
                out.append(shard_fn(name, t))
            else:
                out.append(t.to(device if device is not None else leaf.device))
        return tree_unflatten(like, out), manifest["extra"]
