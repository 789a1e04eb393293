"""The port's checkpointer (``repro_torch.checkpoint.Checkpointer``) and
``fault_tolerance.resume_or_init`` on the CPU, against the reference's
on-disk contract and behaviour (``repro/checkpoint/checkpointer.py``,
``repro/distributed/fault_tolerance.py``): ``step_<n>/`` directories of one
``.npy`` a leaf and a ``manifest.json``, written through ``.tmp`` and a
``COMMIT`` marker; uncommitted directories ignored; ``keep``; a write
error surfacing at the next ``save``.  Round trips are held bit for bit,
bfloat16 included."""
import json
import os

import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.distributed import fault_tolerance as jft
from repro_torch.checkpoint import Checkpointer
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.launch.steps import TrainState
from repro_torch.optim import adamw
from repro_torch.tree import tree_flatten, tree_leaves, tree_map


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: under six test workers the default (one a core)
    oversubscribes the cores on these small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _tree(seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    params = {"embed": {"table": torch.randn((8, 4), generator=g)},
              "blocks": [{"w": torch.randn((4, 4), generator=g).to(torch.bfloat16),
                          "b": torch.randn((4,), generator=g)} for _ in range(2)]}
    opt = adamw.init(adamw.AdamWConfig(moment_dtype=torch.bfloat16), params)
    opt = opt._replace(step=torch.tensor(7, dtype=torch.int32),
                       m=tree_map(lambda t: torch.randn(t.shape, generator=g).to(t.dtype), opt.m))
    return TrainState(params=params, opt=opt)


def _bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and np.array_equal(_bits(x), _bits(y)) for x, y in zip(la, lb))


def test_round_trip_is_bit_exact_bfloat16_included(tmp_path):
    state = _tree()
    ck = Checkpointer(str(tmp_path))
    ck.save(3, state, extra={"step": 3, "note": "x"})
    # training goes on writing the tensors: the snapshot was taken at save
    saved = tree_map(lambda t: t.clone(), state)
    for t in tree_leaves(state):
        t.zero_()
    ck.wait()
    out, extra = ck.restore(3, saved)
    ck.close()
    assert extra == {"step": 3, "note": "x"}
    assert _equal(out, saved)
    assert out.opt.m["blocks"][0]["w"].dtype == torch.bfloat16
    path = tmp_path / "step_00000003"
    manifest = json.loads((path / "manifest.json").read_text())
    names = tree_flatten(saved)[0]
    assert sorted(manifest["leaves"]) == sorted(names)
    assert manifest["leaves"]["params_blocks_1_w"] == {"shape": [4, 4], "dtype": "bfloat16"}
    assert manifest["leaves"]["opt_step"] == {"shape": [], "dtype": "int32"}
    assert (path / "COMMIT").exists() and not (tmp_path / "step_00000003.tmp").exists()
    assert {p.name for p in path.glob("*.npy")} == {n + ".npy" for n in names}


def test_restore_places_on_like_device_and_checks_shapes(tmp_path):
    state = _tree()
    ck = Checkpointer(str(tmp_path))
    ck.save(1, state, blocking=True)
    like = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), state)
    out, _ = ck.restore(1, like, device="cpu")
    assert _equal(out, state) and all(t.device.type == "cpu" for t in tree_leaves(out))
    bad = state._replace(params={**state.params, "embed": {"table": torch.zeros((8, 5))}})
    with pytest.raises(ValueError, match="params_embed_table"):
        ck.restore(1, bad)
    with pytest.raises(FileNotFoundError):
        ck.restore(2, state)
    ck.close()


def test_reference_reads_the_port_checkpoint_and_back(tmp_path):
    """The same layout: a dict tree of float32 / int32 leaves written by
    one package restores in the other, leaf names and all."""
    tree = {"embed": {"table": np.arange(12, dtype=np.float32).reshape(3, 4)},
            "blocks": [{"w": np.full((2, 2), i, np.float32)} for i in range(2)],
            "step": np.array(5, np.int32)}
    ck = Checkpointer(str(tmp_path / "port"))
    ck.save(2, tree_map(torch.from_numpy, tree), extra={"step": 2}, blocking=True)
    ck.close()
    jtree, extra = JCheckpointer(str(tmp_path / "port")).restore(2, tree)
    assert extra == {"step": 2}
    # (the reference's tree comes back with its dict keys sorted)
    got = dict(zip(*tree_flatten(jtree)))
    for name, b in zip(*tree_flatten(tree)):
        np.testing.assert_array_equal(np.asarray(got[name]), b)
    jck = JCheckpointer(str(tmp_path / "ref"))
    jck.save(4, tree, extra={"step": 4}, blocking=True)
    jck.close()
    out, extra = Checkpointer(str(tmp_path / "ref")).restore(4, tree_map(torch.from_numpy, tree))
    assert extra == {"step": 4}
    for a, b in zip(tree_leaves(out), tree_leaves(tree)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_uncommitted_tmp_is_ignored_and_keep_prunes(tmp_path):
    state = {"w": torch.ones(3)}
    ck = Checkpointer(str(tmp_path), keep=2)
    jck = JCheckpointer(str(tmp_path / "ref"), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, state)
        jck.save(s, {"w": np.ones(3, np.float32)})
    ck.wait()
    jck.wait()
    # a crash mid-write leaves a .tmp directory (and a directory without
    # its marker); neither is a checkpoint
    for d in (tmp_path, tmp_path / "ref"):
        os.makedirs(d / "step_00000009.tmp")
        os.makedirs(d / "step_00000008")
    assert ck.committed_steps() == jck.committed_steps() == [3, 4]
    assert ck.latest_step() == jck.latest_step() == 4
    ck.close()
    jck.close()
    empty = Checkpointer(str(tmp_path / "empty"))
    assert empty.latest_step() is None and empty.committed_steps() == []
    empty.close()


def test_write_error_surfaces_at_next_save(tmp_path):
    ck = Checkpointer(str(tmp_path))
    # a leaf named with a "/" cannot be written beside the others: the
    # writer thread fails, and the caller hears of it at the next call
    ck.save(1, {"a/b": torch.ones(2)}, blocking=True)
    with pytest.raises(FileNotFoundError, match="a/b"):
        ck.save(2, {"w": torch.ones(2)})
    with pytest.raises(FileNotFoundError):
        ck.wait()
    assert ck.committed_steps() == []
    ck.close()


@pytest.mark.parametrize("saved", [False, True])
def test_resume_or_init_as_reference(tmp_path, saved):
    state = {"w": torch.arange(3, dtype=torch.float32)}
    ck, jck = Checkpointer(str(tmp_path / "p")), JCheckpointer(str(tmp_path / "j"))
    if saved:
        ck.save(6, state, extra={"step": 6}, blocking=True)
        jck.save(6, {"w": np.arange(3, dtype=np.float32)}, extra={"step": 6}, blocking=True)
    calls = []

    def init():
        calls.append("init")
        return {"w": torch.zeros(3)}

    got, start, extra = ft.resume_or_init(ck, init, lambda: {"w": torch.empty(3)})
    jgot, jstart, jextra = jft.resume_or_init(jck, lambda: {"w": np.zeros(3, np.float32)},
                                              lambda: {"w": np.empty(3, np.float32)})
    assert (start, extra) == (jstart, jextra) == ((6, {"step": 6}) if saved else (0, {}))
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(jgot["w"]))
    assert calls == ([] if saved else ["init"])
    ck.close()
    jck.close()


def test_many_saves_through_the_bounded_queue(tmp_path):
    """Saves faster than the writer drains them (queue of 2, thread
    switches forced often): every save lands whole, in order, and ``keep``
    leaves the newest three."""
    import sys

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ck = Checkpointer(str(tmp_path), keep=3)
        t = torch.zeros(64, 64)
        for step in range(1, 25):
            t.fill_(step)           # training writes the tensor again at once
            ck.save(step, {"w": t}, extra={"step": step})
        ck.wait()
        ck.close()
    finally:
        sys.setswitchinterval(interval)
    ck._worker.join(timeout=10)
    assert not ck._worker.is_alive()
    assert ck.committed_steps() == [22, 23, 24]
    for step in (22, 23, 24):
        out, extra = ck.restore(step, {"w": t})
        assert extra == {"step": step} and bool((out["w"] == step).all())
