"""Boundaries of the port: it (its package, ``chip_smoke.py`` and its
examples ``examples/torch_*.py``) imports neither JAX nor the JAX package,
builds nothing at import, defaults to the card and raises without one,
and ``chip_smoke.py`` refuses to report a result anywhere but on a card
with the repository beside it."""
import ast
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
                         + sorted((ROOT / "examples").glob("torch_*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "flax", "optax"}
    assert not bad, f"{path.name} imports {sorted(bad)}"


def test_import_builds_nothing():
    code = ("import repro_torch, repro_torch.convert, repro_torch.data, sys\n"
            "from repro_torch.kernels import _build\n"
            "assert _build._lib is None\n"
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})


def test_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    import repro_torch
    from repro_torch.convert import index_from_arrays
    from repro_torch.core.serving import ServingIndex

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((16, 4), np.float32)
    graph = np.full((16, 2), -1, np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.build(x)
    with pytest.raises(RuntimeError):
        ServingIndex.from_graph(graph, x, 0)
    with pytest.raises(RuntimeError):
        index_from_arrays(graph, np.zeros((16, 2), np.float32), 0)
    idx = index_from_arrays(graph, np.zeros((16, 2), np.float32), 0, device="cpu")
    with pytest.raises(RuntimeError):
        repro_torch.search(idx, x, x[:2])
    # the sharded packing and the retriever, by every route
    from repro_torch.distributed.serving import ShardedServingIndex
    from repro_torch.launch.serve import Retriever

    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardedServingIndex.from_graph(graph, x, 0, n_shards=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingIndex.from_graph(graph, x, 0, n_shards=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.search(idx, x, x[:2], n_shards=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Retriever(x, idx)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Retriever(x)
    # the empty reservoir
    from repro_torch.core.hashprune import reservoir_init

    with pytest.raises(RuntimeError, match="device='cpu'"):
        reservoir_init(16, 4)
    assert reservoir_init(16, 4, device="cpu").ids.device.type == "cpu"
    # the kernel-contract pass of the lint
    from repro_torch.analysis import contracts

    with pytest.raises(RuntimeError, match="device='cpu'"):
        contracts.check_kernel_contracts()
    assert contracts.check_kernel_contracts(device="cpu") == []


def test_lm_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    """``Server``, ``models.transformer.init``, the serving CLI and the
    training CLI take the card unless given ``device=``/``--device``, and
    raise without one."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train
    from repro_torch.launch.serve import Server
    from repro_torch.models import transformer

    cfg = get_config("qwen2-7b").smoke_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Server("qwen2-7b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init(cfg, torch.Generator())
    assert Server("qwen2-7b", max_len=8, device="cpu").params["embed"]["table"].is_cpu
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "qwen2-7b", "--smoke", "--steps", "1"])
    assert train.run(["--arch", "qwen2-7b", "--smoke", "--steps", "1", "--batch", "2",
                      "--seq", "8", "--device", "cpu"])["losses"]
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen2-7b",
                        "--requests", "1"], cwd=ROOT, capture_output=True, text=True,
                       env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
                            "CUDA_VISIBLE_DEVICES": ""}, timeout=120)
    assert p.returncode != 0 and "device='cpu'" in p.stderr


def test_full_precision_matmul_is_pinned():
    from repro_torch.device import resolve_device

    resolve_device("cpu")
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_cpu_tensors_take_the_plain_versions():
    from repro_torch.kernels import gather_distance, leaf_knn

    x = torch.zeros((8, 4))
    ids = torch.zeros((2, 3), dtype=torch.int32)
    before = gather_distance.launches
    out = gather_distance.gather_distance(x, torch.zeros(8), x[:2], ids)
    assert out.shape == (2, 3) and gather_distance.launches == before
    with pytest.raises(ValueError):
        leaf_knn.leaf_topk(x, torch.zeros((1, 8), dtype=torch.int32), 2, metric="hamming")


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without CUDA, and alone in a directory, the script exits non-zero and
    prints no result line."""
    runs = [(ROOT, ["chip_smoke.py"])]
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    runs.append((tmp_path, ["chip_smoke.py"]))
    for cwd, args in runs:
        p = subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True,
                           text=True, timeout=120)
        assert p.returncode != 0
        assert '"ok"' not in p.stdout
