"""The port's examples (``examples/torch_*.py``) on the CPU at a small size,
each held to its own bar: the quickstart's recall@10 of at least 0.9, the
k-NN graph's ``recall >= 0.90`` assert, the retrieval's top-k ids at
float32 and int8, and the LM training's restart from its checkpoint.  The
modules they call are held against the reference elsewhere
(``test_torch_build.py``, ``test_torch_knn_graph_baselines.py``,
``test_torch_serve_loop.py``, ``test_torch_train.py``).  Without ``--device`` each example takes
the card and raises here."""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
SMALL = {"torch_quickstart": ["--n", "2048", "--queries", "64"],
         "torch_knn_graph": ["--n", "2048"],
         "torch_rag_retrieve": ["--corpus", "2048", "--requests", "6"],
         "torch_rag_serve": ["--corpus", "2048", "--requests", "6"],
         "torch_train_lm": ["--steps", "4", "--batch", "4", "--seq", "32"]}


def _example(name: str):
    spec = importlib.util.spec_from_file_location(f"_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_quickstart_reaches_its_recall(capsys):
    out = _example("torch_quickstart").main(SMALL["torch_quickstart"] + ["--device", "cpu"])
    assert out["n"] == 2048 and out["recall"] >= 0.9, out
    assert "10@10 recall" in capsys.readouterr().out


def test_knn_graph_meets_its_bar(capsys):
    mod = _example("torch_knn_graph")
    out = mod.main(SMALL["torch_knn_graph"] + ["--device", "cpu"])
    assert out["recall"] >= mod.RECALL_BAR, out
    assert 1 <= out["components"] < out["n"] and out["mutual_edges"] > 0
    assert "connected components" in capsys.readouterr().out


def test_mutual_components_by_hand():
    # 0 <-> 1 mutual, 2 -> 0 one way, 3 <-> 4 mutual: two pairs and a singleton
    knn = np.array([[1, -1], [0, 2], [0, -1], [4, -1], [3, -1]])
    assert _example("torch_knn_graph").mutual_components(knn) == (2, 3)


@pytest.mark.parametrize("ann_dtype", ["f32", "int8"])
def test_rag_retrieve_serves_every_request(ann_dtype, capsys):
    out = _example("torch_rag_retrieve").main(
        SMALL["torch_rag_retrieve"] + ["--ann-dtype", ann_dtype, "--device", "cpu"])
    ids = out["ids"]
    assert ids.shape == (6, 2) and ((ids >= 0) & (ids < 2048)).all()
    assert all(len(set(r.tolist())) == 2 for r in ids)
    assert out["device_bytes"] > 0 and out["requests_per_s"] > 0
    assert "[done] 6 requests" in capsys.readouterr().out


def test_train_lm_restarts_from_its_checkpoint(capsys):
    out = _example("torch_train_lm").main(SMALL["torch_train_lm"] + ["--device", "cpu"])
    first, second = out["first"], out["second"]
    assert len(first["losses"]) == 2 and second["start_step"] == 2
    assert len(second["losses"]) == 2
    text = capsys.readouterr().out
    assert "resumed from step 2" in text and "=== done" in text


@pytest.mark.parametrize("name", sorted(SMALL))
def test_examples_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        _example(name).main(SMALL[name])
