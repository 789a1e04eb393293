"""The port's LM serving path (``repro_torch.launch.serve.Server``, its CLI,
``examples/torch_rag_serve.py``) against the JAX package on the CPU.

The reference's ``Server`` cannot be built on this container's JAX (its
mesh-sharded ``jit`` raises), so the port is held against the loop of
``Server.generate`` rebuilt from ``repro.models.model_zoo.build(...)``'s
jitted ``prefill`` and ``decode_step``: greedy tokens identical, with the
reference's parameters carried across by ``convert.lm_from_arrays``.
The RAG example retrieves the ids and generates the tokens of
``examples/rag_serve.py`` itself, run with the reference ``Retriever``
(both packages built with the same dyadic hyperplanes) and a ``Server``
that is the reference loop.
"""
import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.core import sketch as jsketch
from repro.launch.serve import Retriever as JRetriever
from repro.models import model_zoo as j_zoo
from repro_torch.convert import lm_from_arrays
from repro_torch.core import sketch as tsketch
from repro_torch.data import dyadic_hyperplanes
from repro_torch.launch import serve

CPU = "cpu"
EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _reference(arch_id: str, seed: int = 0):
    """The reference's smoke model of ``arch_id`` and its parameters."""
    arch = j_get_config(arch_id)
    model = j_zoo.build(arch.smoke_model, arch.family)
    return arch, model, model.init(jax.random.PRNGKey(seed))


def _reference_generate(arch, model, params, prompts, max_new: int, max_len: int):
    """``repro.launch.serve.Server.generate``'s greedy loop, without its mesh."""
    b, t = prompts.shape
    batch = {"tokens": jnp.asarray(prompts)}
    if arch.family == "vlm":
        batch["positions"] = jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32)[None, None],
                                              (3, b, t))
    logits, cache = jax.jit(lambda p, bt: model.prefill(p, bt, max_len))(params, batch)
    decode = jax.jit(model.decode_step)
    out = np.zeros((b, max_new), np.int32)
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    for i in range(max_new):
        out[:, i] = np.asarray(tok)[:, 0]
        logits, cache = decode(params, tok, cache)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    return out


def _server_with(params, arch_id: str, max_len: int) -> serve.Server:
    """A CPU ``Server`` of ``arch_id``'s smoke model holding the reference's
    ``params``."""
    server = serve.Server(arch_id, smoke=True, max_len=max_len, device=CPU)
    server.params = lm_from_arrays(jax.tree.map(np.asarray, params), device=CPU)
    return server


@pytest.mark.parametrize("arch_id", ["qwen2-7b", "granite-moe-1b-a400m", "qwen2-vl-7b"])
def test_server_greedy_tokens_equal_reference_loop(arch_id):
    arch, model, params = _reference(arch_id, seed=5)
    prompts = np.random.default_rng(5).integers(0, arch.smoke_model.vocab, (3, 11)) \
        .astype(np.int32)
    server = _server_with(params, arch_id, max_len=11 + 10)
    toks, stats = server.generate(prompts, 10)
    want = _reference_generate(arch, model, params, prompts, 10, 21)
    assert toks.dtype == np.int32
    np.testing.assert_array_equal(toks, want)
    assert stats["prefill_s"] > 0 and stats["decode_s"] > 0
    assert stats["decode_tok_per_s"] == pytest.approx(3 * 10 / stats["decode_s"])


def test_server_batch_sampling_and_limits():
    server = serve.Server("qwen2-vl-7b", max_len=12, seed=1, device=CPU)
    batch = server.make_batch(np.zeros((2, 5), np.int32))
    assert tuple(batch["positions"].shape) == (3, 2, 5)
    assert (batch["positions"] == torch.arange(5)).all()
    prompts = np.arange(10, dtype=np.int32).reshape(2, 5)
    a, _ = server.generate(prompts, 6, temperature=0.8, seed=3)
    b, _ = server.generate(prompts, 6, temperature=0.8, seed=3)
    np.testing.assert_array_equal(a, b)
    assert ((a >= 0) & (a < server.vocab)).all()
    with pytest.raises(IndexError):   # prompt + continuation beyond max_len
        server.generate(prompts, 8)
    # the ssm family builds and serves, on one shard and on a mesh alike
    toks, _ = serve.Server("mamba2-130m", max_len=12, device=CPU).generate(prompts, 6)
    assert toks.shape == (2, 6) and ((toks >= 0) & (toks < 256)).all()
    toks_m, _ = serve.Server("mamba2-130m", model_parallel=2, max_len=12,
                             device=CPU).generate(prompts, 6)
    np.testing.assert_array_equal(toks_m, toks)


def test_cli_main_serves_on_the_cpu(capsys):
    rc = serve.main(["--arch", "granite-moe-1b-a400m", "--requests", "5", "--batch", "2",
                     "--prompt-len", "6", "--max-new", "4", "--device", CPU])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.count("batch ") == 3 and "decode" in out
    assert "served 5 requests in 3 batches" in out


def _example(name: str):
    spec = importlib.util.spec_from_file_location(f"_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rag_example_against_reference(arch_id: str, capsys):
    corpus_n, requests = 2048, 6
    mod, ref = _example("torch_rag_serve"), _example("rag_serve")
    arch, model, params = _reference(arch_id)
    hp = dyadic_hyperplanes(3, 12, mod._retrieval().DIM)
    want = {"ids": [], "tokens": []}

    class RefRetriever(JRetriever):
        def retrieve(self, q_emb, **kw):
            hits = super().retrieve(q_emb, **kw)
            want["ids"].append(np.asarray(hits))
            return hits

    class RefServer:
        """``repro.launch.serve.Server``'s interface over the reference loop."""

        def __init__(self, arch_id_, *, smoke, max_len):
            assert arch_id_ == arch_id and smoke
            self.vocab, self.max_len = arch.smoke_model.vocab, max_len

        def generate(self, prompts, max_new):
            toks = _reference_generate(arch, model, params, prompts, max_new, self.max_len)
            want["tokens"].append(toks)
            return toks, {"prefill_s": 0.0, "decode_tok_per_s": 0.0}

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jsketch, "make_hyperplanes",
                   lambda key, m, d, dtype=jnp.float32: jnp.asarray(hp))
        mp.setattr(tsketch, "make_hyperplanes", lambda seed, m, d: hp)
        mp.setattr(mod, "Server", lambda arch_id_, *, smoke, max_len, device:
                   _server_with(params, arch_id_, max_len))
        got = mod.main(["--corpus", str(corpus_n), "--requests", str(requests),
                        "--arch", arch_id, "--device", CPU])
        mp.setattr(ref, "Retriever", RefRetriever)
        mp.setattr(ref, "Server", RefServer)
        mp.setattr(sys, "argv", ["rag_serve.py", "--corpus", str(corpus_n),
                                 "--requests", str(requests), "--arch", arch_id])
        ref.main()
    finally:
        mp.undo()
    assert [len(t) for t in want["tokens"]] == [4, 2]
    np.testing.assert_array_equal(got["ids"], np.concatenate(want["ids"]))
    np.testing.assert_array_equal(got["tokens"], np.concatenate(want["tokens"]))
    assert capsys.readouterr().out.count("[done] 6 RAG requests") == 2


def test_rag_example_equals_reference(capsys):
    """``examples/rag_serve.py`` itself (its defaults, ``--corpus 2048``, 6
    requests in batches of 4 and 2), its ``Retriever`` the reference's with
    each batch's ids recorded and its ``Server`` the reference loop over the
    reference's smoke model, against ``examples/torch_rag_serve.py`` with
    the same parameters: the same ids and the same tokens."""
    _rag_example_against_reference("qwen2-7b", capsys)


def test_rag_example_equals_reference_ssm(capsys):
    """The same with ``--arch mamba2-130m``: the RAG loop in front of the
    SSM."""
    _rag_example_against_reference("mamba2-130m", capsys)
