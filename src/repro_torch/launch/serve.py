"""Batched LM serving and ANN retrieval for a serving stack (counterpart of
``repro/launch/serve.py``).

``Server`` holds an LM's parameters on the device (any of the ten
architectures: the transformer, SSM, hybrid and encoder-decoder families)
and serves request batches: one prefill a batch, then one decode step a
token for every sequence, with greedy or temperature sampling.  Its CLI serves a
queue of random requests in batches:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b --full

(``--device cpu`` on the CPU; without it the card, which must be present).

``Retriever`` wraps a PiPNN index and its corpus embeddings as a packed
``ServingIndex`` on the device, so each ``retrieve`` moves only the query
embeddings in and the ids out.  ``points_dtype`` picks the precision of the
corpus copy: "f32" (exact), "bf16" (half the footprint) or "int8" (the
scalar-quantized packing, about a quarter, with exact norm terms).
``n_shards`` serves through the sharded packing
(``distributed.serving.ShardedServingIndex``), all shards on one device;
``mesh`` (a ``launch.mesh.ShardMesh``) spreads it over the mesh's ranks,
each constructing the ``Retriever`` and calling ``retrieve`` alike.
``examples/torch_rag_serve.py`` puts the ``Retriever`` in front of the
``Server`` for retrieval-augmented generation.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.device import resolve_device, synchronize
from repro_torch.launch import steps
from repro_torch.models.transformer import MeshLogits

RETRIEVER_DTYPES = ("f32", "bf16", "int8")


class Retriever:
    """Device-resident ANN retrieval over ``corpus_emb`` [n, d].

    ``index`` is a prebuilt ``PiPNNIndex``; without one the corpus is built
    here, with ``build_params`` or, by default, the reference's MIPS
    settings (c_max 256, c_min 32, fanout (4, 2), leaf k 2, max_deg 32,
    ``final_prune`` off for MIPS, ``seed``).  ``metric`` defaults to the
    index's (or ``build_params``') own, and to "mips" for the default
    build; one that disagrees raises ``ValueError``.  ``device`` defaults
    to the card and raises without one; with ``mesh`` the device is the
    mesh's and ``device`` must be None."""

    def __init__(self, corpus_emb, index=None, *, points_dtype: str = "f32",
                 metric: str | None = None, build_params=None, seed: int = 0,
                 n_shards: int | None = None, mesh=None, device=None):
        from repro_torch.core import pipnn
        from repro_torch.core.serving import ServingIndex

        if mesh is not None and device is not None:
            raise ValueError(f"a Retriever on a mesh runs on mesh.device; device={device!r} "
                             "is not taken")
        if points_dtype not in RETRIEVER_DTYPES:
            raise ValueError(f"points_dtype must be one of {RETRIEVER_DTYPES}, "
                             f"got {points_dtype!r}")
        if index is not None:
            if metric is not None and index.params.metric != metric:
                raise ValueError(f"metric={metric!r} does not match the prebuilt "
                                 f"index's metric={index.params.metric!r}")
        elif build_params is not None:
            if metric is not None and build_params.metric != metric:
                raise ValueError(f"metric={metric!r} does not match "
                                 f"build_params.metric={build_params.metric!r}")
        elif metric is None:
            metric = "mips"
        if index is None:
            from repro_torch.core.leaf import LeafParams
            from repro_torch.core.rbc import RBCParams

            if build_params is None:
                # MIPS alpha-pruning over-sparsifies hub-structured graphs:
                # keep the HashPrune reservoir as it is for MIPS
                build_params = pipnn.PiPNNParams(
                    rbc=RBCParams(c_max=256, c_min=32, fanout=(4, 2)),
                    leaf=LeafParams(k=2), metric=metric, max_deg=32,
                    final_prune=(metric != "mips"), seed=seed)
            index = pipnn.build(corpus_emb, build_params,
                                device=device if mesh is None else mesh.device)
        self.index = index
        dtype = {"f32": None, "bf16": torch.bfloat16, "int8": "int8"}[points_dtype]
        self.points_dtype = points_dtype
        self.sv = ServingIndex.from_index(index, corpus_emb, dtype=dtype, device=device,
                                          n_shards=n_shards, mesh=mesh)

    def retrieve(self, q_emb: np.ndarray, *, k: int = 2, beam: int = 32) -> np.ndarray:
        """Top-k corpus ids [Q, k] (int64) for a batch of query embeddings.
        ``k``/``beam`` below 1 raise ``ValueError``, NaN/Inf rows an
        ``InvalidQueryError`` naming them."""
        from repro_torch.core.validation import validate_queries, validate_search_params

        validate_search_params(k=k, beam=beam)
        q = validate_queries(q_emb, dim=int(self.sv.points.shape[-1]))
        return self.sv.search(q, k=k, beam=beam)

    def device_bytes(self) -> int:
        return self.sv.device_bytes()


def stub_frames(b: int, t: int, d: int, device) -> torch.Tensor:
    """The encoder-decoder's stub frame embeddings [b, t, d] in bfloat16
    (the audio frontend is not modelled): the reference's standard normal
    draws of ``np.random.default_rng(0)``, rounded float64 -> float32 ->
    bfloat16 as ``jnp.asarray`` rounds them (a direct rounding differs
    where the float32 value is a bfloat16 tie)."""
    frames = np.random.default_rng(0).standard_normal((b, t, d)).astype(np.float32)
    return torch.from_numpy(frames).to(torch.bfloat16).to(device)


class Server:
    """The model of ``arch_id`` (its smoke model unless ``smoke=False``)
    with parameters made on ``device`` (default: the card, which must be
    present) from ``seed``, serving prompts with their continuations of up
    to ``max_len`` tokens in all; a generate past ``max_len`` raises
    ``IndexError`` where the family keeps a KV cache, and serves in the
    ``ssm`` family, whose decode state does not grow.

    ``model_parallel`` m above 1 serves any of the ten architectures on
    the one-process LM mesh ``data = 1, model = m`` on ``device``
    (``launch.mesh.make_lm_mesh``, the one-card counterpart of the
    reference's ``make_local_mesh``), under the arch's policy; ``mesh``
    takes an ``LMMesh`` made elsewhere (``init_lm_mesh`` over a process
    group, every rank constructing the ``Server`` and calling ``generate``
    alike), its device the server's (``device`` must then be None).  The
    parameters are the ones drawn from ``seed`` at m = 1, each shard
    keeping its blocks: the transformer family draws them layer by layer
    and cuts each layer as it comes, the ``ssm``, ``hybrid`` and
    ``encdec`` families draw the whole tree and then cut it (their mesh
    serving is tested on the CPU by ``tests/test_torch_lm_families_mesh.py``
    and on the card by phase 18 of ``python3 chip_smoke.py``)."""

    def __init__(self, arch_id: str, *, smoke: bool = True, model_parallel: int = 1,
                 max_len: int = 256, seed: int = 0, device=None, mesh=None):
        from repro_torch.launch.mesh import make_lm_mesh

        self.arch = get_config(arch_id)
        if mesh is not None:
            if device is not None:
                raise ValueError(f"a Server on a mesh runs on mesh.device; device={device!r} "
                                 "is not taken")
            if model_parallel not in (1, mesh.model):
                raise ValueError(f"model_parallel={model_parallel} disagrees with the mesh's "
                                 f"model={mesh.model}")
        elif model_parallel < 1:
            raise ValueError(f"model_parallel must be >= 1, got {model_parallel}")
        self.device = resolve_device(device) if mesh is None else mesh.device
        if mesh is None and model_parallel > 1:
            mesh = make_lm_mesh(model_parallel, device=self.device)
        self.mesh = mesh
        self.model = steps.build_model(self.arch, smoke=smoke, mesh=mesh)
        self.max_len = max_len
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = self.model.init(gen, self.device)
        self.vocab = self.model.config.vocab
        self.d_model = self.model.config.d_model

    def make_batch(self, tokens: np.ndarray) -> dict:
        """The prefill batch of prompts [B, T]: their tokens; for the
        ``vlm`` family M-RoPE positions [3, B, T] (text: all three
        components the token's index); for ``encdec`` the encoder's
        ``stub_frames`` [B, T, D]."""
        b, t = tokens.shape
        batch = {"tokens": torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                                           device=self.device)}
        if self.arch.family == "vlm":
            pos = torch.arange(t, device=self.device)
            batch["positions"] = pos[None, None].expand(3, b, t)
        if self.arch.family == "encdec":
            batch["frames"] = stub_frames(b, t, self.d_model, self.device)
        return batch

    def generate(self, prompts: np.ndarray, max_new: int, *, temperature: float = 0.0,
                 seed: int = 0):
        """prompts: [B, T] integers.  Returns (tokens [B, max_new] int32,
        {"prefill_s", "decode_s", "decode_tok_per_s"}): the first token is
        sampled from the prefill's logits, then ``max_new`` decode steps
        each sample the next.  Greedy (the first of equal maxima) at
        ``temperature`` 0, else sampled from softmax(logits / temperature)
        by a generator seeded with ``seed``.  The device is synchronised
        before each clock read."""
        b = prompts.shape[0]
        gen = (torch.Generator(device=self.device).manual_seed(seed) if temperature > 0
               else None)
        synchronize(self.device)
        t0 = time.perf_counter()
        logits, cache = self.model.prefill(self.params, self.make_batch(prompts), self.max_len)
        synchronize(self.device)
        t_prefill = time.perf_counter() - t0
        out = torch.empty((b, max_new), dtype=torch.int64, device=self.device)
        tok = self._sample(logits, temperature, gen)
        t0 = time.perf_counter()
        for i in range(max_new):
            out[:, i] = tok[:, 0]
            logits, cache = self.model.decode_step(self.params, tok, cache)
            tok = self._sample(logits, temperature, gen)
        synchronize(self.device)
        t_decode = time.perf_counter() - t0
        return out.cpu().numpy().astype(np.int32), {
            "prefill_s": t_prefill,
            "decode_s": t_decode,
            "decode_tok_per_s": b * max_new / max(t_decode, 1e-9),
        }

    @staticmethod
    def _sample(logits, temperature: float, gen) -> torch.Tensor:
        """The next token [B, 1] of each row.  On a mesh, greedy combines
        the shards' maxima (``MeshLogits.greedy``); sampling gathers the
        logits, so the draws are the one-shard server's."""
        if isinstance(logits, MeshLogits):
            if temperature <= 0:
                return logits.greedy()
            logits = logits.gather()
        if temperature <= 0:
            return torch.argmax(logits, -1)[:, None]
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="serve random requests from an LM in batches")
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, which must be present)")
    args = ap.parse_args(argv)

    server = Server(args.arch, smoke=args.smoke, model_parallel=args.model_parallel,
                    max_len=args.prompt_len + args.max_new, seed=args.seed,
                    device=args.device)
    rng = np.random.default_rng(args.seed)
    queue = rng.integers(0, server.vocab, (args.requests, args.prompt_len)).astype(np.int32)
    done = 0
    agg_tok_s, batches = [], 0
    while done < args.requests:
        chunk = queue[done: done + args.batch]
        if chunk.shape[0] < args.batch:    # pad the final partial batch
            pad = np.repeat(chunk[-1:], args.batch - chunk.shape[0], axis=0)
            chunk = np.concatenate([chunk, pad], axis=0)
        toks, stats = server.generate(chunk, args.max_new, temperature=args.temperature,
                                      seed=args.seed + done)
        done += args.batch
        batches += 1
        agg_tok_s.append(stats["decode_tok_per_s"])
        print(f"batch {batches}: prefill {stats['prefill_s'] * 1e3:.1f}ms, "
              f"decode {stats['decode_tok_per_s']:.1f} tok/s")
    print(f"served {min(done, args.requests)} requests in {batches} batches; "
          f"mean decode throughput {np.mean(agg_tok_s):.1f} tok/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
