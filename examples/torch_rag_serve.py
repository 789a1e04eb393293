"""End-to-end RAG on the PyTorch/CUDA port: PiPNN as the retrieval
substrate in front of an LM server.

  1. build a PiPNN index over a corpus of document embeddings (a Gaussian
     mixture) and serve it through ``Retriever`` by MIPS, at the serving
     precision ``--ann-dtype``;
  2. serve an LM (``--arch``, its smoke model) with batched requests:
     each request embeds its prompt, retrieves its top-k documents
     through the PiPNN graph, prepends their tokens, then prefill and
     greedy decode generate the continuation.

  PYTHONPATH=src python examples/torch_rag_serve.py --ann-dtype int8
  PYTHONPATH=src python examples/torch_rag_serve.py --device cpu

The port of ``examples/rag_serve.py`` with the same constants and random
stream.  The corpus, the payloads and each batch's retrieval are
``examples/torch_rag_retrieve.py``'s functions.  Without a card the default
device raises.
"""
import argparse
import functools
import importlib.util
import pathlib
import time

import numpy as np

from repro_torch.configs.registry import ARCH_IDS
from repro_torch.device import resolve_device, synchronize
from repro_torch.launch.serve import RETRIEVER_DTYPES, Retriever, Server

MAX_NEW = 16


@functools.cache
def _retrieval():
    """``examples/torch_rag_retrieve.py``, imported from beside this file."""
    path = pathlib.Path(__file__).resolve().with_name("torch_rag_retrieve.py")
    spec = importlib.util.spec_from_file_location("_torch_rag_retrieve", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def max_len(rag) -> int:
    """Tokens a request's sequence holds: its documents', its prompt's and
    the ``MAX_NEW`` it generates."""
    return rag.TOPK * rag.DOC_LEN + rag.PROMPT_LEN + MAX_NEW


def serve_requests(rng, retriever, server, doc_tokens, proj, requests: int) -> dict:
    """Serve ``requests`` RAG requests in batches of ``BATCH``: each batch's
    retrieval (``torch_rag_retrieve.next_batch``), then ``server.generate``
    of ``MAX_NEW`` tokens from the augmented prompts."""
    rag = _retrieval()
    served, hits_all, toks_all, stats_all = 0, [], [], []
    synchronize(server.device)
    t_all = time.perf_counter()
    while served < requests:
        b = min(rag.BATCH, requests - served)
        hits, aug = rag.next_batch(rng, b, server.vocab, proj, retriever, doc_tokens)
        toks, stats = server.generate(aug, MAX_NEW)
        hits_all.append(hits)
        toks_all.append(toks)
        stats_all.append(stats)
        served += b
        print(f"[serve] batch of {b}: retrieved {rag.TOPK} docs/req, "
              f"prefill {stats['prefill_s'] * 1e3:.0f}ms, "
              f"decode {stats['decode_tok_per_s']:.0f} tok/s")
    dt = time.perf_counter() - t_all
    print(f"[done] {served} RAG requests in {dt:.2f}s ({served / dt:.2f} req/s end-to-end)")
    return dict(ids=np.concatenate(hits_all), tokens=np.concatenate(toks_all),
                stats=stats_all, requests_per_s=served / dt)


def main(argv=None) -> dict:
    rag = _retrieval()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2-7b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--corpus", type=int, default=8192)
    ap.add_argument("--dim", type=int, default=rag.DIM)
    ap.add_argument("--ann-dtype", choices=RETRIEVER_DTYPES, default="f32",
                    help="serving precision of the corpus copy; int8 = "
                         "scalar-quantized packing (~1/4 the footprint)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)

    # --- 1. corpus: embeddings + token payloads --------------------------
    t0 = time.perf_counter()
    corpus_emb = rag.make_corpus(rng, args.corpus, args.dim)
    retriever = Retriever(corpus_emb, points_dtype=args.ann_dtype, metric="mips", seed=0,
                          device=dev)
    index_s = time.perf_counter() - t0
    device_bytes = retriever.device_bytes()
    print(f"[index] {args.corpus} docs indexed in {index_s:.2f}s "
          f"(avg deg {retriever.index.average_degree():.1f}, "
          f"{args.ann_dtype} serving copy: {device_bytes / 1e6:.2f} MB on device)")

    # --- 2. server --------------------------------------------------------
    server = Server(args.arch, smoke=True, max_len=max_len(rag), device=dev)
    doc_tokens, proj = rag.make_payloads(rng, args.corpus, server.vocab, args.dim)
    out = serve_requests(rng, retriever, server, doc_tokens, proj, args.requests)
    return dict(out, device_bytes=device_bytes, index_s=index_s, ann_dtype=args.ann_dtype)


if __name__ == "__main__":
    main()
