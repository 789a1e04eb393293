"""The retrieval half of the RAG example on the PyTorch/CUDA port: PiPNN as
the retrieval substrate of a serving stack.

  1. build a PiPNN index over a corpus of document embeddings (a Gaussian
     mixture) and serve it through ``Retriever`` by MIPS, at the serving
     precision ``--ann-dtype``;
  2. embed batched requests the way ``examples/rag_serve.py`` does (prompt
     token ids projected into corpus space by a fixed random matrix) and
     retrieve each request's top-k documents.

  PYTHONPATH=src python examples/torch_rag_retrieve.py --ann-dtype int8
  PYTHONPATH=src python examples/torch_rag_retrieve.py --device cpu

The retrieval half of ``examples/rag_serve.py:41-76``, with the same
constants and random stream; this file stops at the augmented prompt, and
``examples/torch_rag_serve.py`` (the whole example) adds the LM that
generates from it, reusing the functions here.  ``VOCAB`` is the
vocabulary of the reference's default ``--arch qwen2-7b`` smoke model,
which the prompt ids and document tokens are drawn from.  Without a card
the default device raises.
"""
import argparse
import time

import numpy as np

from repro_torch.device import resolve_device, synchronize
from repro_torch.launch.serve import RETRIEVER_DTYPES, Retriever

DOC_LEN = 16
VOCAB = 256
BATCH = 4
DIM = 32
TOPK = 2
PROMPT_LEN = 16


def make_corpus(rng, n: int, dim: int = DIM) -> np.ndarray:
    """``n`` document embeddings: a 64-cluster Gaussian mixture."""
    centers = rng.standard_normal((64, dim)) * 2.0
    assign = rng.integers(0, 64, n)
    return (centers[assign] + 0.5 * rng.standard_normal((n, dim))).astype(np.float32)


def make_payloads(rng, n: int, vocab: int, dim: int = DIM):
    """Each document's ``DOC_LEN`` tokens, and the prompt "embedder": a
    fixed projection of prompt token ids into corpus space (a stub for a
    real encoder; deterministic, so retrieval is reproducible)."""
    doc_tokens = rng.integers(0, vocab, (n, DOC_LEN)).astype(np.int32)
    proj = rng.standard_normal((PROMPT_LEN, dim)).astype(np.float32)
    return doc_tokens, proj


def next_batch(rng, b: int, vocab: int, proj, retriever, doc_tokens):
    """``b`` random prompts, their top-``TOPK`` documents by MIPS, and the
    prompts with those documents' tokens prepended: (ids [b, TOPK],
    augmented prompts [b, TOPK * DOC_LEN + PROMPT_LEN])."""
    prompts = rng.integers(0, vocab, (b, PROMPT_LEN)).astype(np.int32)
    q_emb = (prompts / vocab) @ proj          # [b, dim]
    hits = retriever.retrieve(q_emb, k=TOPK, beam=32)
    aug = np.concatenate([doc_tokens[hits.reshape(b, -1)].reshape(b, -1), prompts], axis=1)
    return hits, aug


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--corpus", type=int, default=8192)
    ap.add_argument("--ann-dtype", choices=RETRIEVER_DTYPES, default="f32",
                    help="serving precision of the corpus copy; int8 = "
                         "scalar-quantized packing (~1/4 the footprint)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)

    # --- 1. corpus: embeddings + token payloads --------------------------
    t0 = time.perf_counter()
    corpus_emb = make_corpus(rng, args.corpus)
    retriever = Retriever(corpus_emb, points_dtype=args.ann_dtype, metric="mips", seed=0,
                          device=dev)
    index_s = time.perf_counter() - t0
    device_bytes = retriever.device_bytes()
    print(f"[index] {args.corpus} docs indexed in {index_s:.2f}s "
          f"(avg deg {retriever.index.average_degree():.1f}, "
          f"{args.ann_dtype} serving copy: {device_bytes / 1e6:.2f} MB on device)")
    doc_tokens, proj = make_payloads(rng, args.corpus, VOCAB)

    served, hits_all = 0, []
    synchronize(dev)
    t_all = time.perf_counter()
    while served < args.requests:
        b = min(BATCH, args.requests - served)
        hits, aug = next_batch(rng, b, VOCAB, proj, retriever, doc_tokens)
        hits_all.append(hits)
        served += b
        print(f"[retrieve] batch of {b}: top-{TOPK} doc ids {hits.tolist()}, "
              f"augmented prompt {aug.shape[1]} tokens")
    dt = time.perf_counter() - t_all
    print(f"[done] {served} requests retrieved in {dt:.4f}s ({served / dt:.2f} req/s)")
    return dict(ids=np.concatenate(hits_all), device_bytes=device_bytes, index_s=index_s,
                requests_per_s=served / dt, ann_dtype=args.ann_dtype)


if __name__ == "__main__":
    main()
