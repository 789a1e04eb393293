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

The port of ``examples/rag_serve.py:41-76``, with the same constants and
random stream.  Its LM ``Server`` half (prepending the retrieved
documents' tokens and generating) is not ported: the port has no LM, so
this file stops at the augmented prompt.  ``VOCAB`` is the vocabulary of
the reference's default ``--arch qwen2-7b`` smoke model, which the prompt
ids and document tokens are drawn from.  Without a card the default
device raises.
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
    centers = rng.standard_normal((64, DIM)) * 2.0
    assign = rng.integers(0, 64, args.corpus)
    corpus_emb = (centers[assign]
                  + 0.5 * rng.standard_normal((args.corpus, DIM))).astype(np.float32)
    retriever = Retriever(corpus_emb, points_dtype=args.ann_dtype, metric="mips", seed=0,
                          device=dev)
    index_s = time.perf_counter() - t0
    device_bytes = retriever.device_bytes()
    print(f"[index] {args.corpus} docs indexed in {index_s:.2f}s "
          f"(avg deg {retriever.index.average_degree():.1f}, "
          f"{args.ann_dtype} serving copy: {device_bytes / 1e6:.2f} MB on device)")
    doc_tokens = rng.integers(0, VOCAB, (args.corpus, DOC_LEN)).astype(np.int32)

    # prompt "embedder": project prompt token ids into corpus space (stub
    # for a real encoder; deterministic so retrieval is reproducible)
    proj = rng.standard_normal((PROMPT_LEN, DIM)).astype(np.float32)

    served, hits_all = 0, []
    synchronize(dev)
    t_all = time.perf_counter()
    while served < args.requests:
        b = min(BATCH, args.requests - served)
        prompts = rng.integers(0, VOCAB, (b, PROMPT_LEN)).astype(np.int32)
        q_emb = (prompts / VOCAB) @ proj          # [b, dim]
        hits = retriever.retrieve(q_emb, k=TOPK, beam=32)
        aug = np.concatenate([doc_tokens[hits.reshape(b, -1)].reshape(b, -1), prompts], axis=1)
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
