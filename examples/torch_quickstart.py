"""Quickstart on the PyTorch/CUDA port: build a PiPNN index, query it,
check recall.

  PYTHONPATH=src python examples/torch_quickstart.py               # the card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # the CPU

The port of ``examples/quickstart.py``: the same data, parameters, prints
and beam, through ``repro_torch``.  Without a card the default device
raises.
"""
import argparse
import time

import torch

from repro_torch.core import pipnn
from repro_torch.core.beam_search import brute_force_knn, recall_at_k
from repro_torch.core.leaf import LeafParams
from repro_torch.core.pipnn import PiPNNParams
from repro_torch.core.rbc import RBCParams
from repro_torch.data import VectorPipelineConfig, make_queries, make_vectors
from repro_torch.device import resolve_device, synchronize

BEAM = 96


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--queries", type=int, default=200)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. data: 16k Gaussian-mixture vectors, 200 held-out queries
    cfg = VectorPipelineConfig(n=args.n, dim=48, n_clusters=64, seed=0)
    x = make_vectors(cfg)
    queries = make_queries(cfg, args.queries)

    # 2. build: the paper's pipeline, RBC partition -> leaf 2-NN via
    #    batched GEMM -> HashPrune -> final RobustPrune
    params = PiPNNParams(
        rbc=RBCParams(c_max=512, c_min=64, fanout=(4, 2)),
        leaf=LeafParams(k=3),
        hash_bits=12, l_max=64, max_deg=32, alpha=1.3, seed=0,
    )
    t0 = time.perf_counter()
    index = pipnn.build(x, params, device=dev)
    build_s = time.perf_counter() - t0
    print(f"built index over {x.shape[0]} points in {build_s:.2f}s "
          f"(phases: { {k: round(v, 2) for k, v in index.timings.items()} })")
    print(f"average degree {index.average_degree():.1f}, "
          f"{index.stats['n_leaves']} leaves, "
          f"point repeat {index.stats['point_repeat']:.1f}x")

    # 3. query with beam search; 10@10 recall vs brute force
    pipnn.search(index, x, queries[:1], k=10, beam=BEAM, device=dev)   # packs the index
    synchronize(dev)
    t0 = time.perf_counter()
    found = pipnn.search(index, x, queries, k=10, beam=BEAM, device=dev)
    qps = len(queries) / (time.perf_counter() - t0)
    truth = brute_force_knn(torch.from_numpy(x).to(dev), torch.from_numpy(queries).to(dev), 10)
    recall = recall_at_k(found, truth, 10)
    print(f"10@10 recall {recall:.3f} at {qps:.0f} QPS (beam {BEAM})")
    return dict(n=int(x.shape[0]), build_s=build_s, recall=recall, qps=qps,
                average_degree=index.average_degree())


if __name__ == "__main__":
    main()
