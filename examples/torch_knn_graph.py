"""Downstream task (paper Fig. 6) on the PyTorch/CUDA port: build a
95%-recall k-NN graph, the substrate of clustering and dedup pipelines,
and find its mutual-kNN connected components.

  PYTHONPATH=src python examples/torch_knn_graph.py               # the card
  PYTHONPATH=src python examples/torch_knn_graph.py --device cpu  # the CPU

The port of ``examples/knn_graph.py``: the same settings and its own
``recall >= 0.90`` bar, through ``repro_torch``.  Without a card the
default device raises.
"""
import argparse

import numpy as np

from repro_torch.core.knn_graph import knn_graph_pipnn, knn_graph_recall
from repro_torch.core.leaf import LeafParams
from repro_torch.core.pipnn import PiPNNParams
from repro_torch.core.rbc import RBCParams
from repro_torch.data import VectorPipelineConfig, make_vectors
from repro_torch.device import resolve_device

RECALL_BAR = 0.90


def mutual_components(knn: np.ndarray) -> tuple[int, int]:
    """The mutual-kNN graph's edge count and its connected components
    (union-find over the edges i - j with j in knn[i] and i in knn[j])."""
    n = knn.shape[0]
    kset = [set(r[r >= 0].tolist()) for r in knn]
    mutual = set()
    for i in range(n):
        for j in knn[i]:
            if j >= 0 and i in kset[j]:
                mutual.add((min(i, int(j)), max(i, int(j))))
    parent = list(range(n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for a, b in mutual:
        parent[find(a)] = find(b)
    return len(mutual), len({find(i) for i in range(n)})


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=8192)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    x = make_vectors(VectorPipelineConfig(n=args.n, dim=32, n_clusters=32, seed=1))
    params = PiPNNParams(
        rbc=RBCParams(c_max=256, c_min=32, fanout=(4, 2)),
        leaf=LeafParams(k=3), l_max=64, max_deg=32, seed=0)
    knn, timings = knn_graph_pipnn(x, k=10, beam=48, params=params, device=dev)
    recall = knn_graph_recall(x, knn, k=10, sample=512, device=dev)
    print(f"k-NN graph over {x.shape[0]} points: "
          f"build {timings['build']:.2f}s + query {timings['query']:.2f}s "
          f"= {timings['total']:.2f}s, recall {recall:.3f}")
    assert recall >= RECALL_BAR, "quality bar"
    # example downstream use: mutual-kNN connected components (clustering)
    n_edges, n_comp = mutual_components(knn)
    print(f"mutual-kNN graph: {n_edges} edges, "
          f"{n_comp} connected components (planted: 32 clusters)")
    return dict(n=int(x.shape[0]), recall=recall, mutual_edges=n_edges, components=n_comp,
                **timings)


if __name__ == "__main__":
    main()
