"""Time a kernel of this checkout against other versions of its source,
alternately, in one process on one card.

    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C build/ab
    python scripts/kernel_ab.py gather --baseline build/ab/src/repro_torch/kernels/csrc

Kernels: leaf, hash, merge, gather, gather8, dist, topk.

Each ``--baseline`` directory holds another version's kernel source (with
the ``common.cuh`` beside it); it is compiled with the checkout's nvcc
flags (and its ``-I``, so a header it includes must lie beside it) into a
library of its own.  The inputs are those of ``chip_smoke.py`` on the
SIFT-like data of n points: for ``leaf``, phase 1's (the first stream
chunk of the build's own partition, k = 2); for ``hash``, phase 1's (that
chunk's bidirected edges, from the checkout's leaf top-k, on the build's
sketches, m = 12); for ``merge``, phase 1's two
merge inputs (the build's second merge, ``early``, and its last, ``late``;
each launch merges into a fresh copy of A, copied untimed); for ``gather``
and ``gather8``, phase 4's (the full build's graph rows of each query's 4
true nearest neighbours, C = 256; float32 and bfloat16 rows, or the int8
packing); for ``dist`` and ``topk``, phase 5's (Stage 1's root subproblem:
all n points against its 1,000 leaders; ``dist`` times both entries of
``distance.cu``, float32 and the int8 packing, ``topk`` selects f = 10 from
the float32 matrix the checkout's kernel gives).  Every version must give the
checkout's output.  ``dist`` also holds each version's float32 entry on the
Gaussian mixture the SIFT-like data is made from, against the same
leaders, to ``chip_smoke.py``'s tolerance (``gaussian_pairwise``), and
reports each one's error and whether it is within it
(``float32_gaussian``).  Each round times every version once, the mean of
``--reps`` launches, in an order that alternates between rounds.  Prints
the card's name and power limit, then one JSON line with every round's
times and their medians.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SOURCES = {"leaf": ("leaf_knn.cu", ("pipnn_leaf_topk",)),
           "hash": ("edge_hash.cu", ("pipnn_edge_hashes",)),
           "merge": ("segmented_merge.cu", ("pipnn_merge_sorted_reservoirs",)),
           "gather": ("gather_distance.cu",
                      ("pipnn_gather_distance", "pipnn_gather_distance_bf16")),
           "gather8": ("gather_distance_int8.cu", ("pipnn_gather_distance_int8",)),
           "dist": ("distance.cu", ("pipnn_pairwise_distance", "pipnn_pairwise_distance_int8")),
           "topk": ("topk.cu", ("pipnn_rowwise_topk",))}


def build_version(csrc: pathlib.Path, kernel: str, tag: str) -> ctypes.CDLL:
    """The library of ``csrc``'s source of ``kernel``."""
    from repro_torch.kernels import _build

    src, entries = SOURCES[kernel]
    out = _build.BUILD_DIR.parent / "kernel_ab" / tag
    out.mkdir(parents=True, exist_ok=True)
    obj, lib = out / "kernel.o", out / "libkernel.so"
    for cmd in ([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-c", str(csrc / src),
                 "-o", str(obj)],
                [_build._nvcc(), "-shared", "-o", str(lib), str(obj)]):
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    for name in entries:
        fn = getattr(dll, name)
        fn.argtypes = _build.SIGNATURES[name]
        fn.restype = ctypes.c_int
    return dll


def leaf_cases(x_np, seed: int, dev):
    """Phase 1's leaf top-k call: [(tag, run(lib), its output tensors)]."""
    import torch

    from chip_smoke import phase1_inputs
    from repro_torch.kernels import _build, leaf_knn

    x = torch.from_numpy(x_np).to(dev)
    n = x.shape[0]
    inputs = phase1_inputs(x, seed)
    params = inputs["params"]
    ids = torch.from_numpy(inputs["padded"][:inputs["chunk"]]).to(dev)
    nb, c = ids.shape
    k = params.leaf.k
    oi = torch.empty((nb, c, k), dtype=torch.int32, device=dev)
    od = torch.empty((nb, c, k), dtype=torch.float32, device=dev)

    def run(lib):
        _build.check(lib.pipnn_leaf_topk(
            x.data_ptr(), ids.data_ptr(), n, x.shape[1], nb, c, k,
            leaf_knn.METRIC_CODES["l2"], oi.data_ptr(), od.data_ptr(), _build.stream_ptr(x)),
            "pipnn_leaf_topk")

    return dict(leaves=nb, slots=c, k=k), [("leaf_topk", run, (oi, od), None)]


def hash_cases(x_np, seed: int, dev):
    """Phase 1's edge-hash call: the first chunk's edges on the build's
    sketches."""
    import torch

    from chip_smoke import phase1_inputs
    from repro_torch.core.leaf import emit_knn_edges
    from repro_torch.kernels import _build, leaf_knn

    x = torch.from_numpy(x_np).to(dev)
    inputs = phase1_inputs(x, seed)
    ids = torch.from_numpy(inputs["padded"][:inputs["chunk"]]).to(dev)
    src, dst, _ = emit_knn_edges(ids, *leaf_knn.leaf_topk(x, ids, inputs["params"].leaf.k))
    sk = inputs["sketches"]
    del x, inputs, ids
    e, m = src.numel(), sk.shape[1]
    out = torch.empty(e, dtype=torch.int32, device=dev)

    def run(lib):
        _build.check(lib.pipnn_edge_hashes(sk.data_ptr(), src.data_ptr(), dst.data_ptr(), e, m,
                                           out.data_ptr(), _build.stream_ptr(sk)),
                     "pipnn_edge_hashes")

    return (dict(edges=e, hash_bits=m, valid_share=float((src >= 0).float().mean())),
            [("edge_hashes", run, (out,), None)])


def merge_cases(x_np, seed: int, dev):
    """Phase 1's two merge calls, each on a copy of its A reservoir."""
    import torch

    from chip_smoke import merge_inputs, phase1_inputs
    from repro_torch.kernels import _build

    x = torch.from_numpy(x_np).to(dev)
    n = x.shape[0]
    inputs = phase1_inputs(x, seed)
    params = inputs["params"]
    pairs = merge_inputs(x, inputs)
    info, cases = dict(chunks=pairs["chunks"], l_max=params.l_max), []
    for tag in ("early", "late"):
        a, b = pairs[tag]
        work = tuple(t.clone() for t in a)

        def setup(a=a, work=work):
            for w, t in zip(work, a):
                w.copy_(t)

        def run(lib, work=work, b=b):
            _build.check(lib.pipnn_merge_sorted_reservoirs(
                *(t.data_ptr() for t in (*work, *b)), n, params.l_max,
                _build.stream_ptr(x)), "pipnn_merge_sorted_reservoirs")

        info[f"{tag}_valid_slots_per_row"] = [float((t.ids >= 0).sum() / n) for t in (a, b)]
        cases.append((tag, run, work, setup))
    return info, cases


def _search_block(x_np, q_np, seed: int, dev):
    """Phase 4's block: the full build's graph rows of each query's 4 true
    nearest neighbours; returns (index, queries, those neighbours [Q, 4])."""
    import torch

    import repro_torch
    from repro_torch.core.beam_search import brute_force_knn

    index = repro_torch.build(x_np, repro_torch.PiPNNParams(seed=seed), device=dev)
    q = torch.from_numpy(q_np).to(dev)
    truth = brute_force_knn(torch.from_numpy(x_np).to(dev), q, 10, chunk=256)
    return index, q, torch.from_numpy(truth[:, :4]).to(dev).long()


def _block_info(gids) -> dict:
    import torch

    return dict(queries=gids.shape[0], slots=gids.shape[1], valid=int((gids >= 0).sum()),
                distinct_rows=torch.unique(gids[gids >= 0]).numel())


def gather_cases(x_np, q_np, seed: int, dev):
    """Phase 4's gather calls, float32 and bfloat16 rows."""
    import torch

    from repro_torch.core.pipnn import serving_index
    from repro_torch.kernels import _build, gather_distance

    index, q, expand = _search_block(x_np, q_np, seed, dev)
    sv = serving_index(index, x_np, device=dev)
    gids = sv.graph[expand].reshape(q.shape[0], -1).contiguous()
    nq, c = gids.shape
    n, d = sv.points.shape
    out = torch.empty((nq, c), device=dev)
    cases = []
    for tag, pts, entry in (("float32", sv.points, "pipnn_gather_distance"),
                            ("bfloat16", sv.points.to(torch.bfloat16),
                             "pipnn_gather_distance_bf16")):
        def run(lib, pts=pts, entry=entry):
            _build.check(getattr(lib, entry)(
                pts.data_ptr(), sv.norms.data_ptr(), q.data_ptr(), gids.data_ptr(), n, d, nq,
                c, gather_distance.METRIC_CODES["l2"], out.data_ptr(), _build.stream_ptr(pts)),
                entry)

        cases.append((tag, run, (out,), None))
    return _block_info(gids), cases


def gather8_cases(x_np, q_np, seed: int, dev):
    """Phase 4's int8 gather call on the int8 serving packing."""
    import torch

    from repro_torch.core.metrics import point_norms
    from repro_torch.core.pipnn import serving_index
    from repro_torch.kernels import _build, gather_distance_int8

    index, q, expand = _search_block(x_np, q_np, seed, dev)
    sv = serving_index(index, x_np, dtype="int8", device=dev)
    gids = sv.graph[expand].reshape(q.shape[0], -1).contiguous()
    q_norms = point_norms(q)
    nq, c = gids.shape
    n, d = sv.points.shape
    out = torch.empty((nq, c), device=dev)

    def run(lib):
        _build.check(lib.pipnn_gather_distance_int8(
            sv.points.data_ptr(), sv.scales.data_ptr(), sv.norms.data_ptr(), q.data_ptr(),
            q_norms.data_ptr(), gids.data_ptr(), n, d, nq, c,
            gather_distance_int8.METRIC_CODES["l2"], out.data_ptr(),
            _build.stream_ptr(q)), "pipnn_gather_distance_int8")

    return _block_info(gids), [("int8", run, (out,), None)]


def dist_cases(x_np, gauss, seed: int, dev):
    """Phase 5's distance calls: float32 points against the leaders, and
    the same on their int8 packing; the float32 case also holds each
    version on the Gaussian points ``gauss`` (untimed)."""
    import torch

    from chip_smoke import gaussian_pairwise, phase5_inputs
    from repro_torch.kernels import _build, distance
    from repro_torch.kernels.gather_distance_int8 import quantize_symmetric

    p5 = phase5_inputs(x_np, seed)
    x, leaders = p5["x"], p5["leaders"]
    (n, d), nl = x.shape, leaders.shape[0]
    p8, _ = quantize_symmetric(x)
    a8, b8 = p8, p8[p5["pos"]].contiguous()
    out = torch.empty((n, nl), device=dev)
    out8 = torch.empty((n, nl), dtype=torch.int32, device=dev)

    def run(lib):
        _build.check(lib.pipnn_pairwise_distance(
            x.data_ptr(), leaders.data_ptr(), 1, n, nl, d, distance.METRIC_CODES[p5["metric"]],
            out.data_ptr(), _build.stream_ptr(x)), "pipnn_pairwise_distance")

    def run8(lib):
        _build.check(lib.pipnn_pairwise_distance_int8(
            a8.data_ptr(), b8.data_ptr(), 1, n, nl, d, out8.data_ptr(), _build.stream_ptr(x)),
            "pipnn_pairwise_distance_int8")

    def held(lib):
        def dist(a, b):
            o = torch.empty((1, n, nl), device=dev)
            _build.check(lib.pipnn_pairwise_distance(
                a.data_ptr(), b.data_ptr(), 1, n, nl, d, distance.METRIC_CODES[p5["metric"]],
                o.data_ptr(), _build.stream_ptr(a)), "pipnn_pairwise_distance")
            return o

        xg = torch.from_numpy(gauss).to(dev)
        return gaussian_pairwise(dist, xg, p5["pos"], p5["metric"])

    info = dict(rows=n, leaders=nl, dim=d)
    return info, [("float32", run, (out,), None, held), ("int8", run8, (out8,), None)]


def topk_cases(x_np, seed: int, dev):
    """Phase 5's top-k call on the float32 distance matrix."""
    import torch

    from chip_smoke import phase5_inputs
    from repro_torch.kernels import _build, distance

    p5 = phase5_inputs(x_np, seed)
    dk = distance.pairwise_distance(p5["x"][None], p5["leaders"][None], p5["metric"])
    f = p5["f"]
    del p5
    _, n, nl = dk.shape
    ids = torch.empty((n, f), dtype=torch.int32, device=dev)
    vals = torch.empty((n, f), device=dev)

    def run(lib):
        _build.check(lib.pipnn_rowwise_topk(dk.data_ptr(), n, nl, f, ids.data_ptr(),
                                            vals.data_ptr(), _build.stream_ptr(dk)),
                     "pipnn_rowwise_topk")

    return dict(rows=n, columns=nl, k=f), [("rowwise_topk", run, (ids, vals), None)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=sorted(SOURCES))
    ap.add_argument("--baseline", type=pathlib.Path, action="append", required=True,
                    help="a directory holding another version's source and common.cuh")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=10_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import cuda_ms, smi
    from repro_torch.data import VectorPipelineConfig, make_queries, make_vectors, sift_like
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build

    dev = resolve_device(None)
    versions = {"checkout": _build.library()}
    for i, path in enumerate(args.baseline):
        versions[str(path)] = build_version(path.resolve(), args.kernel, f"v{i}")
    cfg = VectorPipelineConfig(n=args.n, dim=128, n_clusters=1024, seed=args.seed)
    gauss = make_vectors(cfg)
    x_np = sift_like(gauss)
    if args.kernel in ("gather", "gather8"):
        info, cases = (gather_cases if args.kernel == "gather" else gather8_cases)(
            x_np, sift_like(make_queries(cfg, args.queries)), args.seed, dev)
    elif args.kernel == "dist":
        info, cases = dist_cases(x_np, gauss, args.seed, dev)
    else:
        cases_of = {"leaf": leaf_cases, "hash": hash_cases, "merge": merge_cases,
                    "topk": topk_cases}
        info, cases = cases_of[args.kernel](x_np, args.seed, dev)
    result = dict(kernel=args.kernel, n=args.n, reps=args.reps, **info)
    names = list(versions)
    for tag, run, outs, setup, *held in cases:
        setup = setup or (lambda: None)
        setup()
        run(versions["checkout"])
        want = [t.clone() for t in outs]
        for name in names[1:]:
            setup()
            run(versions[name])
            if not all(torch.equal(a, b) for a, b in zip(outs, want)):
                print(f"kernel_ab: {tag} of {name} differs from the checkout's", file=sys.stderr)
                return 1
        if held:
            result[f"{tag}_gaussian"] = {name: held[0](versions[name]) for name in names}
        times = {name: [] for name in names}
        for r in range(args.rounds):
            for name in (names if r % 2 == 0 else names[::-1]):
                times[name].append(cuda_ms(lambda: run(versions[name]), args.reps, setup=setup))
        result[tag] = {name: dict(ms=t, median_ms=statistics.median(t))
                       for name, t in times.items()}
    print(smi())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
