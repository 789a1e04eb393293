#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PiPNN (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed S] [--n N] [--n-small N] [--queries Q]

With no arguments it runs the SIFT1M / BIGANN-1M deployment: n = 1,000,000
points, d = 128, float32, squared L2, 10,000 queries, k = 10, built with
the paper's defaults (``PiPNNParams()``).  The data is synthetic and SIFT-like
(a seeded Gaussian mixture with 1024 clusters mapped onto integers in
[0, 255]); nothing is downloaded.

Phases (any failure exits non-zero before the last line is printed):

0. setup: the card's name and power limit; build the four CUDA kernels
   from ``src/repro_torch/kernels/csrc`` (nvcc, sm_90a) and time the build.
1. the build's three kernels against their plain PyTorch versions on the
   card, on the inputs the full-size build gives them (its partition, cut
   into its stream chunks): leaf top-k bit-exact on the integer data and
   within the stated tolerance on Gaussian data, edge hashes and merge
   bit-exact; kernel and plain times, and the least time the card could
   take for the same work.
2. small parity: n = 65,536 built on the card and on the CPU must give the
   identical graph and entry point, and search must give equal recall.
   Why this can be exact: with integer data below 2^24 every norm, dot
   product and distance is exact in float32 in any summation order, and
   with dyadic hyperplanes (multiples of 1/16, drawn on the host from the
   seed) so is every sketch.  Only then do leaves, leaf top-k, reservoirs,
   prune and gather distances agree bit for bit across devices.
3. full size: build and search through the public entry points with every
   kernel launch counter set to 0 first; phase times, graph statistics,
   peak device memory, recall@10 against brute force and QPS at beams 32,
   64 and 128; graph invariants, the recall floor and launches > 0.
4. the search's gather kernel against its plain version, as in phase 1,
   on blocks of the built graph's rows for the 10,000 queries.

The second-to-last line is the card's ``nvidia-smi`` name and power limit,
the line before it the ``kernels`` JSON, and the last line the result JSON.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

# f32 CUDA-core peak and memory rate of one H100 SXM (NVIDIA's data sheet)
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
EPS32 = 2.0 ** -23           # float32 machine epsilon
RECALL_FLOOR = 0.90          # recall@10 at beam 128, full size


def log(*a) -> None:
    print(*a, flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int, setup=None) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs after one
    warm-up, timed with CUDA events (``setup()``, untimed, runs before each)."""
    import torch

    if setup:
        setup()
    fn()
    total = 0.0
    for _ in range(reps):
        if setup:
            setup()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def phase_kernels(x, xg, seed: int) -> dict:
    """Phase 1: the build's kernels against their plain versions on the
    inputs the full-size build gives them: its own partition of ``x``, cut
    into stream chunks as the build cuts it.  Leaf top-k and edge hashes
    run on the first chunk, the merge on the reservoirs of the first two
    chunks (the inputs of the build's second merge)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core import pipnn, sketch
    from repro_torch.core.hashprune import hashprune_flat
    from repro_torch.core.leaf import emit_knn_edges
    from repro_torch.core.rbc import partition_padded
    from repro_torch.kernels import edge_hash, leaf_knn, segmented_merge

    dev = x.device
    n, d = x.shape
    params = pipnn.PiPNNParams(seed=seed)
    k, l_max = params.leaf.k, params.l_max
    t0 = time.perf_counter()
    padded = partition_padded(x, dataclasses.replace(params.rbc, seed=seed))
    chunk = pipnn._stream_chunk_leaves(params.leaf, n, l_max, *padded.shape)
    leaves = torch.from_numpy(padded[:2 * chunk]).to(dev)
    ids, ids1 = leaves[:chunk], leaves[chunk:]
    sizes = (ids >= 0).sum(dim=1).double()
    log("phase1 partition", json.dumps(dict(
        seconds=time.perf_counter() - t0, n_leaves=int(padded.shape[0]),
        chunk_leaves=chunk, chunk_leaf_size_mean=float(sizes.mean()))))
    del padded
    out = {}

    # leaf top-k: the first stream chunk, C = 1024, d = 128, k = 2
    ki, kd = leaf_knn.leaf_topk(x, ids, k)
    pi, pd = leaf_knn.leaf_topk_plain(x, ids, k, block=16)
    check(torch.equal(ki, pi) and torch.equal(kd, pd), "leaf_topk != plain on integer data")
    del pi, pd
    gi, gd = leaf_knn.leaf_topk(xg, ids, k)
    hi, hd = leaf_knn.leaf_topk_plain(xg, ids, k, block=16)
    fin = torch.isfinite(hd)
    check(torch.equal(torch.isfinite(gd), fin), "leaf_topk finite pattern differs")
    # float32 rounding of |a|^2 + |b|^2 - 2ab summed in another order: a few
    # ulps of the norm terms, which cancel for near neighbours
    max_sq = float((xg * xg).sum(dim=1).max())
    err = (gd[fin] - hd[fin]).abs()
    check(bool((err <= 1e-5 * hd[fin].abs() + 32 * EPS32 * max_sq).all()),
          f"leaf_topk Gaussian dists beyond tolerance (max {float(err.max())})")
    err = float(err.max())
    idx_agree = float((gi == hi).float().mean())
    del gi, gd, hi, hd, fin
    # work this chunk needs: all pairs within each leaf's valid points; each
    # distinct point row read once, the ids read and the outputs written once
    flops = float(2.0 * d * (sizes ** 2).sum())
    rows = torch.unique(ids[ids >= 0]).numel()
    nbytes = float(ids.numel() * 4 + rows * d * 4 + ki.numel() * 8)
    out["leaf_topk"] = dict(
        max_abs_err=err, gaussian_idx_agreement=idx_agree, tolerance="exact on integer "
        "data; Gaussian |err| <= 1e-5 |d| + 32 eps max|x|^2",
        ms=cuda_ms(lambda: leaf_knn.leaf_topk(x, ids, k), 10),
        plain_ms=cuda_ms(lambda: leaf_knn.leaf_topk_plain(x, ids, k, block=16), 2),
        flops=flops, bytes=nbytes, bound_by="operations" if flops / PEAK_F32_FLOPS
        > nbytes / PEAK_BYTES else "bytes",
        bound_ms=1e3 * max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES))
    log("phase1 leaf_topk", json.dumps(out["leaf_topk"]))

    # edge hashes: the chunk's bidirected edges (2 * chunk * C * k entries)
    # on the build's sketches (its seeded hyperplanes, m = 12)
    hp = torch.from_numpy(sketch.make_hyperplanes(seed, params.hash_bits, d)).to(dev)
    sk = sketch.sketch(x, hp).contiguous()
    src, dst, _ = emit_knn_edges(ids, ki, kd)
    del ki, kd
    e = src.numel()
    kh = edge_hash.edge_hashes(sk, src, dst)
    check(torch.equal(kh, edge_hash.edge_hashes_plain(sk, src, dst)), "edge_hashes != plain")
    skg = sketch.sketch(xg, hp).contiguous()
    check(torch.equal(edge_hash.edge_hashes(skg, src, dst),
                      edge_hash.edge_hashes_plain(skg, src, dst)),
          "edge_hashes != plain on Gaussian sketches")
    del kh, skg
    nbytes = float(sk.numel() * 4 + e * 8 + e * 4)
    out["edge_hashes"] = dict(
        max_abs_err=0.0, tolerance="bit-exact", edges=e,
        valid_share=float((src >= 0).float().mean()),
        ms=cuda_ms(lambda: edge_hash.edge_hashes(sk, src, dst), 20),
        plain_ms=cuda_ms(lambda: edge_hash.edge_hashes_plain(sk, src, dst), 3),
        bytes=nbytes, bound_by="bytes", bound_ms=1e3 * nbytes / PEAK_BYTES)
    log("phase1 edge_hashes", json.dumps(out["edge_hashes"]))
    del src, dst

    # merge: the reservoirs of the first two chunks, each the chunk's edges
    # reduced by hashprune_flat as the build reduces them
    def reservoir(leaf_ids):
        edges, _ = pipnn._chunk_edges(x, sk, leaf_ids, k=k, metric=params.metric)
        return hashprune_flat(*edges, n_points=n, l_max=l_max)

    a, b = reservoir(ids), reservoir(ids1)
    want = segmented_merge.merge_sorted_reservoirs_plain(*a, *b)
    got = segmented_merge.merge_sorted_reservoirs(*(t.clone() for t in a), *b)
    check(all(torch.equal(g, w) for g, w in zip(got, want)), "merge != plain")
    work = [None]

    def fresh():
        work[0] = tuple(t.clone() for t in a)

    nbytes = float(9 * n * l_max * 4)
    out["merge_sorted_reservoirs"] = dict(
        max_abs_err=0.0, tolerance="bit-exact", valid_slots_per_row=[
            float((a.ids >= 0).sum() / n), float((b.ids >= 0).sum() / n)],
        ms=cuda_ms(lambda: segmented_merge.merge_sorted_reservoirs(*work[0], *b), 10,
                   setup=fresh),
        plain_ms=cuda_ms(lambda: segmented_merge.merge_sorted_reservoirs_plain(*a, *b), 2),
        bytes=nbytes, bound_by="bytes", bound_ms=1e3 * nbytes / PEAK_BYTES)
    log("phase1 merge_sorted_reservoirs", json.dumps(out["merge_sorted_reservoirs"]))
    return out


def phase_gather(sv, q, gauss_x, gauss_q, truth) -> dict:
    """Phase 4: the search's kernel against its plain version on the
    blocks the search gives it: Q queries, and for each the graph rows of
    E = 4 expanded points (C = 4 * 64 ids, -1 where a row is short).  The
    expanded points are each query's 4 true nearest neighbours, as in the
    search's later hops."""
    import torch

    from repro_torch.core.metrics import point_norms
    from repro_torch.kernels import gather_distance

    dev = sv.points.device
    x, nrm = sv.points, sv.norms
    nq, d = q.shape
    expand = torch.from_numpy(truth[:, :4]).to(dev).long()
    gids = sv.graph[expand].reshape(nq, -1).contiguous()          # [Q, 256]
    xg, qg = torch.from_numpy(gauss_x).to(dev), torch.from_numpy(gauss_q).to(dev)
    sq = (xg * xg).sum(dim=1)
    scale = (qg * qg).sum(dim=1)[:, None] + sq[gids.clamp_min(0).long()]
    for metric in ("l2", "mips", "cosine"):
        nrm_m = point_norms(x, metric)
        got = gather_distance.gather_distance(x, nrm_m, q, gids, metric)
        want = gather_distance.gather_distance_plain(x, nrm_m, q, gids, metric)
        if metric != "cosine":   # cosine divides by a rounded sqrt
            check(torch.equal(got, want), f"gather_distance {metric} != plain on integers")
        nrmg = point_norms(xg, metric)
        gg = gather_distance.gather_distance(xg, nrmg, qg, gids, metric)
        gw = gather_distance.gather_distance_plain(xg, nrmg, qg, gids, metric)
        fin = torch.isfinite(gw)
        check(torch.equal(torch.isfinite(gg), fin), f"gather_distance {metric} inf pattern")
        # l2 and mips: a few ulps of |q|^2 + |p|^2 (the expansion cancels
        # for near points); cosine is O(1)
        slack = 1e-5 if metric == "cosine" else 16 * EPS32 * scale[fin]
        diff = (gg[fin] - gw[fin]).abs()
        check(bool((diff <= 1e-5 * gw[fin].abs() + slack).all()),
              f"gather_distance {metric} Gaussian beyond tolerance (max {float(diff.max())})")
        if metric == "l2":
            err = float(diff.max())
    del xg, qg, sq, scale
    # bytes: a row and a norm for each distinct valid id, read once (-1 ids
    # read nothing), every id and output slot, and the queries
    valid = int((gids >= 0).sum())
    rows = torch.unique(gids[gids >= 0]).numel()
    nbytes = float(rows * (d * 4 + 4) + gids.numel() * 8 + nq * d * 4)
    out = dict(
        max_abs_err=err, tolerance="exact on integer data (l2, mips); Gaussian "
        "|err| <= 1e-5 |d| + 16 eps (|q|^2 + |p|^2) (l2, mips), 1e-5 |d| + 1e-5 (cosine)",
        valid_share=valid / gids.numel(), distinct_rows=rows,
        ms=cuda_ms(lambda: gather_distance.gather_distance(x, nrm, q, gids), 20),
        plain_ms=cuda_ms(lambda: gather_distance.gather_distance_plain(x, nrm, q, gids), 3),
        bytes=nbytes, bound_by="bytes", bound_ms=1e3 * nbytes / PEAK_BYTES)
    log("phase4 gather_distance", json.dumps(out))
    return out


def phase_parity(n: int, n_queries: int, seed: int, dev) -> None:
    """Phase 2: the same build on the card and on the CPU."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.core.beam_search import brute_force_knn, recall_at_k
    from repro_torch.data import (VectorPipelineConfig, dyadic_hyperplanes, make_queries,
                                  make_vectors, sift_like)

    cfg = VectorPipelineConfig(n=n, dim=128, n_clusters=1024, seed=seed)
    x = sift_like(make_vectors(cfg))
    q = sift_like(make_queries(cfg, n_queries))
    hp = dyadic_hyperplanes(seed, 12, 128)
    t0 = time.perf_counter()
    gpu = repro_torch.build(x, hyperplanes=hp, device=dev)
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = repro_torch.build(x, hyperplanes=hp, device="cpu")
    t_cpu = time.perf_counter() - t0
    check(gpu.start == cpu.start, f"start differs: {gpu.start} vs {cpu.start}")
    same = torch.equal(gpu.graph.cpu(), cpu.graph)
    check(same, f"graphs differ in {int((gpu.graph.cpu() != cpu.graph).sum())} slots")
    check(torch.equal(gpu.dists.cpu(), cpu.dists), "graph dists differ")
    truth = brute_force_knn(torch.from_numpy(x).to(dev), torch.from_numpy(q).to(dev), 10)
    ids_gpu = repro_torch.search(gpu, x, q, k=10, beam=64, device=dev)
    ids_cpu = repro_torch.search(cpu, x, q, k=10, beam=64, device="cpu", query_chunk=250)
    r_gpu, r_cpu = recall_at_k(ids_gpu, truth), recall_at_k(ids_cpu, truth)
    check(r_gpu == r_cpu and np.array_equal(ids_gpu, ids_cpu),
          f"search differs: recall {r_gpu} vs {r_cpu}")
    log("phase2", json.dumps(dict(n=n, queries=n_queries, graph_identical=same,
                                  start=gpu.start, recall_at_10_beam64=r_gpu,
                                  build_s_card=t_gpu, build_s_cpu=t_cpu,
                                  stats=gpu.stats)))


def phase_full(x, q, seed: int, dev) -> dict:
    """Phase 3: the main path at full size, through the public entry points."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch import kernels
    from repro_torch.core.beam_search import brute_force_knn, recall_at_k
    from repro_torch.core.pipnn import serving_index

    n, n_queries = x.shape[0], q.shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    index = repro_torch.build(x, repro_torch.PiPNNParams(seed=seed), device=dev)
    wall = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    g = index.graph
    st = index.stats
    check(st["partition_uncovered"] == 0, "points left out of every leaf")
    check(bool(((g >= -1) & (g < n)).all()), "graph ids out of range")
    rows = torch.arange(n, device=g.device)[:, None]
    check(not bool((g == rows).any()), "graph has self loops")
    check(g.shape[1] <= 64, "degree above 64")
    log("phase3 build", json.dumps(dict(
        n=n, wall_s=wall, timings=index.timings, peak_device_bytes=build_peak,
        avg_degree=index.average_degree(),
        stats={k: st[k] for k in ("n_leaves", "point_repeat", "pad_ratio",
                                   "n_candidate_edges", "stream_chunk_leaves",
                                   "leaf_size_mean", "partition_uncovered")})))

    xt = torch.from_numpy(x).to(dev)
    truth = brute_force_knn(xt, torch.from_numpy(q).to(dev), 10, chunk=256)
    del xt
    repro_torch.search(index, x, q[:100], k=10, beam=32, device=dev)   # packs the ServingIndex
    per_beam = {}
    for beam in (32, 64, 128):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, tel = repro_torch.search(index, x, q, k=10, beam=beam, with_stats=True,
                                      device=dev)
        dt = time.perf_counter() - t0
        per_beam[beam] = dict(recall_at_10=recall_at_k(ids, truth), qps=n_queries / dt,
                              seconds=dt, mean_hops=float(tel["hops"].mean()),
                              mean_dist_comps=float(tel["dist_comps"].mean()),
                              converged=float(tel["converged"].mean()))
        log("phase3 search", beam, json.dumps(per_beam[beam]))
    launches = kernels.launch_counts()
    log("phase3 launches", json.dumps(launches))
    for name, cnt in launches.items():
        check(cnt > 0, f"kernel {name} was not launched on the main path")
    check(per_beam[128]["recall_at_10"] >= RECALL_FLOOR,
          f"recall@10 at beam 128 below {RECALL_FLOOR}")
    return dict(launches=launches, peak=torch.cuda.max_memory_allocated(), truth=truth,
                serving=serving_index(index, x, device=dev))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--n-small", type=int, default=65_536)
    ap.add_argument("--queries", type=int, default=10_000)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = pathlib.Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {src}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.data import VectorPipelineConfig, make_queries, make_vectors, sift_like
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build

    card = smi()
    log("card:", card)
    resolve_device(None)   # pins float32 products to full precision
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    log("phase0 kernels built in", round(time.perf_counter() - t0, 3), "s:", lib.name)
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas", line.strip())

    # SIFT-like data (integers in [0, 255]) and the Gaussian mixture it is
    # made from, for the kernels' tolerance checks
    cfg = VectorPipelineConfig(n=args.n, dim=128, n_clusters=1024, seed=args.seed)
    gauss, gauss_q = make_vectors(cfg), make_queries(cfg, args.queries)
    x_np, q_np = sift_like(gauss), sift_like(gauss_q)
    x, xg = torch.from_numpy(x_np).cuda(), torch.from_numpy(gauss).cuda()
    t0 = time.perf_counter()
    kstats = phase_kernels(x, xg, args.seed)
    log("phase1 s", round(time.perf_counter() - t0, 3))
    del x, xg
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    phase_parity(args.n_small, min(args.queries, 1000), args.seed, torch.device("cuda"))
    log("phase2 s", round(time.perf_counter() - t0, 3))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    full = phase_full(x_np, q_np, args.seed, torch.device("cuda"))
    log("phase3 s", round(time.perf_counter() - t0, 3))

    t0 = time.perf_counter()
    kstats["gather_distance"] = phase_gather(
        full["serving"], torch.from_numpy(q_np).cuda(), gauss, gauss_q, full["truth"])
    log("phase4 s", round(time.perf_counter() - t0, 3))

    sources = {"leaf_topk": ("leaf_knn.cu", "src/repro/kernels/leaf_knn.py:114"),
               "edge_hashes": ("edge_hash.cu", "src/repro/kernels/edge_hash.py:58"),
               "merge_sorted_reservoirs": ("segmented_merge.cu",
                                           "src/repro/kernels/segmented_merge.py:104"),
               "gather_distance": ("gather_distance.cu",
                                   "src/repro/kernels/gather_distance.py:179 and :407")}
    counter = {"leaf_topk": "leaf_knn", "edge_hashes": "edge_hash",
               "merge_sorted_reservoirs": "segmented_merge",
               "gather_distance": "gather_distance"}
    rows = []
    for name, (cu, replaces) in sources.items():
        s = kstats[name]
        rows.append(dict(name=name, route="cuda",
                         source=f"src/repro_torch/kernels/csrc/{cu}", replaces=replaces,
                         launches=full["launches"][counter[name]],
                         max_abs_err=s["max_abs_err"], ms=s["ms"], kernel_ms=s["ms"],
                         plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
                         bound_by=s["bound_by"], library_ms=None,
                         tolerance=s["tolerance"]))
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
