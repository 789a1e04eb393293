#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PiPNN (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed S] [--n N] [--n-small N] [--queries Q] [--n-cpu N]

With no arguments it runs the SIFT1M / BIGANN-1M deployment: n = 1,000,000
points, d = 128, float32, squared L2, 10,000 queries, k = 10, built with
the paper's defaults (``PiPNNParams()``).  The data is synthetic and SIFT-like
(a seeded Gaussian mixture with 1024 clusters mapped onto integers in
[0, 255]); nothing is downloaded.

Phases (any failure exits non-zero before the last line is printed):

0. setup: the card's name and power limit; build the CUDA kernels
   from ``src/repro_torch/kernels/csrc`` (nvcc, sm_90a) and time the build.
1. the build's three kernels against their plain PyTorch versions on the
   card, on the inputs the full-size build gives them (its partition, cut
   into its stream chunks): leaf top-k bit-exact on the integer data and
   within the stated tolerance on Gaussian data (and bit-exact at k = 16,
   its lists in shared memory, on the chunk's first 2,048 leaves), edge
   hashes and merge
   bit-exact; kernel and plain times, and the least time the card could
   take for the same work.  The merge runs on two inputs: the build's
   second merge (the first two chunks' reservoirs) and its last (the
   reservoir of every chunk but the last, folded by the kernel, and the
   last chunk's); its bound counts the bytes these rows need (each id row
   up to its first -1, live prefixes, written slots, in 32-byte sectors;
   B's first id alone where B is empty).  The leaf top-k forms its
   products on the tensor cores with three TF32 products per float32
   product (3xTF32), so its bound is those at the TF32 peak; the f32
   CUDA-core bound of the same products stands beside it.
2. small parity: n = 65,536 built on the card and on the CPU must give the
   identical graph and entry point, and search must give equal recall.
   Why this can be exact: with integer data below 2048 whose sums stay
   below 2^24 every norm, dot product and distance is exact in float32 in
   any summation order, also through 3xTF32 products, and
   with dyadic hyperplanes (multiples of 1/16, drawn on the host from the
   seed) so is every sketch.  Only then do leaves, leaf top-k, reservoirs,
   prune and gather distances agree bit for bit across devices.  int8 and
   bfloat16 search give the same ids on both devices too.  The static
   Stage-1 carve (``RBCParams(execution="static")``, through the distance
   and top-k kernels on the card) gives the identical leaf matrix and
   static build on both devices.  The same points
   before the integer mapping (the Gaussian mixture) are built and searched
   on the card, and their float32 / int8 / bfloat16 recall reported.
3. full size: build and search through the public entry points; phase
   times, graph statistics, peak device memory, recall@10 against brute
   force and QPS at beams 32, 64 and 128; graph invariants and the recall
   floor.  Then the same searches with ``dtype="int8"`` and
   ``dtype=torch.bfloat16``: recall, QPS, hops and device bytes, with
   bfloat16's recall at least f32's - 0.01 at every beam; int8's gap to
   f32 is reported against check.sh step 5's 0.02 (see ``GATED``), and the
   int8 ids of 500 queries must equal those of the same search on the CPU.
   The launch counters are set to 0 before each path (the
   build; each search dtype) and read after it: every kernel of a path must
   have run on it.
4. the search's gather kernels against their plain versions, as in phase
   1, on blocks of the built graph's rows for the 10,000 queries: float32,
   bfloat16 and int8 (bit-exact on integer and Gaussian data).  Beside the
   bound (each distinct row read once) stands the time to read every valid
   slot's row with no reuse across queries, for each row type.
5. Stage 1's root subproblem of the full-size build (all n points against
   its 1,000 leaders, f = 10) through ``leader_assign(use_kernels=True)``:
   the distance and top-k kernels against their plain versions and the
   route against the default ``topf`` route (identical ids), both routes
   timed whole, and the int8 distance kernel on the int8 packing of the
   same points; kernel, plain and library times (``torch.cdist``,
   ``torch.topk``; beside the int8 kernel ``torch._int_mm``, which forms
   only its products).  The distance kernel forms its products as three TF32
   products (3xTF32, as the leaf top-k), so its bound is those at the TF32
   peak, with the f32 CUDA-core bound beside it.  It is bit-exact on the
   integer data and, like the leaf top-k, held on the Gaussian mixture (its
   points against the same leaders) to 1e-5 |d| + 32 eps max|x|^2: on the
   integer data the low TF32 parts are 0, so only this check sees them.
   The top-k also at the static carve's level-0 k (12).
6. the static Stage-1 carve at full size: the partition alone, static and
   the default worklist in turns; the static carve step by step (its
   counts: capacity drops, salvage leaves); the distance and top-k kernels
   on its first level-1 block (34 buckets of 15,008 points against their
   80 leaders, masked) against their plain versions, with times, library
   times and bounds; then the static build and its float32 searches
   through the public entry points, the launch counters set to 0 before
   each path (the distance and top-k kernels must run on the build, as
   the build's three do).  Graph invariants, recall@10 at beam 128 at
   least the floor and at least the worklist build's - 0.03.  The
   ``kernels`` line takes the distance and top-k launches from this build.
7. the other build and search options.  (a) The flat build
   (``streaming=False``) at full size on phase 3's own leaves (its leaf
   matrix, recorded on its way through, given as ``leaves=``) and seeded
   hyperplanes: its graph, dists and entry point identical to phase 3's;
   wall time by phase and peak device memory beside the streaming
   build's; the leaf and hash kernels launched on it, the merge kernel
   not.  (b) The flat fold (``merge="flat"``) on the same leaves: the
   identical graph, no merge launch.  (c) ``final_prune=False``: the graph
   equals the same stream's reservoir cut to ``max_deg``, its rows sorted
   by (dist, id) with -1 / +inf padding and holding every id of phase 3's
   pruned rows; its degree, recall@10 and QPS at beams 32, 64 and 128
   beside phase 3's.  (d) Every leaf method (``LeafParams.method``) at
   ``--n-small`` with the reference's ablation settings
   (``benchmarks/bench_leaf_methods.py``: c_max 256, c_min 32, fanout
   (4, 2), k 2, max_deg 32) on one carve's leaves and dyadic hyperplanes:
   recall@10 at beam 64, degree, ``build_leaves`` seconds and launches;
   ``robust_prune`` streamed equals flat; then each method on the card and
   on the CPU at ``--n-cpu`` points (16,384: its own data; the CPU's
   all-to-all ``robust_prune`` takes minutes at 65,536), identical
   graphs.  (e) The host search (``search(batch=False)``, no kernel) on
   200 of the queries at beam 64 beside the serving path on the same
   queries, and the legacy ``beam_search_single`` on the card for every
   query at each beam (``iters = beam + 4``) beside phase 3's serving
   engine.  The launch counters are set to 0 before each path and read
   after it.
8. serving: sharded serving and the serving loop on phase 3's graph and
   queries at full size.  (a) ``ShardedServingIndex`` on one card: at
   S = 1 its ids equal ``ServingIndex``'s at every beam; at S = 8 (float32,
   router "all") recall@10 at least the single card's - 0.01 at every beam
   (``BENCH_qps.json``'s sharded gate); router "leaders" with 2 probes,
   and the int8 and bfloat16 packings (beam 64): recall and QPS beside
   phase 3's;
   each packing's halo (member / ghost / pad rows, ``halo_fraction``),
   its bytes beside S * m * (4 + 4R + d * itemsize + 4 [+ 4]), and the
   gather launches of each search (one a step for each shard).  The merged
   rows never repeat an id, and on the Gaussian mixture at ``--n-small``
   a ghost row's distance is bit-identical in every shard that holds it
   (float32 and bfloat16).  (b) At ``--n-small`` on the integer data the
   S = 8 packing and the float32 and int8 ids are identical on the card and
   on the CPU.  (c) The fault drill at 1M: S = 8, shard 7 down for search
   calls [1, 6), a 10 ms straggler at call 2, 5% NaN rows among 1,024
   requests, ``ServeLoop(k=10, query_chunk=64, straggler_chunk=8,
   max_queue=1024, probe_every=1)`` on a ladder made from phase 3's card
   measurements (``ladder_from_bench`` on its records in
   ``BENCH_qps.json``'s format): every request answered, structured errors
   exactly on the poisoned rows, one tombstone and one re-admission,
   degraded recall at least 0.85 of healthy.  (d) The loop on the single
   card index, the 10,000 queries submitted 256 at a time: two-phase and
   single-phase p50 / p99 latency, throughput, stragglers rerun, and the
   phase-1-drained rows bit-identical between the two; open-loop Poisson
   arrivals at 50% and 120% of the two-phase throughput (p50 / p99,
   rejected requests, downshifts); a search forced to ``kernel_path="xla"``
   launches no gather kernel and the calls around it do.  The launch
   counters are set to 0 before each path and read after it.
9. the distributed build (``launch/build_index.py::build_distributed``) on
   one card, all S shards in one process, at
   ``DistBuildParams(dim=128, n_tile=2**18, l0=16)`` (every other field
   the reference's production default; at S = 8 each shard has the
   shapes of one chip of the reference's 512-chip tile step) on the first
   262,144 points and phase 3's queries.  A smaller ``--n`` takes the
   largest power-of-two tile with two tiles in ``n`` (l0 stays 16).
   (a) One tile at S = 1 and S = 8:
   wall seconds of the tile and final-prune steps, their stats, the
   entries ``group_by_capacity`` drops silently at each stage, the leaves'
   fill before the cut to c_max, peak device
   memory, mean degree, isolated points, and recall@10 and QPS at each
   beam from start 0 (the reference's choice) beside the default
   ``build`` of the same points; recall@10 at beam 128 at least the floor,
   no isolated point, and the distance, top-k and merge kernels launched.
   (b) Two tiles at S = 8: the first tile's rows equal (a)'s graph and no
   edge crosses the tiles' boundary (the reference builds each tile
   alone).  (c) The variants ``quantized`` (the int8 distance kernel must
   launch), ``bf16leaf``, ``opt`` and ``merge="flat"`` (no merge launch)
   at S = 8: recall, times and launches; the int8 recall is reported, not
   gated.  (d) The distance, top-k, int8 distance and merge kernels at
   this path's shapes (each one's first call on shard 0: level 0, a
   level-1 chunk, a leaf chunk, a fold) against their plain versions,
   bit-exact, with kernel, plain and library times and bounds.  (e) Card
   against CPU at one ``tiny`` tile of dim 128, S = 8, baseline and
   quantized, on integer rows whose int8 round trip is exact (SIFT-like
   values halved, each row's largest entry 127) and dyadic hyperplanes:
   identical graphs and dists.  (f) ``knn_graph_pipnn`` on the 262,144
   points (k = 10, beam 32, ``PiPNNParams()``): build, query and total
   seconds, and ``knn_graph_recall`` on 2,000 points at least the
   reference test's 0.85 (the paper's target is 0.95).  The launch
   counters are set to 0 before each path and read after it.
10. the shard mesh (``launch/mesh.py``) over a process group: a one-rank
   NCCL group in this process (``init_mesh`` through a ``FileStore`` in a
   temporary directory, destroyed at the end of the phase), S = 8 shards
   local to rank 0, so every exchange runs through ``all_to_all_single``
   / ``all_gather`` / ``all_reduce``.  The group's set-up and the first
   collective (which builds the communicator) are timed on their own.
   (a) ``build_distributed`` over the mesh at phase 9's shapes: graph and
   dists identical to phase 9's S = 8 one-process build; tile and prune
   seconds beside phase 9's, peak device memory, and the distance, top-k
   and merge launches.  (b) Phase 3's graph served at S = 8 (router
   "all", float32 and int8) over the mesh and with ``n_shards=8``, the
   first 2,000 queries at each beam after an untimed warm-up search each,
   the packing that runs first alternating from beam to beam: identical
   ids, recall@10, QPS and gather launches of both.  (c) Phase 8's fault
   drill through ``ServeLoop`` over (b)'s float32 packings, on a fake
   clock: over the group (each search, probe and tombstone sent through
   ``ShardMesh.broadcast``) and with ``n_shards=8`` the records (every
   result's ids, error, phase and operating point; counters, events,
   injected faults) are identical, every request is answered and the
   structured errors fall exactly on the poisoned rows; then over the
   group on the real clock (the same record), p50 / p99 latency and
   requests/s beside phase 8's drill.  One card cannot time a multi-card
   run: these are the collectives' costs on one rank.
11. the port's examples, the memory audit and the bounded-memory claim.
   (a) ``examples/torch_quickstart.py`` (recall@10 at least 0.9),
   ``torch_knn_graph.py`` (its own ``recall >= 0.90`` assert) and
   ``torch_rag_retrieve.py`` at float32 and int8, in this process at
   their default sizes: the build's leaf, hash and merge kernels and the
   search's gather kernel must launch.  (b)
   ``repro_torch.analysis.memory_audit.audit_all`` on the card: zero
   findings; each program's ledger, exponents, temp over its model and
   envelope price printed.  (c) The first 262,144 points built streamed
   at leaf k = 2 and 4, each stage's device peak read on its own: E about
   doubles (more than 1.5x, so edges kept across chunks would add more
   than one chunk's edge buffer, ``stats["peak_edge_bytes"]``), the
   streaming stage's peak holds its reservoir and one chunk's edges, and
   that peak, like the whole build's, grows by less than one chunk's edge
   buffer.
12. the static contract checker (``repro_torch.analysis.lint``) with every
   pass on the card, which must give zero findings: the kernel contracts
   (ptxas' registers, spills and shared memory against each kernel's
   ``__launch_bounds__`` at every swept shape, and each kernel held to its
   plain version over the edges of its wrapper's admitted range, on
   poisoned allocator blocks and on inputs 4 bytes past a 16-byte
   boundary), the hot-path audit (host syncs counted by the dispatch spy
   and by ``torch.cuda.set_sync_debug_mode``, beside the spy's count on the
   CPU; float64; donation; launch-shape stability), the mesh audit and
   the memory audit.  Logged: each kernel function's resources at its
   largest swept shape, each swept shape's error, the sync counts and each
   pass's seconds; the counters are set to 0 before it, and each row of
   the ``kernels`` line gains its ``phase12_launches``.
13. the roofline (``repro_torch.roofline``).  (a) Each program of the
   memory audit at its canonical point, and the mesh audit's sharded
   search, tile step and final prune at S = 8 on its one-process model,
   walked once under the dispatch walker and timed without it (CUDA
   events, the median of 5 runs after a warm-up, fresh inputs each):
   the compute, memory and collective terms of its work model, the
   dominant term, the bound, time over bound and dispatched over work.
   (b) The default ``build`` of all the points and phase 3's float32
   search at beams 32 / 64 / 128, walked once each, their bounds beside
   phase 3's build seconds and search seconds (no second timed build).
   (c) The hot-path audit's programs walked on the card and on the CPU on
   the same inputs (made on the CPU): equal operations by class, bytes
   and wire bytes; every kernel launch of every walk charged its work
   model (the walker's count equals the launch counters, set to 0 before
   each walk); no program's and no kernel row's time (phases 1, 4, 5, 6
   and 9) under its bound / 1.05; every record complete.  The roofline
   table (``markdown_table``) is printed; each row of the ``kernels``
   line gains its ``phase13_launches``.  Every kernel row's bound comes
   from its kernel's work model (``work`` beside its wrapper) and
   ``roofline.H100``.

The second-to-last line is the card's ``nvidia-smi`` name and power limit,
the line before it the ``kernels`` JSON, and the last line the result JSON.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

RECALL_FLOOR = 0.90          # recall@10 at beam 128, full size
BEAMS = (32, 64, 128)
# recall@10 a downcast serving copy may lose against float32, at every beam.
# bfloat16 is held to it.  int8 is held to check.sh step 5's 0.02 only in
# the report: on SIFT-like data (integers in [0, 255]) the reference's
# symmetric per-row scheme uses half the int8 range and loses more, in the
# JAX package as in the port (the CPU tests hold the two bit for bit).  The
# port's int8 path is held to exactness instead: card ids equal CPU ids.
RECALL_SLACK = {"int8": 0.02, "bfloat16": 0.01}
GATED = ("bfloat16",)
# phase 9: S emulated shards on one card, the tile (the largest power of
# two with two tiles in --n, at most 2^18) and level-0 leaders, the variants
# run at S, and the reference test's k-NN-graph recall floor
# (tests/test_system.py:107)
DIST_SHARDS = 8
DIST_TILE = 2 ** 18
DIST_L0 = 16
DIST_VARIANTS = ("quantized", "bf16leaf", "opt", "flat")
DIST_KNN_FLOOR = 0.85
# phase 10: the queries each mesh search serves (the first of phase 3's)
MESH_QUERIES = 2000


def log(*a) -> None:
    print(*a, flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def bound(work: dict) -> dict:
    """A kernel's row fields from its work model (``work`` beside its
    wrapper): its operations by class and bytes, and the least time the
    card could take for them (``roofline.H100``: the larger of the
    operations at their classes' peaks and the bytes at the memory rate)."""
    from repro_torch.roofline import H100

    return dict(ops=dict(work["ops"]), bytes=work["bytes"], **H100.bound(work))


def tf32_bound(work: dict) -> dict:
    """``bound`` of a 3xTF32 kernel's work (``leaf_topk``,
    ``pairwise_distance``), with its float32 products (a third of its TF32
    operations) and their bound on the CUDA cores in float32 beside it."""
    from repro_torch.roofline import H100

    flops = work["ops"]["tf32"] / 3.0
    return dict(bound(work), flops=flops, tf32_flops=work["ops"]["tf32"],
                bound_f32_cuda_core_ms=H100.bound(dict(work, ops={"f32": flops}))["bound_ms"])


def read_ms(nbytes: float) -> float:
    """Milliseconds to read ``nbytes`` at the card's memory rate."""
    from repro_torch.roofline import H100

    return H100.bound({"bytes": nbytes})["bound_ms"]


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
    run on the first chunk; the merge on the build's second and last merges
    (``merge_inputs``)."""
    import torch

    from repro_torch.analysis import contracts
    from repro_torch.core import sketch
    from repro_torch.core.leaf import emit_knn_edges
    from repro_torch.kernels import edge_hash, leaf_knn

    dev = x.device
    d = x.shape[1]
    t0 = time.perf_counter()
    inputs = phase1_inputs(x, seed)
    params, padded, chunk, sk = (inputs[k] for k in ("params", "padded", "chunk", "sketches"))
    k = params.leaf.k
    ids = torch.from_numpy(padded[:chunk]).to(dev)
    sizes = (ids >= 0).sum(dim=1).double()
    log("phase1 partition", json.dumps(dict(
        seconds=time.perf_counter() - t0, n_leaves=int(padded.shape[0]),
        chunk_leaves=chunk, chunk_leaf_size_mean=float(sizes.mean()))))
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
    check(bool((err <= contracts.tf32_limit(hd[fin], max_sq)).all()),
          f"leaf_topk Gaussian dists beyond tolerance (max {float(err.max())})")
    err = float(err.max())
    idx_agree = float((gi == hi).float().mean())
    del gi, gd, hi, hd, fin
    wide = leaf_wide(x, ids)
    # the chunk's work (``leaf_knn.work``): the kernel keeps the float32
    # result with three TF32 products per f32 product (3xTF32), so its
    # bound is those at the TF32 peak; the f32 CUDA-core bound of the same
    # products is reported beside it
    out["leaf_topk"] = dict(
        max_abs_err=err, gaussian_idx_agreement=idx_agree,
        tolerance=contracts.TF32_TOL,
        ms=cuda_ms(lambda: leaf_knn.leaf_topk(x, ids, k), 10),
        plain_ms=cuda_ms(lambda: leaf_knn.leaf_topk_plain(x, ids, k, block=16), 2),
        **tf32_bound(leaf_knn.work(x, ids, k)), **wide)
    log("phase1 leaf_topk", json.dumps(out["leaf_topk"]))

    # edge hashes: the chunk's bidirected edges (2 * chunk * C * k entries)
    # on the build's sketches (its seeded hyperplanes, m = 12)
    src, dst, _ = emit_knn_edges(ids, ki, kd)
    del ki, kd
    e = src.numel()
    kh = edge_hash.edge_hashes(sk, src, dst)
    check(torch.equal(kh, edge_hash.edge_hashes_plain(sk, src, dst)), "edge_hashes != plain")
    skg = sketch.sketch(xg, inputs["hyperplanes"]).contiguous()
    check(torch.equal(edge_hash.edge_hashes(skg, src, dst),
                      edge_hash.edge_hashes_plain(skg, src, dst)),
          "edge_hashes != plain on Gaussian sketches")
    del kh, skg
    out["edge_hashes"] = dict(
        max_abs_err=0.0, tolerance=contracts.EXACT, edges=e,
        valid_share=float((src >= 0).float().mean()),
        ms=cuda_ms(lambda: edge_hash.edge_hashes(sk, src, dst), 20),
        plain_ms=cuda_ms(lambda: edge_hash.edge_hashes_plain(sk, src, dst), 3),
        **bound(edge_hash.work(sk, src, dst)))
    log("phase1 edge_hashes", json.dumps(out["edge_hashes"]))
    del src, dst

    # merge: the build's second merge (early in the stream) and its last
    pairs = merge_inputs(x, inputs)
    del padded, inputs
    out["merge_sorted_reservoirs"] = merge_stats(pairs["early"])
    out["merge_sorted_reservoirs"]["late"] = merge_stats(pairs["late"])
    log("phase1 merge_sorted_reservoirs", json.dumps(out["merge_sorted_reservoirs"]))
    return out


def leaf_wide(x, ids) -> dict:
    """The leaf top-k at k = 16 (k > 8: its lists in shared memory) on the
    first 2,048 leaves of the chunk ``ids``, bit-exact against its plain
    version on the integer data; its time beside the default k's on the
    same leaves."""
    import torch

    from repro_torch.kernels import leaf_knn

    k = 16
    part = ids[:2048].contiguous()
    got = leaf_knn.leaf_topk(x, part, k)
    want = leaf_knn.leaf_topk_plain(x, part, k, block=16)
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"leaf_topk at k = {k} != plain on integer data")
    del got, want
    return {f"k{k}_leaves": int(part.shape[0]),
            f"k{k}_ms": cuda_ms(lambda: leaf_knn.leaf_topk(x, part, k), 5),
            f"k{k}_default_k_ms_same_leaves": cuda_ms(lambda: leaf_knn.leaf_topk(x, part, 2), 5)}


def phase1_inputs(x, seed: int) -> dict:
    """What the full-size build of ``x`` starts its stream from:
    ``params`` (the defaults, seeded), ``padded`` (its partition, leaf ids
    [leaves, c_max] on the host), ``chunk`` (leaves a stream chunk),
    ``hyperplanes`` and ``sketches`` (its seeded sketches of ``x``)."""
    import dataclasses

    import torch

    from repro_torch.core import pipnn, sketch
    from repro_torch.core.rbc import partition_padded

    n, d = x.shape
    params = pipnn.PiPNNParams(seed=seed)
    padded = partition_padded(x, dataclasses.replace(params.rbc, seed=seed))
    chunk = pipnn._stream_chunk_leaves(params.leaf, n, params.l_max, *padded.shape)
    hp = torch.from_numpy(sketch.make_hyperplanes(seed, params.hash_bits, d)).to(x.device)
    return dict(params=params, padded=padded, chunk=chunk, hyperplanes=hp,
                sketches=sketch.sketch(x, hp).contiguous())


def merge_inputs(x, inputs: dict) -> dict:
    """The merge's inputs as the full-size build's stream gives them
    (``inputs`` from ``phase1_inputs``), each chunk's edges reduced by
    ``hashprune_flat`` as the build reduces them: ``early`` = the
    reservoirs of the first two chunks (the build's second merge),
    ``late`` = the reservoir after folding every chunk but the last with
    the kernel, and the last chunk's reservoir (its last merge)."""
    import torch

    from repro_torch.core import pipnn
    from repro_torch.core.hashprune import (hashprune_flat, merge_segmented_edges,
                                            reservoir_init)
    from repro_torch.core.leaf import iter_leaf_id_chunks

    params, padded, chunk, sk = (inputs[k] for k in ("params", "padded", "chunk", "sketches"))
    n, l_max = x.shape[0], params.l_max
    chunks = list(iter_leaf_id_chunks(torch.from_numpy(padded).to(x.device), chunk))

    def edges(leaf_ids):
        return pipnn._chunk_edges(x, sk, leaf_ids, leaf=params.leaf)[0]

    def reservoir(leaf_ids):
        return hashprune_flat(*edges(leaf_ids), n_points=n, l_max=l_max)

    early = (reservoir(chunks[0]), reservoir(chunks[1]) if len(chunks) > 1
             else reservoir_init(n, l_max, x.device))
    res = reservoir_init(n, l_max, x.device)
    for leaf_ids in chunks[:-1]:
        res = merge_segmented_edges(*res, *edges(leaf_ids))
    return dict(early=early, late=(res, reservoir(chunks[-1])), chunks=len(chunks))


def merge_stats(pair) -> dict:
    """The merge kernel on one input pair: bit-exact against its plain
    version, kernel and plain times, live counts, and the bound of the
    bytes these rows need (``segmented_merge.work``: each id row up to its
    first -1, the live prefixes and the written slots, in 32-byte
    sectors; B's first id alone where B is empty)."""
    import torch

    from repro_torch.analysis import contracts
    from repro_torch.kernels import segmented_merge

    a, b = pair
    n = a.ids.shape[0]
    want = segmented_merge.merge_sorted_reservoirs_plain(*a, *b)
    got = segmented_merge.merge_sorted_reservoirs(*(t.clone() for t in a), *b)
    check(all(torch.equal(g, w) for g, w in zip(got, want)), "merge != plain")
    work = segmented_merge.work(a.ids, b.ids, want[0])
    del got
    fresh_a = [None]

    def fresh():
        fresh_a[0] = tuple(t.clone() for t in a)

    return dict(
        max_abs_err=0.0, tolerance=contracts.EXACT, valid_slots_per_row=[
            float((a.ids >= 0).sum() / n), float((b.ids >= 0).sum() / n),
            float((want[0] >= 0).sum() / n)],
        rows_b_empty=float(((b.ids >= 0).sum(1) == 0).float().mean()),
        ms=cuda_ms(lambda: segmented_merge.merge_sorted_reservoirs(*fresh_a[0], *b), 10,
                   setup=fresh),
        plain_ms=cuda_ms(lambda: segmented_merge.merge_sorted_reservoirs_plain(*a, *b), 2),
        **bound(work))


def phase_gather(servings, q, gauss_x, gauss_q, truth) -> dict:
    """Phase 4: the search's kernels against their plain versions on the
    blocks the search gives them: Q queries, and for each the graph rows of
    E = 4 expanded points (C = 4 * 64 ids, -1 where a row is short).  The
    expanded points are each query's 4 true nearest neighbours, as in the
    search's later hops.  The float32 kernel and its bfloat16 instantiation
    run on the float32 and bfloat16 serving copies, the int8 kernel on the
    int8 packing; each also on the Gaussian mixture the data is made from."""
    import torch

    from repro_torch.analysis import contracts
    from repro_torch.core.metrics import point_norms
    from repro_torch.kernels import gather_distance, gather_distance_int8
    from repro_torch.kernels.gather_distance_int8 import quantize_symmetric

    sv, sv8, sv16 = servings["float32"], servings["int8"], servings["bfloat16"]
    dev = sv.points.device
    x, nrm = sv.points, sv.norms
    nq, d = q.shape
    expand = torch.from_numpy(truth[:, :4]).to(dev).long()
    gids = sv.graph[expand].reshape(nq, -1).contiguous()          # [Q, 256]
    xg, qg = torch.from_numpy(gauss_x).to(dev), torch.from_numpy(gauss_q).to(dev)
    xg16 = xg.to(torch.bfloat16)
    sq = (xg * xg).sum(dim=1)
    scale = (qg * qg).sum(dim=1)[:, None] + sq[gids.clamp_min(0).long()]
    errs = {}
    for metric in ("l2", "mips", "cosine"):
        nrm_m, nrmg = point_norms(x, metric), point_norms(xg, metric)
        for name, pts, pts_g in (("float32", x, xg), ("bfloat16", sv16.points, xg16)):
            got = gather_distance.gather_distance(pts, nrm_m, q, gids, metric)
            want = gather_distance.gather_distance_plain(pts, nrm_m, q, gids, metric)
            if metric != "cosine":   # cosine divides by a rounded sqrt
                check(torch.equal(got, want), f"gather_distance {name} {metric} != plain "
                      "on integers")
            gg = gather_distance.gather_distance(pts_g, nrmg, qg, gids, metric)
            gw = gather_distance.gather_distance_plain(pts_g, nrmg, qg, gids, metric)
            fin = torch.isfinite(gw)
            check(torch.equal(torch.isfinite(gg), fin),
                  f"gather_distance {name} {metric} inf pattern")
            # l2 and mips: a few ulps of |q|^2 + |p|^2 (the expansion cancels
            # for near points); cosine is O(1)
            diff = (gg[fin] - gw[fin]).abs()
            check(bool((diff <= contracts.gather_limit(gw[fin], scale[fin], metric)).all()),
                  f"gather_distance {name} {metric} Gaussian beyond tolerance "
                  f"(max {float(diff.max())})")
            if metric == "l2":
                errs[name] = float(diff.max())
        # int8: the serving packing of the integer data and the packing of
        # the Gaussian data, each with the exact norms of its float32 points
        p8g, scg = quantize_symmetric(xg)
        for tag, (p8, sc, nr, qq) in (("integer", (sv8.points, sv8.scales, nrm_m, q)),
                                      ("gaussian", (p8g, scg, nrmg, qg))):
            args = (p8, sc, nr, qq, point_norms(qq, metric), gids, metric)
            check(torch.equal(gather_distance_int8.gather_distance_int8(*args),
                              gather_distance_int8.gather_distance_int8_plain(*args)),
                  f"gather_distance_int8 {metric} != plain on {tag} data")
        del p8g, scg
    del xg, qg, xg16, sq, scale
    # the work (``gather_distance.work``, ``gather_distance_int8.work``): a
    # row and a norm (and for int8 a scale) for each distinct valid id, read
    # once (-1 ids read nothing), every id and output slot, and the queries
    # (and for int8 their norm terms)
    valid = int((gids >= 0).sum())
    rows = torch.unique(gids[gids >= 0]).numel()
    out = dict(
        max_abs_err=errs["float32"], tolerance=contracts.GATHER_TOL,
        valid_share=valid / gids.numel(), distinct_rows=rows,
        ms=cuda_ms(lambda: gather_distance.gather_distance(x, nrm, q, gids), 20),
        plain_ms=cuda_ms(lambda: gather_distance.gather_distance_plain(x, nrm, q, gids), 3),
        library=None, library_ms=None, **bound(gather_distance.work(x, nrm, q, gids)),
        # every valid slot's row read from device memory, with no reuse
        # across queries: the most the kernel can gain without an order of
        # queries chosen by the caller
        no_reuse_ms=read_ms(valid * d * 4))
    x16 = sv16.points
    b16 = bound(gather_distance.work(x16, nrm, q, gids))
    out.update(
        bf16_max_abs_err=errs["bfloat16"],
        bf16_ms=cuda_ms(lambda: gather_distance.gather_distance(x16, nrm, q, gids), 20),
        bf16_plain_ms=cuda_ms(
            lambda: gather_distance.gather_distance_plain(x16, nrm, q, gids), 3),
        bf16_bound_ms=b16["bound_ms"], bf16_bytes=b16["bytes"],
        bf16_no_reuse_ms=read_ms(valid * d * 2))
    log("phase4 gather_distance", json.dumps(out))
    q_norms = point_norms(q)
    args8 = (sv8.points, sv8.scales, sv8.norms, q, q_norms, gids)
    out8 = dict(
        max_abs_err=0.0, tolerance=contracts.GATHER8_TOL,
        valid_share=valid / gids.numel(), distinct_rows=rows,
        ms=cuda_ms(lambda: gather_distance_int8.gather_distance_int8(*args8), 20),
        plain_ms=cuda_ms(lambda: gather_distance_int8.gather_distance_int8_plain(*args8), 3),
        library=None, library_ms=None, **bound(gather_distance_int8.work(*args8)),
        no_reuse_ms=read_ms(valid * d))
    log("phase4 gather_distance_int8", json.dumps(out8))
    return {"gather_distance": out, "gather_distance_int8": out8}


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
    quant = {}
    for dtype in ("int8", torch.bfloat16):
        a = repro_torch.search(gpu, x, q, k=10, beam=64, dtype=dtype, device=dev)
        b = repro_torch.search(cpu, x, q, k=10, beam=64, dtype=dtype, device="cpu",
                               query_chunk=250)
        check(np.array_equal(a, b), f"{dtype} search differs between card and CPU")
        quant[str(dtype)] = recall_at_k(a, truth)
    static = phase_parity_static(x, hp, seed, dev)
    xg, qg = make_vectors(cfg), make_queries(cfg, n_queries)
    gidx = repro_torch.build(xg, device=dev)
    truth_g = brute_force_knn(torch.from_numpy(xg).to(dev), torch.from_numpy(qg).to(dev), 10)
    gaussian = {str(dtype): recall_at_k(repro_torch.search(gidx, xg, qg, k=10, beam=64,
                                                           dtype=dtype, device=dev), truth_g)
                for dtype in (None, "int8", torch.bfloat16)}
    log("phase2", json.dumps(dict(n=n, queries=n_queries, graph_identical=same,
                                  start=gpu.start, recall_at_10_beam64=r_gpu,
                                  quantized_recall_at_10_beam64=quant,
                                  gaussian_recall_at_10_beam64=gaussian,
                                  build_s_card=t_gpu, build_s_cpu=t_cpu,
                                  stats=gpu.stats, static=static)))


def check_index(index) -> None:
    """The graph invariants of a build: every point in some leaf, ids in
    range, no self loops, degree at most 64."""
    import torch

    g = index.graph
    n = g.shape[0]
    check(index.stats["partition_uncovered"] == 0, "points left out of every leaf")
    check(bool(((g >= -1) & (g < n)).all()), "graph ids out of range")
    rows = torch.arange(n, device=g.device)[:, None]
    check(not bool((g == rows).any()), "graph has self loops")
    check(g.shape[1] <= 64, "degree above 64")


def phase_parity_static(x, hp, seed: int, dev) -> dict:
    """Phase 2's static carve: its leaf matrix (through the distance and
    top-k kernels on the card) and the static build's graph, card against
    CPU, must be identical on the integer data."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.core.rbc import RBCParams, partition_padded

    rp = RBCParams(execution="static", seed=seed)
    out = {}
    mats = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        xt = torch.from_numpy(x).to(d)
        if d.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        mats[name] = partition_padded(xt, rp)
        out[f"partition_s_{name}"] = time.perf_counter() - t0
    check(np.array_equal(mats["card"], mats["cpu"]), "static leaf matrices differ between "
          f"card and CPU ({mats['card'].shape} vs {mats['cpu'].shape})")
    params = repro_torch.PiPNNParams(rbc=rp, seed=seed)
    t0 = time.perf_counter()
    gpu = repro_torch.build(x, params, hyperplanes=hp, device=dev)
    out["build_s_card"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = repro_torch.build(x, params, hyperplanes=hp, device="cpu")
    out["build_s_cpu"] = time.perf_counter() - t0
    check(gpu.stats["partition_execution"] == cpu.stats["partition_execution"] == "static",
          "the static build did not carve statically")
    check(gpu.start == cpu.start, f"static start differs: {gpu.start} vs {cpu.start}")
    same = torch.equal(gpu.graph.cpu(), cpu.graph)
    check(same, f"static graphs differ in {int((gpu.graph.cpu() != cpu.graph).sum())} slots")
    check(torch.equal(gpu.dists.cpu(), cpu.dists), "static graph dists differ")
    out.update(leaf_matrix_identical=True, graph_identical=same,
               leaf_matrix_shape=list(mats["card"].shape),
               stats={k: gpu.stats[k] for k in ("n_leaves", "point_repeat", "pad_ratio",
                                                 "partition_uncovered")})
    return out


def _searches(index, x, q, truth, dev, dtype=None, tag: str = "phase3") -> dict:
    """The full query set at every beam through ``repro_torch.search``."""
    import torch

    import repro_torch
    from repro_torch.core.beam_search import recall_at_k

    per_beam = {}
    for beam in BEAMS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, tel = repro_torch.search(index, x, q, k=10, beam=beam, dtype=dtype,
                                      with_stats=True, device=dev)
        dt = time.perf_counter() - t0
        per_beam[beam] = dict(recall_at_10=recall_at_k(ids, truth), qps=q.shape[0] / dt,
                              seconds=dt, mean_hops=float(tel["hops"].mean()),
                              mean_dist_comps=float(tel["dist_comps"].mean()),
                              converged=float(tel["converged"].mean()))
        log(f"{tag} search", "float32" if dtype is None else str(dtype), beam,
            json.dumps(per_beam[beam]))
    return per_beam


def _path_launches(name: str, needed: tuple[str, ...]) -> dict:
    """The launch counters after one path; each kernel in ``needed`` must
    have run on it."""
    from repro_torch import kernels

    launches = kernels.launch_counts()
    log("launches", name, json.dumps(launches))
    for k in needed:
        check(launches[k] > 0, f"kernel {k} was not launched on the {name} path")
    return launches


def phase_full(x, q, seed: int, dev) -> dict:
    """Phase 3: the main paths at full size, through the public entry
    points: the build, then search with float32, int8 and bfloat16
    serving copies.  The launch counters are set to 0 before each path."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch import kernels
    from repro_torch.core import pipnn
    from repro_torch.core.beam_search import brute_force_knn
    from repro_torch.core.pipnn import serving_index
    from repro_torch.core.serving import ServingIndex

    n = x.shape[0]
    # Stage 1's leaf matrix, recorded on its way through for phase 7
    padded = []
    real_partition = pipnn.partition_padded
    pipnn.partition_padded = lambda *a, **kw: padded.append(real_partition(*a, **kw)) or padded[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        index = repro_torch.build(x, repro_torch.PiPNNParams(seed=seed), device=dev)
        wall = time.perf_counter() - t0
    finally:
        pipnn.partition_padded = real_partition
    build_peak = torch.cuda.max_memory_allocated()
    launches = {"build": _path_launches("build", ("leaf_knn", "edge_hash",
                                                  "segmented_merge"))}
    st = index.stats
    check_index(index)
    log("phase3 build", json.dumps(dict(
        n=n, wall_s=wall, timings=index.timings, peak_device_bytes=build_peak,
        avg_degree=index.average_degree(),
        stats={k: st[k] for k in ("n_leaves", "point_repeat", "pad_ratio",
                                   "n_candidate_edges", "stream_chunk_leaves",
                                   "leaf_size_mean", "partition_uncovered")})))

    xt = torch.from_numpy(x).to(dev)
    truth = brute_force_knn(xt, torch.from_numpy(q).to(dev), 10, chunk=256)
    del xt
    searches, servings = {}, {}
    for name, dtype, kernel in (("float32", None, "gather_distance"),
                                ("int8", "int8", "gather_distance_int8"),
                                ("bfloat16", torch.bfloat16, "gather_distance")):
        kernels.reset_launch_counts()
        # packs the ServingIndex (cached on the index, one dtype at a time)
        repro_torch.search(index, x, q[:100], k=10, beam=32, dtype=dtype, device=dev)
        servings[name] = serving_index(index, x, dtype=dtype, device=dev)
        searches[name] = _searches(index, x, q, truth, dev, dtype)
        launches[name] = _path_launches(f"{name} search", (kernel,))
        log("phase3 serving", name, json.dumps(dict(
            device_bytes=servings[name].device_bytes(),
            points_dtype=str(servings[name].points.dtype))))
    check(searches["float32"][128]["recall_at_10"] >= RECALL_FLOOR,
          f"recall@10 at beam 128 below {RECALL_FLOOR}")
    for name, slack in RECALL_SLACK.items():
        for beam in BEAMS:
            r, r32 = (searches[k][beam]["recall_at_10"] for k in (name, "float32"))
            log("phase3 recall rule", name, beam, json.dumps(dict(
                recall=r, float32=r32, gap=r32 - r, slack=slack, met=r >= r32 - slack,
                gated=name in GATED)))
            if name in GATED:
                check(r >= r32 - slack, f"{name} recall@10 {r} at beam {beam} below "
                      f"float32's {r32} - {slack}")
    # the int8 path at full size against the plain version on the CPU
    sv8 = servings["int8"]
    cpu8 = ServingIndex(graph=sv8.graph.cpu(), points=sv8.points.cpu(), norms=sv8.norms.cpu(),
                        start=sv8.start, metric=sv8.metric, scales=sv8.scales.cpu())
    a = sv8.search(q[:500], k=10, beam=32)
    check(np.array_equal(a, cpu8.search(q[:500], k=10, beam=32)),
          "int8 search differs between card and CPU at full size")
    return dict(launches=launches, peak=build_peak, truth=truth, servings=servings,
                searches=searches, timings=index.timings, index=index, padded=padded[0],
                wall=wall)


def gaussian_pairwise(dist, xg, pos, metric: str) -> dict:
    """``dist(a, b)`` ([1, M, N] float32) on the Gaussian points ``xg``
    against the rows ``pos`` of them (phase 5's leaders), held against
    ``pairwise_distance_plain`` to phase 1's tolerance
    (``contracts.tf32_limit``): ``max_abs_err``, ``within_tolerance`` and
    the largest error's share of its limit (``worst_share``)."""
    from repro_torch.analysis import contracts
    from repro_torch.kernels import distance

    a, b = xg[None], xg[pos][None]
    want = distance.pairwise_distance_plain(a, b, metric)
    err = dist(a, b).sub_(want).abs_()
    max_err = float(err.max())
    max_sq = float((xg * xg).sum(dim=1).max())
    share = float(err.div_(contracts.tf32_limit(want, max_sq)).max())
    return dict(max_abs_err=max_err, within_tolerance=share <= 1.0, worst_share=share)


def phase5_inputs(x_np, seed: int) -> dict:
    """Stage 1's root subproblem of the full-size build of ``x_np``: the
    points on the card (``x``), the leaders ``rbc.ball_carve`` draws first
    (the same seeded ``rng.choice``: positions ``pos``, rows ``leaders``),
    ``f`` = fanout(0) and the metric."""
    import numpy as np
    import torch

    from repro_torch.core.rbc import RBCParams

    p = RBCParams(seed=seed)
    xt = torch.from_numpy(x_np).cuda()
    n = xt.shape[0]
    rng = np.random.default_rng(p.seed)
    n_leaders = int(np.clip(round(p.p_samp * n), 2, p.leader_cap))
    pos = torch.from_numpy(rng.choice(n, size=n_leaders, replace=False)).cuda()
    return dict(x=xt, pos=pos, leaders=xt[pos], f=min(p.fanout_at(0), n_leaders),
                metric=p.metric)


def phase_leader(x_np, gauss, seed: int) -> dict:
    """Phase 5: Stage 1's root subproblem of the full-size build
    (``phase5_inputs``), through ``leader_assign(use_kernels=True)`` as one
    batch, held against the default ``topf`` route, and both routes timed.
    The distance kernel is also held on ``gauss`` (the Gaussian points
    ``x_np`` is made from) against the same leaders' rows of it
    (``gaussian_pairwise``).  Then the int8 distance kernel on the
    ``quantize_symmetric`` packing of the same points and leaders."""
    import torch

    from repro_torch import kernels
    from repro_torch.analysis import contracts
    from repro_torch.core.leader_assign import leader_assign
    from repro_torch.core.rbc import RBCParams, carve_chunks
    from repro_torch.kernels import distance, topk
    from repro_torch.kernels.gather_distance_int8 import quantize_symmetric

    inputs = phase5_inputs(x_np, seed)
    xt, pos, leaders, f, metric = (inputs[k] for k in ("x", "pos", "leaders", "f", "metric"))
    n, d = xt.shape
    n_leaders = leaders.shape[0]
    out = {}

    kernels.reset_launch_counts()
    ids = leader_assign(xt, leaders, f, metric=metric, use_kernels=True)
    launches = _path_launches("leader assignment", ("pairwise_distance", "rowwise_topk"))
    check(torch.equal(ids, leader_assign(xt, leaders, f, metric=metric)),
          "kernel-routed leader_assign != topf route")
    del ids
    # the whole route each way: the kernels, and the default route (one
    # matrix product, then topf's f argmin passes), which the build's Stage
    # 1 runs on 4096-row blocks (core/rbc.py::_assign_device)
    for name, kw in (("kernels", dict(use_kernels=True)), ("topf", {})):
        log("phase5 route", name, json.dumps(dict(
            call=f"leader_assign(x, leaders, {f}, metric={metric!r}"
                 + (", use_kernels=True)" if kw else ")"),
            rows=n, leaders=n_leaders,
            ms=cuda_ms(lambda: leader_assign(xt, leaders, f, metric=metric, **kw), 5))))
        torch.cuda.empty_cache()

    a, b = xt[None], leaders[None]
    dk = distance.pairwise_distance(a, b, metric)
    dp = distance.pairwise_distance_plain(a, b, metric)
    check(torch.equal(dk, dp), "pairwise_distance != plain on integer data")
    del dp
    # on integer data the low TF32 parts are 0: only non-integer data shows
    # whether the kernel keeps the float32 result
    xg = torch.from_numpy(gauss).cuda()
    gs = gaussian_pairwise(lambda a, b: distance.pairwise_distance(a, b, metric), xg, pos,
                           metric)
    del xg
    torch.cuda.empty_cache()
    check(gs["within_tolerance"], "pairwise_distance Gaussian dists beyond tolerance "
          f"(max {gs['max_abs_err']}, {gs['worst_share']} of its limit)")
    # the kernel forms each product as three TF32 products on the tensor
    # cores (3xTF32): its bound is those at the TF32 peak; the f32
    # CUDA-core bound of the same products stands beside it
    out["pairwise_distance"] = dict(
        max_abs_err=gs["max_abs_err"], gaussian_worst_share_of_tolerance=gs["worst_share"],
        tolerance=contracts.TF32_TOL + " (integer data below 2048, every sum below "
        "2^24)",
        shape=[1, n, n_leaders, d], launches=launches["pairwise_distance"],
        ms=cuda_ms(lambda: distance.pairwise_distance(a, b, metric), 5),
        plain_ms=cuda_ms(lambda: distance.pairwise_distance_plain(a, b, metric), 2),
        library="torch.cdist (the square root of the same matrix)",
        library_ms=cuda_ms(lambda: torch.cdist(a, b), 3),
        **tf32_bound(distance.work(a, b, metric)))
    log("phase5 pairwise_distance", json.dumps(out["pairwise_distance"]))

    got, want = topk.rowwise_topk(dk, f), topk.rowwise_topk_plain(dk, f)
    check(all(torch.equal(g, w) for g, w in zip(got, want)), "rowwise_topk != plain")
    del got, want
    out["rowwise_topk"] = dict(
        max_abs_err=0.0, tolerance=contracts.TOPK_TOL, k=f,
        launches=launches["rowwise_topk"],
        ms=cuda_ms(lambda: topk.rowwise_topk(dk, f), 10),
        plain_ms=cuda_ms(lambda: topk.rowwise_topk_plain(dk, f), 2),
        library="torch.topk(largest=False)",
        library_ms=cuda_ms(lambda: torch.topk(dk, f, largest=False), 10),
        **bound(topk.work(dk, f)))
    # the static carve's level 0 selects f0r = fanout(0) + bucket_spill of
    # the same leaders
    k0 = carve_chunks(n, RBCParams(seed=seed))["f0r"]
    got, want = topk.rowwise_topk(dk, k0), topk.rowwise_topk_plain(dk, k0)
    check(all(torch.equal(g, w) for g, w in zip(got, want)), f"rowwise_topk != plain at k = {k0}")
    del got, want
    out["rowwise_topk"]["level0"] = dict(
        k=k0, ms=cuda_ms(lambda: topk.rowwise_topk(dk, k0), 10),
        plain_ms=cuda_ms(lambda: topk.rowwise_topk_plain(dk, k0), 2),
        library_ms=cuda_ms(lambda: torch.topk(dk, k0, largest=False), 10),
        **bound(topk.work(dk, k0)))
    log("phase5 rowwise_topk", json.dumps(out["rowwise_topk"]))
    del dk
    torch.cuda.empty_cache()

    p8, _ = quantize_symmetric(xt)
    a8, b8 = p8[None], p8[pos][None]
    del xt, inputs
    kernels.reset_launch_counts()
    dk = distance.pairwise_distance_int8(a8, b8)
    launches = _path_launches("int8 pairwise", ("pairwise_distance_int8",))
    check(torch.equal(dk, distance.pairwise_distance_int8_plain(a8, b8)),
          "pairwise_distance_int8 != plain")
    del dk
    # torch._int_mm forms only the products (no norms, no expansion): a
    # yardstick for the store-bound floor, not the same function
    a0, b0t = a8[0], b8[0].T
    out["pairwise_distance_int8"] = dict(
        max_abs_err=0.0, tolerance=contracts.INT32_TOL,
        launches=launches["pairwise_distance_int8"],
        ms=cuda_ms(lambda: distance.pairwise_distance_int8(a8, b8), 5),
        plain_ms=cuda_ms(lambda: distance.pairwise_distance_int8_plain(a8, b8), 2),
        library=None, library_ms=None, cross_term_library="torch._int_mm",
        cross_term_library_ms=cuda_ms(lambda: torch._int_mm(a0, b0t), 5),
        **bound(distance.work_int8(a8, b8)))
    log("phase5 pairwise_distance_int8", json.dumps(out["pairwise_distance_int8"]))
    return out


def static_steps(xt, p) -> tuple:
    """``rbc.ball_carve_device``'s steps one by one on the points ``xt``,
    the card synchronised after each: (the padded leaf matrix, seconds per
    step, counts, the level-1 inputs)."""
    import torch

    from repro_torch.core import rbc
    from repro_torch.core.leader_assign import leader_assign

    n = xt.shape[0]
    sh = rbc.carve_chunks(n, p)
    secs = {}

    def lap(name, t0):
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return time.perf_counter()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lead0 = torch.from_numpy(rbc.static_leaders(n, p)).to(xt.device)
    t0 = lap("leaders", t0)
    bpid, bval = rbc.static_level0(xt, lead0, sh, p.metric)
    t0 = lap("level0", t0)
    lead1, lead1_ok = rbc.static_level1_leaders(bpid, bval, sh)
    a1 = rbc.static_level1(xt, bpid, bval, lead1, lead1_ok, sh, p.metric)
    t0 = lap("level1", t0)
    leaf_ids = rbc.static_leaf_routing(a1, bpid, sh, p.c_max)
    t0 = lap("leaf_routing", t0)
    kept = leaf_ids[(leaf_ids >= 0).any(dim=1)]
    t0 = lap("filter", t0)
    padded = rbc.salvage(kept, n, p.c_max)
    secs["copy_and_salvage"] = time.perf_counter() - t0
    secs["total"] = sum(secs.values())
    leaders = xt[lead0.long()]
    blk = rbc._BLOCK_ROWS
    # level 0's assignment alone (its routing is the rest of "level0")
    secs["level0_assign"] = 1e-3 * cuda_ms(lambda: [
        leader_assign(xt[s:s + blk], leaders, sh["f0r"], metric=p.metric, use_kernels=True)
        for s in range(0, n, blk)], 3)
    counts = dict(
        shapes=sh, block_rows=blk,
        level1_buckets_a_block=rbc.static_level1_block_buckets(sh),
        level0_placements=n * sh["f0r"], level0_kept=int(bval.sum()),
        full_buckets=int(bval.all(dim=1).sum()), level1_placements=int((a1 >= 0).sum()),
        leaf_kept=int((leaf_ids >= 0).sum()), full_leaves=int((leaf_ids >= 0).all(dim=1).sum()),
        nonempty_leaves=int(kept.shape[0]), salvage_leaves=int(padded.shape[0] - kept.shape[0]),
        salvaged_points=int((padded[kept.shape[0]:] >= 0).sum()))
    return padded, secs, counts, (bpid, bval, lead1, lead1_ok, sh)


def level1_kernels(x, gauss, level1) -> dict:
    """The distance and top-k kernels on the first level-1 block of the
    static carve (its buckets' points against their 80 leaders, masked as
    ``leader_assign`` masks them), each against its plain version, with
    kernel, plain and library times and bounds."""
    import torch

    from repro_torch.analysis import contracts
    from repro_torch.core import rbc
    from repro_torch.kernels import distance, topk

    bpid, bval, lead1, lead1_ok, sh = level1
    nb, f1 = rbc.static_level1_block_buckets(sh), sh["f1"]
    ids, pok, lids, lok = bpid[:nb], bval[:nb], lead1[:nb], lead1_ok[:nb]
    pts, lds = x[ids.clamp_min(0).long()], x[lids.clamp_min(0).long()]
    b, m, d = pts.shape
    nl = lds.shape[1]
    dk = distance.pairwise_distance(pts, lds)
    check(torch.equal(dk, distance.pairwise_distance_plain(pts, lds)),
          "pairwise_distance != plain at the level-1 shape")
    xg = torch.from_numpy(gauss).to(x.device)
    pg, lg = xg[ids.clamp_min(0).long()], xg[lids.clamp_min(0).long()]
    want = distance.pairwise_distance_plain(pg, lg)
    err = (distance.pairwise_distance(pg, lg) - want).abs()
    max_sq = float((xg * xg).sum(dim=1).max())
    check(bool((err <= contracts.tf32_limit(want, max_sq)).all()),
          f"pairwise_distance Gaussian dists beyond tolerance at the level-1 shape "
          f"(max {float(err.max())})")
    del xg, pg, lg, want
    tc = tf32_bound(distance.work(pts, lds))
    out = {"pairwise_distance": dict(
        shape=[b, m, nl, d], max_abs_err=float(err.max()),
        ms=cuda_ms(lambda: distance.pairwise_distance(pts, lds), 20),
        plain_ms=cuda_ms(lambda: distance.pairwise_distance_plain(pts, lds), 3),
        library="torch.cdist", library_ms=cuda_ms(lambda: torch.cdist(pts, lds), 5),
        bound_ms=tc["bound_ms"], bound_by=tc["bound_by"], tf32_flops=tc["tf32_flops"],
        bytes=tc["bytes"])}
    inf = torch.full((), float("inf"), device=x.device)
    dm = torch.where(pok[:, :, None], torch.where(lok[:, None, :], dk, inf), inf).contiguous()
    got, want = topk.rowwise_topk(dm, f1), topk.rowwise_topk_plain(dm, f1)
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          "rowwise_topk != plain at the level-1 shape")
    out["rowwise_topk"] = dict(
        shape=[b, m, nl], k=f1, max_abs_err=0.0, empty_slots=float((got[0] < 0).float().mean()),
        ms=cuda_ms(lambda: topk.rowwise_topk(dm, f1), 20),
        plain_ms=cuda_ms(lambda: topk.rowwise_topk_plain(dm, f1), 3),
        library="torch.topk(largest=False)",
        library_ms=cuda_ms(lambda: torch.topk(dm, f1, largest=False), 20),
        **bound(topk.work(dm, f1)))
    return out


def phase_static(x_np, q_np, gauss, seed: int, dev, worklist: dict) -> dict:
    """Phase 6: Stage 1's static carve at full size.  The partition alone,
    static and worklist (``"device"``) in turns; the static carve step by
    step; the distance and top-k kernels at its level-1 shape; then the
    static build and its float32 searches through the public entry points,
    the launch counters set to 0 before each path.  ``worklist`` is phase
    3's result (the default build's recall)."""
    import dataclasses

    import numpy as np
    import torch

    import repro_torch
    from repro_torch import kernels
    from repro_torch.core import rbc

    n = x_np.shape[0]
    xt = torch.from_numpy(x_np).to(dev)
    p = rbc.RBCParams(seed=seed)
    part = {"static": [], "device": []}
    for mode in ("static", "device", "static", "device", "static"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mat = rbc.partition_padded(xt, dataclasses.replace(p, execution=mode))
        part[mode].append(time.perf_counter() - t0)
        if mode == "static":
            static_mat = mat
        del mat
    log("phase6 partition_s", json.dumps(part))
    padded, secs, counts, level1 = static_steps(xt, p)
    check(np.array_equal(padded, static_mat), "the static steps differ from ball_carve_device")
    log("phase6 static steps", json.dumps(dict(seconds=secs, **counts)))
    kstats = level1_kernels(xt, gauss, level1)
    for name, v in kstats.items():
        log(f"phase6 {name} level1", json.dumps(v))
    del xt, padded, static_mat, level1
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    index = repro_torch.build(x_np, repro_torch.PiPNNParams(
        seed=seed, rbc=rbc.RBCParams(execution="static")), device=dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {"static build": _path_launches("static build", (
        "pairwise_distance", "rowwise_topk", "leaf_knn", "edge_hash", "segmented_merge"))}
    st = index.stats
    check(st["partition_execution"] == "static", "the static build did not carve statically")
    check_index(index)
    log("phase6 build", json.dumps(dict(
        n=n, wall_s=wall, timings=index.timings, peak_device_bytes=peak,
        avg_degree=index.average_degree(), salvage_leaves=counts["salvage_leaves"],
        stats={k: st[k] for k in ("partition_execution", "n_leaves", "point_repeat",
                                   "pad_ratio", "n_candidate_edges", "stream_chunk_leaves",
                                   "leaf_size_mean", "partition_uncovered")})))
    kernels.reset_launch_counts()
    repro_torch.search(index, x_np, q_np[:100], k=10, beam=32, device=dev)
    searches = _searches(index, x_np, q_np, worklist["truth"], dev, tag="phase6")
    launches["static float32 search"] = _path_launches("static float32 search",
                                                       ("gather_distance",))
    r = searches[128]["recall_at_10"]
    rw = worklist["searches"]["float32"][128]["recall_at_10"]
    check(r >= RECALL_FLOOR, f"static recall@10 at beam 128 {r} below {RECALL_FLOOR}")
    check(r >= rw - 0.03, f"static recall@10 at beam 128 {r} below the worklist's {rw} - 0.03")
    log("phase6 recall rule", json.dumps(dict(
        static=r, worklist=rw, gap=rw - r, slack=0.03,
        partition_s_worklist_build=worklist["timings"]["partition"],
        partition_s_static_build=index.timings["partition"])))
    return dict(launches=launches, level1=kstats)


def _timed_build(x_np, params, dev, name: str, needed: tuple[str, ...], absent=(), **kw):
    """One build through ``repro_torch.build`` with the launch counters and
    the peak-memory counter set just before it: (index, wall seconds, peak
    device bytes, device bytes held before it, launches).  Each kernel in
    ``needed`` must have run on it, none in ``absent``."""
    import torch

    import repro_torch
    from repro_torch import kernels

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    index = repro_torch.build(x_np, params, device=dev, **kw)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = _path_launches(name, needed)
    for k in absent:
        check(launches[k] == 0, f"kernel {k} ran on the {name} path")
    return index, wall, peak, base, launches


def _same_graph(a, b, what: str) -> None:
    import torch

    check(a.start == b.start, f"{what}: start differs ({a.start} vs {b.start})")
    diff = int((a.graph.cpu() != b.graph.cpu()).sum())
    check(diff == 0, f"{what}: graphs differ in {diff} slots")
    check(torch.equal(a.dists.cpu(), b.dists.cpu()), f"{what}: graph dists differ")


def _rows_sorted(graph, dists) -> bool:
    """Every row sorted by (dist, id), -1 exactly where the dist is +inf
    and only after the live slots."""
    import torch

    live = graph >= 0
    ok = torch.equal(live, torch.isfinite(dists))
    ok &= bool((live[:, :-1] | ~live[:, 1:]).all())
    d0, d1, i0, i1 = dists[:, :-1], dists[:, 1:], graph[:, :-1], graph[:, 1:]
    order = (d0 < d1) | ((d0 == d1) & (i0 < i1)) | ~live[:, 1:]
    return ok and bool(order.all())


def _subset_rows(small, big, rows: int = 100_000) -> bool:
    """Every live id of each row of ``small`` is in the same row of ``big``."""
    import torch

    for s in range(0, small.shape[0], rows):
        a, b = small[s:s + rows], big[s:s + rows]
        hit = (a[:, :, None] == b[:, None, :]).any(dim=2) | (a < 0)
        if not bool(hit.all()):
            return False
        del hit
    return True


def phase_options_full(x_np, q_np, seed: int, dev, full: dict) -> dict:
    """Phase 7 (a)-(c) at full size, each on phase 3's own leaves (its
    recorded leaf matrix, given as ``leaves=``) and its seeded hyperplanes:
    the flat build (``streaming=False``), the flat fold (``merge="flat"``)
    and ``final_prune=False``."""
    import torch

    import repro_torch
    from repro_torch import kernels
    from repro_torch.core import pipnn, sketch

    ref = full["index"]
    padded = full["padded"]
    leaves = [row[row >= 0] for row in padded]
    base = repro_torch.PiPNNParams(seed=seed)
    out = {}

    flat, wall, peak, held, launches = _timed_build(
        x_np, base, dev, "flat build", ("leaf_knn", "edge_hash"), ("segmented_merge",),
        leaves=leaves, streaming=False)
    check(not flat.stats["streaming"], "the flat build streamed")
    _same_graph(flat, ref, "flat build vs phase 3")
    out["flat_build"] = dict(
        wall_s=wall, timings=flat.timings, peak_device_bytes=peak, held_before_bytes=held,
        streaming_build_peak_device_bytes=full["peak"], streaming_build_wall_s=full["wall"],
        streaming_build_timings=full["timings"], launches=launches, graph_identical=True,
        stats={k: flat.stats[k] for k in ("n_candidate_edges", "peak_edge_bytes",
                                          "edge_bytes_build_leaves", "merge_workspace_bytes",
                                          "n_leaves", "streaming")})
    log("phase7 flat build", json.dumps(out["flat_build"]))
    del flat
    torch.cuda.empty_cache()

    fold, wall, peak, held, launches = _timed_build(
        x_np, base.with_(merge="flat"), dev, "flat fold", ("leaf_knn", "edge_hash"),
        ("segmented_merge",), leaves=leaves)
    _same_graph(fold, ref, "flat fold vs phase 3")
    out["flat_fold"] = dict(wall_s=wall, timings=fold.timings, peak_device_bytes=peak,
                            held_before_bytes=held, launches=launches, graph_identical=True,
                            merge_workspace_bytes=fold.stats["merge_workspace_bytes"])
    log("phase7 flat fold", json.dumps(out["flat_fold"]))
    del fold
    torch.cuda.empty_cache()

    keep, wall, peak, held, launches = _timed_build(
        x_np, base.with_(final_prune=False), dev, "final_prune=False",
        ("leaf_knn", "edge_hash", "segmented_merge"), leaves=leaves)
    # the reservoir of the same stream, on its own
    xt = torch.from_numpy(x_np).to(dev)
    hp = torch.from_numpy(sketch.make_hyperplanes(seed, base.hash_bits, x_np.shape[1])).to(dev)
    res, _, _ = pipnn._build_reservoir_streaming(xt, padded, sketch.sketch(xt, hp).contiguous(),
                                                 base)
    del xt
    check(torch.equal(keep.graph, res.ids[:, :base.max_deg])
          and torch.equal(keep.dists, res.dists[:, :base.max_deg]),
          "final_prune=False graph != the reservoir cut to max_deg")
    del res
    check(_rows_sorted(keep.graph, keep.dists), "final_prune=False rows not sorted by (dist, id)")
    check(_subset_rows(ref.graph.to(dev), keep.graph),
          "a pruned row holds an id its reservoir lacks")
    kernels.reset_launch_counts()
    repro_torch.search(keep, x_np, q_np[:100], k=10, beam=32, device=dev)
    searches = _searches(keep, x_np, q_np, full["truth"], dev, tag="phase7 final_prune=False")
    slaunch = _path_launches("final_prune=False float32 search", ("gather_distance",))
    pruned = full["searches"]["float32"]
    out["final_prune_off"] = dict(
        wall_s=wall, timings=keep.timings, peak_device_bytes=peak, launches=launches,
        search_launches=slaunch, avg_degree=keep.average_degree(),
        pruned_avg_degree=ref.average_degree(), equals_reservoir=True,
        recall_at_10={b: searches[b]["recall_at_10"] for b in BEAMS},
        qps={b: searches[b]["qps"] for b in BEAMS},
        pruned_recall_at_10={b: pruned[b]["recall_at_10"] for b in BEAMS},
        pruned_qps={b: pruned[b]["qps"] for b in BEAMS})
    log("phase7 final_prune=False", json.dumps(out["final_prune_off"]))
    del keep
    torch.cuda.empty_cache()
    return out


LEAF_METHODS = ("bidirected", "directed", "inverted", "mst", "robust_prune")


def _method_params(method: str, seed: int):
    """The reference's leaf-method ablation settings
    (``benchmarks/bench_leaf_methods.py``)."""
    import repro_torch
    from repro_torch.core.leaf import LeafParams
    from repro_torch.core.rbc import RBCParams

    return repro_torch.PiPNNParams(rbc=RBCParams(c_max=256, c_min=32, fanout=(4, 2)),
                                   leaf=LeafParams(method=method, k=2, max_deg=32),
                                   max_deg=32, seed=seed)


def _method_needs(method: str, streamed: bool) -> tuple[tuple, tuple]:
    needed = ("edge_hash",) + (("leaf_knn",) if method not in ("mst", "robust_prune") else ())
    needed += ("segmented_merge",) if streamed else ()
    absent = (() if streamed else ("segmented_merge",)) + (
        ("leaf_knn",) if method in ("mst", "robust_prune") else ())
    return needed, absent


def phase_leaf_methods(n: int, n_cpu: int, n_queries: int, seed: int, dev) -> dict:
    """Phase 7 (d): every leaf method on SIFT-like integers at ``n``, on the
    card, with the reference's ablation settings, the leaves of one worklist
    carve and dyadic hyperplanes: recall@10 at beam 64, degree,
    ``build_leaves`` seconds, launches; ``robust_prune`` streamed equals
    flat.  Then every method on the card and on the CPU at ``n_cpu`` (its
    own data, leaves and hyperplanes shared), identical graphs."""
    import dataclasses

    import torch

    import repro_torch
    from repro_torch import kernels
    from repro_torch.core.beam_search import brute_force_knn, recall_at_k
    from repro_torch.core.rbc import partition
    from repro_torch.data import (VectorPipelineConfig, dyadic_hyperplanes, make_queries,
                                  make_vectors, sift_like)

    def data(size):
        cfg = VectorPipelineConfig(n=size, dim=128, n_clusters=1024, seed=seed)
        x = sift_like(make_vectors(cfg))
        rbc = dataclasses.replace(_method_params("bidirected", seed).rbc, seed=seed)
        return x, partition(torch.from_numpy(x).to(dev), rbc), cfg

    hp = dyadic_hyperplanes(seed, 12, 128)
    x, leaves, cfg = data(n)
    q = sift_like(make_queries(cfg, n_queries))
    truth = brute_force_knn(torch.from_numpy(x).to(dev), torch.from_numpy(q).to(dev), 10)
    out = {"n": n, "n_cpu": n_cpu, "queries": n_queries, "methods": {}}
    for m in LEAF_METHODS:
        p = _method_params(m, seed)
        needed, absent = _method_needs(m, m != "mst")
        idx, wall, peak, _, launches = _timed_build(x, p, dev, f"leaf method {m}", needed,
                                                    absent, leaves=leaves, hyperplanes=hp)
        check(idx.stats["streaming"] == (m != "mst"), f"{m}: streaming flag")
        ids = repro_torch.search(idx, x, q, k=10, beam=64, device=dev)
        row = dict(recall_at_10_beam64=recall_at_k(ids, truth), avg_degree=idx.average_degree(),
                   build_leaves_s=idx.timings["build_leaves"], wall_s=wall,
                   peak_device_bytes=peak, n_candidate_edges=idx.stats["n_candidate_edges"],
                   launches={k: launches[k] for k in ("leaf_knn", "edge_hash",
                                                       "segmented_merge")})
        if m == "robust_prune":
            flat, fwall, _, _, flaunch = _timed_build(
                x, p, dev, "leaf method robust_prune flat", *_method_needs(m, False),
                leaves=leaves, hyperplanes=hp, streaming=False)
            _same_graph(flat, idx, "robust_prune flat vs streamed")
            row.update(flat_wall_s=fwall, flat_build_leaves_s=flat.timings["build_leaves"],
                       flat_launches={k: flaunch[k] for k in ("leaf_knn", "edge_hash",
                                                              "segmented_merge")},
                       flat_equals_streamed=True)
        out["methods"][m] = row
        log("phase7 leaf method", m, json.dumps(row))
        del idx

    x, leaves, _ = data(n_cpu) if n_cpu != n else (x, leaves, None)
    for m in LEAF_METHODS:
        p = _method_params(m, seed)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        card = repro_torch.build(x, p, leaves=leaves, hyperplanes=hp, device=dev)
        t_card = time.perf_counter() - t0
        _path_launches(f"leaf method {m} at n = {n_cpu}", _method_needs(m, m != "mst")[0])
        t0 = time.perf_counter()
        cpu = repro_torch.build(x, p, leaves=leaves, hyperplanes=hp, device="cpu")
        t_cpu = time.perf_counter() - t0
        _same_graph(card, cpu, f"leaf method {m}: card vs CPU at n = {n_cpu}")
        out["methods"][m].update(card_equals_cpu=True, parity_card_s=t_card, parity_cpu_s=t_cpu)
        log("phase7 leaf method parity", m, json.dumps(dict(
            n=n_cpu, card_s=t_card, cpu_s=t_cpu, graph_identical=True)))
    return out


def phase_host_search(full: dict, x_np, q_np, dev, n_host: int = 200) -> dict:
    """Phase 7 (e): the host oracle ``search(batch=False)`` on ``n_host`` of
    the queries at beam 64 beside the serving path on the same queries;
    then the legacy ``beam_search_single`` on the card for every query at
    each beam with ``iters = beam + 4``, beside the serving engine's
    phase 3 numbers."""
    import torch

    import repro_torch
    from repro_torch import kernels
    from repro_torch.core.beam_search import beam_search_single, recall_at_k
    from repro_torch.core.pipnn import serving_index

    index, truth = full["index"], full["truth"]
    qs = q_np[:n_host]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    host = repro_torch.search(index, x_np, qs, k=10, beam=64, batch=False)
    t_host = time.perf_counter() - t0
    check(not any(_path_launches("host search", ()).values()), "a kernel ran on the host search")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = repro_torch.search(index, x_np, qs, k=10, beam=64, device=dev)
    t_batch = time.perf_counter() - t0
    out = {"host": dict(queries=n_host, beam=64, recall_at_10=recall_at_k(host, truth[:n_host]),
                        seconds=t_host,
                        batch_recall_at_10=recall_at_k(served, truth[:n_host]),
                        batch_seconds=t_batch)}
    log("phase7 host search", json.dumps(out["host"]))
    sv = serving_index(index, x_np, device=dev)
    q = torch.from_numpy(q_np).to(dev)
    engine = full["searches"]["float32"]
    out["single"] = {}
    for beam in BEAMS:
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, _ = beam_search_single(sv.graph, sv.points, q, start=sv.start, beam=beam,
                                    iters=beam + 4, metric=sv.metric)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        _path_launches(f"beam_search_single {beam}", ())   # torch operations, no kernel
        out["single"][beam] = dict(
            recall_at_10=recall_at_k(ids[:, :10].cpu().numpy(), truth), qps=q.shape[0] / dt,
            seconds=dt, engine_recall_at_10=engine[beam]["recall_at_10"],
            engine_qps=engine[beam]["qps"], engine_over_single_qps=engine[beam]["qps"] * dt
            / q.shape[0])
        log("phase7 beam_search_single", beam, json.dumps(out["single"][beam]))
    return out


def _no_repeats(ids) -> bool:
    """No merged row holds an id twice (-1 pads aside)."""
    import numpy as np

    s = np.sort(ids, axis=1)
    return not bool(((s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)).any())


def _halo_contract(sv, q, beam: int) -> dict:
    """The halo's dedup contract on the card: every (query, global id) pair
    that reaches more than one shard's beam carries the same distance bits
    in each, and the merged rows repeat no id."""
    import numpy as np
    import torch

    qt = torch.from_numpy(q).to(sv.device)
    ids_s, ds_s, *_ = sv._shard_search(qt, None, beam=beam, iters=beam + 4, expansions=4,
                                       early_exit=True, plain=False)
    ids_s, ds_s = ids_s.cpu().numpy(), ds_s.cpu().numpy()
    live = ids_s >= 0
    key = (np.broadcast_to(np.arange(q.shape[0])[None, :, None], ids_s.shape)[live]
           .astype(np.int64) * sv.n + ids_s[live])
    bits = ds_s.view(np.int32)[live]
    order = np.lexsort((bits, key))
    key, bits = key[order], bits[order]
    same = key[1:] == key[:-1]
    check(bool((bits[1:][same] == bits[:-1][same]).all()),
          "a ghost row's distance differs between the shards that hold it")
    check(bool(same.any()), "no row reached two shards' beams")
    merged = sv.search(q, k=10, beam=beam)
    check(_no_repeats(merged), "a merged row repeats an id")
    return dict(replicated_pairs=int(same.sum()), pairs=int(key.size), ghost_bits_equal=True,
                merged_repeats=0)


def _timed_search(sv, q, truth, beam: int, counter: str) -> dict:
    """One search of every query: recall@10, QPS and the gather launches."""
    import torch

    from repro_torch import kernels
    from repro_torch.core.beam_search import recall_at_k

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, st = sv.search(q, k=10, beam=beam, with_stats=True)
    dt = time.perf_counter() - t0
    launches = kernels.launch_counts()[counter]
    check(launches > 0 and st["kernel_path"] == "hbm", f"{counter} not launched (beam {beam})")
    check(_no_repeats(ids), f"a merged row repeats an id (beam {beam})")
    return dict(ids=ids, recall_at_10=recall_at_k(ids, truth), qps=q.shape[0] / dt, seconds=dt,
                gather_launches=launches, mean_hops=float(st["hops"].mean()),
                converged=float(st["converged"].mean()))


def phase_sharded(full: dict, x_np, q_np, seed: int, dev, n_small: int) -> dict:
    """Phase 8 (a) and (b): sharded serving at full size, S = 1 and 8 on one
    card, then card against CPU at ``n_small``."""
    import dataclasses

    import numpy as np
    import torch

    import repro_torch
    from repro_torch import kernels
    from repro_torch.core.serving import ServingIndex
    from repro_torch.data import (VectorPipelineConfig, dyadic_hyperplanes, make_queries,
                                  make_vectors, sift_like)
    from repro_torch.distributed.serving import ShardedServingIndex

    index, truth = full["index"], full["truth"]
    single = full["searches"]["float32"]
    out = {"launches": {}}
    sv1 = ServingIndex.from_index(index, x_np, device=dev)
    s1 = ShardedServingIndex.from_index(index, x_np, n_shards=1, device=dev)
    out["s1"] = {}
    for beam in BEAMS:
        a = _timed_search(sv1, q_np, truth, beam, "gather_distance")
        b = _timed_search(s1, q_np, truth, beam, "gather_distance")
        check(np.array_equal(a["ids"], b["ids"]), f"S = 1 ids differ from ServingIndex's at "
              f"beam {beam}")
        out["s1"][beam] = dict(ids_equal=True, recall_at_10=a["recall_at_10"],
                               single_qps=a["qps"], sharded_qps=b["qps"],
                               single_launches=a["gather_launches"],
                               sharded_launches=b["gather_launches"])
        log("phase8 S=1", beam, json.dumps(out["s1"][beam]))
    del s1
    torch.cuda.empty_cache()

    packs = {}
    for name, dtype in (("float32", None), ("int8", "int8"), ("bfloat16", torch.bfloat16)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        sv = ShardedServingIndex.from_index(index, x_np, n_shards=8, dtype=dtype, device=dev,
                                            seed=seed)
        torch.cuda.synchronize()
        t_pack = time.perf_counter() - t0
        hs = sv.halo_stats()
        s, m = sv.n_shards, sv.shard_capacity
        r, d = sv.graph.shape[2], sv.points.shape[2]
        row = 4 + 4 * r + d * sv.points.element_size() + 4 + (4 if dtype == "int8" else 0)
        out[f"pack_{name}"] = dict(
            seconds=t_pack, shard_capacity=m, reckoned_bytes=s * m * row,
            device_bytes=sv.device_bytes(breakdown=True),
            per_shard_bytes=sv.device_bytes(per_shard=True),
            peak_during_pack_bytes=torch.cuda.max_memory_allocated() - held,
            members=hs["members"].tolist(), ghosts=hs["ghosts"].tolist(),
            pads=hs["pads"].tolist(), halo_fraction=hs["halo_fraction"])
        log("phase8 packing S=8", name, json.dumps(out[f"pack_{name}"]))
        counter = "gather_distance_int8" if dtype == "int8" else "gather_distance"
        routes = [("all", sv)]
        if dtype is None:
            routes.append(("leaders", dataclasses.replace(sv, router="leaders", n_probes=2,
                                                          health=None)))
        for route, svr in routes:
            tag = f"s8_{name}_{route}"
            out[tag] = {}
            # the downcast copies at beam 64 only: on this data their
            # sharded recall tracks float32's at every beam
            for beam in BEAMS if dtype is None else (64,):
                res = _timed_search(svr, q_np, truth, beam, counter)
                ref = full["searches"][name][beam]
                res.pop("ids")
                res.update(single_card_recall_at_10=ref["recall_at_10"],
                           single_card_qps=ref["qps"],
                           gap=ref["recall_at_10"] - res["recall_at_10"],
                           launches_per_shard=res["gather_launches"] / 8)
                out[tag][beam] = res
                log("phase8", tag, beam, json.dumps(res))
                out["launches"][f"{tag}_b{beam}"] = res["gather_launches"]
                if tag == "s8_float32_all":
                    check(res["recall_at_10"] >= single[beam]["recall_at_10"] - 0.01,
                          f"S = 8 recall@10 {res['recall_at_10']} at beam {beam} below the "
                          f"single card's {single[beam]['recall_at_10']} - 0.01")
        if dtype is None:
            packs["float32"] = sv
        else:
            del sv
        torch.cuda.empty_cache()

    # the dedup contract on the Gaussian mixture the data are made from
    cfg = VectorPipelineConfig(n=n_small, dim=128, n_clusters=1024, seed=seed)
    xg, qg = make_vectors(cfg), make_queries(cfg, 1000)
    gidx = repro_torch.build(xg, device=dev)
    out["gaussian"] = {}
    for name, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        sv = ShardedServingIndex.from_index(gidx, xg, n_shards=8, dtype=dtype, device=dev)
        out["gaussian"][name] = _halo_contract(sv, qg, 64)
        log("phase8 Gaussian dedup", name, json.dumps(out["gaussian"][name]))
    del gidx, sv

    # card against CPU on the integer data at n_small
    xs = sift_like(make_vectors(cfg))
    qs = sift_like(make_queries(cfg, 200))
    sidx = repro_torch.build(xs, hyperplanes=dyadic_hyperplanes(seed, 12, 128), device=dev)
    out["card_vs_cpu"] = {}
    for name, dtype in (("float32", None), ("int8", "int8")):
        card = ShardedServingIndex.from_index(sidx, xs, n_shards=8, dtype=dtype, device=dev)
        cpu = ShardedServingIndex.from_index(sidx, xs, n_shards=8, dtype=dtype, device="cpu")
        for field in ("gids", "graph", "points", "norms", "starts", "leaders", "scales"):
            a, b = getattr(card, field), getattr(cpu, field)
            check((a is None and b is None) or torch.equal(a.cpu(), b),
                  f"S = 8 {name} packing's {field} differs between card and CPU")
        t0 = time.perf_counter()
        a = card.search(qs, k=10, beam=64)
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        b = cpu.search(qs, k=10, beam=64)
        t_cpu = time.perf_counter() - t0
        check(np.array_equal(a, b), f"S = 8 {name} ids differ between card and CPU")
        out["card_vs_cpu"][name] = dict(n=n_small, queries=200, packing_identical=True,
                                        ids_identical=True, card_s=t_card, cpu_s=t_cpu)
        log("phase8 card vs CPU", name, json.dumps(out["card_vs_cpu"][name]))
    out["sv1"], out["s8"] = sv1, packs["float32"]
    return out


def _percentiles(lat) -> dict:
    import numpy as np

    a = np.asarray(lat, float) * 1e3
    return dict(p50_ms=float(np.percentile(a, 50)), p99_ms=float(np.percentile(a, 99)))


def phase8_ladder(full: dict):
    """The serving loop's ladder from phase 3's own card measurements, in
    BENCH_qps.json's record format."""
    import tempfile

    from repro_torch.launch.serve_loop import ladder_from_bench

    recs = [dict(engine="serve_E4", beam=b, recall=r["recall_at_10"], qps=r["qps"])
            for b, r in full["searches"]["float32"].items()]
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "qps.json"
        path.write_text(json.dumps([{"records": recs}]))
        ladder = ladder_from_bench(path)
    check(ladder is not None, "no ladder from phase 3's records")
    return ladder


# the fault drill of phase 8 (c) and phase 10 (c): 1,024 requests, 5% of
# them poisoned, shard 7 down for search calls [1, 6), one straggler
DRILL_REQUESTS = 1024
DRILL_PLAN = dict(shard_down={7: (1, 6)}, straggle={2: 0.01})
DRILL_LOOP = dict(k=10, query_chunk=64, straggler_chunk=8, max_queue=1024, probe_every=1)


def phase_loop(full: dict, sharded: dict, q_np, dev) -> dict:
    """Phase 8 (c) and (d): the fault drill on the 1M S = 8 packing, then
    the serving loop's latency on the single-card index, two-phase against
    single-phase, an open-loop Poisson load and a search forced to "xla"."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.core.beam_search import recall_at_k
    from repro_torch.launch.serve_loop import QueueFull, ServeLoop
    from repro_torch.testing.faults import FaultPlan, inject_faults, poison_queries

    sv1, s8, truth = sharded["sv1"], sharded["s8"], full["truth"]
    out = {"launches": {}}
    ladder = phase8_ladder(full)
    out["ladder"] = [dict(name=p.name, beam=p.beam, recall=p.recall_bound, qps=p.qps)
                     for p in ladder]
    log("phase8 ladder", json.dumps(out["ladder"]))

    # (c) the fault drill
    nreq = DRILL_REQUESTS
    q = q_np[:nreq]
    healthy = recall_at_k(s8.search(q, k=10, beam=ladder[0].beam), truth[:nreq])
    qp, rows = poison_queries(q, 0.05, seed=7)
    plan = FaultPlan(**DRILL_PLAN)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with inject_faults(s8, plan) as inj:
        loop = ServeLoop(s8, ladder=ladder, **DRILL_LOOP)
        rid_to_row = {loop.submit(qp[i]): i for i in range(nreq)}
        res = loop.run_until_drained()
        for _ in range(12):
            res += loop.step()
            if not s8.down_shards:
                break
    wall = time.perf_counter() - t0
    out["launches"]["drill"] = kernels.launch_counts()["gather_distance"]
    check(len(res) == nreq, f"drill answered {len(res)} of {nreq} requests")
    bad = sorted(rid_to_row[r.rid] for r in res if r.error)
    check(bad == rows.tolist(), "structured errors are not exactly the poisoned rows")
    check(all(r.error == "invalid:nan_inf" for r in res if not r.ok), "an unexpected error")
    check(("shard_failure", 1, 7) in inj.events, "shard 7 did not fail at call 1")
    check(loop.counters["shards_marked_down"] == 1 and loop.counters["shards_readmitted"] == 1,
          f"tombstones / re-admissions: {dict(loop.counters)}")
    check(not s8.down_shards and "search" not in vars(s8), "health or search not restored")
    ids = np.full((nreq, 10), -1, np.int64)
    for r in res:
        if r.ok:
            ids[rid_to_row[r.rid]] = r.ids
    ok_rows = np.setdiff1d(np.arange(nreq), rows)
    degraded = recall_at_k(ids[ok_rows], truth[:nreq][ok_rows])
    check(degraded >= 0.85 * healthy, f"degraded recall {degraded} below 0.85 x {healthy}")
    out["drill"] = dict(requests=nreq, answered=len(res), poisoned=len(rows),
                        errors_exactly_poisoned=True, counters=dict(loop.counters),
                        injected=[list(e) for e in inj.events], calls=inj.calls,
                        healthy_recall_at_10=healthy, degraded_recall_at_10=degraded,
                        wall_s=wall, gather_launches=out["launches"]["drill"],
                        **_percentiles([r.latency for r in res if r.ok]))
    log("phase8 drill", json.dumps(out["drill"]))

    # (d) the loop on the single-card index, the same requests a chunk at a
    # time: two-phase, single-phase, and two-phase with a shorter phase-1
    # cap, so that some rows drain in phase 1 and the rest rerun in phase 2
    chunk = 256
    nbatch = -(-q_np.shape[0] // chunk)
    kw = dict(k=10, query_chunk=chunk, straggler_chunk=32, max_queue=4 * chunk, ladder=ladder)
    runs = {}
    for name in ("two_phase", "single_phase", "two_phase_short_drain"):
        opts = dict(two_phase=name != "single_phase")
        if name == "two_phase_short_drain":
            # halfway between the fewest steps a search can converge in
            # (every beam slot expanded once) and the steps the single-phase
            # batches took, each to its slowest row
            top = ladder[0]
            fewest = -(-top.beam // top.expansions)
            steps = out["single_phase"]["gather_launches"] / nbatch - 1
            opts["drain_iters"] = int((fewest + steps) // 2)
        kernels.reset_launch_counts()
        loop = ServeLoop(sv1, **opts, **kw)
        torch.cuda.synchronize()
        res = []
        t0 = time.perf_counter()
        for c0 in range(0, q_np.shape[0], chunk):
            for qi in q_np[c0: c0 + chunk]:
                loop.submit(qi)
            res += loop.step()
        res += loop.run_until_drained()
        wall = time.perf_counter() - t0
        byrid = {r.rid: r for r in res}
        check(len(byrid) == q_np.shape[0] and all(r.ok and not r.partial for r in res),
              f"{name}: the loop left a request unanswered or partial")
        check(loop.counters["downshift"] == 0, f"{name}: the loop left the ladder's top rung")
        ids = np.stack([byrid[i].ids for i in range(q_np.shape[0])])
        runs[name] = byrid
        out[name] = dict(requests=len(res), throughput_qps=len(res) / wall, wall_s=wall,
                         drain_iters=loop.drain_iters, backstop_iters=loop.backstop_iters,
                         recall_at_10=recall_at_k(ids, truth), counters=dict(loop.counters),
                         op_point=loop.operating_point.name,
                         gather_launches=kernels.launch_counts()["gather_distance"],
                         **_percentiles([r.latency for r in res]))
        out["launches"][name] = out[name]["gather_launches"]
        log("phase8 loop", name, json.dumps(out[name]))
    short = out["two_phase_short_drain"]["counters"]
    check(short.get("drained_phase1", 0) > 0 and short.get("rerun_phase2", 0) > 0,
          f"the short drain did not split the rows between the phases: {short}")
    # every row, drained in phase 1 or rerun in phase 2, equals the
    # single-phase row: a converged row is frozen, and a straggler's rerun
    # runs the same search to the same cap
    out["drained_identical"] = {}
    for name in ("two_phase", "two_phase_short_drain"):
        by_phase = {1: 0, 2: 0}
        for i, r in runs[name].items():
            check(np.array_equal(r.ids, runs["single_phase"][i].ids),
                  f"{name}: a phase-{r.phase} row differs from the single-phase run")
            by_phase[r.phase] += 1
        out["drained_identical"][name] = dict(phase1_rows=by_phase[1], phase2_rows=by_phase[2],
                                              identical=True)
    log("phase8 drained identical", json.dumps(out["drained_identical"]))

    # open-loop Poisson arrivals at 50% and 120% of the two-phase throughput
    thr = out["two_phase"]["throughput_qps"]
    for share in (0.5, 1.2):
        rng = np.random.default_rng(11)
        arrivals = np.cumsum(rng.exponential(1.0 / (share * thr), size=q_np.shape[0]))
        loop = ServeLoop(sv1, **kw)
        res, nexti, rejected = [], 0, 0
        t0 = time.perf_counter()
        while nexti < len(arrivals) or loop.queue_depth:
            now = time.perf_counter() - t0
            while nexti < len(arrivals) and arrivals[nexti] <= now:
                try:
                    loop.submit(q_np[nexti])
                except QueueFull:
                    rejected += 1
                nexti += 1
            if loop.queue_depth:
                res += loop.step()
            elif nexti < len(arrivals):
                time.sleep(min(0.001, arrivals[nexti] - now))
        wall = time.perf_counter() - t0
        key = f"poisson_{int(share * 100)}"
        out[key] = dict(rate_qps=share * thr, requests=len(arrivals), served=len(res),
                        rejected=rejected, downshifts=loop.counters["downshift"],
                        upshifts=loop.counters["upshift"], throughput_qps=len(res) / wall,
                        wall_s=wall, **_percentiles([r.latency for r in res]))
        check(len(res) + rejected == len(arrivals), f"{key}: requests lost")
        check(len(res) > 0 and all(r.ok for r in res), f"{key}: a request failed")
        if share < 1.0:
            check(rejected == 0, f"{key}: {rejected} requests rejected below capacity")
        log("phase8", key, json.dumps(out[key]))

    # a search forced to "xla" launches no gather kernel; the calls around
    # it do, and all three give the same ids on the integer data
    out["forced_xla"] = {}
    for name, sv in (("single", sv1), ("sharded", s8)):
        calls = []
        with inject_faults(sv, FaultPlan(force_kernel_path={1: "xla"})) as inj:
            for _ in range(3):
                kernels.reset_launch_counts()
                ids, st = sv.search(q_np[:256], k=10, beam=32, with_stats=True)
                calls.append((ids, st["kernel_path"], kernels.launch_counts()["gather_distance"]))
        check(calls[1][1:] == ("xla", 0), f"{name}: the forced call launched {calls[1][2]}")
        check(all(c[1] == "hbm" and c[2] > 0 for c in (calls[0], calls[2])),
              f"{name}: a call around the forced one launched no gather kernel")
        check(all(np.array_equal(c[0], calls[0][0]) for c in calls), f"{name}: forced ids")
        out["forced_xla"][name] = dict(launches=[c[2] for c in calls],
                                       paths=[c[1] for c in calls], events=inj.events)
        log("phase8 forced xla", name, json.dumps(out["forced_xla"][name]))
    return out


class DistProbe:
    """Instruments ``build_distributed`` through ``launch.build_index``'s
    module globals for one run: wall seconds of each tile step and final
    prune step (the card synchronised around each), the tile steps' stats,
    the entries each ``group_by_capacity`` stage drops silently, and the
    leaves' fill before the cut to c_max.  A tile step's groupings are
    told apart by their (groups, capacity) from
    ``DistBuildParams.derived``, which must differ between its stages; it
    must group S times at each of them (dispatch, buckets, leaves, edges),
    a final prune step S times (requests).  With
    ``capture`` it also keeps a copy of the first inputs of the level-0
    and level-1 assignments, the leaf top-k, the int8 leaf products and
    the fold, for phase 9's kernel checks.  With ``stages`` it times each
    stage's calls, the card synchronised around each (which slows the
    run): the level-0 and level-1 assignments, the groupings, the leaf
    chunks, the folds and the prune blocks."""

    TILE_STAGES = ("bucket", "leaf", "edge")

    TIMED = {"_assign": "assign", "_leaf_chunk_edges": "leaf_chunks", "_fold": "fold",
             "prune_reservoir_block": "prune_blocks"}

    def __init__(self, bi, capture: bool = False, stages: bool = False):
        self.bi, self.capture, self.stages = bi, capture, stages
        self.stage_s = {k: 0.0 for k in ("group",) + tuple(self.TIMED.values())}
        self.drops = {k: 0 for k in ("dispatch",) + self.TILE_STAGES + ("request",)}
        self.tile_s, self.prune_s, self.stats, self.inputs = [], [], [], {}
        self.step, self.calls, self.saved, self.stage_of = None, {}, {}, {}
        self.leaf_counts = []

    def _timed(self, make, kind, secs, stats=None):
        import torch

        def outer(mesh, p):
            # a mesh or a shard count; each groups once a local shard
            step = make(mesh, p)
            n_shards = getattr(mesh, "n_shards", mesh)
            n_local = len(getattr(mesh, "local", range(n_shards)))
            dv = p.derived(n_shards)
            if kind == "prune":
                self.stage_of[kind] = {(n_shards, dv["cap_req"]): "request"}
            else:
                self.stage_of[kind] = {(n_shards, dv["cap_send"]): "dispatch",
                                       (dv["nb_loc"], dv["cap_b"]): "bucket",
                                       (dv["n_leaf"], p.c_max): "leaf",
                                       (n_shards, dv["cap_edge"]): "edge"}
                check(len(self.stage_of[kind]) == 4,
                      f"phase 9: two of the tile step's groupings share a shape: {dv}")

            def timed(*a):
                torch.cuda.synchronize()
                self.step, self.calls = kind, {}
                t0 = time.perf_counter()
                out = step(*a)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                want = ({"request": n_local} if kind == "prune" else
                        {k: n_local for k in ("dispatch",) + self.TILE_STAGES})
                check(self.calls == want, f"phase 9 {kind} step grouped {self.calls}, "
                      f"expected {want}")
                if stats is not None:
                    stats.append(out[1].tolist())
                return out
            return timed
        return outer

    def _stage(self, name, real):
        import torch

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*a, **kw)
            torch.cuda.synchronize()
            self.stage_s[name] += time.perf_counter() - t0
            return out
        return timed

    def _group(self, real):
        if self.stages:
            real = self._stage("group", real)

        import torch

        def group(keys, valid, n_groups, cap, payloads, shuffle=False):
            outs, ok = real(keys, valid, n_groups, cap, payloads, shuffle)
            stage = self.stage_of[self.step][(n_groups, cap)]
            self.calls[stage] = self.calls.get(stage, 0) + 1
            self.drops[stage] += int(valid.sum()) - int(ok.sum())
            if stage == "leaf":
                self.leaf_counts.append(
                    torch.bincount(keys[valid].long(), minlength=n_groups).cpu())
            return outs, ok
        return group

    def leaf_fill(self, c_max: int) -> dict:
        """The leaves' sizes before the cut to c_max, over every tile and
        shard: leaf slots, slots holding an instance, quantiles of the
        held leaves' sizes, the leaves over c_max and the instances they
        hold."""
        import torch

        counts = torch.cat(self.leaf_counts).double()
        held = counts[counts > 0]
        over = counts > c_max
        q = torch.quantile(held, torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64))
        return dict(slots=int(counts.numel()), used=int(held.numel()),
                    mean=float(held.mean()), p50=float(q[0]), p90=float(q[1]),
                    p99=float(q[2]), max=int(held.max()), over_c_max=int(over.sum()),
                    instances=int(counts.sum()), instances_in_over=int(counts[over].sum()),
                    dropped=int((counts[over] - c_max).sum()))

    def _first(self, name, real, keep):
        def spy(*a, **kw):
            if name not in self.inputs and keep(a, kw):
                self.inputs[name] = ([t.clone() if hasattr(t, "clone") else t for t in a],
                                     {k: v.clone() if hasattr(v, "clone") else v
                                      for k, v in kw.items()})
            return real(*a, **kw)
        return spy

    def __enter__(self):
        bi = self.bi
        names = ["make_tile_step", "make_final_prune_step", "group_by_capacity"]
        if self.stages:
            names += list(self.TIMED)
        if self.capture:
            names += ["leader_assign", "rowwise_topk", "pairwise_distance_int8",
                      "merge_segmented_edges"]
        self.saved = {n: getattr(bi, n) for n in names}
        bi.make_tile_step = self._timed(self.saved["make_tile_step"], "tile", self.tile_s,
                                        self.stats)
        bi.make_final_prune_step = self._timed(self.saved["make_final_prune_step"], "prune",
                                               self.prune_s)
        bi.group_by_capacity = self._group(self.saved["group_by_capacity"])
        if self.stages:
            for n, label in self.TIMED.items():
                setattr(bi, n, self._stage(label, self.saved[n]))
        if self.capture:
            level0 = lambda a, kw: kw.get("point_valid") is None
            bi.leader_assign = self._first("level0", self.saved["leader_assign"], level0)
            la = bi.leader_assign
            bi.leader_assign = self._first("level1", la, lambda a, kw: not level0(a, kw))
            bi.rowwise_topk = self._first("leaf_topk", self.saved["rowwise_topk"],
                                          lambda a, kw: True)
            bi.pairwise_distance_int8 = self._first(
                "int8", self.saved["pairwise_distance_int8"], lambda a, kw: True)
            bi.merge_segmented_edges = self._first(
                "fold", self.saved["merge_segmented_edges"], lambda a, kw: True)
        return self

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(self.bi, n, f)


def _graph_stats(graph) -> dict:
    deg = (graph >= 0).sum(1)
    return dict(mean_degree=float(deg.mean()), isolated=int((deg == 0).sum()))


def _dist_run(x_np, q_np, truth, s, p, dev, name: str, needed=(), absent=(),
              capture=False, search=True, stages=False, phase: str = "phase9") -> dict:
    """One ``build_distributed(x, s, p)`` on the card (``s`` a shard count,
    or a mesh on ``dev``) with the launch and peak-memory counters set just
    before it; its steps' times, stats, silent drops, graph statistics,
    launches and (``search``) recall@10 and QPS at each beam from start 0
    through the serving engine."""
    import torch

    from repro_torch import kernels
    from repro_torch.convert import index_from_arrays
    from repro_torch.launch import build_index as bi

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with DistProbe(bi, capture, stages) as probe:
        t0 = time.perf_counter()
        graph, dists = bi.build_distributed(x_np, s, p, seed=0,
                                            device=dev if isinstance(s, int) else None)
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = _path_launches(name, needed)
    for k in absent:
        check(launches[k] == 0, f"kernel {k} ran on the {name} path")
    fill = probe.leaf_fill(p.c_max)
    check(fill["dropped"] == probe.drops["leaf"], f"phase 9 {name}: the leaves' fill drops "
          f"{fill['dropped']}, the leaf grouping {probe.drops['leaf']}")
    out = dict(n=x_np.shape[0], shards=getattr(s, "n_shards", s), wall_s=wall,
               tile_s=probe.tile_s,
               final_prune_s=probe.prune_s, stats=probe.stats, silent_drops=probe.drops,
               leaf_fill=fill, peak_device_bytes=peak, launches=launches, **_graph_stats(graph))
    if stages:
        out["stage_s"] = probe.stage_s
    log(f"{phase} {name}", json.dumps(out))
    out.update(graph=graph, dists=dists, inputs=probe.inputs)
    if search:
        index = index_from_arrays(graph, dists, 0, device=dev)
        out["search"] = _searches(index, x_np, q_np, truth, dev, tag=f"phase9 {name}")
        del index
    return out


def dist_kernels(base: dict, quant: dict) -> dict:
    """Phase 9 (d): the distance, top-k, int8 distance and merge kernels
    on the inputs the S = 8 tile step gives them (the first call of each
    on shard 0), against their plain versions, with kernel, plain and
    library times and bounds."""
    import torch

    from repro_torch.core.hashprune import Reservoir, hashprune_flat
    from repro_torch.kernels import distance, topk

    out = {}
    (pts0, lead0, f0), _ = base["inputs"]["level0"]
    (pts1, lead1, f1), kw1 = base["inputs"]["level1"]
    inf = torch.full((), float("inf"), device=pts0.device)
    for tag, a, b, k, kw in (("level0", pts0[None], lead0[None], f0, {}),
                             ("level1", pts1.contiguous(), lead1.contiguous(), f1, kw1)):
        bsz, m, d = a.shape
        nl = b.shape[1]
        dk = distance.pairwise_distance(a, b)
        check(torch.equal(dk, distance.pairwise_distance_plain(a, b)),
              f"pairwise_distance != plain at phase 9's {tag} shape")
        tc = tf32_bound(distance.work(a, b))
        out[f"pairwise_distance_{tag}"] = dict(
            shape=[bsz, m, nl, d], max_abs_err=0.0, tolerance="exact on integer data",
            ms=cuda_ms(lambda: distance.pairwise_distance(a, b), 20),
            plain_ms=cuda_ms(lambda: distance.pairwise_distance_plain(a, b), 5),
            library="torch.cdist", library_ms=cuda_ms(lambda: torch.cdist(a, b), 10),
            bound_ms=tc["bound_ms"], bound_by=tc["bound_by"], tf32_flops=tc["tf32_flops"],
            bytes=tc["bytes"])
        if kw.get("leader_valid") is not None:      # masked as leader_assign masks it
            dk = torch.where(kw["leader_valid"][:, None, :], dk, inf)
            dk = torch.where(kw["point_valid"][:, :, None], dk, inf).contiguous()
        got, want = topk.rowwise_topk(dk, k), topk.rowwise_topk_plain(dk, k)
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"rowwise_topk != plain at phase 9's {tag} shape")
        out[f"rowwise_topk_{tag}"] = dict(
            shape=[bsz, m, nl], k=k, max_abs_err=0.0, tolerance="exact (ids and values)",
            empty_slots=float((got[0] < 0).float().mean()),
            ms=cuda_ms(lambda: topk.rowwise_topk(dk, k), 20),
            plain_ms=cuda_ms(lambda: topk.rowwise_topk_plain(dk, k), 5),
            library="torch.topk(largest=False)",
            library_ms=cuda_ms(lambda: torch.topk(dk, k, largest=False), 20),
            **bound(topk.work(dk, k)))
        del dk, got, want

    (dl, k), _ = base["inputs"]["leaf_topk"]
    got, want = topk.rowwise_topk(dl, k), topk.rowwise_topk_plain(dl, k)
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          "rowwise_topk != plain at phase 9's leaf shape")
    bsz, m, n = dl.shape
    out["rowwise_topk_leaf"] = dict(
        shape=[bsz, m, n], k=k, max_abs_err=0.0, tolerance="exact (ids and values)",
        empty_slots=float((got[0] < 0).float().mean()),
        ms=cuda_ms(lambda: topk.rowwise_topk(dl, k), 20),
        plain_ms=cuda_ms(lambda: topk.rowwise_topk_plain(dl, k), 5),
        library="torch.topk(largest=False)",
        library_ms=cuda_ms(lambda: torch.topk(dl, k, largest=False), 20),
        **bound(topk.work(dl, k)))
    del got, want

    (qa, qb), _ = quant["inputs"]["int8"]
    dk = distance.pairwise_distance_int8(qa, qb)
    check(torch.equal(dk, distance.pairwise_distance_int8_plain(qa, qb)),
          "pairwise_distance_int8 != plain at phase 9's leaf shape")
    bsz, m, d = qa.shape
    n = qb.shape[1]
    out["pairwise_distance_int8_leaf"] = dict(
        shape=[bsz, m, n, d], max_abs_err=0.0, tolerance="exact (int32)",
        ms=cuda_ms(lambda: distance.pairwise_distance_int8(qa, qb), 20),
        plain_ms=cuda_ms(lambda: distance.pairwise_distance_int8_plain(qa, qb), 5),
        library=None, library_ms=None,
        cross_term_library=f"torch._int_mm, {bsz} calls (the products alone)",
        cross_term_library_ms=cuda_ms(
            lambda: [torch._int_mm(qa[i], qb[i].T) for i in range(bsz)], 20),
        **bound(distance.work_int8(qa, qb)))
    del dk

    fold, _ = base["inputs"]["fold"]
    a = Reservoir(*fold[:3])
    b = hashprune_flat(*fold[3:], n_points=a.ids.shape[0], l_max=a.ids.shape[1])
    out["merge_sorted_reservoirs_fold"] = dict(shape=list(a.ids.shape), **merge_stats((a, b)))
    for name, s in out.items():
        log(f"phase9 kernel {name}", json.dumps(s))
    return out


def _round_trip_rows(x):
    """SIFT-like integers halved onto [0, 127], each row's largest entry
    set to 127: the int8 scheme's scale is then exactly 1.0, so the
    quantized route's vectors stay integers and every float32 sum of the
    build is exact on both devices."""
    import numpy as np

    y = np.floor(x / 2)
    y[np.arange(len(y)), np.argmax(y, axis=1)] = 127
    return y.astype(np.float32)


def dist_tile(n: int) -> int:
    """Phase 9's tile: the largest power of two with two tiles in ``n``
    points, at most ``DIST_TILE``."""
    return min(DIST_TILE, 1 << ((n // 2).bit_length() - 1))


def phase_dist(x_np, q_np, seed: int, dev, n_tile: int, l0: int) -> dict:
    """Phase 9: the distributed build (``launch/build_index.py``) on one
    card, all S shards in one process; see the module docstring."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch import kernels
    from repro_torch.core import knn_graph
    from repro_torch.core.beam_search import brute_force_knn
    from repro_torch.data import dyadic_hyperplanes
    from repro_torch.launch import build_index as bi

    s8 = DIST_SHARDS
    p = bi.DistBuildParams(dim=x_np.shape[1], n_tile=n_tile, l0=l0)
    x = np.ascontiguousarray(x_np[:n_tile])
    log("phase9 config", json.dumps(dict(params=dataclasses.asdict(p), n=n_tile,
                                         derived={s: p.derived(s) for s in (1, s8)})))
    truth = brute_force_knn(torch.from_numpy(x).to(dev), torch.from_numpy(q_np).to(dev), 10,
                            chunk=256)
    out = {}
    # (a) one tile at S = 1 and S = 8, and the default build of the same points
    need = ("pairwise_distance", "rowwise_topk", "segmented_merge")
    runs = {}
    for s in (1, s8):
        runs[s] = _dist_run(x, q_np, truth, s, p, dev, f"S{s}", need,
                            absent=("pairwise_distance_int8",), capture=s == s8)
        r = runs[s]["search"][128]["recall_at_10"]
        check(r >= RECALL_FLOOR, f"distributed build at S = {s}: recall@10 {r} at beam 128 "
              f"below {RECALL_FLOOR}")
        check(runs[s]["isolated"] == 0, f"distributed build at S = {s}: "
              f"{runs[s]['isolated']} isolated points")
    idx, wall, peak, _, launches = _timed_build(x, repro_torch.PiPNNParams(seed=seed), dev,
                                                "phase9 default build",
                                                ("leaf_knn", "edge_hash", "segmented_merge"))
    out["default_build"] = dict(wall_s=wall, peak_device_bytes=peak, timings=idx.timings,
                                mean_degree=idx.average_degree(), launches=launches)
    log("phase9 default build", json.dumps(out["default_build"]))
    out["default_build"]["search"] = _searches(idx, x, q_np, truth, dev,
                                               tag="phase9 default build")
    del idx
    torch.cuda.empty_cache()

    # (b) two tiles at S = 8: the first tile's rows are (a)'s, no edge
    # crosses; its steps timed stage by stage
    x2 = np.ascontiguousarray(x_np[:2 * n_tile])
    check(len(x2) > n_tile, f"phase 9 (b) needs two tiles: {len(x2)} points, tile {n_tile}")
    two = _dist_run(x2, q_np, None, s8, p, dev, "two_tiles", need, search=False, stages=True)
    same = np.array_equal(two["graph"][:n_tile], runs[s8]["graph"]) and np.array_equal(
        two["dists"][:n_tile], runs[s8]["dists"])
    check(same, "the two-tile build's first tile differs from the one-tile build")
    g2 = two["graph"]
    ok = g2 >= 0
    tile_of = np.broadcast_to((np.arange(len(g2)) // n_tile)[:, None], g2.shape)
    crossing = int(((g2 // n_tile) != tile_of)[ok].sum())
    check(crossing == 0, f"{crossing} edges cross the tile boundary")
    out["two_tiles"] = {k: two[k] for k in ("wall_s", "tile_s", "final_prune_s", "stats",
                                           "silent_drops", "leaf_fill", "peak_device_bytes",
                                           "launches", "mean_degree", "isolated", "stage_s")}
    out["two_tiles"].update(first_tile_identical=same, crossing_edges=crossing)
    log("phase9 two_tiles checks", json.dumps(dict(first_tile_identical=same,
                                                   crossing_edges=crossing)))
    del two, g2, ok, tile_of

    # (c) the variants at S = 8 on the one tile
    out["variants"] = {}
    for v in DIST_VARIANTS:
        pv = (dataclasses.replace(p, merge="flat") if v == "flat" else
              dataclasses.replace(bi.production_params(p.dim, v), n_tile=n_tile, l0=l0))
        int8 = pv.route_dtype == "int8"
        r = _dist_run(x, q_np, truth, s8, pv, dev, v,
                      need[:2] + (("pairwise_distance_int8",) if int8 else ())
                      + (("segmented_merge",) if v != "flat" else ()),
                      absent=(() if int8 else ("pairwise_distance_int8",))
                      + (("segmented_merge",) if v == "flat" else ()), capture=v == "quantized")
        if v == "quantized":
            quant = r
        if v == "flat":
            # mergeability: the flat fold gives the segmented fold's graph
            check(np.array_equal(r["graph"], runs[s8]["graph"])
                  and np.array_equal(r["dists"], runs[s8]["dists"]),
                  "the flat fold's graph differs from the segmented fold's")
        out["variants"][v] = {k: r[k] for k in ("wall_s", "tile_s", "final_prune_s", "stats",
                                               "silent_drops", "leaf_fill", "launches",
                                               "mean_degree", "isolated", "search",
                                               "peak_device_bytes")}
    # (d) the kernels at this path's shapes
    out["kernels"] = dist_kernels(runs[s8], quant)
    del quant
    # phase 10 holds its build over a process group against this one
    out["S8_graph"] = (runs[s8]["graph"], runs[s8]["dists"])
    for s in (1, s8):
        runs[s].pop("inputs")
        out[f"S{s}"] = {k: v for k, v in runs[s].items() if k not in ("graph", "dists")}
    del runs
    torch.cuda.empty_cache()

    # (e) card against CPU on integer data whose int8 round trip is exact
    ps = bi.DistBuildParams.tiny(dim=x_np.shape[1], l0=16)
    xs = _round_trip_rows(x_np[:ps.n_tile])
    hp = dyadic_hyperplanes(seed, ps.m_bits, ps.dim)
    out["card_vs_cpu"] = {}
    for v, kw in (("baseline", {}), ("quantized", dict(route_dtype="int8"))):
        pv = dataclasses.replace(ps, **kw)
        res = {}
        for name, d in (("card", dev), ("cpu", "cpu")):
            t0 = time.perf_counter()
            res[name] = bi.build_distributed(xs, s8, pv, hyperplanes=hp, device=d)
            res[f"{name}_s"] = time.perf_counter() - t0
        same = all(np.array_equal(a, b) for a, b in zip(res["card"], res["cpu"]))
        check(same, f"phase 9 card vs CPU ({v}): graphs differ in "
              f"{int((res['card'][0] != res['cpu'][0]).sum())} slots")
        out["card_vs_cpu"][v] = dict(n=len(xs), identical=same, card_s=res["card_s"],
                                     cpu_s=res["cpu_s"], **_graph_stats(res["card"][0]))
    log("phase9 card_vs_cpu", json.dumps(out["card_vs_cpu"]))

    # (f) the k-NN-graph task on the same points
    kernels.reset_launch_counts()
    knn, times = knn_graph.knn_graph_pipnn(x, k=10, beam=32, params=repro_torch.PiPNNParams(),
                                           device=dev)
    launches = _path_launches("phase9 knn_graph", ("leaf_knn", "edge_hash", "segmented_merge",
                                                   "gather_distance"))
    rec = knn_graph.knn_graph_recall(x, knn, k=10, sample=2000, device=dev)
    check(rec >= DIST_KNN_FLOOR, f"k-NN-graph recall {rec} below {DIST_KNN_FLOOR}")
    out["knn_graph"] = dict(n=len(x), k=10, beam=32, recall=rec, paper_target=0.95,
                            floor=DIST_KNN_FLOOR, launches=launches, **times)
    log("phase9 knn_graph", json.dumps(out["knn_graph"]))
    return out


def _mesh_search(sv, q, truth, beam: int, counter: str) -> dict:
    """One search of ``q``: ids, recall@10, QPS and launches."""
    import torch

    from repro_torch import kernels
    from repro_torch.core.beam_search import recall_at_k

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = sv.search(q, k=10, beam=beam)
    dt = time.perf_counter() - t0
    launches = kernels.launch_counts()
    check(launches[counter] > 0, f"{counter} not launched (beam {beam})")
    return dict(ids=ids, recall_at_10=recall_at_k(ids, truth), qps=q.shape[0] / dt,
                seconds=dt, launches=launches)


def phase_mesh(x_np, q_np, full: dict, dist: dict, n_tile: int, l0: int, drill8: dict) -> dict:
    """Phase 10: the distributed build and sharded serving over a one-rank
    NCCL process group (``launch.mesh.init_mesh``); see the module
    docstring."""
    import os
    import tempfile

    import numpy as np
    import torch

    from repro_torch.distributed.serving import ShardedServingIndex
    from repro_torch.launch import build_index as bi
    from repro_torch.launch.mesh import init_mesh

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        store = torch.distributed.FileStore(os.path.join(tmp, "store"), 1)
        t0 = time.perf_counter()
        mesh = init_mesh(DIST_SHARDS, "cuda", store=store, rank=0, world=1)
        out["init_s"] = time.perf_counter() - t0
        try:
            check(mesh.group is not None and torch.distributed.get_backend() == "nccl",
                  f"phase 10 mesh has no NCCL group: {mesh}")
            # the first collective builds the communicator: timed on its own
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one = mesh.psum([torch.ones(1, device=mesh.device)])
            torch.cuda.synchronize()
            out["communicator_s"] = time.perf_counter() - t0
            check(float(one) == 1.0, "phase 10: a one-rank psum is not the identity")
            log("phase10 group", json.dumps(dict(backend=torch.distributed.get_backend(),
                                                 world=mesh.world,
                                                 n_shards=mesh.n_shards, device=str(mesh.device),
                                                 init_s=out["init_s"],
                                                 communicator_s=out["communicator_s"])))

            # (a) the distributed build over the group, against phase 9's
            # S = 8 one-process build of the same points
            p = bi.DistBuildParams(dim=x_np.shape[1], n_tile=n_tile, l0=l0)
            run = _dist_run(np.ascontiguousarray(x_np[:n_tile]), q_np, None, mesh, p,
                            mesh.device, "mesh_build",
                            ("pairwise_distance", "rowwise_topk", "segmented_merge"),
                            absent=("pairwise_distance_int8",), search=False, phase="phase10")
            g9, d9 = dist["S8_graph"]
            same = np.array_equal(run["graph"], g9) and np.array_equal(run["dists"], d9)
            check(same, f"phase 10: the build over the group differs from phase 9's S = 8 "
                  f"build in {int((run['graph'] != g9).sum())} slots")
            p9 = dist[f"S{DIST_SHARDS}"]
            out["build"] = {k: run[k] for k in ("wall_s", "tile_s", "final_prune_s", "stats",
                                                "peak_device_bytes", "launches",
                                                "mean_degree", "isolated")}
            out["build"].update(identical_to_phase9=same, phase9_tile_s=p9["tile_s"],
                                phase9_final_prune_s=p9["final_prune_s"],
                                phase9_peak_device_bytes=p9["peak_device_bytes"])
            log("phase10 build", json.dumps(out["build"]))
            del run, g9, d9
            torch.cuda.empty_cache()

            # (b) phase 3's graph served at S = 8 over the group and in one
            # process: identical ids at every beam
            index, q = full["index"], np.ascontiguousarray(q_np[:MESH_QUERIES])
            truth = full["truth"][:MESH_QUERIES]
            out["serve"] = {}
            for name, dtype in (("float32", None), ("int8", "int8")):
                counter = "gather_distance_int8" if dtype == "int8" else "gather_distance"
                svs, res = {}, {}
                for how, kw in (("mesh", dict(mesh=mesh)),
                                ("n_shards", dict(n_shards=DIST_SHARDS, device=mesh.device))):
                    t0 = time.perf_counter()
                    svs[how] = ShardedServingIndex.from_index(index, x_np, dtype=dtype, **kw)
                    torch.cuda.synchronize()
                    res[how] = dict(pack_s=time.perf_counter() - t0,
                                    device_bytes=svs[how].device_bytes())
                    svs[how].search(q[:100], k=10, beam=BEAMS[0])      # warm-up, untimed
                # the packing that runs first alternates from beam to beam
                for i, beam in enumerate(BEAMS):
                    order = ("n_shards", "mesh") if i % 2 == 0 else ("mesh", "n_shards")
                    got = {how: _mesh_search(svs[how], q, truth, beam, counter) for how in order}
                    check(np.array_equal(got["mesh"]["ids"], got["n_shards"]["ids"]),
                          f"phase 10 {name}: mesh ids differ from n_shards=8's at beam {beam}")
                    for how, r in got.items():
                        res[how][str(beam)] = {k: v for k, v in r.items() if k != "ids"}
                        res[how][str(beam)]["ran_first"] = how == order[0]
                if dtype is None:
                    f32_svs = svs
                del svs
                torch.cuda.empty_cache()
                res["ids_identical"] = True
                out["serve"][name] = res
                log("phase10 serve", name, json.dumps(res))

            # (c) the serving loop over the group, beside one process
            out["loop"] = phase_mesh_loop(f32_svs, q_np, full, drill8)
            del f32_svs
            torch.cuda.empty_cache()
        finally:
            mesh.close()
    # the launches of each path: the build, each mesh search, the loops
    out["launches"] = {"mesh_build": out["build"]["launches"],
                       **{f"mesh_{name}_b{beam}": r["mesh"][str(beam)]["launches"]
                          for name, r in out["serve"].items() for beam in BEAMS},
                       "mesh_loop_drill": out["loop"]["launches"]}
    return out


def _loop_drill(sv, qp, ladder, clock) -> tuple[dict, list]:
    """Phase 8's fault drill through ``ServeLoop`` over ``sv`` on ``clock``:
    its record (every result's rid, ids, error, phase, partial and
    operating point; the counters, events and injected faults) and its
    results."""
    from repro_torch.launch.serve_loop import ServeLoop
    from repro_torch.testing.faults import FaultPlan, inject_faults

    events = []
    with inject_faults(sv, FaultPlan(**DRILL_PLAN)) as inj:
        with ServeLoop(sv, ladder=ladder, clock=clock,
                       on_event=lambda k, d: events.append([k, d]), **DRILL_LOOP) as loop:
            for qi in qp:
                loop.submit(qi)
            res = loop.run_until_drained()
            for _ in range(12):
                res += loop.step()
                if not sv.down_shards:
                    break
    check(not sv.down_shards and "search" not in vars(sv), "health or search not restored")
    record = dict(results=[(r.rid, None if r.ids is None else r.ids.tolist(), r.error, r.phase,
                            r.partial, r.op_point) for r in res],
                  counters=dict(loop.counters), events=events,
                  injected=[list(e) for e in inj.events], calls=inj.calls)
    return json.loads(json.dumps(record)), res


def phase_mesh_loop(svs: dict, q_np, full: dict, drill8: dict) -> dict:
    """Phase 10 (c): phase 8's fault drill through ``ServeLoop`` over the S =
    8 packing on the one-rank NCCL group (every search, probe and tombstone
    sent through ``ShardMesh.broadcast``) and over ``n_shards=8`` in one
    process, on a fake clock: identical records.  Then over the group on
    the real clock: the same record, and latency and requests/s beside
    phase 8's drill (the one-process loop over the same packing's twin)."""
    from repro_torch import kernels
    from repro_torch.testing.faults import poison_queries

    class FakeClock:
        def __init__(self):
            self.t = 0.0

        def __call__(self):
            return self.t

    t_start = time.perf_counter()
    ladder = phase8_ladder(full)
    qp, rows = poison_queries(q_np[:DRILL_REQUESTS], 0.05, seed=7)
    fake = {how: _loop_drill(svs[how], qp, ladder, FakeClock())[0] for how in ("n_shards", "mesh")}
    check(fake["mesh"] == fake["n_shards"],
          "phase 10 (c): the loop over the group differs from the one-process loop")
    check(len(fake["mesh"]["results"]) == DRILL_REQUESTS, "phase 10 (c): a request unanswered")
    check(sorted(r[0] for r in fake["mesh"]["results"] if r[2]) == rows.tolist()
          and all(r[2] in (None, "invalid:nan_inf") for r in fake["mesh"]["results"]),
          "phase 10 (c): structured errors are not exactly the poisoned rows")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    record, res = _loop_drill(svs["mesh"], qp, ladder, time.perf_counter)
    wall = time.perf_counter() - t0
    launches = _path_launches("phase10 loop mesh", ("gather_distance",))
    # no decision reads the clock (no deadline, no p99 target): the real
    # clock gives the fake clock's record but for the events' p99 readings
    check({k: v for k, v in record.items() if k != "events"}
          == {k: v for k, v in fake["mesh"].items() if k != "events"},
          "phase 10 (c): the real clock's drill differs from the fake clock's")
    out = {"fake_clock_identical": True, "launches": launches,
           "mesh": dict(requests=len(res), wall_s=wall, requests_per_s=len(res) / wall,
                        counters=record["counters"],
                        **_percentiles([r.latency for r in res if r.ok])),
           "phase8_drill": {k: drill8[k] for k in ("p50_ms", "p99_ms", "wall_s", "requests")}}
    out["phase8_drill"]["requests_per_s"] = drill8["requests"] / drill8["wall_s"]
    out["seconds"] = time.perf_counter() - t_start
    log("phase10 loop", json.dumps(out))
    return out


# phase 11: the examples' bars, the paths whose kernels each must launch,
# and the bounded-memory check's points and leaf k
EXAMPLE_RECALL = 0.9
BUILD_KERNELS = ("leaf_knn", "edge_hash", "segmented_merge")
BOUNDED_N = 2 ** 18
BOUNDED_K = (2, 4)
# the build's stages, each read for its own device peak (``core.pipnn``'s
# names, as ``build`` calls them)
BUILD_STAGES = ("partition_padded", "_build_reservoir_streaming", "final_prune")


@contextlib.contextmanager
def _stage_peaks(record: dict):
    """Within it, each of ``BUILD_STAGES`` that ``repro_torch.build`` calls
    has its own device peak read: the card is synchronised and the peak
    counter reset when the stage starts, and read when it ends.
    ``record[stage]`` holds the bytes allocated at its start, its peak and
    its peak above that start; ``record["between"]`` the highest peak read
    outside the stages before each reset (the counter after the last stage
    the caller reads)."""
    import torch

    from repro_torch.core import pipnn

    def wrap(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            record["between"] = max(record.get("between", 0), torch.cuda.max_memory_allocated())
            start = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            record[name] = dict(start=start, peak=peak, peak_above_start=peak - start)
            return out
        return run

    orig = {name: getattr(pipnn, name) for name in BUILD_STAGES}
    try:
        for name, fn in orig.items():
            setattr(pipnn, name, wrap(name, fn))
        yield record
    finally:
        for name, fn in orig.items():
            setattr(pipnn, name, fn)


def _example(name: str):
    """``examples/<name>.py`` of this checkout, imported as a module."""
    import importlib.util

    path = pathlib.Path(__file__).resolve().parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples_audit(x_np, seed: int, n_bounded: int) -> dict:
    """Phase 11: (a) the port's examples in this process at their default
    sizes, each held to its bar and its kernels; (b) the bounded-memory
    audit (``analysis.memory_audit.audit_all``) with zero findings; (c) the
    same ``n_bounded`` points streamed at leaf k = 2 and 4: E about doubles
    and the streaming stage's own peak, and the build's, grow by less than
    one chunk's edge buffer."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch import kernels
    from repro_torch.analysis import memory_audit
    from repro_torch.core.leaf import LeafParams

    out = {"launches": {}, "examples": {}}
    # (a) the examples; the search's kernel by the serving copy
    runs = (("torch_quickstart", [], "gather_distance"),
            ("torch_knn_graph", [], "gather_distance"),
            ("torch_rag_retrieve", ["--ann-dtype", "f32"], "gather_distance"),
            ("torch_rag_retrieve", ["--ann-dtype", "int8"], "gather_distance_int8"))
    for name, argv, search_kernel in runs:
        tag = name + (f"_{argv[-1]}" if argv else "")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        got = _example(name).main(argv)
        wall = time.perf_counter() - t0
        launches = _path_launches(f"phase11 {tag}", BUILD_KERNELS + (search_kernel,))
        rec = {k: v for k, v in got.items() if k != "ids"}
        if name == "torch_quickstart":
            check(got["recall"] >= EXAMPLE_RECALL,
                  f"quickstart recall@10 {got['recall']} below {EXAMPLE_RECALL}")
        if name == "torch_rag_retrieve":
            ids = got["ids"]
            check(ids.shape == (8, 2) and bool((ids >= 0).all()), f"{tag}: ids {ids.tolist()}")
            rec["ids"] = ids.tolist()
        out["examples"][tag] = dict(wall_s=wall, launches=launches, **rec)
        out["launches"][tag] = launches
        log("phase11 example", tag, json.dumps(out["examples"][tag]))
        torch.cuda.empty_cache()

    # (b) the memory audit
    records = {}
    t0 = time.perf_counter()
    findings = memory_audit.audit_all(device="cuda", records=records)
    out["audit_s"] = time.perf_counter() - t0
    for name, r in records.items():
        log("phase11 audit", name, json.dumps(r))
    check(findings == [], "memory audit findings:\n" + "\n".join(f.render() for f in findings))
    out["audit"] = {name: dict(peak=r["canonical_ledger"]["peak"],
                               temp=r["canonical_ledger"]["temp_bytes"],
                               model=r["workspace_model"], exponents=r["exponents"],
                               envelope_total=r["envelope_bytes"]["total"])
                    for name, r in records.items()}
    log("phase11 audit summary", json.dumps(dict(findings=0, seconds=out["audit_s"],
                                                 specs=out["audit"])))
    torch.cuda.empty_cache()

    # (c) the bounded-memory check end to end, on the streaming stage's own
    # peak: the whole build's is led by another stage
    x = np.ascontiguousarray(x_np[:n_bounded])
    builds = {}
    for k in BOUNDED_K:
        p = repro_torch.PiPNNParams(leaf=LeafParams(k=k), seed=seed)
        with _stage_peaks({}) as stages:
            idx, wall, tail, held, launches = _timed_build(
                x, p, torch.device("cuda"), f"phase11 bounded k={k}", BUILD_KERNELS)
        st = idx.stats
        peaks = {name: stages[name]["peak"] for name in BUILD_STAGES}
        peaks["between"], peaks["after"] = stages["between"], tail
        whole = max(peaks.values())
        stream = stages["_build_reservoir_streaming"]
        builds[k] = dict(wall_s=wall, peak_device_bytes=whole, peak_above_held=whole - held,
                         leading_stage=max(peaks, key=peaks.get), stages=stages,
                         stream_peak_above_start=stream["peak_above_start"],
                         reservoir_bytes=len(x) * p.l_max * 12,
                         n_candidate_edges=st["n_candidate_edges"],
                         stream_chunk_leaves=st["stream_chunk_leaves"],
                         peak_edge_bytes=st["peak_edge_bytes"], n_leaves=st["n_leaves"],
                         launches=launches)
        out["launches"][f"bounded_k{k}"] = launches
        # the stage's peak holds its reservoir and a chunk's edge buffer at
        # once, so edges kept across chunks would show in it
        check(stream["peak_above_start"] >= builds[k]["reservoir_bytes"] + st["peak_edge_bytes"],
              f"k = {k}: the streaming stage's peak {stream['peak_above_start']} B does not "
              f"hold its reservoir and one chunk's edges")
        del idx
        torch.cuda.empty_cache()
    k2, k4 = (builds[k] for k in BOUNDED_K)
    growth = k4["stream_peak_above_start"] - k2["stream_peak_above_start"]
    build_growth = k4["peak_above_held"] - k2["peak_above_held"]
    # what a stage that kept every edge would add: E's growth at 16 B an edge
    kept = (k4["n_candidate_edges"] - k2["n_candidate_edges"]) * 16
    check(k4["n_candidate_edges"] > 1.5 * k2["n_candidate_edges"],
          f"leaf k = 4 did not grow E: {k2['n_candidate_edges']} -> {k4['n_candidate_edges']}")
    check(kept > k4["peak_edge_bytes"],
          f"E grew by {kept} B of edges, within one chunk's edge buffer "
          f"{k4['peak_edge_bytes']}: the check could not fail")
    check(growth < k4["peak_edge_bytes"],
          f"the streaming stage's peak grew by {growth} bytes with E, one chunk's edge buffer "
          f"being {k4['peak_edge_bytes']}")
    check(build_growth < k4["peak_edge_bytes"],
          f"the build's peak grew by {build_growth} bytes with E, one chunk's edge buffer "
          f"being {k4['peak_edge_bytes']}")
    out["bounded"] = dict(n=len(x), builds={str(k): v for k, v in builds.items()},
                          stream_peak_growth=growth, peak_growth=build_growth,
                          kept_edges_growth=kept, chunk_edge_bytes=k4["peak_edge_bytes"],
                          edge_ratio=k4["n_candidate_edges"] / k2["n_candidate_edges"])
    log("phase11 bounded", json.dumps(out["bounded"]))
    return out


def phase_lint() -> dict:
    """Phase 12: ``lint.run_all`` with every pass on the card, one pass at
    a time (for its seconds), after setting the launch counters to 0; any
    finding fails the phase.  Returns the launches, seconds and records."""
    from repro_torch import kernels
    from repro_torch.analysis import hotpath_audit, lint

    kernels.reset_launch_counts()
    records, seconds, findings = {}, {}, []
    for name in lint.PASSES:
        t0 = time.perf_counter()
        findings += lint.run_all(passes=(name,), device="cuda", records=records)
        seconds[name] = time.perf_counter() - t0
    launches = kernels.launch_counts()
    kern = records["kernels"]
    for spec_name, rec in kern.items():
        if not isinstance(rec, dict) or "resources" not in rec:
            continue
        for fn, r in rec["resources"].items():
            log("phase12 resources", fn, json.dumps(r))
        log("phase12 sweep", spec_name, json.dumps(rec["sweep"]))
    # the spy's sync counts on the CPU beside the card's (spy and debug mode)
    cpu = {}
    hotpath_audit.audit_hot_paths("cpu", records=cpu)
    syncs = {name: dict(cpu_model=cpu[name]["syncs"], card_model=r["syncs"],
                        card_debug_mode=r["card_syncs"], budget=r["budget"],
                        card_ops=r.get("card_ops"), stray=r.get("stray"))
             for name, r in records["hotpath"]["programs"].items()}
    log("phase12 syncs", json.dumps(syncs))
    log("phase12 shapes", json.dumps(records["hotpath"]["shapes"]))
    log("phase12 mesh", json.dumps(records["mesh"], default=str))
    log("phase12 seconds", json.dumps(dict(seconds, limits=kern.get("limits"))))
    check(findings == [], "lint findings on the card:\n"
          + "\n".join(f.render() for f in findings))
    for spec_counter, n in launches.items():
        check(n > 0, f"phase 12 launched no {spec_counter} kernel")
    return dict(launches=launches, seconds=seconds, syncs=syncs)


ROOFLINE_SLACK = 1.05      # a time under its bound / this means the model overcounts
ROOFLINE_REPS = 5


def _median_ms(make) -> float:
    """Median device ms of ``fn(*args, **kwargs)`` over ``ROOFLINE_REPS`` runs after a
    warm-up, CUDA events around each; ``make()`` gives (fn, args, kwargs)
    afresh before each run, untimed (the programs write into their
    arguments)."""
    import statistics

    import torch

    times = []
    for i in range(ROOFLINE_REPS + 1):
        fn, args, kw = make()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*args, **kw)
        b.record()
        torch.cuda.synchronize()
        if i:
            times.append(a.elapsed_time(b))
        del fn, args, kw
    return statistics.median(times)


def _launch_check(r, what: str, tally) -> None:
    """Every kernel launch of the walk of ``r`` was charged: the walker's
    charged calls equal the launch counters (set to 0 before the walk)."""
    from repro_torch import kernels

    launched = {k: v for k, v in kernels.launch_counts().items() if v}
    check(r.kernel_launches == launched,
          f"{what}: the walker charged {r.kernel_launches}, the kernels launched {launched}")
    tally.update(launched)


def _roofline_row(r, ms: float, **extra) -> dict:
    bound_ms = 1e3 * r.bound_seconds()
    row = dict(name=r.name, kind=r.kind, mesh=r.mesh, t_compute=r.t_compute,
               t_memory=r.t_memory, t_collective=r.t_collective, dominant=r.dominant,
               bound_ms=bound_ms, ms=ms, time_over_bound=ms / bound_ms if bound_ms else None,
               dispatched_over_work=r.dispatched_over_work, work_ops=r.work_ops,
               work_bytes=r.work_bytes, coll_bytes=r.coll_bytes, coll_by_op=r.coll_by_op,
               dispatched_ops=r.dispatched_ops, dispatched_bytes=r.dispatched_bytes,
               launches=r.kernel_launches, bytes_per_device=r.bytes_per_device, **extra)
    check(ms >= bound_ms / ROOFLINE_SLACK,
          f"{r.name}: {ms} ms under its bound {bound_ms} ms / {ROOFLINE_SLACK}: its work "
          "model overcounts")
    return row


def _kernel_times(stats, where: str = ""):
    """Every (where, ms, bound_ms) of the kernel rows in ``stats``, nested
    shapes and the bfloat16 rows included."""
    if not isinstance(stats, dict):
        return
    for ms_key, bound_key in (("ms", "bound_ms"), ("bf16_ms", "bf16_bound_ms"),
                              ("late_ms", "late_bound_ms")):
        if stats.get(ms_key) is not None and stats.get(bound_key) is not None:
            yield f"{where}.{ms_key}", stats[ms_key], stats[bound_key]
    for k, v in stats.items():
        yield from _kernel_times(v, f"{where}.{k}" if where else k)


def phase_roofline(full: dict, kstats: dict, dist_kernels: dict, x_np, q_np, seed: int) -> dict:
    """Phase 13: the roofline (``repro_torch.roofline``).  (a) Each program
    of the memory audit at its canonical point, and the mesh audit's
    search, tile step and final prune at S = 8 on the one-process model,
    walked once on the card and timed without the walker (median of
    ``ROOFLINE_REPS`` after a warm-up): terms, dominant, bound, time over
    bound, dispatched over work.  (b) The default ``build`` of all of
    ``x_np`` and phase 3's float32 search at each beam, walked once each,
    their bounds beside phase 3's times.  (c) The hot-path audit's programs
    walked on the card and on the CPU on the same inputs: equal counts;
    every launch of every walk charged; no program's or kernel's time under
    its bound / ``ROOFLINE_SLACK``; every record complete."""
    from collections import Counter

    import numpy as np
    import torch

    import repro_torch
    from repro_torch import kernels
    from repro_torch.analysis import hotpath_audit, memory_audit, mesh_audit
    from repro_torch.roofline import analyze_program
    from repro_torch.roofline.analysis import RECORD_KEYS, markdown_table, record

    dev = torch.device("cuda")
    tally: Counter = Counter()
    rows, roofs = [], []
    t0 = time.perf_counter()
    # (a) the registered programs
    for spec in memory_audit.default_specs():
        kernels.reset_launch_counts()
        r = memory_audit.roofline_of(spec, device=dev)
        _launch_check(r, spec.name, tally)
        rec = record(r)
        check(all(rec.get(k) is not None for k in RECORD_KEYS),
              f"{spec.name}: roofline record incomplete")

        def make(spec=spec):
            prog = spec.build(spec.base, dev)
            return prog.fn, prog.args, prog.kwargs

        rows.append(_roofline_row(r, _median_ms(make), point=spec.base))
        roofs.append(r)
        torch.cuda.empty_cache()
    for spec in mesh_audit.default_specs():
        if spec.program is None:
            continue
        kernels.reset_launch_counts()
        r = mesh_audit.program_roofline(spec, dev)
        _launch_check(r, spec.name, tally)

        def make(spec=spec):
            fn, args, _ = spec.program(mesh_audit.model_mesh(mesh_audit.ROOFLINE_SHARDS, dev),
                                       dev)
            return fn, args, {}

        rows.append(_roofline_row(r, _median_ms(make), point=f"S={mesh_audit.ROOFLINE_SHARDS}"))
        roofs.append(r)
    for row in rows:
        log("phase13 program", json.dumps(row, default=str))
    log("phase13 programs_s", round(time.perf_counter() - t0, 3))

    # (b) at full width: the build and phase 3's search, walked once each
    n, d = x_np.shape
    params = repro_torch.PiPNNParams(seed=seed)
    kernels.reset_launch_counts()
    t1 = time.perf_counter()
    rb = analyze_program(lambda: repro_torch.build(x_np, params, device=dev), name="build",
                         kind="build", device=dev,
                         work=lambda w: memory_audit.build_work(w, n, d, params.max_deg))
    walk_s = time.perf_counter() - t1
    _launch_check(rb, "the full-size build", tally)
    index = rb.walk.out
    check_index(index)
    full_rows = [_roofline_row(rb, 1e3 * full["wall"], phase3="build wall_s",
                               walked_s=walk_s, n=n)]
    roofs.append(rb)
    repro_torch.search(index, x_np, q_np[:100], k=10, beam=BEAMS[0], device=dev)
    nq = q_np.shape[0]
    r_deg = int(index.graph.shape[1])
    for beam in BEAMS:
        def work(w):
            return memory_audit.search_work(w, float(np.sum(w.out[1]["hops"])), r_deg,
                                            float(nq * d * 4 + nq * 10 * 4))

        kernels.reset_launch_counts()
        rs = analyze_program(lambda: repro_torch.search(index, x_np, q_np, k=10, beam=beam,
                                                        with_stats=True, device=dev),
                             name=f"search beam {beam}", kind="serve", device=dev, work=work)
        _launch_check(rs, f"the search at beam {beam}", tally)
        secs = full["searches"]["float32"][beam]["seconds"]
        full_rows.append(_roofline_row(rs, 1e3 * secs, phase3="search seconds, 10,000 queries",
                                       queries=nq))
        roofs.append(rs)
    del index
    for row in full_rows:
        log("phase13 full", json.dumps(row, default=str))
    torch.cuda.empty_cache()

    # (c) the hot-path programs: the card's walk equals the CPU's
    same = {}
    for prog in hotpath_audit.default_programs():
        kernels.reset_launch_counts()
        rc = hotpath_audit.program_roofline(prog, dev)
        _launch_check(rc, prog.name, tally)
        rh = hotpath_audit.program_roofline(prog, "cpu")
        keys = ("dispatched_ops", "dispatched_bytes", "dispatched_coll_bytes", "work_ops",
                "work_bytes", "coll_bytes", "kernel_launches")
        got = {k: (getattr(rc, k), getattr(rh, k)) for k in keys}
        same[prog.name] = dict(card=record(rc), cpu_equal=all(a == b for a, b in got.values()))
        check(same[prog.name]["cpu_equal"], f"{prog.name}: the card's walk differs from the "
              f"CPU's: {[(k, v) for k, v in got.items() if v[0] != v[1]]}")
    log("phase13 card_vs_cpu", json.dumps(same, default=str))
    kernel_rows = []
    for where, ms, bound_ms in [*_kernel_times(kstats), *_kernel_times(dist_kernels, "phase9")]:
        kernel_rows.append([where, ms, bound_ms, ms / bound_ms])
        check(ms >= bound_ms / ROOFLINE_SLACK, f"kernel {where}: {ms} ms under its bound "
              f"{bound_ms} ms / {ROOFLINE_SLACK}: its work model overcounts")
    log("phase13 kernels time_over_bound", json.dumps(kernel_rows))
    for line in markdown_table(roofs).splitlines():
        log("phase13 table", line)
    return dict(launches=dict(tally), programs=rows, full=full_rows)


def _sites(replaces: tuple) -> str:
    """``a.py:1`` and ``a.py:2`` as ``a.py:1 and :2``."""
    return " and :".join([replaces[0]] + [r.rpartition(":")[2] for r in replaces[1:]])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--n-small", type=int, default=65_536)
    ap.add_argument("--queries", type=int, default=10_000)
    ap.add_argument("--n-cpu", type=int, default=16_384,
                    help="points of phase 7's leaf-method builds on the card and the CPU")
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
    kstats.update(phase_gather(full["servings"], torch.from_numpy(q_np).cuda(), gauss,
                               gauss_q, full["truth"]))
    log("phase4 s", round(time.perf_counter() - t0, 3))
    del full["servings"]
    # phase 7 compares with phase 3's graph: kept on the host meanwhile, so
    # the card holds what it held in phases 5 and 6 before phase 7 existed
    idx = full["index"]
    idx.graph, idx.dists = idx.graph.cpu(), idx.dists.cpu()
    for attr in ("_serving", "_serving_x", "_serving_graph", "_serving_key"):
        idx.__dict__.pop(attr, None)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    kstats.update(phase_leader(x_np, gauss, args.seed))
    log("phase5 s", round(time.perf_counter() - t0, 3))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    static = phase_static(x_np, q_np, gauss, args.seed, torch.device("cuda"), full)
    full["launches"].update(static["launches"])
    for name, s in static["level1"].items():
        kstats[name]["level1"] = s
    log("phase6 s", round(time.perf_counter() - t0, 3))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    opts = phase_options_full(x_np, q_np, args.seed, torch.device("cuda"), full)
    opts["leaf_methods"] = phase_leaf_methods(args.n_small, args.n_cpu, min(args.queries, 1000),
                                              args.seed, torch.device("cuda"))
    opts["search"] = phase_host_search(full, x_np, q_np, torch.device("cuda"))
    log("phase7 s", round(time.perf_counter() - t0, 3))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    sharded = phase_sharded(full, x_np, q_np, args.seed, torch.device("cuda"), args.n_small)
    served = phase_loop(full, sharded, q_np, torch.device("cuda"))
    phase8 = {**sharded["launches"], **served["launches"]}
    drill8 = served["drill"]
    del sharded, served
    log("phase8 s", round(time.perf_counter() - t0, 3))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    dist = phase_dist(x_np, q_np, args.seed, torch.device("cuda"), dist_tile(args.n), DIST_L0)
    log("phase9 s", round(time.perf_counter() - t0, 3))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    mesh = phase_mesh(x_np, q_np, full, dist, dist_tile(args.n), DIST_L0, drill8)
    log("phase10 s", round(time.perf_counter() - t0, 3))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    audit = phase_examples_audit(x_np, args.seed, dist_tile(args.n))
    log("phase11 s", round(time.perf_counter() - t0, 3))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    lint_out = phase_lint()
    log("phase12 s", round(time.perf_counter() - t0, 3))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    roof = phase_roofline(full, kstats, dist["kernels"], x_np, q_np, args.seed)
    log("phase13 s", round(time.perf_counter() - t0, 3))

    # each kernel's CUDA source, the TPU kernels' pallas_calls and its launch
    # counter come from the contract registry; the path whose run its
    # launches are read from
    from repro_torch.analysis import contracts

    paths = {"leaf_topk": "build", "edge_hashes": "build", "merge_sorted_reservoirs": "build",
             "gather_distance": "float32", "gather_distance_int8": "int8",
             "pairwise_distance": "static build", "pairwise_distance_int8": "quantized",
             "rowwise_topk": "static build"}
    sources = {spec.name: (spec.source, _sites(spec.replaces), spec.counter, paths[spec.name])
               for spec in contracts.REGISTRY}
    # phase 9's runs: the distributed build at S = 1 and 8 and its variants
    p9 = {**{f"S{s}": dist[f"S{s}"]["launches"] for s in (1, DIST_SHARDS)},
          "two_tiles": dist["two_tiles"]["launches"],
          **{v: r["launches"] for v, r in dist["variants"].items()},
          "knn_graph": dist["knn_graph"]["launches"]}
    p9_kernels = {"pairwise_distance": ("pairwise_distance_level0", "pairwise_distance_level1"),
                  "rowwise_topk": ("rowwise_topk_level0", "rowwise_topk_level1",
                                   "rowwise_topk_leaf"),
                  "pairwise_distance_int8": ("pairwise_distance_int8_leaf",),
                  "merge_sorted_reservoirs": ("merge_sorted_reservoirs_fold",)}
    rows = []
    for name, (cu, replaces, counter, path) in sources.items():
        s = kstats[name]
        # the int8 distance's path is phase 9's quantized build, its first
        # build path; every other kernel's is named in ``sources``
        launches = (p9[path][counter] if name == "pairwise_distance_int8"
                    else full["launches"][path][counter])
        row = dict(name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/{cu}",
                   replaces=replaces, launches=launches, max_abs_err=s["max_abs_err"],
                   ms=s["ms"], kernel_ms=s["ms"], plain_ms=s["plain_ms"],
                   bound_ms=s["bound_ms"], bound_by=s["bound_by"],
                   library_ms=s.get("library_ms"), library=s.get("library"),
                   tolerance=s["tolerance"])
        if name in ("leaf_topk", "pairwise_distance"):
            row.update(bound_f32_cuda_core_ms=s["bound_f32_cuda_core_ms"])
        if name in ("pairwise_distance", "rowwise_topk"):
            # the times above are Stage 1's root subproblem (phase 5); the
            # static carve's level-1 block (and for the top-k its level-0
            # k) beside them
            row.update({k: s[k] for k in ("level1", "level0") if k in s},
                       root_subproblem_launches=s["launches"])
        if counter in ("leaf_knn", "edge_hash", "segmented_merge"):
            # launches on phase 7's paths
            row.update(
                flat_build_launches=opts["flat_build"]["launches"][counter],
                flat_fold_launches=opts["flat_fold"]["launches"][counter],
                final_prune_off_launches=opts["final_prune_off"]["launches"][counter],
                leaf_methods_launches={m: r["launches"][counter] for m, r in
                                       opts["leaf_methods"]["methods"].items()},
                robust_prune_flat_launches=opts["leaf_methods"]["methods"]["robust_prune"][
                    "flat_launches"][counter])
        if name == "leaf_topk":
            row.update({k: v for k, v in s.items() if k.startswith("k16_")})
        if name == "pairwise_distance_int8":
            row.update(cross_term_library=s["cross_term_library"],
                       cross_term_library_ms=s["cross_term_library_ms"],
                       phase5_launches=s["launches"])
        if name in p9_kernels:
            row.update(phase9_launches={k: v[counter] for k, v in p9.items()},
                       phase9_shapes={k: dist["kernels"][k] for k in p9_kernels[name]})
        # phase 10: the build, the searches and the serving loop over the
        # one-rank NCCL group (the loop also in one process)
        row.update(phase10_launches={k: v[counter] for k, v in mesh["launches"].items()})
        # phase 11: the examples and the bounded-memory builds
        row.update(phase11_launches={k: v[counter] for k, v in audit["launches"].items()})
        # phase 12: the contract checker's sweep and programs
        row.update(phase12_launches=lint_out["launches"][counter])
        # phase 13: the roofline's walks of the registered programs, the
        # full-size build and searches and the hot-path programs
        row.update(phase13_launches=roof["launches"].get(counter, 0))
        if name == "merge_sorted_reservoirs":
            late = s["late"]
            row.update(valid_slots_per_row=s["valid_slots_per_row"], late_ms=late["ms"],
                       late_bound_ms=late["bound_ms"],
                       late_valid_slots_per_row=late["valid_slots_per_row"])
        if name == "gather_distance_int8":
            row.update(no_reuse_ms=s["no_reuse_ms"],
                       phase8_launches={k: v for k, v in phase8.items() if "_int8_" in k})
        if name == "gather_distance":
            # phase 8: each S = 8 search at full size (f32, bf16; router
            # "all" and "leaders"), the fault drill and the serving loop
            row.update(phase8_launches={k: v for k, v in phase8.items() if "_int8_" not in k})
            row.update(no_reuse_ms=s["no_reuse_ms"],
                       bf16_launches=full["launches"]["bfloat16"]["gather_distance"],
                       **{k: v for k, v in s.items() if k.startswith("bf16_")})
        rows.append(row)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
