"""Where the card's time goes in one build and one search.

    PYTHONPATH=src python -m repro_torch.trace_build [--n N] [--queries Q] [--seed S]

Builds the SIFT-like data set of ``chip_smoke.py`` (n = 1M, d = 128 by
default) and searches it once at beam 64, under ``torch.profiler``.  Prints
one JSON line per region (build, search) with its wall seconds, the
device-busy seconds (the union of all kernel and copy intervals in the
trace), the idle share of the card, and the ten kernels with the most
device time.  Needs a card; the traced run is slower than an untraced one,
so end-to-end times come from ``chip_smoke.py``, not from here.
"""
from __future__ import annotations

import argparse
import json
import time


def _busy_seconds(events) -> float:
    """Seconds covered by the union of the device intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy * 1e-6          # the profiler's times are microseconds


def _region(name: str, fn) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy = _busy_seconds(dev)
    per_kernel: dict[str, float] = {}
    for e in dev:
        per_kernel[e.name] = per_kernel.get(e.name, 0.0) + (e.time_range.end
                                                            - e.time_range.start) * 1e-6
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    return dict(region=name, wall_s=wall, device_busy_s=busy,
                idle_share=1.0 - busy / wall if wall > 0 else None,
                n_device_events=len(dev),
                top_kernels=[dict(name=k[:90], seconds=v) for k, v in top])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=10_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import repro_torch
    from repro_torch.data import VectorPipelineConfig, make_queries, make_vectors, sift_like

    cfg = VectorPipelineConfig(n=args.n, dim=128, n_clusters=1024, seed=args.seed)
    x = sift_like(make_vectors(cfg))
    q = sift_like(make_queries(cfg, args.queries))
    repro_torch.build(x[:20_000])          # first use: kernel build, CUDA set-up
    out = {}
    print(json.dumps(_region("build", lambda: out.setdefault(
        "index", repro_torch.build(x, repro_torch.PiPNNParams(seed=args.seed))))),
        flush=True)
    repro_torch.search(out["index"], x, q[:100], k=10, beam=64)   # packs the index
    print(json.dumps(_region("search_beam64", lambda: repro_torch.search(
        out["index"], x, q, k=10, beam=64))), flush=True)


if __name__ == "__main__":
    main()
