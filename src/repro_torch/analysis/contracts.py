"""Kernel contract checker of the port (counterpart of
``repro/analysis/contracts.py``): rules PIPK001-005 over the CUDA kernels.

The registry (``REGISTRY``) has one entry a port kernel, paired with the
Pallas kernels it replaces: the wrapper, its plain version, its C entries
in ``_build.SIGNATURES``, its launch counter in ``kernels._MODULES``, its
``__global__`` functions and their template instantiations in ``csrc/``,
its tolerance (the one statement ``chip_smoke.py`` reads too) and a case
generator over the wrapper's admitted range.

  PIPK001  resources.  ptxas' report (``_build.build()`` writes it beside
           the library) gives each kernel function's registers, spill
           stores and loads, stack frame and static shared memory; the
           launch's own plan (a C ``*_plan`` entry the launch shares its
           arithmetic with) gives the dynamic shared memory at each swept
           shape.  Held against the function's ``__launch_bounds__(threads,
           min_blocks)``: no spill byte (unless the entry states a reviewed
           bound), registers x threads x min_blocks within the SM's 65,536,
           static + dynamic shared memory within the per-block opt-in
           limit, and min_blocks blocks' shared memory (with the 1 KB each
           block reserves) within the SM's 228 KB.  The VMEM budget and
           tile padding of the TPU rule have no counterpart.
  PIPK002  alignment.  The sweep includes inputs 4 bytes past a 16-byte
           boundary (a contiguous slice of a larger buffer) and row widths
           that are not multiples of 4: the hazard of the 16-byte loads.
           The kernel must equal its plain version there, or its wrapper
           must refuse the input with ``ValueError``.  The TPU (sublane,
           lane) tile rule has no meaning on the card.
  PIPK003  coverage.  Before each swept call the caching allocator's free
           blocks are poisoned (the cache emptied, then blocks allocated at
           the outputs' sizes, filled with the byte 0x7F, freed), then the
           output is held against the plain version at the entry's
           tolerance: an element the grid never writes keeps the poison and
           fails.  An output of a kernel that does not work in place must
           lie in poisoned memory, or the case tested nothing and fires.
           The shapes are the edges of each wrapper's admitted range.
  PIPK004  pairing.  Each entry's plain version resolves, its C symbols
           are in ``SIGNATURES`` and its counter in ``_MODULES``; on the
           card every swept call moves the counter (a call that launches
           nothing is a stale entry).
  PIPK005  census, from the sources alone: every ``__global__`` in
           ``csrc/*.cu``, every ``SIGNATURES`` key, every wrapper function
           that calls ``_build.library()`` and every reference
           ``pallas_call`` site is claimed by exactly one entry, and every
           entry's symbols exist.  A kernel whose entry has no plan must
           launch with no dynamic shared memory.  On the card the
           instantiations in ptxas' report equal the declared ones.

On the CPU PIPK001-003 report a skip with zero findings (no toolchain, no
kernel); PIPK004's static part and PIPK005 run anywhere.
"""
from __future__ import annotations

import ast
import dataclasses
import importlib
import itertools
import math
import pathlib
import re
from typing import Callable

import torch

from repro_torch.analysis.lint import Finding, report, repo_root

EPS32 = 2.0 ** -23
POISON = 0x7F                   # the byte poured into free blocks
POISON_WORD = 0x7F7F7F7F        # four of them: an int32 or float32 element
SM_REGISTERS = 65536            # registers of an SM (every card since Kepler)
SM_SHARED = 228 * 1024          # shared memory of an H100 SM
BLOCK_SHARED_OPTIN = 227 * 1024 # the most one block may opt in to on an H100
BLOCK_RESERVED = 1024           # shared memory the system reserves a block
REG_GRANULE = 8                 # registers are allocated 8 a thread (256 a warp)

CSRC = "src/repro_torch/kernels/csrc"


# ---------------------------------------------------------------------------
# tolerances (chip_smoke.py reads the same statements)
# ---------------------------------------------------------------------------

def tf32_limit(want: torch.Tensor, max_sq) -> torch.Tensor:
    """3xTF32 products (the leaf and pairwise kernels) against float32:
    ``1e-5 |d| + 32 eps max|x|^2``."""
    return want.abs() * 1e-5 + 32 * EPS32 * max_sq


def gather_limit(want: torch.Tensor, scale, metric: str = "l2") -> torch.Tensor:
    """The gather's norm expansion against the plain version's: l2 and
    mips ``1e-5 |d| + 16 eps (|q|^2 + |p|^2)`` (``scale``), cosine (which
    divides by a rounded sqrt) ``1e-5 |d| + 1e-5``."""
    if metric == "cosine":
        return want.abs() * 1e-5 + 1e-5
    return want.abs() * 1e-5 + 16 * EPS32 * scale


# each kernel's tolerance as stated beside its numbers (its limit functions
# above where it is not exact)
EXACT = "bit-exact"
TF32_TOL = "exact on integer data; Gaussian |err| <= 1e-5 |d| + 32 eps max|x|^2"
GATHER_TOL = ("exact on integer data (l2, mips); Gaussian |err| <= 1e-5 |d| + 16 eps "
              "(|q|^2 + |p|^2) (l2, mips), 1e-5 |d| + 1e-5 (cosine)")
GATHER8_TOL = "bit-exact on integer and Gaussian data, all three metrics"
INT32_TOL = "exact (int32)"
TOPK_TOL = "exact (ids and values)"


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Case:
    """One swept call: ``make(device, gen)`` returns the wrapper's (args,
    kwargs); ``params`` feed the plan and the reviewed bounds."""

    label: str
    params: dict
    make: Callable
    misaligned: bool = False


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    name: str                   # the wrapper's name (a row of chip_smoke's kernels line)
    wrapper: str                # "module:symbol"
    plain: str                  # "module:symbol" of the plain version
    counter: str                # key of kernels._MODULES
    source: str                 # csrc/*.cu file
    c_symbols: tuple            # its entries in _build.SIGNATURES
    kernels: dict               # __global__ base name -> declared instantiations
    replaces: tuple             # reference pallas_call sites, "path:line"
    tolerance: str
    cases: Callable             # () -> [Case]
    compare: Callable           # (got, want, args, kwargs) -> (ok, max_err, note)
    plan: Callable | None = None     # case params -> {"smem", "K"?}; None: no dynamic smem
    spills: dict = dataclasses.field(default_factory=dict)   # reviewed: inst -> spill bytes
    smem_blocks: Callable | None = None   # case params -> blocks the design accepts
    reviewed: str = ""               # why a reviewed bound is what it is
    in_place: bool = False           # the kernel writes its outputs into its inputs

    @property
    def module(self) -> str:
        return self.wrapper.partition(":")[0]

    @property
    def path(self) -> str:
        return "src/" + self.module.replace(".", "/") + ".py"


def _resolve(ref: str):
    mod, _, name = ref.partition(":")
    return getattr(importlib.import_module(mod), name)


# -- data makers --------------------------------------------------------------

def _aligned(shape, dtype, dev, fill: Callable, misaligned: bool) -> torch.Tensor:
    """A contiguous tensor of ``shape``, 4 bytes past a 16-byte boundary
    when ``misaligned`` (a slice of a larger buffer), filled by
    ``fill(tensor)``."""
    numel = math.prod(shape)
    if not misaligned:
        t = torch.empty(shape, dtype=dtype, device=dev)
    else:
        off = max(1, 4 // torch.empty((), dtype=dtype).element_size())
        t = torch.empty(numel + off + 16, dtype=dtype, device=dev)[off:off + numel].view(shape)
    fill(t)
    return t


def _gauss(gen):
    return lambda t: t.copy_(torch.randn(t.shape, generator=gen, device=t.device,
                                         dtype=torch.float32).to(t.dtype))


def _ints(gen, lo: int, hi: int):
    return lambda t: t.copy_(torch.randint(lo, hi, t.shape, generator=gen, device=t.device,
                                           dtype=t.dtype))


def _ids_with_pad(gen, n: int, pad_share: float = 0.2):
    """int32 ids in [0, n) with about ``pad_share`` of them -1."""
    def fill(t):
        ids = torch.randint(0, n, t.shape, generator=gen, device=t.device, dtype=torch.int32)
        pad = torch.rand(t.shape, generator=gen, device=t.device) < pad_share
        t.copy_(torch.where(pad, -1, ids))
    return fill


def _leaf_ids(gen, n: int, b: int, c: int, dev, misaligned: bool) -> torch.Tensor:
    """[b, c] leaves of distinct points: the first full, the second about
    half full, the last all padding."""
    def fill(t):
        t.fill_(-1)
        for i, size in enumerate((c, c // 2 + 3)[: b - 1]):
            size = min(size, c)
            t[i, :size] = torch.randperm(n, generator=gen, device=dev)[:size].to(torch.int32)
    return _aligned((b, c), torch.int32, dev, fill, misaligned)


# -- comparisons --------------------------------------------------------------

def _poisoned(t: torch.Tensor) -> bool:
    if t.dtype in (torch.int32, torch.float32):
        return bool((t.view(torch.int32) == POISON_WORD).any())
    return False


def _exact(got, want, *_):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    ok = all(g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w)
             for g, w in zip(got, want))
    err = 0.0
    for g, w in zip(got, want):
        if g.shape == w.shape and g.is_floating_point():
            fin = torch.isfinite(w)
            if bool(fin.any()):
                err = max(err, float((g[fin] - w[fin]).abs().max()))
    return ok, err, "" if ok else "differs from the plain version"


def _cmp_leaf(got, want, args, kwargs):
    """Distances slot by slot within the 3xTF32 tolerance, the same finite
    pattern, and each returned id's own distance equal to its slot's (so a
    right distance under a wrong id fails); ids may differ where distances
    tie within the tolerance."""
    (gi, gd), (wi, wd) = got, want
    points, leaf_ids = args[0], args[1]
    fin = torch.isfinite(wd)
    if not torch.equal(torch.isfinite(gd), fin) or not torch.equal(gi < 0, ~fin):
        return False, float("inf"), "finite pattern differs"
    if not bool(fin.any()):
        return True, 0.0, ""
    max_sq = float((points * points).sum(dim=1).max())
    err = (gd[fin] - wd[fin]).abs()
    ok = bool((err <= tf32_limit(wd[fin], max_sq)).all())
    b, c, k = gi.shape
    ids = leaf_ids.long()
    nb = torch.gather(ids, 1, gi.clamp_min(0).reshape(b, c * k).long()).reshape(b, c, k)
    own = ((points[ids.clamp_min(0)][:, :, None, :] - points[nb.clamp_min(0)]) ** 2).sum(-1)
    ok = ok and bool(((own[fin] - gd[fin]).abs() <= tf32_limit(gd[fin], max_sq)).all())
    return ok, float(err.max()), "" if ok else "distances beyond tolerance"


def _cmp_gather(got, want, args, kwargs):
    points, _, queries, ids = args[:4]
    metric = kwargs.get("metric", "l2")
    fin = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), fin):
        return False, float("inf"), "inf pattern differs"
    if not bool(fin.any()):
        return True, 0.0, ""
    p32 = points.float()
    scale = (queries * queries).sum(1)[:, None] + (p32 * p32).sum(1)[ids.clamp_min(0).long()]
    err = (got[fin] - want[fin]).abs()
    ok = bool((err <= gather_limit(want[fin], scale[fin], metric)).all())
    return ok, float(err.max()), "" if ok else "beyond tolerance"


def _cmp_pairwise(got, want, args, kwargs):
    a, b = args[0], args[1]
    if got.shape != want.shape:
        return False, float("inf"), "shape differs"
    if want.numel() == 0:
        return True, 0.0, ""
    max_sq = max(float((a * a).sum(-1).max()) if a.numel() else 0.0,
                 float((b * b).sum(-1).max()) if b.numel() else 0.0)
    err = (got - want).abs()
    ok = bool((err <= tf32_limit(want, max_sq)).all())
    return ok, float(err.max()), "" if ok else "beyond tolerance"


# -- case generators ----------------------------------------------------------

KS = (1, 32)                           # k at both ends of 1..MAX_K
DEPTHS = (8, 100, 128, 736, 1024)      # D: tiny, not a multiple of 4, the build's, deep
WIDTHS_N = (1, 16, 80, 1000, 1025)     # N: 1, under a tile, not a multiple of 4 or the block
HASH_BITS = (1, 12, 16)
RESERVOIR_L = (1, 64, 96, 128)


def _leaf_cases() -> list[Case]:
    n = 4096
    cases = []
    for k, d, c in itertools.product(KS, DEPTHS, (70, 1024)):
        cases.append(_leaf_case(n, 3, c, d, k, False))
    # the build's leaves (c_max 1024, d 128) at its k = 2 and at the largest
    # register list and the smaller shared-memory list
    cases += [_leaf_case(n, 3, 1024, 128, k, False) for k in (2, 8, 16)]
    for k in KS:
        cases.append(_leaf_case(n, 3, 1024, 128, k, True))
    return cases


def _leaf_case(n, b, c, d, k, mis) -> Case:
    def make(dev, gen):
        pts = _aligned((n, d), torch.float32, dev, _gauss(gen), mis)
        return (pts, _leaf_ids(gen, n, b, c, dev, mis), k), {"metric": "l2"}
    return Case(f"B={b} C={c} d={d} k={k}" + (" misaligned" if mis else ""),
                dict(c=c, d=d, k=k), make, mis)


def _edge_cases() -> list[Case]:
    cases = []
    for m, e in itertools.product(HASH_BITS, (1, 1025, 100_003)):
        cases.append(_edge_case(m, e, False))
    for m in (12, 16):
        cases.append(_edge_case(m, 1025, True))
    return cases


def _edge_case(m, e, mis) -> Case:
    n = 1000

    def make(dev, gen):
        sk = _aligned((n, m), torch.float32, dev, _gauss(gen), mis)
        src = _aligned((e,), torch.int32, dev, _ids_with_pad(gen, n, 0.1), mis)
        dst = _aligned((e,), torch.int32, dev, _ids_with_pad(gen, n, 0.1), mis)
        return (sk, src, dst), {}
    return Case(f"E={e} m={m}" + (" misaligned" if mis else ""), dict(m=m, e=e), make, mis)


def _reservoir(n, l, dev, gen, mis):
    """A valid [n, l] reservoir (sorted live prefix, one slot a bucket,
    (-1, 0, +inf) padding), from ``hashprune_flat`` of random edges with
    few hash buckets, so that A and B collide."""
    from repro_torch.core.hashprune import hashprune_flat

    e = max(1, n * l * 2)
    src = torch.randint(0, n + 1, (e,), generator=gen, device=dev, dtype=torch.int32)
    dst = torch.randint(0, 4 * max(l, 4), (e,), generator=gen, device=dev, dtype=torch.int32)
    hs = torch.randint(0, max(2, l + l // 2), (e,), generator=gen, device=dev,
                       dtype=torch.int32)
    ds = torch.randint(0, 64, (e,), generator=gen, device=dev).to(torch.float32)
    res = hashprune_flat(src, dst, hs, ds, n_points=n, l_max=l)
    return tuple(_aligned(t.shape, t.dtype, dev, lambda o, t=t: o.copy_(t), mis) for t in res)


def _merge_cases() -> list[Case]:
    cases = [_merge_case(n, l, False) for l in RESERVOIR_L for n in (1, 1000)]
    cases += [_merge_case(1000, l, True) for l in (64, 96)]
    return cases


def _merge_case(n, l, mis) -> Case:
    def make(dev, gen):
        return (*_reservoir(n, l, dev, gen, mis), *_reservoir(n, l, dev, gen, mis)), {}
    return Case(f"n={n} l={l}" + (" misaligned" if mis else ""), dict(l=l, n=n), make, mis)


def _gather_cases(dtype) -> list[Case]:
    cases = [_gather_case(d, 7, c, dtype, False, "l2") for d in DEPTHS for c in (33, 1025)]
    cases += [_gather_case(128, 7, 1025, dtype, False, m) for m in ("mips", "cosine")]
    cases += [_gather_case(d, 7, 1025, dtype, True, "l2") for d in (128, 100)]
    return cases


def _gather_case(d, nq, c, dtype, mis, metric) -> Case:
    n = 5000

    def make(dev, gen):
        from repro_torch.core.metrics import point_norms

        x = torch.randn((n, d), generator=gen, device=dev)
        norms = point_norms(x, metric)
        pts = _aligned((n, d), dtype, dev, lambda t: t.copy_(x.to(dtype)), mis)
        q = _aligned((nq, d), torch.float32, dev, _gauss(gen), mis)
        ids = _aligned((nq, c), torch.int32, dev, _ids_with_pad(gen, n), mis)
        return (pts, norms, q, ids), {"metric": metric}
    tag = {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]
    return Case(f"{tag} d={d} Q={nq} C={c} {metric}" + (" misaligned" if mis else ""),
                dict(d=d, c=c), make, mis)


def _gather8_cases() -> list[Case]:
    cases = [_gather8_case(d, 7, c, False, "l2") for d in DEPTHS for c in (33, 1025)]
    cases += [_gather8_case(128, 7, 1025, False, m) for m in ("mips", "cosine")]
    cases += [_gather8_case(d, 7, 1025, True, "l2") for d in (128, 100)]
    return cases


def _gather8_case(d, nq, c, mis, metric) -> Case:
    n = 5000

    def make(dev, gen):
        from repro_torch.core.metrics import point_norms
        from repro_torch.kernels.gather_distance_int8 import quantize_symmetric

        x = torch.randn((n, d), generator=gen, device=dev)
        norms = point_norms(x, metric)
        x8, scales = quantize_symmetric(x)
        pts = _aligned((n, d), torch.int8, dev, lambda t: t.copy_(x8), mis)
        q = _aligned((nq, d), torch.float32, dev, _gauss(gen), mis)
        ids = _aligned((nq, c), torch.int32, dev, _ids_with_pad(gen, n), mis)
        return (pts, scales, norms, q, point_norms(q, metric), ids), {"metric": metric}
    return Case(f"int8 d={d} Q={nq} C={c} {metric}" + (" misaligned" if mis else ""),
                dict(d=d, c=c), make, mis)


def _pairwise_shapes():
    shapes = [(2, 130, n, 128) for n in WIDTHS_N]
    shapes += [(2, 130, 1025, d) for d in DEPTHS if d != 128]
    return shapes


def _pairwise_cases(int8: bool) -> list[Case]:
    cases = [_pairwise_case(*s, int8, False) for s in _pairwise_shapes()]
    cases += [_pairwise_case(2, 130, 1000, d, int8, True) for d in (128, 100)]
    return cases


def _pairwise_case(b, m, n, d, int8, mis) -> Case:
    def make(dev, gen):
        if int8:
            fill, dt = _ints(gen, -128, 128), torch.int8
        else:
            fill, dt = _gauss(gen), torch.float32
        a = _aligned((b, m, d), dt, dev, fill, mis)
        bb = _aligned((b, n, d), dt, dev, fill, mis)
        return (a, bb), ({} if int8 else {"metric": "l2"})
    return Case(f"B={b} M={m} N={n} D={d}" + (" misaligned" if mis else ""),
                dict(b=b, m=m, n=n, d=d), make, mis)


def _topk_cases() -> list[Case]:
    cases = [_topk_case(n, k, False) for k in KS for n in WIDTHS_N + (65_537,)]
    cases += [_topk_case(n, 32, True) for n in (1000, 1025)]
    return cases


def _topk_case(n, k, mis) -> Case:
    def make(dev, gen):
        def fill(t):
            v = torch.randint(0, 50, t.shape, generator=gen, device=dev).to(torch.float32)
            masked = torch.rand(t.shape, generator=gen, device=dev) < 0.1
            t.copy_(torch.where(masked, float("inf"), v))   # ties and masked entries
        return (_aligned((2, 33, n), torch.float32, dev, fill, mis), k), {}
    return Case(f"B=2 M=33 N={n} k={k}" + (" misaligned" if mis else ""), dict(n=n, k=k),
                make, mis)


# -- plans ------------------------------------------------------------------

def _leaf_plan(p: dict) -> dict:
    from repro_torch.kernels import leaf_knn

    return leaf_knn.launch_plan(p["c"], p["d"], p["k"])


def _merge_plan(p: dict) -> dict:
    from repro_torch.kernels import segmented_merge

    return segmented_merge.launch_plan(p["l"])


def _pairwise_plan(p: dict) -> dict:
    from repro_torch.kernels import distance

    return distance.launch_plan()


def _pairwise8_plan(p: dict) -> dict:
    from repro_torch.kernels import distance

    return distance.launch_plan_int8()


LEAF_REVIEW = ("the leaf kernel's 3 blocks an SM (__launch_bounds__(128, 3)) hold where "
               "the build runs it, k <= 8 at d <= 128 on leaves of up to 1024; the wide "
               "lists (k > 8) and deeper rows keep the whole row tile and the lists in "
               "shared memory and run 2 or 1 blocks an SM by design (LEAF_BLOCKS).  Under "
               "the launch bound's 168 registers the register lists of K = 5..8 spill part "
               "of themselves (ptxas' report on the H100 toolchain); k = 1..4 spill nothing")
# Reviewed spills (bytes of stores + loads in ptxas' report, H100 toolchain):
# each is the price of the register cap its __launch_bounds__ sets for
# occupancy.  A spill that grows past its entry, or a new one, fires PIPK001.
LEAF_SPILLS = {(5, 1): 98, (6, 1): 370, (6, 4): 374, (7, 1): 538, (7, 4): 546,
               (8, 1): 682, (8, 4): 642}
CAP_REVIEW = ("the __launch_bounds__ register cap is the kernel's occupancy choice (its "
              "source's note); ptxas spills the stated bytes under it, and whether the cap "
              "pays for them is a measurement for a later change")


# Reviewed floor: the swept (C, d, k) where the leaf kernel runs fewer than
# its launch bound's 3 blocks an SM, at the blocks it gets there today on
# the H100 (228 KB an SM, the launch's own plan).  Any other case must keep
# 3; a case that loses a block fires PIPK001.
LEAF_BLOCKS = {(1024, 8, 32): 2, (70, 100, 32): 2, (1024, 100, 32): 2, (70, 128, 32): 2,
               (1024, 128, 32): 2, (1024, 128, 16): 2,
               **{(c, d, k): 1 for c in (70, 1024) for d in (736, 1024) for k in (1, 32)}}


def _leaf_blocks(p: dict) -> int:
    """The blocks an SM the leaf kernel's design accepts at a case
    (``LEAF_REVIEW``)."""
    return LEAF_BLOCKS.get((p["c"], p["d"], p["k"]), 3)


_K = "repro_torch.kernels."
_LEAF_INST = frozenset((k, v) for k in (*range(1, 9), 16, 32) for v in (4, 1))

REGISTRY: tuple[KernelSpec, ...] = (
    KernelSpec("leaf_topk", _K + "leaf_knn:leaf_topk", _K + "leaf_knn:leaf_topk_plain",
               "leaf_knn", "leaf_knn.cu", ("pipnn_leaf_topk", "pipnn_leaf_topk_plan"),
               {"leaf_topk_kernel": _LEAF_INST}, ("src/repro/kernels/leaf_knn.py:114",),
               TF32_TOL, _leaf_cases, _cmp_leaf, plan=_leaf_plan, smem_blocks=_leaf_blocks,
               spills=LEAF_SPILLS, reviewed=LEAF_REVIEW),
    KernelSpec("edge_hashes", _K + "edge_hash:edge_hashes", _K + "edge_hash:edge_hashes_plain",
               "edge_hash", "edge_hash.cu", ("pipnn_edge_hashes",),
               {"edge_hash_kernel": frozenset((m,) for m in range(5))},
               ("src/repro/kernels/edge_hash.py:58",), EXACT, _edge_cases, _exact),
    KernelSpec("merge_sorted_reservoirs", _K + "segmented_merge:merge_sorted_reservoirs",
               _K + "segmented_merge:merge_sorted_reservoirs_plain", "segmented_merge",
               "segmented_merge.cu",
               ("pipnn_merge_sorted_reservoirs", "pipnn_merge_sorted_reservoirs_plan"),
               {"merge_kernel": frozenset({()})}, ("src/repro/kernels/segmented_merge.py:104",),
               EXACT, _merge_cases, _exact, plan=_merge_plan, spills={(): 204},
               reviewed=CAP_REVIEW + " (<= 32 registers: 64 warps an SM)", in_place=True),
    KernelSpec("gather_distance", _K + "gather_distance:gather_distance",
               _K + "gather_distance:gather_distance_plain", "gather_distance",
               "gather_distance.cu", ("pipnn_gather_distance", "pipnn_gather_distance_bf16"),
               {"gather_distance_kernel": frozenset({("f", 4, 32), ("f", 1, 32),
                                                     ("__nv_bfloat16", 8, 16),
                                                     ("__nv_bfloat16", 1, 32)})},
               ("src/repro/kernels/gather_distance.py:179",
                "src/repro/kernels/gather_distance.py:407"),
               GATHER_TOL, lambda: _gather_cases(torch.float32) + _gather_cases(torch.bfloat16),
               _cmp_gather, spills={("f", 4, 32): 92, ("__nv_bfloat16", 8, 16): 24,
                                    ("__nv_bfloat16", 1, 32): 192},
               reviewed=CAP_REVIEW + " (<= 64 registers: 32 warps an SM)"),
    KernelSpec("gather_distance_int8", _K + "gather_distance_int8:gather_distance_int8",
               _K + "gather_distance_int8:gather_distance_int8_plain", "gather_distance_int8",
               "gather_distance_int8.cu", ("pipnn_gather_distance_int8",),
               {"gather_distance_int8_kernel": frozenset({(16, 8), (1, 32)})},
               ("src/repro/kernels/gather_distance.py:275",
                "src/repro/kernels/gather_distance.py:499"),
               GATHER8_TOL, _gather8_cases, _exact, spills={(16, 8): 20, (1, 32): 100},
               reviewed=CAP_REVIEW + " (<= 64 registers: 32 warps an SM)"),
    KernelSpec("pairwise_distance", _K + "distance:pairwise_distance",
               _K + "distance:pairwise_distance_plain", "pairwise_distance", "distance.cu",
               ("pipnn_pairwise_distance", "pipnn_pairwise_distance_plan"),
               {"pairwise_distance_kernel": frozenset({(4,), (1,)})},
               ("src/repro/kernels/distance.py:91",), TF32_TOL,
               lambda: _pairwise_cases(False), _cmp_pairwise, plan=_pairwise_plan),
    KernelSpec("pairwise_distance_int8", _K + "distance:pairwise_distance_int8",
               _K + "distance:pairwise_distance_int8_plain", "pairwise_distance_int8",
               "distance.cu", ("pipnn_pairwise_distance_int8",
                               "pipnn_pairwise_distance_int8_plan"),
               {"pairwise_distance_int8_kernel": frozenset({(16,), (4,), (1,)})},
               ("src/repro/kernels/distance.py:123",), INT32_TOL,
               lambda: _pairwise_cases(True), _exact, plan=_pairwise8_plan),
    KernelSpec("rowwise_topk", _K + "topk:rowwise_topk", _K + "topk:rowwise_topk_plain",
               "rowwise_topk", "topk.cu", ("pipnn_rowwise_topk",),
               {"rowwise_topk_kernel": frozenset({(4,), (1,)})},
               ("src/repro/kernels/topk.py:70",), TOPK_TOL, _topk_cases, _exact,
               spills={(1,): 196},
               reviewed=CAP_REVIEW + " (<= 64 registers, 4 blocks of 256 an SM; only the "
               "scalar-load path for rows not 16-byte aligned spills)"),
)


def spec_by_name(name: str) -> KernelSpec:
    return next(s for s in REGISTRY if s.name == name)


# ---------------------------------------------------------------------------
# source parsing: __global__ functions, launch bounds, exports, launches
# ---------------------------------------------------------------------------

_COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_CONST = re.compile(r"constexpr\s+(?:int|size_t|unsigned|long long)\s+(\w+)\s*=\s*([^;]+);")
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\(((?:[^()]|\([^()]*\))*)\)"
                     r"\s*)?(\w+)\s*\(")
_EXPORT = re.compile(r"PIPNN_EXPORT\s+int\s+(\w+)\s*\(")
_LAUNCH = re.compile(r"(\w+)(?:<[^<>]*>)?\s*<<<(.*?)>>>", re.S)
_NAMESPACE = re.compile(r"namespace\s+(\w+)\s*\{")


def _strip(text: str) -> str:
    return _COMMENT.sub(lambda m: "\n" * m.group(0).count("\n"), text)


def _namespaces(text: str) -> list[tuple[int, int, str]]:
    """Named namespace blocks: (start, end, name)."""
    out = []
    for m in _NAMESPACE.finditer(text):
        depth, i = 1, m.end()
        while depth and i < len(text):
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            i += 1
        out.append((m.start(), i, m.group(1)))
    return out


def _scope(pos: int, spaces) -> str:
    for start, end, name in spaces:
        if start <= pos < end:
            return name
    return ""


def _eval_expr(expr: str, consts: dict, scope: str) -> int:
    """An integer constant expression of a ``.cu`` (its ``constexpr``
    names resolved in ``scope`` first)."""

    def name(m):
        q = m.group(0)
        for key in ((f"{scope}::{q}",) if scope and "::" not in q else ()) + (q,):
            if key in consts:
                return f"({consts[key]})"
        raise KeyError(q)

    for _ in range(8):
        expr = re.sub(r"\((?:size_t|int|unsigned|long long)\)", "", expr)
        new = re.sub(r"(?:\w+::)?[A-Za-z_]\w*", name, expr)
        if new == expr:
            break
        expr = new
    if not re.fullmatch(r"[\d\s+\-*/()%]+", expr):
        raise ValueError(expr)
    return int(eval(expr.replace("/", "//")))   # integer arithmetic only, checked above


def parse_csrc(csrc: pathlib.Path) -> dict:
    """Every ``.cu`` under ``csrc``: its ``__global__`` functions with their
    launch bounds (threads, min_blocks) and line, its ``PIPNN_EXPORT``
    entries, and for each kernel the dynamic shared memory arguments of its
    launches (``<<<grid, block, smem, stream>>>``)."""
    out = {"globals": {}, "exports": {}, "launch_smem": {}}
    for cu in sorted(pathlib.Path(csrc).glob("*.cu")):
        text = _strip(cu.read_text())
        spaces = _namespaces(text)
        consts = {}
        for m in _CONST.finditer(text):
            sc = _scope(m.start(), spaces)
            consts[f"{sc}::{m.group(1)}" if sc else m.group(1)] = m.group(2).strip()
        for m in _GLOBAL.finditer(text):
            bounds, name = m.group(1), m.group(2)
            line = text.count("\n", 0, m.start(2)) + 1
            lb = None
            if bounds:
                parts = [p.strip() for p in re.split(r",(?![^(]*\))", bounds)]
                sc = _scope(m.start(), spaces)
                lb = tuple(_eval_expr(p, consts, sc) for p in parts)
                lb = lb if len(lb) == 2 else (lb[0], 1)
            out["globals"][name] = {"file": cu.name, "line": line, "bounds": lb}
        for m in _EXPORT.finditer(text):
            out["exports"][m.group(1)] = {"file": cu.name,
                                          "line": text.count("\n", 0, m.start()) + 1}
        for m in _LAUNCH.finditer(text):
            args = [a.strip() for a in m.group(2).split(",")]
            out["launch_smem"].setdefault(m.group(1), []).append(
                args[2] if len(args) > 2 else "0")
    return out


def _library_wrappers(kernels_dir: pathlib.Path) -> set[str]:
    """``module:function`` of every wrapper function that calls
    ``_build.library()``."""
    out = set()
    for py in sorted(pathlib.Path(kernels_dir).glob("*.py")):
        tree = ast.parse(py.read_text(), filename=str(py))
        for fn in tree.body:
            if not isinstance(fn, ast.FunctionDef):
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "library" \
                        and isinstance(node.func.value, ast.Name) \
                        and node.func.value.id == "_build":
                    out.add(f"repro_torch.kernels.{py.stem}:{fn.name}")
                    break
    return out


def _pallas_sites(root: pathlib.Path) -> set[str]:
    """``path:line`` of every ``pallas_call`` in the reference's kernels
    (read, never imported)."""
    out = set()
    kdir = root / "src" / "repro" / "kernels"
    for py in sorted(kdir.glob("*.py")) if kdir.is_dir() else ():
        tree = ast.parse(py.read_text(), filename=str(py))
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                f = node.func
                name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)
                if name == "pallas_call":
                    out.add(f"{py.relative_to(root).as_posix()}:{node.lineno}")
    return out


def _signature_keys() -> set[str]:
    from repro_torch.kernels import _build

    return set(_build.SIGNATURES)


def check_census(root: pathlib.Path | None = None, *,
                 csrc: pathlib.Path | None = None) -> list[Finding]:
    """PIPK005 from the sources alone (``csrc`` replaceable for the tests'
    fixtures)."""
    root = pathlib.Path(root) if root is not None else repo_root()
    csrc = pathlib.Path(csrc) if csrc is not None else root / CSRC
    kernels_dir = root / "src" / "repro_torch" / "kernels"
    signatures = _signature_keys()
    src = parse_csrc(csrc)
    findings: list[Finding] = []

    def census(kind: str, found: dict, claims_of: Callable) -> None:
        claims: dict[str, list[str]] = {}
        for spec in REGISTRY:
            for item in claims_of(spec):
                claims.setdefault(item, []).append(spec.name)
        for item, (path, line) in sorted(found.items()):
            owners = claims.get(item, [])
            if len(owners) != 1:
                findings.append(Finding(
                    "PIPK005", path, line, item,
                    f"{kind} claimed by {len(owners)} registry entries {owners} (exactly "
                    f"one must claim it: add it to contracts.REGISTRY)"))
        for item in sorted(set(claims) - set(found)):
            for owner in claims[item]:
                findings.append(Finding(
                    "PIPK005", spec_by_name(owner).path, 0, owner,
                    f"registry entry names {kind} '{item}', which does not exist"))

    census("__global__ function",
           {k: (f"{CSRC}/{v['file']}", v["line"]) for k, v in src["globals"].items()},
           lambda s: tuple(s.kernels))
    census("C entry (_build.SIGNATURES key)", {k: ("src/repro_torch/kernels/_build.py", 0)
                                                for k in signatures},
           lambda s: s.c_symbols)
    census("exported C entry", {k: (f"{CSRC}/{v['file']}", v["line"])
                                for k, v in src["exports"].items()},
           lambda s: s.c_symbols)
    census("wrapper calling _build.library()",
           {w: ("src/" + w.partition(":")[0].replace(".", "/") + ".py", 0)
            for w in _library_wrappers(kernels_dir)},
           lambda s: (s.wrapper,))
    sites = _pallas_sites(root)
    if sites:
        census("reference pallas_call site", {s: (s.rpartition(":")[0], int(s.rpartition(":")[2]))
                                              for s in sites},
               lambda s: s.replaces)
    # a kernel whose entry declares no plan launches with no dynamic smem
    for spec in REGISTRY:
        if spec.plan is not None:
            continue
        for kname in spec.kernels:
            bad = [a for a in src["launch_smem"].get(kname, []) if a != "0"]
            if bad:
                findings.append(Finding(
                    "PIPK005", f"{CSRC}/{spec.source}", 0, kname,
                    f"launches with dynamic shared memory {bad} but its registry entry "
                    f"declares no plan: PIPK001 could not price it"))
    return findings


def check_pairing(registry=REGISTRY) -> list[Finding]:
    """PIPK004's static part."""
    from repro_torch import kernels

    signatures, counters = _signature_keys(), kernels._MODULES
    findings = []
    for spec in registry:
        def bad(msg):
            findings.append(Finding("PIPK004", spec.path, 0, spec.name, msg))
        for ref, what in ((spec.wrapper, "wrapper"), (spec.plain, "plain version")):
            try:
                _resolve(ref)
            except (ImportError, AttributeError):
                bad(f"{what} '{ref}' does not resolve: every kernel needs its plain twin")
        for sym in spec.c_symbols:
            if sym not in signatures:
                bad(f"C symbol '{sym}' is not in _build.SIGNATURES")
        if spec.counter not in counters:
            bad(f"launch counter '{spec.counter}' is not in kernels._MODULES")
    return findings


# ---------------------------------------------------------------------------
# PIPK001: ptxas' report
# ---------------------------------------------------------------------------

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")


def parse_ptxas(text: str) -> dict[str, dict]:
    """ptxas' ``-v`` report -> mangled entry name -> registers, stack frame,
    spill stores, spill loads and static shared memory (bytes)."""
    out: dict[str, dict] = {}
    entry = props = None
    for line in text.splitlines():
        if m := _ENTRY.search(line):
            entry = m.group(1)
            out.setdefault(entry, dict(registers=0, stack=0, spill_stores=0, spill_loads=0,
                                       smem=0))
        elif m := _PROPS.search(line):
            props = m.group(1)
        elif (m := _FRAME.search(line)) and props in out:
            out[props].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
        elif (m := _USED.search(line)) and entry is not None:
            out[entry].update(registers=int(m.group(1)), smem=int(m.group(2) or 0))
    return out


def demangle(mangled: str, names) -> tuple[str, tuple] | None:
    """(kernel base name, template arguments) of an Itanium-mangled entry
    whose name is one of ``names``: ints as ints (``Li4E``), types as their
    mangled token (``f``, ``__nv_bfloat16``)."""
    for name in sorted(names, key=len, reverse=True):
        m = re.search(rf"{len(name)}{name}(?=[IE])", mangled)
        if m is None:
            continue
        s, i, targs = mangled, m.end(), []
        if i < len(s) and s[i] == "I":
            i += 1
            while i < len(s) and s[i] != "E":
                if s[i] == "L":                         # a literal: L<type><value>E
                    j = s.index("E", i)
                    targs.append(int(re.sub(r"^L[a-z]", "", s[i:j])))
                    i = j + 1
                elif s[i].isdigit():                    # a length-prefixed name
                    n = re.match(r"\d+", s[i:]).group(0)
                    targs.append(s[i + len(n): i + len(n) + int(n)])
                    i += len(n) + int(n)
                else:                                   # a builtin type
                    targs.append(s[i])
                    i += 1
        return name, tuple(targs)
    return None


@dataclasses.dataclass
class CardLimits:
    optin: int = BLOCK_SHARED_OPTIN
    per_sm: int = SM_SHARED
    registers: int = SM_REGISTERS
    source: str = "H100 constants"


def card_limits(device) -> CardLimits:
    """The card's per-block opt-in and per-SM shared memory
    (``cudaDevAttrMaxSharedMemoryPerBlockOptin``, read through
    ``torch.cuda.get_device_properties``) and registers an SM."""
    props = torch.cuda.get_device_properties(torch.device(device))
    optin = getattr(props, "shared_memory_per_block_optin", None)
    per_sm = getattr(props, "shared_memory_per_multiprocessor", None)
    regs = getattr(props, "regs_per_multiprocessor", None)
    return CardLimits(optin=int(optin or BLOCK_SHARED_OPTIN),
                      per_sm=int(per_sm or SM_SHARED), registers=int(regs or SM_REGISTERS),
                      source="device properties" if optin else "H100 constants")


def check_function(spec: KernelSpec, kname: str, inst: tuple, res: dict, bounds,
                   limits: CardLimits) -> list[Finding]:
    """PIPK001's shape-free part for one instantiation: spills and the
    register file."""
    findings = []
    label = f"{kname}{list(inst)}"
    spill = res["spill_stores"] + res["spill_loads"]
    if spill > spec.spills.get(inst, 0):
        findings.append(Finding(
            "PIPK001", f"{CSRC}/{spec.source}", 0, label,
            f"{res['spill_stores']} bytes spill stores, {res['spill_loads']} bytes spill "
            f"loads (reviewed bound {spec.spills.get(inst, 0)}"
            + (f": {spec.reviewed}" if inst in spec.spills else "")
            + "): registers spill to local memory"))
    if bounds is None:
        findings.append(Finding("PIPK001", f"{CSRC}/{spec.source}", 0, label,
                                "no __launch_bounds__: no promise to hold it to"))
        return findings
    threads, min_blocks = bounds
    regs = -(-res["registers"] // REG_GRANULE) * REG_GRANULE
    if regs * threads * min_blocks > limits.registers:
        findings.append(Finding(
            "PIPK001", f"{CSRC}/{spec.source}", 0, label,
            f"{res['registers']} registers x {threads} threads x {min_blocks} blocks = "
            f"{regs * threads * min_blocks} > the SM's {limits.registers}: "
            f"__launch_bounds__({threads}, {min_blocks}) is not kept"))
    return findings


def check_shape(spec: KernelSpec, kname: str, inst: tuple, res: dict, bounds, dyn: int,
                case: Case, limits: CardLimits) -> tuple[list[Finding], dict]:
    """PIPK001's shape part for one instantiation at one swept case: the
    static + dynamic shared memory against the block limit and against the
    blocks an SM the launch bounds promise (or the reviewed floor)."""
    findings = []
    label = f"{kname}{list(inst)}"
    threads, min_blocks = bounds or (0, 1)
    total = res["smem"] + dyn
    by_smem = limits.per_sm // (total + BLOCK_RESERVED)
    regs = -(-res["registers"] // REG_GRANULE) * REG_GRANULE
    by_regs = limits.registers // max(1, regs * max(threads, 1))
    want = spec.smem_blocks(case.params) if spec.smem_blocks else min_blocks
    if total > limits.optin:
        findings.append(Finding(
            "PIPK001", f"{CSRC}/{spec.source}", 0, label,
            f"[{case.label}] {res['smem']} static + {dyn} dynamic shared memory = {total} "
            f"bytes > the per-block opt-in limit {limits.optin}"))
    elif by_smem < want:
        findings.append(Finding(
            "PIPK001", f"{CSRC}/{spec.source}", 0, label,
            f"[{case.label}] {total} bytes of shared memory a block leave {by_smem} blocks "
            f"an SM of {limits.per_sm} bytes; the launch promises {want}"
            + (" (reviewed floor)" if spec.smem_blocks else
               f" (__launch_bounds__({threads}, {min_blocks}))")))
    rec = dict(registers=res["registers"], spill_stores=res["spill_stores"],
               spill_loads=res["spill_loads"], stack=res["stack"], static_smem=res["smem"],
               dynamic_smem=dyn, blocks_promised=want, launch_bounds=list(bounds or ()),
               blocks_by_smem=by_smem, blocks_by_registers=by_regs)
    return findings, rec


# ---------------------------------------------------------------------------
# PIPK002-004 on the card: the sweep
# ---------------------------------------------------------------------------

def _outputs(out) -> list[torch.Tensor]:
    return list(out) if isinstance(out, (tuple, list)) else [out]


def poison(nbytes: list[int], device) -> list[tuple[int, int]]:
    """Empty the caching allocator's cache, then pour ``POISON`` into
    blocks of the given sizes and free them, so that the next allocations
    of those sizes start poisoned; returns the poisoned address ranges
    ``(start, end)``, adjacent blocks merged."""
    torch.cuda.empty_cache()
    bufs = [torch.empty(max(1, n), dtype=torch.uint8, device=device) for n in nbytes]
    for b in bufs:
        b.fill_(POISON)
    spans = sorted((b.data_ptr(), b.data_ptr() + b.numel()) for b in bufs)
    del bufs
    merged: list[tuple[int, int]] = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def _in_poison(t: torch.Tensor, spans) -> bool:
    a = t.data_ptr()
    return any(lo <= a and a + t.numel() * t.element_size() <= hi for lo, hi in spans)


SWEEP_SEED = 0


def sweep_kernel(spec: KernelSpec, device, records: dict | None = None) -> list[Finding]:
    """PIPK002, PIPK003 and PIPK004's launch check over ``spec``'s cases on
    the card; fills ``records[label]`` with each case's error and launches."""
    from repro_torch import kernels

    wrapper, plain = _resolve(spec.wrapper), _resolve(spec.plain)
    gen = torch.Generator(device=device).manual_seed(SWEEP_SEED)
    findings: list[Finding] = []
    for case in spec.cases():
        args, kwargs = case.make(device, gen)
        want = plain(*[a.clone() if spec.in_place and isinstance(a, torch.Tensor) else a
                       for a in args], **kwargs)
        spans = [] if spec.in_place else poison(
            [t.numel() * t.element_size() for t in _outputs(want)], device)
        before = kernels.launch_counts()[spec.counter]
        try:
            got = wrapper(*args, **kwargs)
        except ValueError as e:
            if records is not None:
                records[case.label] = dict(refused=str(e))
            continue
        torch.cuda.synchronize(device)
        launched = kernels.launch_counts()[spec.counter] - before
        rule = "PIPK002" if case.misaligned else "PIPK003"
        if launched < 1:
            findings.append(Finding("PIPK004", spec.path, 0, spec.name,
                                    f"[{case.label}] the call launched nothing: a stale "
                                    f"registry entry"))
        outs = _outputs(got)
        poisoned = sum(_in_poison(o, spans) for o in outs)
        if not spec.in_place and poisoned < len(outs):
            findings.append(Finding("PIPK003", spec.path, 0, spec.name,
                                    f"[{case.label}] {len(outs) - poisoned} of {len(outs)} "
                                    f"outputs outside the poisoned blocks: the coverage "
                                    f"check tested nothing there"))
        if any(_poisoned(o) for o in outs):
            findings.append(Finding(rule, spec.path, 0, spec.name,
                                    f"[{case.label}] an output element keeps the allocator "
                                    f"poison: the grid never wrote it"))
        ok, err, note = spec.compare(got, want, args, kwargs)
        if not ok:
            findings.append(Finding(rule, spec.path, 0, spec.name,
                                    f"[{case.label}] {note} ({spec.tolerance}; max "
                                    f"|err| {err})"))
        if records is not None:
            records[case.label] = dict(max_abs_err=err, launches=launched,
                                       poisoned_outputs=poisoned)
        del args, got, want, outs
    return findings


def check_resources(spec: KernelSpec, report_text: str, device, limits: CardLimits,
                    records: dict | None = None, src: dict | None = None) -> list[Finding]:
    """PIPK001 for one entry, and PIPK005's instantiation census against
    ptxas' report: every declared instantiation compiled, no other one."""
    src = src if src is not None else parse_csrc(repo_root() / CSRC)
    funcs: dict[tuple, dict] = {}
    for mangled, res in parse_ptxas(report_text).items():
        got = demangle(mangled, spec.kernels)
        if got is not None:
            funcs[got] = res
    findings: list[Finding] = []
    for kname, declared in spec.kernels.items():
        compiled = {inst for (k, inst) in funcs if k == kname}
        if compiled != set(declared):
            findings.append(Finding(
                "PIPK005", f"{CSRC}/{spec.source}", 0, kname,
                f"instantiations in ptxas' report {sorted(compiled)} differ from the "
                f"registry's {sorted(declared)}"))
    worst: dict[str, dict] = {}
    for (kname, inst), res in sorted(funcs.items(), key=lambda kv: str(kv[0])):
        bounds = src["globals"][kname]["bounds"]
        findings += check_function(spec, kname, inst, res, bounds, limits)
        for case in spec.cases():
            plan = spec.plan(case.params) if spec.plan else {"smem": 0}
            if "K" in plan and inst and inst[0] != plan["K"]:
                continue            # another list length serves this k
            f, rec = check_shape(spec, kname, inst, res, bounds, plan["smem"], case, limits)
            findings += f
            key = f"{kname}{list(inst)}"
            if key not in worst or rec["dynamic_smem"] >= worst[key]["dynamic_smem"]:
                worst[key] = dict(rec, shape=case.label)
    if records is not None:
        records.update(worst)
    return findings


def check_kernel_contracts(root: pathlib.Path | None = None, *, device=None,
                           records: dict | None = None) -> list[Finding]:
    """PIPK001-005 over the registry on ``device`` (default: the card,
    raising without one): the census and the static pairing anywhere, the
    resources and the sweep on the card (a skip with zero findings when
    the caller asks for the CPU)."""
    import time

    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    root = pathlib.Path(root) if root is not None else repo_root()
    records = {} if records is None else records
    findings = check_census(root) + check_pairing()
    if dev.type != "cuda":
        report("kernels", "no card: PIPK001-003 and the launch check of PIPK004 skipped")
        return findings
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    text = lib.with_suffix(".log").read_text()
    limits = card_limits(dev)
    src = parse_csrc(root / CSRC)
    records["limits"] = dataclasses.asdict(limits)
    for spec in REGISTRY:
        res_rec: dict = {}
        sweep_rec: dict = {}
        findings += check_resources(spec, text, dev, limits, res_rec, src)
        findings += sweep_kernel(spec, dev, sweep_rec)
        records[spec.name] = dict(resources=res_rec, sweep=sweep_rec)
        for fn, r in res_rec.items():
            report("kernels", f"{fn}: {r['registers']} regs, spills {r['spill_stores']}/"
                   f"{r['spill_loads']} B, smem {r['static_smem']}+{r['dynamic_smem']} B at "
                   f"{r['shape']}, blocks/SM promised {r['blocks_promised']} (launch bounds "
                   f"{r['launch_bounds']}), allowed by smem {r['blocks_by_smem']}, by "
                   f"registers {r['blocks_by_registers']}")
        torch.cuda.empty_cache()
    records["seconds"] = time.perf_counter() - t0
    return findings
