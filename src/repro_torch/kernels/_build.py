"""Build and load the hand-written CUDA kernels.

Route: ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one process per
source, all started together) and links them into one shared library with
a plain C interface, which ``ctypes`` loads.  No PyTorch headers are
included, so a build takes seconds.  The build is made at first use, never
at import, into ``build/repro_torch_kernels/`` at the repository root
(listed in ``.gitignore``), under a name that hashes the sources, so an
edited source is rebuilt and an unchanged one is reused.  No fast-math:
the leaf, gather and distance kernels must round like the plain versions.

Every C entry returns ``cudaGetLastError()`` after its launch;
``check`` raises on anything but 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_int64
# C entry points: name -> argument types (all return int, a cudaError_t)
SIGNATURES = {
    "pipnn_leaf_topk": [P, P, I, I, I, I, I, I, P, P, P],
    "pipnn_edge_hashes": [P, P, P, L, I, P, P],
    "pipnn_merge_sorted_reservoirs": [P, P, P, P, P, P, L, I, P],
    "pipnn_gather_distance": [P, P, P, P, I, I, I, I, I, P, P],
    "pipnn_gather_distance_bf16": [P, P, P, P, I, I, I, I, I, P, P],
    "pipnn_gather_distance_int8": [P, P, P, P, P, P, I, I, I, I, I, P, P],
    "pipnn_pairwise_distance": [P, P, I, I, I, I, I, P, P],
    "pipnn_pairwise_distance_int8": [P, P, I, I, I, I, P, P],
    "pipnn_rowwise_topk": [P, L, I, I, P, P, P],
    # launch plans (the dynamic shared memory a launch requests; no launch)
    "pipnn_leaf_topk_plan": [I, I, I, P, P],
    "pipnn_merge_sorted_reservoirs_plan": [I, P],
    "pipnn_pairwise_distance_plan": [P],
    "pipnn_pairwise_distance_int8_plan": [P],
}

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the kernels if the library for the current sources is not
    built yet; returns its path.  ptxas' register and shared-memory report
    goes to ``<name>.log`` beside it."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"libpipnn_kernels_{_digest()}.so"
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = pathlib.Path(tmp) / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name} ==\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
        tmp_lib = pathlib.Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib), *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        lib_path.with_suffix(".log").write_text(log)
        os.replace(tmp_lib, lib_path)   # atomic: processes building at once agree
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def plan_value(name: str, *args) -> list[int]:
    """Call the C plan entry ``name`` with the int ``args`` and as many
    ``long long`` / ``int`` out-slots as its signature has pointers past
    them; returns their values.  ``ValueError`` when the entry refuses the
    shape (a launch there would fail with the same code)."""
    outs = [ctypes.c_longlong() if i == 0 else ctypes.c_int()
            for i in range(len(SIGNATURES[name]) - len(args))]
    rc = getattr(library(), name)(*args, *(ctypes.addressof(o) for o in outs))
    if rc != 0:
        raise ValueError(f"{name}{args}: the launch refuses this shape (cudaError {rc})")
    return [o.value for o in outs]


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


def stream_ptr(tensor) -> int:
    """The current CUDA stream of ``tensor``'s device, as a pointer int."""
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream


def require_cuda(name: str, *tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: all inputs must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
