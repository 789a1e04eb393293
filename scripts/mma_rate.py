"""Measure the rate at which one card issues ``mma.sync`` tensor-core
products, the ceiling of any kernel built on them (the leaf top-k and the
float32 pairwise distance form their products as ``mma.sync.m16n8k8``
TF32, three per float32 product; the int8 pairwise distance as
``mma.sync.m16n8k32`` s8).

    python scripts/mma_rate.py

Each warp keeps 16 independent accumulators and issues 16 MMAs an
iteration on operands held in registers, so neither memory nor latency
limits it.  Prints the card's name and power limit, then one JSON line
with each shape's TFLOP/s (TOP/s for s8; the mean of five timed
launches after one warm-up), beside the dense peak of NVIDIA's data
sheet, which only ``wgmma`` reaches.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <int KIND>
__global__ void __launch_bounds__(256) mma_loop(int iters, float* out) {
  float c[16][4] = {};
  int ci[16][4] = {};
  uint32_t a0 = threadIdx.x, a1 = a0 * 3u, a2 = a0 * 5u, a3 = a0 * 7u, b0 = a0 * 11u,
           b1 = a0 * 13u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if constexpr (KIND == 0)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                     : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      else if constexpr (KIND == 1)
        asm volatile("mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                     "{%4,%5}, {%6}, {%0,%1,%2,%3};\n"
                     : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                     : "r"(a0), "r"(a1), "r"(b0));
      else if constexpr (KIND == 2)
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                     : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      else
        asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+r"(ci[j][0]), "+r"(ci[j][1]), "+r"(ci[j][2]), "+r"(ci[j][3])
                     : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j)
    s += c[j][0] + c[j][1] + c[j][2] + c[j][3] + (float)(ci[j][0] + ci[j][1] + ci[j][2] + ci[j][3]);
  if (s == 1.2345f) out[0] = s;   // keeps the loop; never true in practice
}

extern "C" __attribute__((visibility("default")))
int mma_rate_run(int kind, int blocks, int iters, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (kind == 0) mma_loop<0><<<blocks, 256, 0, s>>>(iters, o);
  else if (kind == 1) mma_loop<1><<<blocks, 256, 0, s>>>(iters, o);
  else if (kind == 2) mma_loop<2><<<blocks, 256, 0, s>>>(iters, o);
  else mma_loop<3><<<blocks, 256, 0, s>>>(iters, o);
  return cudaGetLastError();
}
"""

BLOCKS_PER_SM = 2   # blocks of 8 warps an SM
ITERS = 4096        # loop iterations a warp, 16 MMAs each

# name, kind, FLOPs of one MMA, dense data-sheet peak in TFLOP/s
SHAPES = (("tf32_m16n8k8", 0, 2 * 16 * 8 * 8, 495.0),
          ("tf32_m16n8k4", 1, 2 * 16 * 8 * 4, 495.0),
          ("bf16_m16n8k16", 2, 2 * 16 * 8 * 16, 989.0),
          ("s8_m16n8k32", 3, 2 * 16 * 8 * 32, 1979.0))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mma_rate: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import smi
    from repro_torch.kernels import _build

    out_dir = _build.BUILD_DIR.parent / "mma_rate"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib_path = out_dir / "mma_rate.cu", out_dir / "libmma_rate.so"
    src.write_text(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib_path),
                    str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.mma_rate_run.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_void_p]
    lib.mma_rate_run.restype = ctypes.c_int
    props = torch.cuda.get_device_properties(0)
    blocks = props.multi_processor_count * BLOCKS_PER_SM
    out = torch.zeros(1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    result = dict(sms=props.multi_processor_count, blocks=blocks, warps_per_block=8,
                  iters=ITERS)
    for name, kind, flops, peak in SHAPES:
        def run():
            _build.check(lib.mma_rate_run(kind, blocks, ITERS, out.data_ptr(), stream),
                         "mma_rate_run")

        run()
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(5):
            run()
        ev[1].record()
        torch.cuda.synchronize()
        ms = ev[0].elapsed_time(ev[1]) / 5
        total = float(blocks) * 8 * ITERS * 16 * flops
        result[name] = dict(ms=ms, tflops=total / ms / 1e9, datasheet_tflops=peak)
    print(smi())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
