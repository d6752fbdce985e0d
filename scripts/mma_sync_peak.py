#!/usr/bin/env python3
"""Throughput ceiling of ``mma.sync`` on the card, for the tile shapes the
port's flash-attention and int8 GEMM kernels issue.

    python3 scripts/mma_sync_peak.py

Builds a kernel (``build.NVCC_FLAGS``, into ``src/repro_torch/kernels/
_build/``) whose 8 warps per block issue back-to-back ``mma.sync`` into
8 independent accumulators each, with no loads, and times it on 1, 2 and 4
blocks per SM: s8 m16n8k32 (the int8 GEMM), bf16 m16n8k16 (flash attention
in 16-bit types) and TF32 m16n8k8 (flash attention's 3xTF32 f32 path).
Prints one line per case and a JSON object with the card's name and power
limit as the last line.  Needs one NVIDIA GPU with ``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>
template <int KIND>
__global__ void __launch_bounds__(256) peak(float* out, int iters) {
  uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u, 7u};
  uint32_t b0 = threadIdx.x * 11u, b1 = 13u;
  int ai[8][4] = {};
  float af[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if constexpr (KIND == 0)
        asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(ai[j][0]), "+r"(ai[j][1]), "+r"(ai[j][2]), "+r"(ai[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      else if constexpr (KIND == 1)
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(af[j][0]), "+f"(af[j][1]), "+f"(af[j][2]), "+f"(af[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      else
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(af[j][0]), "+f"(af[j][1]), "+f"(af[j][2]), "+f"(af[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j)
    for (int e = 0; e < 4; ++e) s += float(ai[j][e]) + af[j][e];
  out[blockIdx.x * 256 + threadIdx.x] = s;     // keeps the products live
}
extern "C" int run(int kind, float* out, int blocks, int iters) {
  if (kind == 0) peak<0><<<blocks, 256>>>(out, iters);
  else if (kind == 1) peak<1><<<blocks, 256>>>(out, iters);
  else peak<2><<<blocks, 256>>>(out, iters);
  return int(cudaGetLastError());
}
"""
# (name, ops per mma, published dense peak of an H100 SXM in TOP/s)
CASES = ((0, "s8 m16n8k32", 2 * 16 * 8 * 32, 1979.0),
         (1, "bf16 m16n8k16", 2 * 16 * 8 * 16, 989.0),
         (2, "tf32 m16n8k8", 2 * 16 * 8 * 8, 495.0))
ITERS = 4000


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mma_sync_peak: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / "mma_sync_peak.cu"
    so = build.BUILD_DIR / "mma_sync_peak.so"
    src.write_text(SOURCE)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                    str(src)], check=True)
    fn = ctypes.CDLL(str(so)).run
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(4 * sms * 256, device="cuda")
    rows = []
    for kind, name, ops, peak in CASES:
        for per_sm in (1, 2, 4):
            blocks = per_sm * sms
            if fn(kind, out.data_ptr(), blocks, 10) != 0:
                raise RuntimeError("launch failed")
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(kind, out.data_ptr(), blocks, ITERS)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
            tops = blocks * 8 * ITERS * 8 * ops / ms / 1e9
            rows.append({"mma": name, "blocks_per_sm": per_sm,
                         "tops": tops, "share_of_peak": tops / peak})
            print(f"{name}, {per_sm} block(s) of 8 warps per SM: "
                  f"{tops:.1f} TOP/s ({100 * tops / peak:.1f} % of {peak:g})",
                  flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": smi, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
