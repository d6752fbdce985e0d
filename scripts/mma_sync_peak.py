#!/usr/bin/env python3
"""Throughput ceiling of ``mma.sync`` on the card, for the tile shapes the
port's flash-attention, int8 GEMM and fused DS-CIM MVM kernels issue.

    python3 scripts/mma_sync_peak.py

Builds a kernel (``build.NVCC_FLAGS``, into ``src/repro_torch/kernels/
_build/``) whose 8 warps per block issue back-to-back ``mma.sync`` into
8 independent accumulators each, with no loads, and times it on 1, 2 and 4
blocks per SM: s8 m16n8k32 (the int8 GEMM), bf16 m16n8k16 (flash attention
in 16-bit types), TF32 m16n8k8 (flash attention's 3xTF32 f32 path) and
b1 m16n8k256 ``.and.popc`` (the fused DS-CIM MVM's counts).  The data
sheet gives no b1 rate for Hopper, so the b1 line also states its rate in
DS-CIM row products (one ``popc(ta & tb)`` of a 32-bit point mask: 8 per
k256 step) beside what s8 m16n8k32 would give on {0,1} operands expanded
to one byte per point (pmax = 18 bytes per row product, dscim1/L256).

It then builds the b1 form of ``wgmma`` (m64n256k256 ``.s32.b1.b1.and.popc``,
one warpgroup a block, operands from shared memory) for sm_90a and, where
``ptxas`` takes it, times it the same way; where it does not, it prints
the refusal.  Prints one line per case and a JSON object with the card's
name and power limit as the last line.  Needs one NVIDIA GPU with ``nvcc``.
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
      else if constexpr (KIND == 2)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(af[j][0]), "+f"(af[j][1]), "+f"(af[j][2]), "+f"(af[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      else
        asm volatile("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(ai[j][0]), "+r"(ai[j][1]), "+r"(ai[j][2]), "+r"(ai[j][3])
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
  else if (kind == 2) peak<2><<<blocks, 256>>>(out, iters);
  else peak<3><<<blocks, 256>>>(out, iters);
  return int(cudaGetLastError());
}
"""
# (name, ops per mma, published dense peak of an H100 SXM in TOP/s; none
# for b1, whose ops are bit ANDs and popcount adds)
CASES = ((0, "s8 m16n8k32", 2 * 16 * 8 * 32, 1979.0),
         (1, "bf16 m16n8k16", 2 * 16 * 8 * 16, 989.0),
         (2, "tf32 m16n8k8", 2 * 16 * 8 * 8, 495.0),
         (3, "b1 m16n8k256 and.popc", 2 * 16 * 8 * 256, None))
ITERS = 4000
PMAX = 18                # points per block of dscim1/L256
# DS-CIM row products (one 32-bit mask pair) per mma: b1 k256 holds 8
# masks; s8 k32 holds 32 / PMAX rows expanded to one byte per point
ROWS_PER_MMA = {0: 16 * 8 * 32 / PMAX, 3: 16 * 8 * 8}

# wgmma m64n256k256 b1 .and.popc: one warpgroup a block, both operands
# from shared memory (no swizzle; the bits are whatever the fill left,
# since only the rate is read), 128 s32 accumulators a thread, 8 products
# a commit group.  Compiled on its own, so a refusal leaves the mma.sync
# cases standing.
WG_N = 256
WG_ACC = WG_N // 2                      # s32 accumulators a thread
WG_REGS = ",".join(f"%{i}" for i in range(WG_ACC))
WG_OUTS = ", ".join(f'"+r"(d[{i}])' for i in range(WG_ACC))
WGMMA_SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>
__global__ void __launch_bounds__(128) wg_peak(float* out, int iters) {
  __shared__ __align__(128) uint32_t sm[4096];            // 16 KB
  for (int i = threadIdx.x; i < 4096; i += 128) sm[i] = i * 2654435761u;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(sm));
  // descriptor: start >> 4, leading byte offset 128, stride byte offset 256
  const uint64_t da = (uint64_t)((base >> 4) & 0x3FFF)
                      | ((uint64_t)(128 >> 4) << 16)
                      | ((uint64_t)(256 >> 4) << 32);
  const uint64_t db = da + (4096 >> 4);                   // B 4 KB on
  int d[ACC] = {};
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %SCALE, 0;\n"
          "wgmma.mma_async.sync.aligned.m64nNNk256.s32.b1.b1.and.popc "
          "{REGS}, %DA, %DB, p;\n}\n"
          : OUTS
          : "l"(da), "l"(db), "r"(1));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  float s = 0.f;
  for (int i = 0; i < ACC; ++i) s += float(d[i]);
  out[blockIdx.x * 128 + threadIdx.x] = s;     // keeps the products live
}
extern "C" int run(float* out, int blocks, int iters) {
  wg_peak<<<blocks, 128>>>(out, iters);
  return int(cudaGetLastError());
}
""".replace("ACC", str(WG_ACC)).replace("NN", str(WG_N)).replace(
    "REGS", WG_REGS).replace("OUTS", WG_OUTS).replace(
    "%DA", f"%{WG_ACC}").replace("%DB", f"%{WG_ACC + 1}").replace(
    "%SCALE", f"%{WG_ACC + 2}")


def _time_ms(torch, launch) -> float:
    """Device time of one launch, by CUDA events, after a short warm-up."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def wgmma_b1(torch, build, sms: int):
    """The b1 ``wgmma`` case: ("refused: <ptxas>", []) where nvcc does not
    compile it for sm_90a, else ("compiled", rows) timed on 1, 2 and 3
    one-warpgroup blocks per SM (128 accumulators a thread: 4 do not fit
    in an SM's registers)."""
    src = build.BUILD_DIR / "wgmma_b1_peak.cu"
    so = build.BUILD_DIR / "wgmma_b1_peak.so"
    src.write_text(WGMMA_SOURCE)
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                        str(src)], capture_output=True, text=True)
    if r.returncode != 0:
        return "refused: " + " ".join((r.stdout + r.stderr).split())[:300], []
    fn = ctypes.CDLL(str(so)).run
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    out = torch.empty(3 * sms * 128, device="cuda")
    rows = []
    ops = 2 * 64 * WG_N * 256
    for per_sm in (1, 2, 3):
        blocks = per_sm * sms
        if fn(out.data_ptr(), blocks, 10) != 0:
            raise RuntimeError("wgmma b1 launch failed")
        ms = _time_ms(torch, lambda: fn(out.data_ptr(), blocks, ITERS))
        mmas_per_s = blocks * ITERS * 8 / ms * 1e3
        rows.append({"mma": f"b1 wgmma m64n{WG_N}k256 and.popc",
                     "blocks_per_sm": per_sm,
                     "tops": mmas_per_s * ops / 1e12, "share_of_peak": None,
                     "dscim_row_products_per_s": mmas_per_s * 64 * WG_N * 8})
    return "compiled", rows


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
            mmas_per_s = blocks * 8 * ITERS * 8 / ms * 1e3
            tops = mmas_per_s * ops / 1e12
            row = {"mma": name, "blocks_per_sm": per_sm, "tops": tops,
                   "share_of_peak": tops / peak if peak else None}
            note = f"{100 * tops / peak:.1f} % of {peak:g}" if peak else \
                "no published peak"
            if kind in ROWS_PER_MMA:
                row["dscim_row_products_per_s"] = \
                    mmas_per_s * ROWS_PER_MMA[kind]
                note += (f"; {row['dscim_row_products_per_s'] / 1e12:.2f} T "
                         "DS-CIM row products/s")
            rows.append(row)
            print(f"{name}, {per_sm} block(s) of 8 warps per SM: "
                  f"{tops:.1f} TOP/s ({note})", flush=True)
    probe, wrows = wgmma_b1(torch, build, sms)
    print(f"wgmma m64n{WG_N}k256 b1 and.popc for sm_90a: {probe}",
          flush=True)
    for row in wrows:
        rows.append(row)
        print(f"{row['mma']}, {row['blocks_per_sm']} warpgroup block(s) per "
              f"SM: {row['tops']:.1f} TOP/s (no published peak; "
              f"{row['dscim_row_products_per_s'] / 1e12:.2f} T DS-CIM row "
              "products/s)", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": smi, "rows": rows,
                      "wgmma_b1": probe}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
