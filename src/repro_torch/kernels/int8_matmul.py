"""Exact int8 matmul -> int32, the DCIM adder-tree baseline (port of
``repro/kernels/int8_matmul.py`` and ``ops.int8_matmul``).

``int8_matmul`` launches ``csrc/int8_matmul.cu`` (a hand-written GEMM on
the int8 tensor cores, ``mma.sync`` s8 with split-K where the output tiles
leave SMs idle; its header gives the design and what bounds it) on CUDA
tensors, and runs ``int8_matmul_plain`` (``ref.py int8_matmul_ref``) on
CPU tensors.  Both are exact.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = ["int8_matmul", "int8_matmul_plain", "LAUNCHES"]

LAUNCHES = build.LaunchCounter("int8_matmul")
# int8_matmul_launch(x, w, out, M, N, K, stream)
ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def int8_matmul_plain(x_i8, w_i8) -> torch.Tensor:
    """x (M, K) @ w (K, N) over int8 values -> (M, N) int32.  PyTorch has no
    integer matmul on CUDA, so there it runs in float64, which is exact for
    |sums| < 2^53 (any K below 2^39); on the CPU in int64."""
    x = x_i8.to(torch.int8)
    w = w_i8.to(torch.int8)
    if x.is_cuda:
        prod = (x.to(torch.float64) @ w.to(torch.float64)).to(torch.int64)
    else:
        prod = x.to(torch.int64) @ w.to(torch.int64)
    return prod.to(torch.int32)


def _launch_kernel(x, w) -> torch.Tensor:
    M, K = x.shape
    N = w.shape[1]
    if w.shape[0] != K or w.device != x.device:
        raise ValueError(f"int8_matmul kernel: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)} on {x.device}, {w.device}")
    out = torch.empty((M, N), dtype=torch.int32, device=x.device)
    fn = build.bind("int8_matmul", "int8_matmul_launch", ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K, stream)
    if rc != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: error {rc}")
    LAUNCHES.count += 1
    return out


def int8_matmul(x_i8, w_i8) -> torch.Tensor:
    """Exact x (M, K) @ w (K, N) -> (M, N) int32; operands are cast to int8
    as the reference's wrapper casts them."""
    x = x_i8.to(torch.int8)
    w = w_i8.to(torch.int8)
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w)
    if x.device.type == "cuda":
        return _launch_kernel(x.contiguous(), w.contiguous())
    raise ValueError(f"no int8_matmul route for device {x.device}")
