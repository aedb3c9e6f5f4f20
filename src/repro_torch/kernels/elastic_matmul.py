"""Width-elastic matmul (K1): the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``src/repro/kernels/elastic_matmul.py:
elastic_matmul``.  ``y[m, n] = sum_{k<k_act} x[m, k] w[k, n]`` for
``n < n_act`` and exact zeros for ``n_act <= n < n_out``, accumulated in
fp32, for bf16 or fp32 inputs.  The kernel (``csrc/elastic_matmul.cu``)
reads the widths from a device int32[2] (the counterpart of scalar
prefetch) and the active block of the FULL resident weight through its row
stride, so no call copies ``w[:k_act, :n_act]``.  Its source note says what
bounds it on the H100 and what the design does about that.

``elastic_matmul`` launches the kernel on CUDA tensors and raises on
anything it does not take; ``elastic_matmul_plain`` is the same function in
plain PyTorch, used for CPU tensors and to hold the kernel against.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# kernel launches since the last reset (the wrapper adds one per launch)
launches = 0

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _launcher():
    fn = build.library("elastic_matmul").repro_elastic_matmul
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _row_stride(t: torch.Tensor) -> int:
    # a size-1 leading dim may carry any stride; the kernel never steps it
    return t.stride(0) if t.shape[0] > 1 else t.shape[1]


def check_args(x: torch.Tensor, w: torch.Tensor, k_act: int, n_act: int,
               n_out: int) -> None:
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError(f"x and w must be 2-D, got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in DTYPE_CODES:
        raise TypeError(f"x and w must share a dtype in float32/bfloat16, "
                        f"got {x.dtype} and {w.dtype}")
    if not (0 <= k_act <= min(x.shape[1], w.shape[0])):
        raise ValueError(f"k_act={k_act} outside x {tuple(x.shape)} / "
                         f"w {tuple(w.shape)}")
    if not (0 <= n_act <= min(n_out, w.shape[1])):
        raise ValueError(f"n_act={n_act} outside n_out={n_out} / "
                         f"w {tuple(w.shape)}")


def elastic_matmul(x: torch.Tensor, w: torch.Tensor, widths: torch.Tensor,
                   k_act: int, n_act: int, n_out: int) -> torch.Tensor:
    """Launch the CUDA kernel: x (M, >=k_act), w (>=k_act, >=n_act) with unit
    inner strides, ``widths`` the device int32 tensor [k_act, n_act]."""
    global launches
    check_args(x, w, k_act, n_act, n_out)
    dev = x.device
    if dev.type != "cuda" or w.device != dev or widths.device != dev:
        raise ValueError(f"elastic_matmul needs x, w and widths on one CUDA "
                         f"device, got {dev}, {w.device}, {widths.device}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {dev} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if widths.dtype != torch.int32 or widths.shape != (2,) \
            or not widths.is_contiguous():
        raise ValueError("widths must be a contiguous int32 tensor of 2")
    if (x.shape[1] > 1 and x.stride(1) != 1) or \
            (w.shape[1] > 1 and w.stride(1) != 1):
        raise ValueError("x and w need a unit inner stride (row-major rows)")
    M = x.shape[0]
    y = torch.empty((M, n_out), dtype=x.dtype, device=dev)
    if M == 0 or n_out == 0:
        return y
    rc = _launcher()(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                     widths.data_ptr(), M, _row_stride(x), _row_stride(w),
                     n_out, n_out, DTYPE_CODES[x.dtype],
                     torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"elastic_matmul launch failed (CUDA error {rc})")
    launches += 1
    return y


def elastic_matmul_plain(x: torch.Tensor, w: torch.Tensor, k_act: int,
                         n_act: int, n_out: int) -> torch.Tensor:
    """The same function in plain PyTorch (slice, matmul, zero-pad)."""
    check_args(x, w, k_act, n_act, n_out)
    y = x[:, :k_act] @ w[:k_act, :n_act]
    if n_out > n_act:
        y = torch.nn.functional.pad(y, (0, n_out - n_act))
    return y
