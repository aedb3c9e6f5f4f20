"""Expert-gated grouped matmul (K3): the CUDA kernel's wrapper and its plain
version.

Replaces the Pallas TPU kernel ``src/repro/kernels/expert_matmul.py:
expert_matmul``.  ``out[e, c] = x[e, c] @ w[e]`` for ``c < counts[e]`` and
exact zeros for the rows past each expert's count, accumulated in fp32,
for bf16 or fp32 inputs.  The kernel (``csrc/expert_matmul.cu``) reads
``counts`` from a device int32 tensor (the counterpart of scalar prefetch),
skips every tile past an expert's count without reading x or w, and reads
x and w through their expert and row strides, so a sliced expert width
(``w[..., :a_ff]``) or expert count (``w[:a_experts]``) is a view of the
full resident weight, never a copy.  Its source note says what bounds it
on the H100 and what the design does about that.

``expert_matmul`` launches the kernel on CUDA tensors and raises on
anything it does not take; ``expert_matmul_plain`` is the same function in
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
    fn = build.library("expert_matmul").repro_expert_matmul
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def check_args(x: torch.Tensor, w: torch.Tensor,
               counts: torch.Tensor) -> None:
    if x.ndim != 3 or w.ndim != 3:
        raise ValueError(f"want x (E, C, K) and w (E, K, F), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} does not match w "
                         f"{tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in DTYPE_CODES:
        raise TypeError(f"x and w must share a dtype in float32/bfloat16, "
                        f"got {x.dtype} and {w.dtype}")
    if counts.shape != (x.shape[0],) or counts.dtype != torch.int32:
        raise ValueError(f"counts must be int32 of shape ({x.shape[0]},), "
                         f"got {counts.dtype} {tuple(counts.shape)}")


def _stride(t: torch.Tensor, dim: int) -> int:
    # a size-1 dim may carry any stride; the kernel never steps it
    return t.stride(dim) if t.shape[dim] > 1 else 0


def expert_matmul(x: torch.Tensor, w: torch.Tensor,
                  counts: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: x (E, C, K) and w (E, K, F) with unit inner
    strides, ``counts`` a contiguous device int32 (E,) tensor."""
    global launches
    check_args(x, w, counts)
    dev = x.device
    if dev.type != "cuda" or w.device != dev or counts.device != dev:
        raise ValueError(f"expert_matmul needs x, w and counts on one CUDA "
                         f"device, got {dev}, {w.device}, {counts.device}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {dev} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if not counts.is_contiguous():
        raise ValueError("counts must be contiguous")
    if (x.shape[2] > 1 and x.stride(2) != 1) or \
            (w.shape[2] > 1 and w.stride(2) != 1):
        raise ValueError("x and w need a unit inner stride (row-major rows)")
    E, C, K = x.shape
    F = w.shape[2]
    y = torch.empty((E, C, F), dtype=x.dtype, device=dev)
    if y.numel() == 0:
        return y
    rc = _launcher()(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                     counts.data_ptr(), E, C, K, F, _stride(x, 0),
                     _stride(x, 1), _stride(w, 0), _stride(w, 1),
                     DTYPE_CODES[x.dtype],
                     torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"expert_matmul launch failed (CUDA error {rc})")
    launches += 1
    return y


def expert_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                        counts: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: zero the rows at
    ``c >= counts[e]``, then one batched product."""
    check_args(x, w, counts)
    live = (torch.arange(x.shape[1], device=x.device)[None, :]
            < counts[:, None])
    xm = torch.where(live[..., None], x, torch.zeros((), dtype=x.dtype,
                                                     device=x.device))
    return torch.bmm(xm, w)
