"""Flash attention (K2): the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py:
flash_attention``: blocked online-softmax attention with the running max,
denominator and accumulator in fp32, causal or not.  The kernel
(``csrc/flash_attention.cu``) masks keys at positions >= T (the reference
wrapper's zero-padded keys enter the softmax: fault F1 in ROADMAP.md),
picks the kv head as ``h // (H // KH)`` (no repeated k/v copy) and reads
and writes through (batch, seq, head) strides.  Its source note says what
bounds it on the H100 and what the design does about that.

Layout at this level: q (B, S, H, D), k/v (B, T, KH, D) -> o (B, S, H, D).
``flash_attention`` launches the kernel on CUDA tensors;
``flash_attention_plain`` is the same function in plain PyTorch.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

# kernel launches since the last reset (the wrapper adds one per launch)
launches = 0

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (8, 16, 64)   # the ViT configs (64) and their smoke configs


def _launcher():
    fn = build.library("flash_attention").repro_flash_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,S,H,D), k/v (B,T,KH,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (H must be a multiple of KH)")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPE_CODES:
        raise TypeError(f"q, k, v must share a dtype in float32/bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool) -> torch.Tensor:
    """Launch the CUDA kernel (inputs may be strided; head dim contiguous)."""
    global launches
    check_args(q, k, v)
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"flash_attention needs q, k, v on one CUDA device, "
                         f"got {dev}, {k.device}, {v.device}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {dev} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    B, S, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v need a contiguous head dim")
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=dev)
    if B * H * S == 0:
        return o
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, o) for s in t.stride()[:3]))
    rc = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     B, H, KH, S, T, D, strides, 1.0 / math.sqrt(D),
                     int(causal), DTYPE_CODES[q.dtype],
                     torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed (CUDA error {rc})")
    launches += 1
    return o


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool) -> torch.Tensor:
    """The same function in plain PyTorch: repeat kv heads for GQA, then
    the naive oracle over (B*H, S, D)."""
    check_args(q, k, v)
    B, S, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    if KH != H:
        k = k.repeat_interleave(H // KH, dim=2)
        v = v.repeat_interleave(H // KH, dim=2)
    qf = q.transpose(1, 2).reshape(B * H, S, D)
    kf = k.transpose(1, 2).reshape(B * H, T, D)
    vf = v.transpose(1, 2).reshape(B * H, T, D)
    o = flash_attention_ref(qf, kf, vf, causal=causal)
    return o.reshape(B, H, S, D).transpose(1, 2)
