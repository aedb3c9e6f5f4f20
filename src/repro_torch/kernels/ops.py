"""Public wrappers around the kernels (reshaping, width tensors, routing).

Counterparts of the reference ``kernels/ops.py:elastic_matmul_op`` and
``flash_attention_op``, and ``expert_matmul_op`` for the reference's
``kernels/expert_matmul.py:expert_matmul``.  A CUDA tensor goes to the
hand-written kernel (or the call raises: there is no fallback); a CPU
tensor goes to the kernel's plain PyTorch version.  The kernels mask their ragged edges themselves, so
unlike the TPU wrappers these pad nothing: they only reshape.

:func:`plain_kernels` routes CUDA tensors to the plain versions for the
current thread.  It exists to hold the kernels against their plain
versions on the card; the serving path never enters it.

Where a gradient is wanted (grad mode on and an input that requires it),
K1 and K2 run inside a ``torch.autograd.Function`` whose backward is the
kernels' backward (K1's dgrad and wgrad kernels, K2's backward kernel) or,
on the CPU, their plain versions; the route is fixed when the forward
runs (autograd runs the backward on its own thread).  K3 on the kernel
route runs inside a Function whose backward is K3's dgrad and wgrad
kernels; its plain route is differentiable as it is.  Without a gradient
the ops call the forward alone, as the serving path does.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import elastic_matmul as _em
from repro_torch.kernels import expert_matmul as _xm
from repro_torch.kernels import flash_attention as _fa

_state = threading.local()
_widths: Dict[Tuple[torch.device, int, int], torch.Tensor] = {}
_widths_lock = threading.Lock()


@contextlib.contextmanager
def plain_kernels():
    """Run the plain versions on CUDA tensors too (this thread only)."""
    prev = getattr(_state, "plain", False)
    _state.plain = True
    try:
        yield
    finally:
        _state.plain = prev


def plain_active() -> bool:
    """Whether this thread runs the plain versions (inside
    :func:`plain_kernels`): what a recompute on autograd's thread (remat)
    must set again to take the forward's route."""
    return getattr(_state, "plain", False)


def route_contexts():
    """``torch.utils.checkpoint``'s (forward, recompute) contexts: the
    recompute runs on autograd's thread, where :func:`plain_kernels` is
    not set, so it sets the forward's route again (remat)."""
    plain = plain_active()
    return (contextlib.nullcontext(),
            plain_kernels() if plain else contextlib.nullcontext())


def _use_kernel(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return not plain_active()
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


# (kernel name, module, its launch counter, its counts by variant)
_COUNTERS = (
    ("elastic_matmul", _em, "launches", "variant_launches"),
    ("flash_attention", _fa, "launches", "variant_launches"),
    ("expert_matmul", _xm, "launches", "variant_launches"),
    ("elastic_matmul_dgrad", _em, "dgrad_launches", "dgrad_variant_launches"),
    ("elastic_matmul_wgrad", _em, "wgrad_launches", "wgrad_variant_launches"),
    ("flash_attention_bwd", _fa, "bwd_launches", "bwd_variant_launches"),
    ("expert_matmul_dgrad", _xm, "dgrad_launches", "dgrad_variant_launches"),
    ("expert_matmul_wgrad", _xm, "wgrad_launches", "wgrad_variant_launches"),
)


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel (each wrapper counts its own)."""
    out = {}
    for name, mod, n, _ in _COUNTERS:
        with mod.count_lock:
            out[name] = getattr(mod, n)
    return out


def variant_counts() -> Dict[str, Dict[str, int]]:
    """Launches so far of the kernels that have variants, by variant."""
    out = {}
    for name, mod, _, v in _COUNTERS:
        with mod.count_lock:
            out[name] = dict(getattr(mod, v))
    return out


def reset_launch_counts() -> None:
    """Set every kernel's launch count, and each variant's, to 0."""
    for _, mod, n, v in _COUNTERS:
        with mod.count_lock:
            setattr(mod, n, 0)
            per = getattr(mod, v)
            per.update(dict.fromkeys(per, 0))


def widths_tensor(device: torch.device, k_act: int, n_act: int
                  ) -> torch.Tensor:
    """The device int32 [k_act, n_act] the kernel reads, cached per width
    pair so a call pays no host-to-device copy after the first.  A CUDA
    graph captures a call's cached tensor; creating one inside a capture
    (a host-to-device copy) raises: the capture's eager warm-up makes it."""
    key = (device, k_act, n_act)
    with _widths_lock:
        t = _widths.get(key)
        if t is None:
            if device.type == "cuda" and \
                    torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"elastic_matmul: widths ({k_act}, {n_act}) would be "
                    f"made inside a CUDA graph capture: run the call "
                    f"eagerly first")
            t = torch.tensor([k_act, n_act], dtype=torch.int32, device=device)
            _widths[key] = t
        return t


def _wants_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _em_forward(kernel: bool, x2, w, k_act, n_act, n_out):
    if kernel:
        return _em.elastic_matmul(x2, w, widths_tensor(x2.device, k_act,
                                                        n_act),
                                  k_act, n_act, n_out)
    return _em.elastic_matmul_plain(x2, w, k_act, n_act, n_out)


class _ElasticMatmul(torch.autograd.Function):
    """K1 with its backward: dgrad and wgrad at the forward's widths."""

    @staticmethod
    def forward(ctx, x2, w, k_act, n_act, n_out, kernel):
        ctx.save_for_backward(x2, w)
        ctx.args = (k_act, n_act, kernel)
        return _em_forward(kernel, x2, w, k_act, n_act, n_out)

    @staticmethod
    def backward(ctx, dy):
        x2, w = ctx.saved_tensors
        k_act, n_act, kernel = ctx.args
        dx = dw = None
        if kernel:
            widths = widths_tensor(dy.device, k_act, n_act)
            if ctx.needs_input_grad[0]:
                dx = _em.elastic_matmul_dgrad(dy, w, widths, k_act, n_act,
                                              x2.shape[1])
            if ctx.needs_input_grad[1]:
                dw = _em.elastic_matmul_wgrad(x2, dy, widths, k_act, n_act,
                                              tuple(w.shape))
        else:
            if ctx.needs_input_grad[0]:
                dx = _em.elastic_matmul_dgrad_plain(dy, w, k_act, n_act,
                                                    x2.shape[1])
            if ctx.needs_input_grad[1]:
                dw = _em.elastic_matmul_wgrad_plain(x2, dy, k_act, n_act,
                                                    tuple(w.shape))
        return dx, dw, None, None, None, None


def elastic_matmul_op(x: torch.Tensor, w: torch.Tensor, k_act: int,
                      n_act: int, *, n_out: Optional[int] = None
                      ) -> torch.Tensor:
    """x (..., Kx) @ w (Kw, Nw) over the active widths -> (..., n_out).

    Only ``x[..., :k_act]`` and ``w[:k_act, :n_act]`` are read; columns
    ``n_act <= n < n_out`` are exact zeros.  ``n_out`` defaults to ``Nw``
    (the TPU op's shape); sliced-mode layers pass ``n_out=n_act`` and
    ``x`` of width ``k_act`` against the full resident ``w``.  The
    gradient of x is zero past k_act and that of w outside the active
    block.
    """
    k_act, n_act = int(k_act), int(n_act)
    n_out = w.shape[-1] if n_out is None else int(n_out)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    kernel = _use_kernel(x2)
    if _wants_grad(x2, w):
        y = _ElasticMatmul.apply(x2, w, k_act, n_act, n_out, kernel)
    else:
        y = _em_forward(kernel, x2, w, k_act, n_act, n_out)
    return y.reshape(*lead, n_out)


class _FlashAttention(torch.autograd.Function):
    """K2 with its backward, from the forward's fp32 logsumexp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, kernel):
        if kernel:
            o, lse = _fa.flash_attention(q, k, v, causal=causal,
                                         return_lse=True)
        else:
            o, lse = _fa.flash_attention_plain(q, k, v, causal=causal), None
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, kernel)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, kernel = ctx.args
        if kernel:
            dq, dk, dv = _fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                 causal=causal)
        else:
            dq, dk, dv = _fa.flash_attention_bwd_plain(q, k, v, o, do,
                                                       causal=causal)
        return dq, dk, dv, None, None


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True,
                       kv_len: Optional[torch.Tensor] = None,
                       return_lse: bool = False):
    """q (B, S, H, D), k/v (B, T, KH, D) -> (B, S, H, D); GQA for KH < H.
    ``kv_len``, a 0-d int32 on k's device, masks the keys at or past it
    (a decode step over a whole cache; no gradient).  ``return_lse``
    (no gradient) also returns each row's fp32 logsumexp (B, H, S)."""
    kernel = _use_kernel(q)
    if _wants_grad(q, k, v):
        if kv_len is not None or return_lse:
            raise NotImplementedError("flash_attention_op: no gradient "
                                      "through a decode cache (kv_len) or "
                                      "a returned logsumexp")
        return _FlashAttention.apply(q, k, v, causal, kernel)
    fn = _fa.flash_attention if kernel else _fa.flash_attention_plain
    return fn(q, k, v, causal=causal, kv_len=kv_len, return_lse=return_lse)


class _ExpertMatmul(torch.autograd.Function):
    """K3 on the kernel route where a gradient is wanted: its backward is
    the dgrad and wgrad kernels, over the forward's counts (the rows past
    them carry no gradient: the forward wrote constant zeros there)."""

    @staticmethod
    def forward(ctx, x, w, counts):
        ctx.save_for_backward(x, w, counts)
        return _xm.expert_matmul(x, w, counts)

    @staticmethod
    def backward(ctx, dy):
        x, w, counts = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _xm.expert_matmul_dgrad(dy, w, counts)
        if ctx.needs_input_grad[1]:
            dw = _xm.expert_matmul_wgrad(x, dy, counts)
        return dx, dw, None


def expert_matmul_op(x: torch.Tensor, w: torch.Tensor,
                     counts: torch.Tensor) -> torch.Tensor:
    """x (E, C, K) @ w (E, K, F) per expert -> (E, C, F); rows
    ``c >= counts[e]`` (an int32 (E,) tensor on x's device) are exact
    zeros.  ``w`` may be a strided view of a larger resident weight; its
    gradient comes in the view's shape."""
    if not _use_kernel(x):
        return _xm.expert_matmul_plain(x, w, counts)
    if _wants_grad(x, w):
        return _ExpertMatmul.apply(x, w, counts)
    return _xm.expert_matmul(x, w, counts)
