"""Public wrappers around the kernels (reshaping, width tensors, routing).

Counterparts of the reference ``kernels/ops.py:elastic_matmul_op`` and
``flash_attention_op``.  A CUDA tensor goes to the hand-written kernel (or
the call raises: there is no fallback); a CPU tensor goes to the kernel's
plain PyTorch version.  The kernels mask their ragged edges themselves, so
unlike the TPU wrappers these pad nothing: they only reshape.

:func:`plain_kernels` routes CUDA tensors to the plain versions for the
current thread.  It exists to hold the kernels against their plain
versions on the card; the serving path never enters it.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import elastic_matmul as _em
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


def _use_kernel(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return not getattr(_state, "plain", False)
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def widths_tensor(device: torch.device, k_act: int, n_act: int
                  ) -> torch.Tensor:
    """The device int32 [k_act, n_act] the kernel reads, cached per width
    pair so a call pays no host-to-device copy after the first."""
    key = (device, k_act, n_act)
    with _widths_lock:
        t = _widths.get(key)
        if t is None:
            t = torch.tensor([k_act, n_act], dtype=torch.int32, device=device)
            _widths[key] = t
        return t


def elastic_matmul_op(x: torch.Tensor, w: torch.Tensor, k_act: int,
                      n_act: int, *, n_out: Optional[int] = None
                      ) -> torch.Tensor:
    """x (..., Kx) @ w (Kw, Nw) over the active widths -> (..., n_out).

    Only ``x[..., :k_act]`` and ``w[:k_act, :n_act]`` are read; columns
    ``n_act <= n < n_out`` are exact zeros.  ``n_out`` defaults to ``Nw``
    (the TPU op's shape); sliced-mode layers pass ``n_out=n_act`` and
    ``x`` of width ``k_act`` against the full resident ``w``.
    """
    k_act, n_act = int(k_act), int(n_act)
    n_out = w.shape[-1] if n_out is None else int(n_out)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if _use_kernel(x2):
        y = _em.elastic_matmul(x2, w, widths_tensor(x2.device, k_act, n_act),
                               k_act, n_act, n_out)
    else:
        y = _em.elastic_matmul_plain(x2, w, k_act, n_act, n_out)
    return y.reshape(*lead, n_out)


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True) -> torch.Tensor:
    """q (B, S, H, D), k/v (B, T, KH, D) -> (B, S, H, D); GQA for KH < H."""
    if _use_kernel(q):
        return _fa.flash_attention(q, k, v, causal=causal)
    return _fa.flash_attention_plain(q, k, v, causal=causal)
