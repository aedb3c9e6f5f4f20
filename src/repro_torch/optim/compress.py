"""Gradient compression: int8 quantisation with error feedback.

Counterpart of the reference ``optim/compress.py``: a data-parallel
gradient all-reduce moves parameter-sized fp32 tensors every step;
quantising each to int8 with one scale a tensor cuts those bytes 4x, and
error feedback (the residual carried to the next step) corrects the
quantisation noise over steps.  :func:`compressed_all_reduce` is the
counterpart of ``compressed_psum``: an int8 payload summed in int32 over
a process group and dequantised with the largest scale.

Fault F8, copied for parity: each rank quantises with its OWN scale, but
the sum is dequantised with the largest one, so where the ranks' scales
differ the mean is biased toward the rank with the largest gradient (two
ranks with g = 1 and g = 2 everywhere give 2.0, not 1.5); the returned
error is measured against the local scale, so error feedback never sees
the gap.  ``tests/test_torch_mesh_train.py`` pins it.  As in the
reference, the training launcher does not wire compression into its
step.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.distributed import ctx


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` rounded as one IEEE division on every device: the card
    turns a division by a host scalar into a product with its reciprocal,
    which rounds differently (a divisor on ``a``'s device does not)."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: (q, scale), scale = (max |g| + 1e-12) /
    127 as a 0-d fp32 tensor."""
    amax = torch.max(torch.abs(g)) + 1e-12
    scale = _div(amax, 127.0)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_leaf(g: torch.Tensor, err: torch.Tensor):
    """Error-feedback compression of one gradient leaf through the lossy
    channel, on one process: (decompressed gradient, new error)."""
    g = g.to(torch.float32) + err
    q, scale = quantize_int8(g)
    deq = dequantize_int8(q, scale)
    return deq, g - deq


def compressed_all_reduce(g: torch.Tensor, err: torch.Tensor, group):
    """The mean of every rank's ``g + err`` over ``group`` through int8
    payloads: each rank quantises with its own scale, the payloads are
    summed in int32 (no overflow), and the sum is dequantised with the
    largest scale (fault F8: the module note).  Returns (mean, new
    error), the error against the rank's own dequantised payload."""
    g = g.to(torch.float32) + err
    q, scale = quantize_int8(g)
    scale_max = ctx.all_reduce(scale.clone().reshape(1), "max", group)[0]
    qsum = ctx.all_reduce(q.to(torch.int32), "sum", group)
    n = torch.distributed.get_world_size(group)
    mean = _div(qsum.to(torch.float32) * scale_max, float(n))
    local = dequantize_int8(q, scale)
    return mean, g - local


def _map2(fn, a, b):
    if isinstance(a, dict):
        outs = {k: _map2(fn, a[k], b[k]) for k in a}
        return ({k: o[0] for k, o in outs.items()},
                {k: o[1] for k, o in outs.items()})
    if isinstance(a, (list, tuple)):
        outs = [_map2(fn, x, y) for x, y in zip(a, b, strict=True)]
        return [o[0] for o in outs], [o[1] for o in outs]
    return fn(a, b)


def tree_compress(grads, errors):
    """:func:`compress_leaf` on every leaf: (grads, errors) trees."""
    return _map2(compress_leaf, grads, errors)


def init_errors(params):
    """Zero fp32 errors shaped like ``params``."""
    if isinstance(params, dict):
        return {k: init_errors(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [init_errors(v) for v in params]
    return torch.zeros_like(params, dtype=torch.float32)
