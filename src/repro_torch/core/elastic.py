"""Mask/slice duality for elastic layers.

Two execution modes implement the paper's dynamic DNN:

* masked mode (training) — active sizes are tensors; inactive channels are
  exact zeros, so one graph covers every sub-network;
* sliced mode (serving) — active sizes are Python ints; parameters are
  sliced before the call so compute genuinely shrinks (the runtime
  governor switches between per-subnet executables).

The invariant that makes both modes agree exactly: every activation tensor
carries zeros beyond its active channel count, and normalisation layers
compute statistics over active channels only.  This slice of the port
serves in sliced mode; the masked layers come with the training slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.types import Active, is_static


def active_mask(a, size: int, dtype=torch.float32,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """[size] vector: 1.0 for channels < a, else 0.0."""
    if isinstance(a, torch.Tensor):
        device = a.device if device is None else device
    return (torch.arange(size, device=device) < a).to(dtype)


def mask_dim(x: torch.Tensor, a: Active, axis: int = -1) -> torch.Tensor:
    """Zero channels >= a along ``axis`` (no-op for None / full static)."""
    if a is None:
        return x
    size = x.shape[axis]
    if is_static(a) and int(a) == size:
        return x
    m = active_mask(a, size, x.dtype, x.device)
    shape = [1] * x.ndim
    shape[axis] = size
    return x * m.reshape(shape)


def take_dim(p: torch.Tensor, a: Active, axis: int) -> torch.Tensor:
    """STATIC slice of a parameter along ``axis`` to the first ``a`` rows
    (a view: the resident parameter is not copied)."""
    if a is None:
        return p
    if not is_static(a):
        raise TypeError("take_dim needs a static active size")
    return p.narrow(axis, 0, int(a))


def spec_to_dynamic(spec, dims: dict,
                    device: Optional[torch.device] = None) -> dict:
    """Turn a SubnetSpec into tensor active counts for masked-mode apply.

    ``dims`` maps knob name -> full size, e.g. {"d_model": 768, "d_ff": 3072,
    "n_heads": 12, "n_layers": 12}.  Returns int32 scalar tensors so a
    single graph handles any spec.
    """
    def t(n):
        return torch.tensor(n, dtype=torch.int32, device=device)

    out = {}
    if "d_model" in dims:
        out["a_model"] = t(_round(dims["d_model"], spec.width_mult))
    if "d_ff" in dims:
        out["a_ff"] = t(_round(dims["d_ff"], spec.ffn_mult))
    if "n_heads" in dims:
        out["a_heads"] = t(_round(dims["n_heads"], spec.heads_mult))
    if "n_layers" in dims:
        out["a_layers"] = t(_round(dims["n_layers"], spec.depth_mult))
    if "n_experts" in dims and spec.num_experts is not None:
        out["a_experts"] = t(spec.num_experts)
    return out


def _round(full: int, mult: float) -> int:
    return max(1, int(round(full * mult)))


def spec_to_static(spec, dims: dict, multiple_of: int = 1) -> dict:
    """SubnetSpec -> STATIC active counts (python ints) for sliced mode.

    Like :func:`spec_to_dynamic` but returns hashable ints, so the result
    selects a specialised executable (the serving engine's cache).
    ``multiple_of`` keeps sliced dims divisible by the tensor sharding.
    Python's ``round`` (half to even) is kept: heads 0.75 x 6 gives 4.
    """
    def rnd(full, mult):
        n = max(multiple_of, int(round(full * mult / multiple_of))
                * multiple_of)
        return min(n, full)

    out = {}
    if "d_model" in dims:
        out["a_model"] = rnd(dims["d_model"], spec.width_mult)
    if "d_ff" in dims:
        out["a_ff"] = rnd(dims["d_ff"], spec.ffn_mult)
    if "n_heads" in dims:
        n_kv = dims.get("n_kv_heads", dims["n_heads"])
        h = max(1, int(round(dims["n_heads"] * spec.heads_mult)))
        if dims["n_heads"] % n_kv == 0 and n_kv < dims["n_heads"]:
            h = max(n_kv, (h // n_kv) * n_kv)     # keep GQA groups even
        out["a_heads"] = min(h, dims["n_heads"])
    if "n_layers" in dims:
        out["a_layers"] = _round(dims["n_layers"], spec.depth_mult)
    if "n_experts" in dims and spec.num_experts is not None:
        out["a_experts"] = int(spec.num_experts)
    if spec.top_k is not None:
        out["top_k"] = int(spec.top_k)
    return out
