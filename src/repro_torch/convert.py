"""Turn a reference (JAX) parameter tree, given as numpy arrays, into the
port's parameters.

The tests hold the port against the reference on the same weights, so they
initialise with the reference's ``vit_init``, map its leaves to numpy and
convert here.  Layouts are kept (dense kernels ``(d_in, d_out)``, the patch
embed HWIO); the layer stack that ``jax.vmap`` builds along a leading axis
becomes the port's list of per-layer dicts.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def to_torch(tree, device: Optional[torch.device] = None):
    """dicts/lists/tuples of numpy arrays -> the same tree of tensors."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_torch(v, device) for v in tree]
    t = torch.from_numpy(np.array(tree, copy=True))
    return t.to(device) if device is not None else t


def unstack(tree, n: int) -> list:
    """A tree whose leaves carry a leading axis of ``n`` -> n trees."""
    def take(t, i):
        if isinstance(t, dict):
            return {k: take(v, i) for k, v in t.items()}
        return t[i]
    return [take(tree, i) for i in range(n)]


def vit_params(jax_params: dict, device: Optional[torch.device] = None
               ) -> dict:
    """Reference ``vit_init`` params (numpy leaves) -> ``repro_torch``'s."""
    params = to_torch(jax_params, device)
    layers = params["layers"]
    n = len(next(iter(_leaves(layers))))
    params["layers"] = unstack(layers, n)
    return params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
