"""Turn a reference (JAX) parameter tree, given as numpy arrays, into the
port's parameters.

The tests hold the port against the reference on the same weights, so they
initialise with the reference's ``vit_init``, ``lm_init``, ``resnet_init``,
``effnet_init``, ``dit_init`` or ``unet_init``, map its leaves to numpy and
convert here (under a mesh, to one rank's blocks: :func:`lm_params_shard`,
:func:`vision_params_shard`).  Layouts are
kept (dense kernels ``(d_in, d_out)``, conv kernels HWIO, switchable BN
arrays ``(n_settings, C)``, expert weights ``(E, d, f)``); each layer
stack that ``jax.vmap`` builds along a leading axis becomes the port's list
of per-layer dicts: :func:`vit_params` converts the ViT's and DiT's
trees (both stack ``layers``).  The conv nets' and the UNet's trees (each
stage a list of block dicts in the reference too) convert with
``to_torch`` as they are.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.layers import kv_cache_of


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
    """Reference ``vit_init`` or ``dit_init`` params (numpy leaves) ->
    ``repro_torch``'s: the ``layers`` stack unstacked."""
    params = to_torch(jax_params, device)
    layers = params["layers"]
    n = len(next(iter(_leaves(layers))))
    params["layers"] = unstack(layers, n)
    return params


def lm_params(jax_params: dict, device: Optional[torch.device] = None
              ) -> dict:
    """Reference ``lm_init`` params (numpy leaves) -> ``repro_torch``'s.

    Only the leading layer axis of ``dense_layers`` and ``moe_layers`` (the
    axis ``jax.vmap`` adds) is unstacked; the expert axis of ``wi``/``wg``/
    ``wo`` stays."""
    params = to_torch(jax_params, device)
    for name in ("dense_layers", "moe_layers"):
        if name in params:
            n = len(next(iter(_leaves(params[name]))))
            params[name] = unstack(params[name], n)
    return params


def lm_params_shard(jax_params: dict, mesh, coords=None,
                    device: Optional[torch.device] = None,
                    spec_fn=None) -> dict:
    """Reference ``lm_init`` params (numpy leaves) -> one rank's port
    params under ``mesh``: converted as :func:`lm_params`, each leaf then
    cut to the block the rank at mesh coordinate ``coords`` (default this
    rank) holds by ``spec_fn(path, shape)`` on the port's paths (default
    the serving placement, ``distributed.sharding.layer_serving_spec``:
    the routed experts split over ``"model"``, the rest whole; training:
    ``train_spec_fn(cfg)``), as a contiguous copy of its own."""
    from repro_torch.distributed.sharding import (layer_serving_spec,
                                                  shard_tree)
    return shard_tree(lm_params(jax_params, device), mesh, coords,
                      spec_fn or layer_serving_spec, own=True)


def vision_params_shard(jax_params: dict, mesh, spec_fn, coords=None,
                        device: Optional[torch.device] = None) -> dict:
    """Reference ``vit_init``, ``resnet_init`` or ``effnet_init`` params
    (numpy leaves) -> one rank's port params under ``mesh``: converted
    (the ViT's ``layers`` stack unstacked, :func:`vit_params`), each leaf
    then cut to the block the rank at mesh coordinate ``coords`` (default
    this rank) holds by ``spec_fn(path, shape)`` on the port's paths (the
    training placement, ``distributed.sharding.vision_train_spec_fn``),
    as a contiguous copy of its own."""
    from repro_torch.distributed.sharding import shard_tree
    params = vit_params(jax_params, device) if "layers" in jax_params \
        else to_torch(jax_params, device)
    return shard_tree(params, mesh, coords, spec_fn, own=True)


def lm_caches(jax_caches: dict, device: Optional[torch.device] = None
              ) -> dict:
    """Reference stacked decode caches {"dense"|"moe": {"k": (L, B, T, KH,
    D), "v": ..., "len": (L,)}} (numpy leaves) -> the port's per-layer
    lists, each with its ``len`` as a 0-d device int32 and its host
    mirror ``fill`` (:func:`repro_torch.core.layers.kv_cache_of`)."""
    out = {}
    for name, c in jax_caches.items():
        k, v = to_torch(c["k"], device), to_torch(c["v"], device)
        out[name] = [kv_cache_of(k[i], v[i], int(np.asarray(
            c["len"]).reshape(-1)[i])) for i in range(k.shape[0])]
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
