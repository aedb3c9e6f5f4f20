"""Optimizers as plain functions over the port's parameter trees.

Counterpart of the reference ``optim/api.py``: ``make_optimizer(name,
**hp)`` returns ``(init_fn, update_fn)``::

    state = init_fn(params)
    params, state = update_fn(params, grads, state, step)

Parameters and gradients are trees (dicts and lists) of tensors with the
same structure; moments are fp32 and shaped like the parameters.  The
port updates IN PLACE: ``update_fn`` writes the new values into the
parameter and state tensors it was given (under ``no_grad``) and returns
the same trees, where the reference returns new ones.  A gradient that is
``None`` (a parameter no loss reached, such as a layer the masked depth
gate skipped) counts as zeros, as the reference's zero gradient does.

Under a mesh (``layout=(mesh, specs)``, the training placement's spec of
every parameter) each rank updates its own blocks: AdamW and SGD with
momentum are elementwise, so their blocks' updates are the whole
update's; :func:`clip_by_global_norm` sums each leaf's squares once,
over the axes that split it; Adafactor's factored moments all-reduce
their row and column sums over the axes that split the reduced dim, as
the reference's ``opt_specs_like`` places them.

The weight-decay mask ``_wd_ok`` reads the same path strings as the
reference's.  The port's layer stack is a list, so its paths carry a layer
index (``layers/3/attn/q/kernel``) that the reference's stacked leaves do
not (``layers/attn/q/kernel``); no index contains a masked substring, so
both pick the same leaves.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.distributed import ctx
from repro_torch.distributed.sharding import (entry_axes, clean_spec,
                                              is_spec, split_axes)


def named_leaves(tree, path: str = "", is_leaf=None
                 ) -> List[Tuple[str, object]]:
    """[(path, leaf)] of a tree of dicts and lists, in a fixed order; paths
    as the reference's ``_path_str`` writes them (keys and list indices
    joined by '/').  ``is_leaf(t)`` stops the walk at a tuple (a spec)."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += named_leaves(v, f"{path}/{k}" if path else str(k),
                                is_leaf)
        return out
    if isinstance(tree, (list, tuple)) and not (is_leaf and is_leaf(tree)):
        out = []
        for i, v in enumerate(tree):
            out += named_leaves(v, f"{path}/{i}" if path else str(i),
                                is_leaf)
        return out
    return [(path, tree)]


def pop_grads(params):
    """The ``.grad`` accumulated on each parameter, as a tree of the
    parameters' structure (``None`` where no loss reached one), with every
    ``.grad`` cleared for the next step."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v) for v in t]
        g, t.grad = t.grad, None
        return g
    return walk(params)


def _wd_ok(path_s: str) -> bool:
    """No weight decay on norms/biases/BN."""
    return not any(t in path_s for t in ("bias", "scale", "ln", "norm", "bn",
                                         "pos", "cls"))


def _grad_list(params, grads) -> List[torch.Tensor]:
    """Each parameter's gradient in leaf order, zeros for a missing one."""
    ps = [p for _, p in named_leaves(params)]
    gs = [g for _, g in named_leaves(grads)] if grads is not None else []
    if len(gs) != len(ps):
        raise ValueError(f"grads have {len(gs)} leaves, params {len(ps)}")
    return [torch.zeros_like(p) if g is None else g for p, g in zip(ps, gs)]


def clip_by_global_norm(grads, max_norm: float, layout=None):
    """(grads scaled by min(1, max_norm / max(norm, 1e-6)), norm), the norm
    over every leaf in fp32 and the scale applied on the device (no host
    sync), IN PLACE: each leaf is scaled in fp32 and written back in its
    dtype (the reference's new tree, the same values; a copy of qwen's 15
    GB of fp32 gradients would not fit beside its state on one card), and
    the same tree returned.  ``None`` leaves stay ``None``.  With
    ``layout`` (mesh, specs) the leaves are a rank's blocks: each leaf's
    sum of squares is summed over the axes that split it, never over
    those that replicate it."""
    named = [(p, g) for p, g in named_leaves(grads) if g is not None]
    if not named:
        return grads, torch.zeros(())
    if layout is None:
        gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                            for _, g in named))
    else:
        mesh, specs = layout
        spec_of = dict(named_leaves(specs, is_leaf=is_spec))
        by_axes = {}
        for p, g in named:
            ax = split_axes(spec_of[p], mesh)
            sq = torch.sum(torch.square(g.float()))
            by_axes[ax] = sq if ax not in by_axes else by_axes[ax] + sq
        gn = torch.sqrt(sum(ctx.all_reduce_axes(sq.reshape(1), mesh, ax)[0]
                            for ax, sq in sorted(by_axes.items())))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-6), max=1.0)
    with torch.no_grad():
        for _, g in named:
            if g.dtype == torch.float32:
                g.mul_(scale)
            else:
                g.copy_(g.float() * scale)
    return grads, gn


def _write(p: torch.Tensor, new: torch.Tensor) -> None:
    p.copy_(new.to(p.dtype))


# --- AdamW -------------------------------------------------------------------

def adamw(lr: float = 1e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1):
    def init(params):
        return {"s": tree_map(lambda p: {
            "mu": torch.zeros_like(p, dtype=torch.float32),
            "nu": torch.zeros_like(p, dtype=torch.float32)}, params)}

    @torch.no_grad()
    def update(params, grads, state, step, layout=None):
        t = float(step) + 1.0
        c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        leaves = named_leaves(params)
        gs = _grad_list(params, grads)
        ss = _state_list(params, state["s"])
        for (path, p), g, s in zip(leaves, gs, ss):
            g = g.float()
            mu, nu = s["mu"], s["nu"]
            mu.mul_(b1).add_(g, alpha=1 - b1)
            nu.mul_(b2).addcmul_(g, g, value=1 - b2)
            # (mu / c1) / (sqrt(nu / c2) + eps), then p - lr u, with two
            # leaf-sized temporaries (qwen's head: 4.6 GB each) where the
            # plain expression takes five
            u = (mu / c1).div_((nu / c2).sqrt_().add_(eps))
            if weight_decay and _wd_ok(path):
                u.add_(p.float(), alpha=weight_decay)
            u.mul_(lr)
            if p.dtype == torch.float32:
                p.sub_(u)
            else:
                _write(p, p.float() - u)
        return params, state

    return init, update


# --- Adafactor (factored second moment; for 1T-param configs) ---------------

def adafactor(lr: float = 1e-3, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0):
    def _factored(shape) -> bool:
        return len(shape) >= 2 and shape[-1] >= 128 and shape[-2] >= 128

    def init(params):
        def st(p):
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32,
                                          device=p.device)}
            return {"v": torch.zeros_like(p, dtype=torch.float32)}
        return {"s": tree_map(st, params)}

    @torch.no_grad()
    def update(params, grads, state, step, layout=None):
        t = float(step) + 1.0
        beta = 1.0 - t ** (-decay)
        leaves = named_leaves(params)
        gs = _grad_list(params, grads)
        ss = _state_list(params, state["s"])
        specs = _spec_list(params, layout)
        for (_, p), g, s, spec in zip(leaves, gs, ss, specs):
            mean = _block_mean(layout, spec)
            g = g.float()
            g2 = torch.square(g) + eps
            if "vr" in s:
                s["vr"].mul_(beta).add_(mean(g2, -1), alpha=1 - beta)
                s["vc"].mul_(beta).add_(mean(g2, -2), alpha=1 - beta)
                # vr's last dim is the parameter's dim -2
                vr_mean = _block_mean(layout, spec and spec[:-1])(
                    s["vr"], -1)
                vr_hat = s["vr"] / torch.clamp(vr_mean[..., None], min=eps)
                u = g * torch.rsqrt(vr_hat)[..., None] \
                    * torch.rsqrt(torch.clamp(s["vc"], min=eps))[..., None, :]
            else:
                s["v"].mul_(beta).add_(g2, alpha=1 - beta)
                u = g * torch.rsqrt(torch.clamp(s["v"], min=eps))
            rms = torch.sqrt(mean(torch.square(u), None) + 1e-30)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            _write(p, p.float() - lr * u)
        return params, state

    return init, update


def _spec_list(params, layout) -> list:
    """Each parameter's spec in leaf order (None without a layout)."""
    if layout is None:
        return [None] * len(named_leaves(params))
    return [sp for _, sp in named_leaves(layout[1], is_leaf=is_spec)]


def _block_mean(layout, spec: Optional[tuple]) -> Callable:
    """``mean(t, dim)``: the whole leaf's mean along ``dim`` (``None``:
    over every element) from a rank's block ``t`` under ``spec``: the
    block's sum, summed over the axes that split the reduced dims, over
    the whole leaf's count."""
    def mean(t, dim):
        if layout is None:
            return torch.mean(t) if dim is None else torch.mean(t, dim)
        mesh = layout[0]
        entries = clean_spec(spec, mesh)
        dims = range(t.ndim) if dim is None else (dim % t.ndim,)
        axes = [a for d in dims for a in entry_axes(entries[d])]
        n = math.prod(t.shape[d] for d in dims) * ctx.axes_size(mesh, axes)
        if dim is None:
            return ctx.all_reduce_axes(t.sum().reshape(1), mesh,
                                       axes)[0] / n
        return ctx.all_reduce_axes(t.sum(dim), mesh, axes) / n
    return mean


# --- SGD momentum ------------------------------------------------------------

def sgdm(lr: float = 0.1, momentum: float = 0.9, weight_decay: float = 1e-4):
    def init(params):
        return {"s": tree_map(lambda p: {
            "m": torch.zeros_like(p, dtype=torch.float32)}, params)}

    @torch.no_grad()
    def update(params, grads, state, step, layout=None):
        leaves = named_leaves(params)
        gs = _grad_list(params, grads)
        ss = _state_list(params, state["s"])
        for (path, p), g, s in zip(leaves, gs, ss):
            g = g.float()
            if weight_decay and _wd_ok(path):
                g = g + weight_decay * p.float()
            s["m"].mul_(momentum).add_(g)
            _write(p, p.float() - lr * s["m"])
        return params, state

    return init, update


def make_optimizer(name: str, **hp) -> Tuple[Callable, Callable]:
    return {"adamw": adamw, "adafactor": adafactor, "sgdm": sgdm}[name](**hp)


def tree_map(fn, tree):
    """``tree``'s structure (dicts and lists) with ``fn(leaf)`` at each
    leaf, in :func:`named_leaves` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def _state_list(params, state_tree) -> List[dict]:
    """Each parameter's state dict in leaf order: ``state_tree`` has the
    parameters' structure with a dict of moments at each leaf (the
    reference's ``flatten_up_to``)."""
    if isinstance(params, dict):
        return [s for k, v in params.items()
                for s in _state_list(v, state_tree[k])]
    if isinstance(params, (list, tuple)):
        return [s for v, st in zip(params, state_tree, strict=True)
                for s in _state_list(v, st)]
    return [state_tree]
