"""The LM's train, prefill and decode steps, the vision nets' train step
and the diffusion nets' train step and denoiser.

Counterparts of the ``train_step``, ``prefill`` and ``decode`` closures
of the reference's ``launch/steps.py:_lm_cell``, the ``train_step`` of
its ``_vis_cell``, the ``train_step`` and ``gen_step`` of its
``_diff_cell``, its ``_accum_grads`` and ``build_cell``'s
``cfg_overrides``.  The LM also trains under a device mesh
(:func:`make_lm_train_step` with ``mesh=``: one rank of it, the training
placement's blocks of the parameters and AdamW state, the rank's rows of
each microbatch), and its prefill and decode run under one (the experts
split over ``"model"``, the decode cache over the sequence as the
reference's ``_lm_cell`` rule has it: over every axis below a batch of
16), eagerly (gloo's collectives cannot be captured in a CUDA graph).
The vision family trains under a mesh too (:func:`make_vis_train_step`
with ``mesh=``: the reference's ``vision_rules`` placement, the rank's
rows of each microbatch, batch norm over the whole microbatch).
The functions run eagerly; :class:`LMGraphs` runs the one-card prefill
and decode step as CUDA graphs on the card, the counterpart of the
reference's jit-compiled closures.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.registry import vision_family
from repro_torch.core.distill import ce_loss
from repro_torch.distributed import ctx
from repro_torch.distributed.decode_attn import (batch_block, is_sharded,
                                                 seq_start)
from repro_torch.distributed.sharding import (is_spec, model_split,
                                              replicated_axes)
from repro_torch.graphs import Graph, new_pool, pool_bytes
from repro_torch.models import diffusion as diff
from repro_torch.models.dit import dit_apply
from repro_torch.models.efficientnet import effnet_apply
from repro_torch.models.resnet import resnet_apply
from repro_torch.models.transformer import (LMConfig, check_decodable,
                                            lm_apply, make_decode_caches)
from repro_torch.models.unet import unet_apply
from repro_torch.models.vit import vit_apply
from repro_torch.optim.api import (clip_by_global_norm, named_leaves,
                                   pop_grads, tree_map)


# Grad-accumulation defaults of the reference's ``build_cell``:
# microbatches per step, by (arch, shape).  Neither conv net has an
# entry, so both train at accum 1 by default, as in the reference;
# UNet-SDXL's train_256 step is 2 microbatches of 128.
ACCUM_DEFAULTS = {
    ("qwen1.5-110b", "train_4k"): 16,
    ("kimi-k2-1t-a32b", "train_4k"): 16,
    ("granite-20b", "train_4k"): 16,
    ("deepseek-moe-16b", "train_4k"): 4,
    ("unet-sdxl", "train_1024"): 2,
    ("unet-sdxl", "train_256"): 2,
    ("dit-l2", "train_1024"): 2,
}
# Config fields replaced where one card cannot hold the model, by (arch,
# shape name, or "serve" for the LM launcher's serving), printed by the
# launcher that applies them.  Training: the reference's build_cell
# cfg_overrides, the first layers of the stack at full width.  fp32
# parameters, gradients and AdamW moments take 16 bytes a parameter, kimi's
# bf16 parameters with Adafactor 8 (2 + a bf16 gradient 2 + its fp32 sum
# 4; the factored moments are small): deepseek-moe-16b 4 layers, 1 dense +
# 3 MoE, 2.27 B parameters, 36 GB (its 28 layers need 262 GB: ROADMAP item
# 11); qwen1.5-110b 1 of 80 layers, 1.36 B + 2.49 B of embedding and head,
# 61.6 GB (2 layers, 83 GB, do not fit); granite-20b 8 of 52, 3.64 B, 58.2
# GB; kimi-k2-1t-a32b its dense first layer, 2.86 B, 22.9 GB (an MoE
# layer is 17.1 B more).  Serving in bf16 at full width, the first layers
# of the stack: qwen1.5-110b 8 x 1.36 B + 2.49 B, 26.7 GB; kimi-k2-1t-a32b
# its dense layer and one MoE layer of 384 experts, 19.9 B, 39.9 GB; the
# other LMs serve whole.  A training entry may also hold ``global_batch``,
# as ``SHARED_CARD_CUT``'s do (none does here: the launcher keeps the
# shape's batch, 256 x 4096 at train_4k).
ONE_CARD_CUT = {
    ("deepseek-moe-16b", "train_4k"): {"n_layers": 4},
    ("qwen1.5-110b", "train_4k"): {"n_layers": 1},
    ("granite-20b", "train_4k"): {"n_layers": 8},
    ("kimi-k2-1t-a32b", "train_4k"): {"n_layers": 1},
    ("qwen1.5-110b", "serve"): {"n_layers": 8},
    ("kimi-k2-1t-a32b", "serve"): {"n_layers": 2},
}
# Training under a mesh whose ranks share one card (or the host's CPU):
# deepseek-moe-16b cut further to its dense layer and one MoE layer at
# full width (1.09 B parameters, 17.5 GB of fp32 state over the ranks),
# as ``chip_smoke.py`` phase 10 cuts it, and to a global batch of 4
# sequences as 2 microbatches (a 2 x 2 mesh's data block holds one row
# of each): every FSDP block crosses gloo, through host memory, twice a
# microbatch; granite-20b to 2 layers (1.36 B, 21.8 GB) and kimi-k2 to
# its dense layer (2.86 B, 22.9 GB), each a global batch of 2 sequences
# as 1 microbatch.  ``n_layers`` cuts the config; ``global_batch`` and
# ``accum`` (``--accum`` overrides it) the step
SHARED_CARD_CUT = {
    ("deepseek-moe-16b", "train_4k"): {"n_layers": 2, "global_batch": 4,
                                       "accum": 2},
    ("granite-20b", "train_4k"): {"n_layers": 2, "global_batch": 2,
                                  "accum": 1},
    ("kimi-k2-1t-a32b", "train_4k"): {"n_layers": 1, "global_batch": 2,
                                      "accum": 1},
    # the vision family whole (no depth cut: 22-304 M parameters, at most
    # 4.9 GB of fp32 state over the ranks), cls_224's global batch cut
    # from 256 to 8 images as 2 microbatches (a 2 x 2 mesh's data block
    # holds 2 of each): every split conv's output crosses gloo, through
    # host memory, twice a microbatch
    **{(a, "cls_224"): {"global_batch": 8, "accum": 2}
       for a in ("dynamic-ofa-supernet", "deit-b", "vit-l16", "resnet-152",
                 "efficientnet-b7")},
}


def _rows(tree, lo: int, hi: int):
    """Rows lo:hi of every tensor of a (nested) batch dict."""
    if isinstance(tree, dict):
        return {k: _rows(v, lo, hi) for k, v in tree.items()}
    return tree[lo:hi]


def accum_grads(loss_fn: Callable, params, batch: dict, accum: int):
    """The reference's ``_accum_grads``: ``loss_fn(params, mb)`` and its
    backward over ``accum`` consecutive chunks of the batch (a dict of
    tensors or of such dicts: the diffusion batch's ``cond``), one chunk's
    activations alive at a time.  Returns (the mean loss, detached; the
    gradients, a tree of the parameters' structure, ``None`` where no loss
    reached a leaf), every ``.grad`` cleared.  At ``accum`` <= 1 each
    gradient is in its parameter's dtype; above, the chunks' gradients sum
    in fp32 whatever the parameter's dtype (a bf16 leaf's each chunk cast
    up, an fp32 leaf's accumulated by autograd on its ``.grad``), in chunk
    order, and are divided by ``accum`` in place, as the reference's
    ``jnp.zeros(p.shape, jnp.float32)`` sums are."""
    if accum <= 1:
        loss = loss_fn(params, batch)
        loss.backward()
        return loss.detach(), pop_grads(params)
    B = next(iter(batch.values())).shape[0]
    if B % accum:
        raise ValueError(f"batch {B} does not split into {accum} chunks")
    n = B // accum
    leaves = [p for _, p in named_leaves(params)]
    sums: Dict[int, torch.Tensor] = {}
    lsum = None
    for i in range(accum):
        loss = loss_fn(params, _rows(batch, i * n, (i + 1) * n))
        loss.backward()
        lsum = loss.detach() if lsum is None else lsum + loss.detach()
        # an fp32 leaf sums on its .grad (autograd adds in place, no
        # second buffer); any other leaf's chunk gradient is cast up into
        # its fp32 sum and its .grad cleared
        with torch.no_grad():
            for j, p in enumerate(leaves):
                if p.dtype == torch.float32 or p.grad is None:
                    continue
                g, p.grad = p.grad, None
                if j in sums:
                    sums[j].add_(g)
                else:
                    sums[j] = g.float()
    out = []
    with torch.no_grad():
        for j, p in enumerate(leaves):
            g, p.grad = sums.get(j, p.grad), None
            out.append(None if g is None else g.div_(accum))
    it = iter(out)
    return lsum / accum, tree_map(lambda _: next(it), params)


def _or_zeros(p: torch.Tensor, g, accum: int) -> torch.Tensor:
    """``g``, or zeros for a leaf no loss reached, in the dtype
    :func:`accum_grads` gives the others."""
    if g is not None:
        return g
    return torch.zeros_like(p, dtype=torch.float32 if accum > 1 else None)


def clipped_step(loss_fn: Callable, update_fn: Callable,
                 accum: int) -> Callable:
    """The reference's train step around ``loss_fn(params, mb)``: its
    mean over ``accum`` microbatches (:func:`accum_grads`), the gradient
    clipped to global norm 1.0, one optimizer update.

    ``step(params, opt, batch, step) -> (params, opt, {"loss", "gnorm"})``
    with the parameters (leaves that require grad) and the optimizer state
    updated in place and the metrics as device scalars."""
    def step(params, opt, batch, step):
        pop_grads(params)
        loss, grads = accum_grads(loss_fn, params, batch, accum)
        grads, gn = clip_by_global_norm(grads, 1.0)
        params, opt = update_fn(params, grads, opt, step)
        return params, opt, {"loss": loss, "gnorm": gn}
    return step


def vis_forward(arch_id: str, cfg, *, mesh=None, specs=None) -> Callable:
    """``forward(params, images) -> logits`` of the reference's
    ``vis_train`` step: the ViTs as they serve, the conv nets with
    batch-statistics BN (``train=True``); with ``mesh`` and ``specs``
    one rank's forward under the training placement."""
    fam = vision_family(arch_id)
    kw = dict(mesh=mesh, specs=specs)
    if fam == "vit":
        return lambda p, x: vit_apply(p, x, cfg, **kw)[0]
    if fam == "resnet":
        return lambda p, x: resnet_apply(p, x, cfg, train=True, **kw)[0]
    if fam == "effnet":
        return lambda p, x: effnet_apply(p, x, cfg, train=True, **kw)[0]
    raise NotImplementedError(f"{arch_id}: no ported vis_train forward")


def make_vis_train_step(arch_id: str, cfg, update_fn: Callable,
                        accum: int = 1, *, mesh=None,
                        specs=None) -> Callable:
    """The reference's ``vis_train`` step: cross entropy of the full net
    on the labels through :func:`clipped_step`.

    ``mesh`` (with ``specs``, the vision placement's spec of every leaf,
    from the whole leaves' shapes: ``distributed.sharding.
    vision_train_spec_fn``): one rank's step, as :func:`mesh_step`
    describes it, on its blocks and its rows of each microbatch; each
    rank differentiates the cross entropy of its rows over the global
    image count and the ``"model"`` ranks that replicate the logits."""
    forward = vis_forward(arch_id, cfg, mesh=mesh, specs=specs)
    if mesh is None:
        def loss_fn(params, mb):
            return ce_loss(forward(params, mb["images"]), mb["labels"])
        return clipped_step(loss_fn, update_fn, accum)
    if specs is None:
        raise ValueError("a mesh step wants the training placement's specs")

    def share_fn(params, mb):
        nll = vocab_parallel_nll(forward(params, mb["images"]),
                                 mb["labels"], mesh, False)
        return nll.sum() / (nll.numel() * mesh.size())
    return mesh_step(share_fn, update_fn, accum, mesh, specs)


def diff_denoise(arch_id: str, cfg, E=None) -> Callable:
    """``denoise(params, latents, t, cond) -> eps`` of the reference's
    ``_diff_cell`` (its ``gen_step``: one evaluation of the sampler's
    model): DiT on ``cond["y"]``, the UNet on ``cond["ctx"]`` and
    ``cond["pooled"]``."""
    if arch_id.startswith("dit"):
        return lambda p, x, t, cond: dit_apply(p, x, t, cond["y"], cfg, E=E)
    if arch_id.startswith("unet"):
        return lambda p, x, t, cond: unet_apply(p, x, t, cond["ctx"],
                                                cond["pooled"], cfg, E=E)
    raise NotImplementedError(f"{arch_id}: no ported diffusion denoiser")


def make_diff_train_step(arch_id: str, cfg, update_fn: Callable,
                         accum: int = 1) -> Callable:
    """The reference's ``diff_train`` step: ``q_sample`` of the latents at
    the batch's t with its noise, the denoiser, the MSE of the first C
    output channels against the noise (the mean over ``accum``
    microbatches), the gradient clipped to global norm 1.0, one optimizer
    update.  ``batch`` is {"latents", "noise", "t", "cond": {...}} as the
    launcher's ``diffusionize`` makes it.

    ``step(params, opt, batch, step) -> (params, opt, {"loss", "gnorm"})``
    as :func:`clipped_step`'s."""
    denoise = diff_denoise(arch_id, cfg)
    sched = diff.make_schedule()
    on_device = {}

    def loss_fn(params, mb):
        lat, noise = mb["latents"], mb["noise"]
        s = on_device.get(lat.device)
        if s is None:
            s = on_device[lat.device] = diff.schedule_on(sched, lat.device)
        x_t = diff.q_sample(s, lat, mb["t"], noise)
        eps = denoise(params, x_t, mb["t"], mb["cond"])[..., :lat.shape[-1]]
        return torch.mean(torch.square(eps.float() - noise.float()))
    return clipped_step(loss_fn, update_fn, accum)


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor, mesh,
                       split: bool) -> torch.Tensor:
    """Per-token negative log-likelihood (fp32) of logits whose last dim
    is this rank's block of the vocabulary (``split``; else the whole
    vocabulary): the max, the sum of exponentials and the target's logit
    each summed or maxed over ``"model"`` in fp32, the sums through the
    differentiable all-reduce.  The same function as ``ce_loss``'s
    log-softmax; replicated over ``"model"``."""
    z = logits.float()
    if not split:
        return -torch.gather(torch.log_softmax(z, -1), -1,
                             labels.long()[..., None])[..., 0]
    group = ctx.axes_group(mesh, ("model",))
    V_loc = z.shape[-1]
    with torch.no_grad():
        m = ctx.all_reduce(z.max(-1).values, "max", group)
    se = ctx.all_reduce_grad(torch.exp(z - m[..., None]).sum(-1), group)
    local = labels.long() - ctx.axes_index(mesh, ("model",)) * V_loc
    inside = (local >= 0) & (local < V_loc)
    t = torch.gather(z, -1, local.clamp(0, V_loc - 1)[..., None])[..., 0]
    t = ctx.all_reduce_grad(t * inside, group)
    return m + torch.log(se) - t


def reduce_replicated(grads, specs, mesh) -> None:
    """Sum, in place, each gradient block over the mesh axes that
    replicate its leaf (``specs`` mirrors ``grads``), one flat fp32
    buffer per set of axes: each rank's share of the loss left it a
    partial (``ctx``'s convention).  Blocks split over batch axes were
    reduce-scattered in the backward."""
    spec_of = dict(named_leaves(specs, is_leaf=is_spec))
    groups: Dict[tuple, list] = {}
    for path, g in named_leaves(grads):
        axes = replicated_axes(spec_of[path], mesh)
        if axes:
            groups.setdefault(axes, []).append(g)
    for axes, gs in sorted(groups.items()):
        flat = ctx.all_reduce_axes(
            torch.cat([g.reshape(-1).float() for g in gs]), mesh, axes)
        for g, part in zip(gs, flat.split([g.numel() for g in gs])):
            g.copy_(part.view_as(g))


def mesh_step(share_fn: Callable, update_fn: Callable, accum: int, mesh,
              specs) -> Callable:
    """One rank's train step under the training placement ``specs`` (a
    tree beside the parameters): ``share_fn(params, mb)`` is the rank's
    share of the reference's loss on its rows of a microbatch (the shares
    of every rank sum to it), so that the gradients summed over the ranks
    that hold a leaf are the reference's (``ctx``'s convention).  Blocks
    split over batch axes are reduce-scattered in each microbatch's
    backward; after the last microbatch the rest are summed over the
    axes that replicate them (:func:`reduce_replicated`); then the clip
    over blocks and the update on them.  The loss and gradient norm
    returned are the global ones, on every rank."""
    world = ctx.axes_group(mesh, mesh.mesh_dim_names)

    def step(params, opt, batch, step):
        pop_grads(params)
        share, grads = accum_grads(share_fn, params, batch, accum)
        # a leaf no loss reached: zeros (fp32 where the sums are), so that
        # every rank sums the same buffers
        gs = iter([g for _, g in named_leaves(grads)])
        grads = tree_map(lambda p: _or_zeros(p, next(gs), accum), params)
        reduce_replicated(grads, specs, mesh)
        grads, gn = clip_by_global_norm(grads, 1.0, layout=(mesh, specs))
        params, opt = update_fn(params, grads, opt, step,
                                layout=(mesh, specs))
        loss = ctx.all_reduce(share.reshape(1).clone(), "sum", world)[0]
        return params, opt, {"loss": loss, "gnorm": gn}
    return step


def make_lm_train_step(cfg: LMConfig, update_fn: Callable, accum: int = 1,
                       *, E=None, cfg_overrides: Optional[dict] = None,
                       mesh=None, specs=None) -> Callable:
    """The reference's ``_lm_cell`` train step: the cross entropy of the
    next-token logits on the labels plus the MoE aux loss (weighted by
    ``lm_apply``), through :func:`clipped_step`.  ``batch`` is {"tokens",
    "labels"} (B, S).  ``cfg_overrides`` replaces config fields first, as
    the reference's ``build_cell`` does (the launcher's one-card depth
    cut); the step's ``cfg`` attribute is the config it runs, for the
    parameters' init.

    ``mesh`` (with ``specs``, the training placement's spec of every
    leaf, a tree beside ``params``, computed from the WHOLE leaves'
    shapes: ``distributed.sharding.train_spec_fn``): the step of one
    rank, whose ``params`` and optimizer state are its blocks and whose
    ``batch`` holds its rows of
    each microbatch, microbatch after microbatch (``data.
    microbatch_rows``): its data block of the reference's microbatch i
    is its chunk i.  Each rank differentiates its share of the
    reference's loss (the cross entropy of its rows over the global
    token count, over the ``"model"`` ranks that replicate it; the aux
    loss over all ranks), so that the gradients summed over the ranks
    that hold a leaf are the reference's: FSDP blocks reduce-scattered in
    each microbatch's backward (fp32), the rest summed over the axes that
    replicate them after the last microbatch (:func:`reduce_replicated`);
    then the clip over blocks and the update on them.  The loss and
    gradient norm returned are the global ones, on every rank."""
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    if mesh is None:
        def loss_fn(params, mb):
            logits, aux, _ = lm_apply(params, mb["tokens"], cfg, E=E)
            return ce_loss(logits, mb["labels"]) + aux
        step = clipped_step(loss_fn, update_fn, accum)
        step.cfg = cfg
        return step
    if specs is None or E:
        raise ValueError("a mesh step wants the training placement's "
                         "specs, at full width")

    def share_fn(params, mb):
        logits, aux, _ = lm_apply(params, mb["tokens"], cfg, mesh=mesh,
                                  specs=specs)
        nll = vocab_parallel_nll(logits, mb["labels"], mesh, model_split(
            specs["lm_head"]["kernel"], mesh))
        return nll.sum() / (nll.numel() * mesh.size()) + aux / mesh.size()
    step = mesh_step(share_fn, update_fn, accum, mesh, specs)
    step.cfg = cfg
    return step


def lm_prefill(params: dict, tokens: torch.Tensor, cfg: LMConfig, *,
               E=None, max_len: Optional[int] = None,
               caches: Optional[dict] = None, mesh=None):
    """tokens (B, S) -> last-position logits (B, V), as the reference's
    prefill returns them.  With ``max_len``, also returns decode caches of
    ``max_len`` slots holding this prefill's k and v (filled to S), ready
    for :func:`lm_decode`: (logits, caches); with ``caches`` (from
    :func:`make_decode_caches`) it writes into those in place instead,
    their ``len`` set to S on the device (no host sync: a graph of it
    refills the same caches).  Like decode, that raises at a sliced depth
    or head count (fault F4).  Under a ``mesh`` (this rank's part) the
    caches are this rank's block of each, as :func:`make_decode_caches`
    gives them, filled with its rows and slots of this prefill's k and
    v."""
    want = max_len is not None or caches is not None
    if want:
        check_decodable(cfg, E)
    logits, _, kv = lm_apply(params, tokens, cfg, E=E, return_kv=want,
                             mesh=mesh)
    # a copy, not a view: a view would keep the (B, S, V) logits alive
    last = logits[:, -1, :].clone()
    if not want:
        return last
    B, S = tokens.shape
    if caches is None:
        caches = make_decode_caches(cfg, B, max_len, dtype=cfg.cdtype(),
                                    device=tokens.device, mesh=mesh)
    rows, start = slice(None), 0
    for name, layers in kv.items():
        for c, new in zip(caches[name], layers):
            if is_sharded(cfg.decode_impl, mesh):
                slots = c["k"].shape[1]
                rows, start = batch_block(mesh, B), seq_start(mesh, B, slots)
            n = min(max(S - start, 0), c["k"].shape[1])
            c["k"][:, :n] = new["k"][rows, start:start + n]
            c["v"][:, :n] = new["v"][rows, start:start + n]
            c["len"].fill_(S)
            c["fill"] = S
    return last, caches


def lm_decode(params: dict, caches: dict, tokens: torch.Tensor,
              cfg: LMConfig, *, E=None, mesh=None):
    """One decode step: tokens (B, 1) against ``caches`` (updated in place)
    -> (logits (B, V), caches).  Raises NotImplementedError at a sliced
    depth or head count, where the reference's decode fails (fault F4).
    Under a ``mesh``, this rank's step against its cache blocks (the
    logits whole on every rank)."""
    logits, _, caches = lm_apply(params, tokens, cfg, E=E, caches=caches,
                                 mesh=mesh)
    return logits[:, -1, :], caches


class LMGraphs:
    """The LM's prefill and decode step as CUDA graphs on the card.

    One prefill graph per (operating point, whether it writes the caches)
    over a static (B, S) prompt, and one decode-step graph per decodable
    point over a static (B, 1) token input, all over one set of static
    decode caches of ``max_len`` slots.  A prefill graph writes its k and
    v into the caches and sets their device ``len`` to S; a decode graph
    writes this step's k and v at ``len`` and advances ``len`` in place,
    so one graph serves every step, as the reference's decode executable
    does with its traced ``len``.  The host mirror ``fill`` of each cache
    is advanced here per replay, and a step that would overflow the
    caches raises before the replay.  The graphs share one memory pool
    and replay on the caller's stream.  Capture happens at first use (or
    :meth:`capture`); its eager warm-up and the capture leave the caches'
    ``len`` and ``fill`` as they were.
    """

    def __init__(self, params: dict, cfg: LMConfig, batch: int,
                 prefill_len: int, max_len: int, device: torch.device):
        self.params, self.cfg = params, cfg
        self.pool = new_pool()
        self.stream = torch.cuda.Stream(device)
        self.caches = make_decode_caches(cfg, batch, max_len,
                                         dtype=cfg.cdtype(), device=device)
        self.prompt = torch.zeros((batch, prefill_len), dtype=torch.long,
                                  device=device)
        self.step_in = torch.zeros((batch, 1), dtype=torch.long,
                                   device=device)
        self._graphs: Dict[tuple, Graph] = {}

    def _layers(self):
        for stack in self.caches.values():
            yield from stack

    @staticmethod
    def _point(E) -> tuple:
        return tuple(sorted((E or {}).items()))

    def _graph(self, key: tuple, fn: Callable, inputs) -> Graph:
        g = self._graphs.get(key)
        if g is None:
            saved = [(c, c["fill"], c["len"].clone()) for c in self._layers()]
            # capture from the state after a prefill: a decode step's
            # warm-up must find room in the caches
            S = self.prompt.shape[1]
            for c in self._layers():
                c["fill"] = S
                c["len"].fill_(S)
            try:
                g = Graph(fn, inputs, pool=self.pool, stream=self.stream)
            finally:
                for c, fill, n in saved:
                    c["fill"] = fill
                    c["len"].copy_(n)
            self._graphs[key] = g
        return g

    def _prefill_graph(self, E, caches: bool) -> Graph:
        def fn(tokens):
            with torch.inference_mode():
                if caches:
                    return lm_prefill(self.params, tokens, self.cfg, E=E,
                                      caches=self.caches)[0]
                return lm_prefill(self.params, tokens, self.cfg, E=E)
        return self._graph(("prefill", self._point(E), caches), fn,
                           [self.prompt])

    def _decode_graph(self, E) -> Graph:
        def fn(tokens):
            with torch.inference_mode():
                return lm_decode(self.params, self.caches, tokens, self.cfg,
                                 E=E)[0]
        return self._graph(("decode", self._point(E)), fn, [self.step_in])

    def capture(self, E=None, *, decodable: bool = True) -> None:
        """Capture the prefill graph at ``E`` (writing the caches when
        ``decodable``) and, when decodable, the decode-step graph."""
        self._prefill_graph(E, decodable)
        if decodable:
            self._decode_graph(E)

    def prefill(self, tokens: torch.Tensor, E=None, *,
                decodable: bool = True) -> torch.Tensor:
        """Replay the prefill of ``tokens`` (B, S): last-position logits
        (B, V), and when ``decodable`` the static caches filled to S."""
        out = self._prefill_graph(E, decodable).run(tokens)
        if decodable:
            for c in self._layers():
                c["fill"] = tokens.shape[1]
        return out

    def decode(self, tokens: torch.Tensor, E=None) -> torch.Tensor:
        """Replay one decode step of ``tokens`` (B, 1) against the static
        caches: logits (B, V).  Raises before the replay when a cache is
        full."""
        g = self._decode_graph(E)
        for c in self._layers():
            if c["fill"] + 1 > c["k"].shape[1]:
                raise ValueError(f"kv cache {tuple(c['k'].shape)} at len "
                                 f"{c['fill']} cannot take another step")
        out = g.run(tokens)
        for c in self._layers():
            c["fill"] += 1
        return out

    @property
    def captures(self) -> int:
        return len(self._graphs)

    def pool_bytes(self) -> Optional[int]:
        """Device memory held by the graphs' pool."""
        return pool_bytes(self.pool)
