"""Decoder-only LM (dense and MoE) with elastic knobs, prefill and decode.

Counterpart of the reference ``models/transformer.py``: a static ``E``
slices the expert count, top-k, per-expert and dense FFN width, heads and
depth (sliced mode); 0-d tensor widths (masked mode) keep the full widths
with zeros past the active counts, as the reference does.  The masked
depth gate runs the first ``a_layers`` layers and skips the rest, where
the reference runs every layer and adds ``gate * f(h)`` with ``gate = 0``
past ``a_layers``: the logits are the same, and the aux loss then counts
the layers run, as sliced mode's does (the reference's masked aux loss
also counts the gated layers'; ROADMAP §3).  Parameters are a dict in the
reference layout,
except that each layer stack (``dense_layers``, ``moe_layers``) is a list
of per-layer dicts, and the decode caches likewise (the reference stacks
both on a leading axis for ``jax.lax.scan``; here the scan is a Python
loop).  Every dense product runs on the elastic matmul (K1), attention on
flash attention (K2, head dim 128 for the LMs, 112 for kimi-k2) and every
routed expert product on the expert-gated matmul (K3).

Under a device ``mesh`` (``lm_apply(..., mesh=)``, one rank of it) the
parameters are the rank's (:func:`lm_init`'s ``shard``).  Serving: the
routed experts split over ``"model"``, the rest replicated; the MoE
layers take ``cfg.moe.dispatch`` (``"a2a"``: expert parallelism) and
decode takes ``cfg.decode_impl`` (``"sharded"``: each rank holds a block
of the cache's sequence, :func:`make_decode_caches`); everything else
runs replicated on every rank.  Training (``specs=``: the training
placement's spec of every leaf, ``distributed.sharding.train_spec_fn``):
the tokens are the rank's rows of the batch; each layer gathers its FSDP
blocks inside itself (under remat again in the recompute), attention and
the dense FFN and shared experts run tensor parallel over ``"model"``,
the embedding looks up the rank's vocabulary block and all-reduces, and
the head gives the rank's block of the vocabulary's logits
(``launch/steps.py:vocab_parallel_nll`` takes them).

``remat`` other than ``"none"`` runs each layer under
``torch.utils.checkpoint`` when a gradient is wanted: a full recompute of
the layer in the backward (the reference's ``dots_nb`` policy saves the
products without batch dims and recomputes the rest; the port saves only
the layer's input: ROADMAP §3).  The recompute takes the forward's
kernel/plain route (it runs on autograd's thread).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import layers as L
from repro_torch.core.types import ElasticSpace
from repro_torch.device import resolve_device
from repro_torch.distributed import ctx
from repro_torch.distributed.sharding import model_split
from repro_torch.distributed.decode_attn import is_sharded, local_cache_shape
from repro_torch.kernels import ops
from repro_torch.models.moe import MoEConfig, moe_apply, moe_init


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    qkv_bias: bool = False
    gated_mlp: bool = True
    act: str = "silu"
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    first_k_dense: int = 0
    d_ff_dense: Optional[int] = None     # FFN width of leading dense layers
    # the reference's attention variants: the port runs every attention
    # through K2, so unused here; decode_impl "sharded" decodes against a
    # sequence-sharded cache under a mesh (two-pass softmax)
    attn_impl: str = "ref"               # ref | blocked_scan | blocked_causal
    decode_impl: str = "xla"             # xla | sharded (two-pass softmax)
    block_q: int = 512
    block_kv: int = 512
    # the reference's remat policy; any but "none" recomputes each whole
    # layer in the port's backward (module note)
    remat: str = "none"                  # none | full | dots | dots_nb
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    elastic: ElasticSpace = ElasticSpace()

    @property
    def n_moe_layers(self) -> int:
        return self.n_layers - self.first_k_dense if self.moe else 0

    @property
    def n_dense_layers(self) -> int:
        return self.first_k_dense if self.moe else self.n_layers

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _attn_init(gen, cfg: LMConfig, dtype, device) -> dict:
    return L.attention_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.d_head, qkv_bias=cfg.qkv_bias, dtype=dtype,
                            device=device)


def _dense_layer_init(gen, cfg: LMConfig, dtype, device) -> dict:
    return {
        "ln1": L.rmsnorm_init(cfg.d_model, dtype, device),
        "attn": _attn_init(gen, cfg, dtype, device),
        "ln2": L.rmsnorm_init(cfg.d_model, dtype, device),
        "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff_dense or cfg.d_ff,
                          gated=cfg.gated_mlp, dtype=dtype, device=device),
    }


def _moe_layer_init(gen, cfg: LMConfig, dtype, device, keep=None) -> dict:
    return {
        "ln1": L.rmsnorm_init(cfg.d_model, dtype, device),
        "attn": _attn_init(gen, cfg, dtype, device),
        "ln2": L.rmsnorm_init(cfg.d_model, dtype, device),
        "moe": moe_init(gen, cfg.d_model, cfg.moe, dtype=dtype,
                        device=device, keep=keep),
    }


def _map_leaves(fn, tree, path: str):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_leaves(fn, v, f"{path}/{i}") for i, v in enumerate(tree)]
    return fn(path, tree)


def lm_init(gen: torch.Generator, cfg: LMConfig, *,
            device: Optional[torch.device] = None,
            dtype: Optional[torch.dtype] = None,
            shard: Optional[Callable] = None) -> dict:
    """Random parameters with the reference's distributions (normal
    kernels scaled by 1/sqrt(fan_in), 0.02-scaled embedding, unit norms),
    drawn from ``gen``, tensor by tensor, in ``dtype`` (default the
    config's param dtype; the MoE routers are always fp32).

    The parameters live on the card unless the caller passes ``"cpu"``;
    with no card and no explicit request this raises.  Normals are drawn on
    the generator's device: give a generator on the card for a full-size
    model (16.4 B normals drawn on the CPU would take minutes and host
    memory the size of the model in fp32).

    ``shard(path, t)`` (a rank's block of each leaf under a mesh:
    ``distributed.sharding``; paths as ``moe_layers/3/moe/wi``) runs on
    every leaf, the routed experts' as soon as each is drawn, the others
    once their layer is: the draws are the one-process run's, and a rank
    never holds more than one whole expert weight beside its blocks.
    """
    device = resolve_device(device)
    dtype = cfg.pdtype() if dtype is None else dtype
    cut = (lambda path, t: t) if shard is None else shard

    def part(path, tree):
        return _map_leaves(cut, tree, path) if shard is not None else tree

    params = {"embed": part("embed", L.embedding_init(
                  gen, cfg.vocab_size, cfg.d_model, dtype, device)),
              "final_norm": part("final_norm", L.rmsnorm_init(
                  cfg.d_model, dtype, device))}
    if cfg.n_dense_layers:
        params["dense_layers"] = [
            part(f"dense_layers/{i}", _dense_layer_init(gen, cfg, dtype,
                                                        device))
            for i in range(cfg.n_dense_layers)]
    if cfg.n_moe_layers:
        layers = []
        for i in range(cfg.n_moe_layers):
            at = f"moe_layers/{i}"
            lp = _moe_layer_init(
                gen, cfg, dtype, device,
                keep=lambda name, t, at=at: cut(f"{at}/moe/{name}", t))
            experts = {k: lp["moe"].pop(k) for k in ("wi", "wg", "wo")}
            lp = part(at, lp)
            lp["moe"].update(experts)
            layers.append(lp)
        params["moe_layers"] = layers
    if not cfg.tie_embeddings:
        params["lm_head"] = part("lm_head", L.dense_init(
            gen, cfg.d_model, cfg.vocab_size, bias=False, dtype=dtype,
            device=device))
    return params


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def _block(h, lp, cfg: LMConfig, E, *, is_moe: bool, kv_cache=None,
           return_kv: bool, mesh=None, specs=None):
    """One transformer block.  Returns (h, aux_loss, new_cache).
    ``specs``: the layer's leaves' specs under the training placement
    (the module note)."""
    a_model = E.get("a_model")
    a_ff = E.get("a_ff")
    tp = tp_ff = None
    if specs is not None:
        lp = L.gather_blocks(lp, specs, mesh, cfg.cdtype())
        tp = L.tp_mesh(specs["attn"], "q", "o", mesh)
        if not is_moe:
            tp_ff = L.tp_mesh(specs["mlp"], "wi", "wo", mesh)
    hn = L.rmsnorm_apply(lp["ln1"], h, a=a_model, eps=cfg.norm_eps)
    attn_out, new_cache = L.attention_apply(
        lp["attn"], hn, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        d_head=cfg.d_head, causal=True, rope_theta=cfg.rope_theta,
        a_model=a_model, a_heads=E.get("a_heads"), kv_cache=kv_cache,
        return_kv=return_kv, decode_impl=cfg.decode_impl, mesh=mesh, tp=tp)
    h = h + attn_out
    hn = L.rmsnorm_apply(lp["ln2"], h, a=a_model, eps=cfg.norm_eps)
    if is_moe:
        ff, aux = moe_apply(lp["moe"], hn, cfg.moe,
                            a_experts=E.get("a_experts"),
                            top_k=E.get("top_k"), a_ff=a_ff, a_model=a_model,
                            mesh=mesh,
                            specs=None if specs is None else specs["moe"])
    else:
        ff = L.mlp_apply(lp["mlp"], hn, a_model=a_model,
                         a_ff=E.get("a_ff_dense", a_ff), act=cfg.act,
                         tp=tp_ff)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h + ff, aux, new_cache


def _remat_block(h, lp, cfg: LMConfig, E, is_moe: bool, mesh, specs):
    return _block(h, lp, cfg, E, is_moe=is_moe, return_kv=False, mesh=mesh,
                  specs=specs)[:2]


def _stack(h, stack, cfg: LMConfig, E, *, is_moe: bool, caches=None,
           return_kv: bool, mesh=None, specs=None):
    """The layers of one homogeneous stack in order (the reference's scan);
    each under ``checkpoint`` when ``cfg.remat`` asks for it and a
    gradient is wanted (h requires one): one card, or a mesh under the
    training placement (``specs``: one per layer)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    new_caches = []
    remat = cfg.remat != "none" and torch.is_grad_enabled() \
        and h.requires_grad and caches is None and not return_kv \
        and (mesh is None or specs is not None)
    for i, lp in enumerate(stack):
        sp = None if specs is None else specs[i]
        if remat:
            h, a = checkpoint(_remat_block, h, lp, cfg, E, is_moe, mesh, sp,
                              use_reentrant=False,
                              context_fn=ops.route_contexts)
            nc = None
        else:
            h, a, nc = _block(h, lp, cfg, E, is_moe=is_moe,
                              kv_cache=None if caches is None else caches[i],
                              return_kv=return_kv, mesh=mesh, specs=sp)
        aux = aux + a
        new_caches.append(nc)
    return h, aux, (new_caches if new_caches[0] is not None else None)


def check_decodable(cfg: LMConfig, E) -> None:
    """Raise unless decode is defined at ``E``: not at a sliced depth or
    head count, where the reference's decode fails too (fault F4 in
    ROADMAP.md: its caches keep every layer and kv head)."""
    E = E or {}
    a_layers, a_heads = E.get("a_layers"), E.get("a_heads")
    if (a_layers is not None and int(a_layers) < cfg.n_layers) or \
            (a_heads is not None and int(a_heads) < cfg.n_heads):
        raise NotImplementedError(
            f"decode at a sliced depth or head count ({dict(E)}) is not "
            f"defined: the reference's decode raises there too (fault F4)")


def _embed_vocab_parallel(p: dict, spec, tokens, mesh, dtype):
    """The embedding under the training placement: the rows of the rank's
    block of the vocabulary (its FSDP block gathered first), zeros for the
    ids outside it, summed over ``"model"``."""
    tbl = L.gather_blocks(p, {"embedding": spec}, mesh, dtype)["embedding"]
    if not model_split(spec, mesh):
        return L._cast(tbl[tokens], dtype)
    V_loc = tbl.shape[0]
    local = tokens - ctx.axes_index(mesh, ("model",)) * V_loc
    inside = (local >= 0) & (local < V_loc)
    rows = L._cast(tbl[local.clamp(0, V_loc - 1)], dtype) \
        * inside[..., None].to(dtype)
    return ctx.all_reduce_grad(rows, ctx.axes_group(mesh, ("model",)))


def lm_apply(params: dict, tokens: torch.Tensor, cfg: LMConfig, *, E=None,
             caches=None, return_kv: bool = False, mesh=None, specs=None):
    """tokens (B, S) int -> logits (B, S, V).

    Returns (logits, aux_loss, new_caches).  ``caches`` is a dict
    {"dense": [per-layer cache], "moe": [...]} for decode (see
    :func:`make_decode_caches`; decode updates the cache tensors in
    place); ``return_kv`` makes prefill also emit caches.

    ``E``'s widths are ints (sliced mode) or 0-d int32 CPU tensors
    (masked mode: the module note; ``top_k`` stays an int).  Decode at a
    sliced or masked depth or head count raises
    (:func:`check_decodable`).  ``mesh``: this rank's part of a mesh run
    (the module note); the logits come out whole on every rank.
    ``specs`` (with ``mesh``): the training placement, a tree of specs
    mirroring ``params`` (full width, no caches; the module note):
    ``tokens`` are the rank's rows, the logits its rows by its block of
    the vocabulary, the aux loss the reference's (the mean over shards)
    on every rank.
    """
    if specs is not None and (caches is not None or return_kv or E):
        raise NotImplementedError("the training placement runs the full "
                                  "width without caches")
    E = {k: v if L._masked(v) or v is None else int(v)
         for k, v in (E or {}).items()}
    a_model = E.get("a_model")
    a_layers = E.get("a_layers")
    if caches is not None:
        check_decodable(cfg, E)
    # depth: distribute the active layers over the two stacks; the masked
    # depth gate runs the same layers (the module note)
    dense_stack = params.get("dense_layers")
    moe_stack = params.get("moe_layers")
    if a_layers is not None:
        a_layers = int(a_layers)
        nd = min(cfg.n_dense_layers, a_layers)
        nm = max(0, a_layers - cfg.n_dense_layers)
        if dense_stack is not None:
            dense_stack = dense_stack[:nd]
        if moe_stack is not None:
            moe_stack = moe_stack[:nm]

    sp = specs or {}
    if specs is not None:
        h = _embed_vocab_parallel(params["embed"], sp["embed"]["embedding"],
                                  tokens, mesh, cfg.cdtype())
    else:
        h = L.embedding_apply(params["embed"], tokens, a=a_model,
                              dtype=cfg.cdtype())
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    new_caches = {}
    if dense_stack:
        h, a, nc = _stack(h, dense_stack, cfg, E, is_moe=False,
                          caches=None if caches is None else caches["dense"],
                          return_kv=return_kv, mesh=mesh,
                          specs=sp.get("dense_layers"))
        aux = aux + a
        new_caches["dense"] = nc
    if moe_stack:
        h, a, nc = _stack(h, moe_stack, cfg, E, is_moe=True,
                          caches=None if caches is None else caches["moe"],
                          return_kv=return_kv, mesh=mesh,
                          specs=sp.get("moe_layers"))
        aux = aux + a
        new_caches["moe"] = nc

    h = L.rmsnorm_apply(params["final_norm"], h, a=a_model, eps=cfg.norm_eps)
    if cfg.tie_embeddings:
        if specs is not None:
            raise NotImplementedError("tied embeddings under the training "
                                      "placement (no ported config ties)")
        logits = L.embedding_attend(params["embed"], h, a=a_model)
    elif specs is not None:
        head = L.gather_blocks(params["lm_head"], sp["lm_head"], mesh,
                               cfg.cdtype())
        logits = L.dense_apply(head, h)
    else:
        logits = L.dense_apply(params["lm_head"], h, a_in=a_model)
    weight = cfg.moe.router_aux_weight if cfg.moe else 0.0
    new_caches = {k: v for k, v in new_caches.items() if v is not None}
    return logits, aux * weight, (new_caches or None)


def make_decode_caches(cfg: LMConfig, batch: int, max_len: int, *,
                       dtype=torch.bfloat16, filled: int = 0,
                       device: Optional[torch.device] = None,
                       mesh=None) -> dict:
    """Zeroed KV caches for decode, one dict per layer:
    {"k": (B, max_len, KH, Dh), "v": ..., "len": the fill point as a 0-d
    int32 on the device (the reference's traced scalar), "fill": the same
    as a host int} (:func:`repro_torch.core.layers.kv_cache_of`).  With a
    ``mesh`` and ``cfg.decode_impl == "sharded"``, this rank's block:
    (B_loc, T_loc, KH, Dh) by the reference's rule
    (:func:`repro_torch.distributed.decode_attn.cache_axes`), ``len`` and
    ``fill`` still the global fill."""
    device = resolve_device(device)
    rows, slots = batch, max_len
    if is_sharded(cfg.decode_impl, mesh):
        rows, slots = local_cache_shape(mesh, batch, max_len)

    def one():
        shape = (rows, slots, cfg.n_kv_heads, cfg.d_head)
        return L.kv_cache_of(torch.zeros(shape, dtype=dtype, device=device),
                             torch.zeros(shape, dtype=dtype, device=device),
                             filled)
    out = {}
    if cfg.n_dense_layers:
        out["dense"] = [one() for _ in range(cfg.n_dense_layers)]
    if cfg.n_moe_layers:
        out["moe"] = [one() for _ in range(cfg.n_moe_layers)]
    return out


