"""Elastic layers of the serving path (functional: params dict, apply).

Counterparts of the reference ``core/layers.py`` with the same parameter
layouts (dense kernels ``(d_in, d_out)``, conv kernels HWIO) and the same
order of operations and dtypes.  Widths are ``None`` (full), static
``int`` (sliced mode: the compute shrinks) or 0-d int32 CPU tensors
(masked mode, training: activations keep their full width with exact
zeros past the active count, and norms take their statistics over the
active channels).  The host samples masked widths, so a layer reads them
with ``int()`` at no device sync and hands K1 the cached device copy.

Every matrix product goes through ``kernels.ops``: the dense layers, the
1x1 convs and the patch embed (an unfold followed by a dense product)
through the elastic matmul, the attention core through flash attention.
The products read the FULL resident weights at their active widths; the
other convs (k x k, depthwise, grouped) go to ``F.conv2d`` as the
reference leaves them to XLA; bias adds, norms, pooling, rotary
embeddings and activations stay plain torch ops.

Under the training placement of a mesh (``distributed.sharding.
train_spec_fn``) a layer first gathers its FSDP blocks
(:func:`gather_blocks`), and the dense FFN and attention run tensor
parallel where their kernels are split over ``"model"`` (``tp=mesh``):
q/k/v and wi/wg on the rank's column block (its heads, its hidden
units), o and wo on the matching row block, whose partial products one
all-reduce sums (``ctx.all_reduce_grad``; a replicated bias is added
after it).  The vision family's placement (``sharding.
vision_train_spec_fn``) adds convs split on their output channels
(``conv_apply(..., tp=mesh)``: the rank's channels, then gathered over
``"model"``), a row-split classifier (:func:`_row_parallel` on the
rank's block of its input, :func:`model_cols`) and batch norm whose
statistics are summed over the batch axes (``sbn_apply(..., mesh=)``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.elastic import active_mask, mask_dim, take_dim
from repro_torch.core.types import is_static
from repro_torch.distributed import ctx
from repro_torch.distributed.decode_attn import (cache_axes, is_sharded,
                                                 sharded_decode_attention)
from repro_torch.distributed.sharding import fsdp_entry, model_split
from repro_torch.kernels.ops import elastic_matmul_op, flash_attention_op


def _cast(p: torch.Tensor, dtype) -> torch.Tensor:
    return p.to(dtype) if p.dtype != dtype else p


def cast_params(params, dtype: torch.dtype):
    """Every floating tensor of a param tree in ``dtype``, except the MoE
    routers, which stay fp32 as the reference initialises and applies them.

    The models cast each weight to the compute dtype where it is used, so
    resident weights kept in the compute dtype give the same numbers
    without a copy per call.
    """
    if isinstance(params, dict):
        return {k: v if k == "router" else cast_params(v, dtype)
                for k, v in params.items()}
    if isinstance(params, list):
        return [cast_params(v, dtype) for v in params]
    return params.to(dtype) if params.is_floating_point() else params


def _masked(a) -> bool:
    return a is not None and not is_static(a)


def _static(a, name: str):
    if _masked(a):
        raise NotImplementedError(
            f"{name}: no masked (tensor-width) mode; the port's training "
            f"path does not use this layer")
    return None if a is None else int(a)


def _normal(gen: torch.Generator, shape, scale: float, dtype, device):
    """N(0, scale^2) drawn in fp32 on the generator's device, then placed
    on ``device`` in ``dtype`` (a CPU generator gives the same weights on
    every device; a CUDA generator draws a large model on the card)."""
    t = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device).mul_(scale)
    return t.to(dtype=dtype, device=device)


def gather_blocks(tree, specs, mesh, dtype):
    """A layer's weights as its rank computes with them under the training
    placement: each leaf whose spec splits it over batch axes alone (its
    FSDP dim) cast to ``dtype`` and all-gathered along that dim (half the
    bytes of the fp32 block in bf16; the backward reduce-scatters the
    gradient in fp32), every other leaf as it is (``specs`` mirrors
    ``tree``).  Run inside the layer, so that remat's recompute gathers
    again rather than keep the whole weights alive."""
    if isinstance(tree, dict):
        return {k: gather_blocks(v, specs[k], mesh, dtype)
                for k, v in tree.items()}
    ent = fsdp_entry(specs, mesh)
    if ent is None:
        return tree
    return ctx.all_gather_grad(tree, mesh, ent[1], ent[0], dtype)


def _row_parallel(p: dict, x: torch.Tensor, mesh, **kw) -> torch.Tensor:
    """The dense product of a row-split kernel (this rank's rows of the
    input dim, ``x`` its matching columns): the partial products summed
    over ``"model"``, then the (replicated) bias."""
    y = dense_apply({"kernel": p["kernel"]}, x, **kw)
    y = ctx.all_reduce_grad(y, ctx.axes_group(mesh, ("model",)))
    if p.get("bias") is not None:
        y = y + _cast(p["bias"], y.dtype)
    return y


def model_cols(x: torch.Tensor, k: int, mesh) -> torch.Tensor:
    """This rank's block of ``k`` columns of ``x``, whose last dim is
    split in blocks over ``"model"``."""
    m = ctx.axes_index(mesh, ("model",))
    return x[..., m * k:(m + 1) * k]


def model_tp(specs, mesh):
    """``mesh`` when a leaf's ``kernel`` spec in ``specs`` (a layer's
    specs, or None) splits it over ``"model"``, else None."""
    if specs is None or not model_split(specs["kernel"], mesh):
        return None
    return mesh


def tp_mesh(specs: dict, first: str, last: str, mesh):
    """``mesh`` when a block's kernels are split over ``"model"`` (the
    column kernel ``first`` and the row kernel ``last`` together), else
    None; a block split on one side only raises."""
    if specs is None:
        return None
    col = model_split(specs[first]["kernel"], mesh)
    if col != model_split(specs[last]["kernel"], mesh):
        raise ValueError(f"{first} and {last} must be split over 'model' "
                         f"together: {specs[first]} / {specs[last]}")
    return mesh if col else None


# ---------------------------------------------------------------------------
# Dense
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = True, dtype=torch.float32, device=None,
               scale: Optional[float] = None) -> dict:
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    p = {"kernel": _normal(gen, (d_in, d_out), scale, dtype, device)}
    if bias:
        p["bias"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense_apply(p: dict, x: torch.Tensor, *, a_in=None,
                a_out=None) -> torch.Tensor:
    """x: (..., a_in) in sliced mode, (..., d_in) zero past ``a_in`` in
    masked mode.  Elastic in/out channels.

    The product reads the active block of the full resident kernel.
    Sliced mode computes and writes only the active output columns;
    masked mode (a tensor ``a_out``) keeps the full width with exact zeros
    past ``a_out``, which is K1's own function, and adds the bias on the
    active columns only.
    """
    w, b = p["kernel"], p.get("bias")
    k_act = w.shape[0] if a_in is None else int(a_in)
    n_act = w.shape[1] if a_out is None else int(a_out)
    n_out = w.shape[1] if _masked(a_out) else n_act
    if not (x.shape[-1] >= k_act if _masked(a_in)
            else x.shape[-1] == k_act):
        raise ValueError(f"dense_apply: x width {x.shape[-1]} does not fit "
                         f"active input width {k_act} of {w.shape[0]}")
    y = elastic_matmul_op(x, _cast(w, x.dtype), k_act, n_act, n_out=n_out)
    if b is not None:
        bias = _cast(take_dim(b, n_act, 0), x.dtype)
        if n_out > n_act:
            bias = F.pad(bias, (0, n_out - n_act))
        y = y + bias
    return y


# ---------------------------------------------------------------------------
# Normalisation
# ---------------------------------------------------------------------------

def layernorm_init(d: int, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm_apply(p: dict, x: torch.Tensor, *, a=None,
                    eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last dim with the reference's eps of 1e-6; in
    masked mode the statistics are over the first ``a`` channels and the
    output is zero past them."""
    scale, bias = p["scale"], p["bias"]
    if _masked(a):
        n = int(a)
        m = active_mask(n, x.shape[-1], x.dtype, x.device)
        mean = torch.sum(x * m, -1, keepdim=True) / n
        var = torch.sum(torch.square((x - mean) * m), -1, keepdim=True) / n
        y = (x - mean) * torch.rsqrt(var + eps)
        return (y * _cast(scale, x.dtype) + _cast(bias, x.dtype)) * m
    if a is not None:
        # sliced mode: caller already sliced x to (..., a)
        scale, bias = take_dim(scale, a, 0), take_dim(bias, a, 0)
    mean = torch.mean(x, -1, keepdim=True)
    var = torch.mean(torch.square(x - mean), -1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * _cast(scale, x.dtype) + _cast(bias, x.dtype)


def rmsnorm_init(d: int, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_apply(p: dict, x: torch.Tensor, *, a=None,
                  eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim (sliced mode: x is already (..., a);
    masked mode: statistics over the first ``a`` channels, zeros past)."""
    scale = p["scale"]
    if _masked(a):
        n = int(a)
        m = active_mask(n, x.shape[-1], x.dtype, x.device)
        ms = torch.sum(torch.square(x * m), -1, keepdim=True) / n
        return x * torch.rsqrt(ms + eps) * _cast(scale, x.dtype) * m
    if a is not None:
        scale = take_dim(scale, a, 0)
    ms = torch.mean(torch.square(x), -1, keepdim=True)
    return x * torch.rsqrt(ms + eps) * _cast(scale, x.dtype)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def embedding_init(gen: torch.Generator, vocab: int, d: int,
                   dtype=torch.float32, device=None) -> dict:
    return {"embedding": _normal(gen, (vocab, d), 0.02, dtype, device)}


def embedding_apply(p: dict, ids: torch.Tensor, *, a=None,
                    dtype=torch.bfloat16) -> torch.Tensor:
    """Rows of the (vocab, d) table at ``ids``, first ``a`` columns (sliced
    mode) or all columns with zeros past ``a`` (masked mode), in
    ``dtype``.  The reference casts the whole table and then gathers; the
    port gathers and then casts the rows (the same values, no table copy)."""
    tbl = p["embedding"]
    if _masked(a):
        return mask_dim(_cast(tbl[ids], dtype), a, -1)
    if a is not None:
        tbl = take_dim(tbl, int(a), 1)
    return _cast(tbl[ids], dtype)


def embedding_attend(p: dict, x: torch.Tensor, *, a=None) -> torch.Tensor:
    """Tied-embedding logits: x (..., d) @ embedding.T -> (..., vocab);
    x is (..., a) in sliced mode, (..., d) zero past ``a`` in masked mode
    (the full table then, as the reference).

    The transposed table has no unit inner stride, which the elastic
    matmul needs, so this product is a plain ``torch.matmul``.  No ported
    config ties its embeddings (every LM has an ``lm_head``)."""
    tbl = p["embedding"]
    if a is not None and not _masked(a):
        tbl = take_dim(tbl, int(a), 1)
    return x @ _cast(tbl, x.dtype).T


# ---------------------------------------------------------------------------
# MLP blocks (dense FFN)
# ---------------------------------------------------------------------------

_ACTS = {
    "silu": F.silu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda h: F.gelu(h, approximate="tanh"),
    "relu": F.relu,
}


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, *,
             gated: bool = True, bias: bool = False, dtype=torch.float32,
             device=None) -> dict:
    p = {"wi": dense_init(gen, d_model, d_ff, bias=bias, dtype=dtype,
                          device=device),
         "wo": dense_init(gen, d_ff, d_model, bias=bias, dtype=dtype,
                          device=device)}
    if gated:
        p["wg"] = dense_init(gen, d_model, d_ff, bias=bias, dtype=dtype,
                             device=device)
    return p


def mlp_apply(p: dict, x: torch.Tensor, *, a_model=None, a_ff=None,
              act: str = "silu", tp=None) -> torch.Tensor:
    """Gated (SwiGLU) or plain FFN with elastic hidden and model dims.
    ``tp`` (a mesh): wi/wg are this rank's column blocks and wo its row
    block (the module note), at full width."""
    if tp is not None:
        if a_model is not None or a_ff is not None:
            raise NotImplementedError("tensor-parallel FFN at full width "
                                      "only")
        h = dense_apply(p["wi"], x)
        if "wg" in p:
            h = _ACTS[act](dense_apply(p["wg"], x)) * h
        else:
            h = _ACTS[act](h)
        return _row_parallel(p["wo"], h, tp)
    h = dense_apply(p["wi"], x, a_in=a_model, a_out=a_ff)
    fn = _ACTS[act]
    if "wg" in p:
        g = dense_apply(p["wg"], x, a_in=a_model, a_out=a_ff)
        h = fn(g) * h
    else:
        h = fn(h)
    if _masked(a_ff):
        h = mask_dim(h, a_ff, -1)   # act(0) = 0 for relu/silu, not gelu-tanh
    return dense_apply(p["wo"], h, a_in=a_ff, a_out=a_model)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, ..., D) with D even; positions: (B, S) or (S,).

    Half-split rotation (not interleaved) with fp32 angles; the result is
    cast back to x's dtype, as the reference does."""
    d = x.shape[-1]
    half = d // 2
    freq = torch.exp(-math.log(theta)
                     * torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(torch.float32) * freq     # (B, S, half)
    extra = x.ndim - 3
    ang = ang.reshape(ang.shape[:2] + (1,) * extra + (half,))
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :half], x[..., half:]
    y = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (MHA/GQA, elastic query heads)
# ---------------------------------------------------------------------------
#
# Query heads are laid out as (R groups, K kv-heads): flat head h = r*K + k,
# as in the reference.  Slicing the first ``a_heads`` heads then keeps every
# kv head with an equal number of groups.

def attention_init(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv: int, d_head: int, *, qkv_bias: bool = False,
                   dtype=torch.float32, device=None) -> dict:
    kw = dict(bias=qkv_bias, dtype=dtype, device=device)
    return {
        "q": dense_init(gen, d_model, n_heads * d_head, **kw),
        "k": dense_init(gen, d_model, n_kv * d_head, **kw),
        "v": dense_init(gen, d_model, n_kv * d_head, **kw),
        "o": dense_init(gen, n_heads * d_head, d_model, **kw),
    }


def kv_cache_of(k: torch.Tensor, v: torch.Tensor, fill: int) -> dict:
    """A decode cache over k and v (B, T, KH, D) holding ``fill``
    positions: ``len`` a 0-d int32 on their device (made by a kernel, so
    legal inside a graph capture), ``fill`` its host mirror."""
    return {"k": k, "v": v, "fill": int(fill),
            "len": torch.full((), int(fill), dtype=torch.int32,
                              device=k.device)}


def _group(q: torch.Tensor, R: int, KH: int) -> torch.Tensor:
    """q (B, S, H, D) in the reference's (R, K) head layout -> K2's, query
    heads grouped by kv head (h // R); a view at R = 1."""
    if R == 1:
        return q
    B, S, H, D = q.shape
    return q.reshape(B, S, R, KH, D).transpose(2, 3).reshape(B, S, H, D)


def _ungroup(o: torch.Tensor, R: int, KH: int) -> torch.Tensor:
    """The inverse of :func:`_group`."""
    if R == 1:
        return o
    B, S, H, D = o.shape
    return o.reshape(B, S, KH, R, D).transpose(2, 3).reshape(B, S, H, D)


def attention_apply(p: dict, x: torch.Tensor, *, n_heads: int, n_kv: int,
                    d_head: int, causal: bool = True,
                    rope_theta: Optional[float] = None,
                    a_model=None, a_heads=None,
                    kv_cache: Optional[dict] = None,
                    return_kv: bool = False, decode_impl: str = "xla",
                    mesh=None, tp=None) -> tuple:
    """Returns (out (B, S, d_model_active), new_kv_cache | None).

    The reference's prefill (``impl="ref"``; its blocked XLA variants
    compute the same function) and KV-cache decode, with static head
    slicing.  ``rope_theta=None`` (the ViT) applies no rotary embedding.

    kv_cache: {"k": (B, T, KH, D), "v": (B, T, KH, D), "len": 0-d int32 on
    the cache's device, "fill": the same count as a host int} (see
    :func:`kv_cache_of`).  ``len`` is the reference's traced scalar: rope
    positions are ``len + arange(S)`` on the device, this step's k and v
    are written at those positions IN PLACE (the reference returns updated
    copies; the port saves the memory), ``len`` advances by S in place, and
    attention runs, non-causally as the reference does, over the WHOLE
    cache with the keys at or past ``len`` masked; so a CUDA graph of a
    decode step advances its own cache and serves every step.  ``fill``
    mirrors ``len`` on the host: the overflow check reads it, before any
    write and with no device-to-host read, and advances it by S (code
    that replays a graph advances it per replay).  The returned cache is
    the same dict.
    ``return_kv`` returns this call's (roped) k and v as a new cache.
    ``decode_impl="sharded"`` with a ``mesh`` that has a ``"model"`` axis
    decodes against a sequence-sharded cache (this rank's block: see
    :func:`repro_torch.distributed.decode_attn.sharded_decode_attention`),
    the sequence over ``"model"`` at B >= 16 and over every axis below,
    as the reference's rule; otherwise the one-process decode.
    ``tp`` (a mesh): q/k/v are this rank's column blocks, its share of the
    heads, and o the matching row block (the module note); full width,
    no cache.  MHA: the rank's q heads are its kv heads.  GQA and MQA: the
    rank's contiguous block of the (R, K) query heads is R / n groups
    against EVERY kv head, while its k and v columns hold K / n kv heads
    (MQA's one head: a share of its columns), so the k and v projections'
    outputs are gathered over ``"model"`` (:func:`ctx.all_gather_grad`,
    whose adjoint reduce-scatters their gradient) and attention runs R / n
    groups against all K kv heads; R must divide by the ``"model"`` ranks.
    """
    B, S, _ = x.shape
    H = n_heads
    gather_kv = False
    if tp is not None:
        n = ctx.axes_size(tp, ("model",))
        if (a_model, a_heads, kv_cache) != (None, None, None) or return_kv \
                or n_heads % n or (n_kv != n_heads
                                   and (n_heads // n_kv) % n):
            raise NotImplementedError(
                f"tensor-parallel attention: full width without a cache, "
                f"whole heads a rank, the query groups per kv head "
                f"dividing the model axis ({n_heads} / {n_kv} heads over "
                f"{n}; ROADMAP §3)")
        if n_kv == n_heads:
            n_kv = n_heads // n
        else:         # k's columns split over "model" (not where too few)
            gather_kv = p["k"]["kernel"].shape[-1] != n_kv * d_head
        H = n_heads = n_heads // n
    mha = n_kv == n_heads
    # MHA: kv heads shrink together with query heads.  GQA/MQA: kv heads stay
    # (they are cheap); query groups per kv head shrink.
    masked_heads = _masked(a_heads)
    sliced_heads = None if masked_heads else _static(a_heads,
                                                     "attention_apply")
    kv_active = n_kv
    if sliced_heads is not None:
        H = sliced_heads
        if mha:
            kv_active = sliced_heads
        elif sliced_heads % n_kv:
            raise ValueError("active heads must keep GQA groups even")
    R = H // kv_active
    # masked heads: every head runs at full width; the inactive heads'
    # q (and MHA's k, v) columns are exact zeros from K1 and their outputs
    # are gated to zero below, as the reference's head mask does
    a_q = a_heads * d_head if masked_heads else (
        None if sliced_heads is None else sliced_heads * d_head)

    q = dense_apply(p["q"], x, a_in=a_model, a_out=a_q)
    a_kv = a_q if mha else None
    k = dense_apply(p["k"], x, a_in=a_model, a_out=a_kv)
    v = dense_apply(p["v"], x, a_in=a_model, a_out=a_kv)
    if gather_kv:
        k = ctx.all_gather_grad(k, tp, ("model",), k.ndim - 1)
        v = ctx.all_gather_grad(v, tp, ("model",), v.ndim - 1)
    q = q.reshape(B, S, H, d_head)
    k = k.reshape(B, S, kv_active, d_head)
    v = v.reshape(B, S, kv_active, d_head)

    kv_len = None
    sharded = kv_cache is not None and is_sharded(decode_impl, mesh)
    if kv_cache is not None:
        ck, cv, fill = kv_cache["k"], kv_cache["v"], kv_cache["fill"]
        if ck.shape[2] != kv_active or (not sharded
                                        and fill + S > ck.shape[1]):
            raise ValueError(
                f"kv cache {tuple(ck.shape)} at len {fill} cannot take {S} "
                f"more positions of {kv_active} kv heads")
        if sharded and S != 1:
            raise ValueError(f"the sharded decode takes one token a step, "
                             f"got {S}")
        positions = kv_cache["len"] + torch.arange(S, device=x.device)
    if rope_theta is not None:
        if kv_cache is None:
            positions = torch.arange(S, device=x.device)
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)

    new_cache = None
    if return_kv:
        new_cache = kv_cache_of(k, v, S)
    if sharded:
        seq_axes, b_axes = cache_axes(mesh, B)
        out = _ungroup(sharded_decode_attention(
            _group(q, R, kv_active), k, v, kv_cache, mesh=mesh,
            seq_axes=seq_axes, batch_axes=b_axes), R, kv_active)
        new_cache = kv_cache
    else:
        if kv_cache is not None:
            ck.index_copy_(1, positions, k.to(ck.dtype))
            cv.index_copy_(1, positions, v.to(cv.dtype))
            kv_len = kv_cache["len"]
            kv_len.add_(S)
            kv_cache["fill"] = fill + S
            new_cache = kv_cache
            k, v = _cast(ck, q.dtype), _cast(cv, q.dtype)
            causal = False
        out = _ungroup(flash_attention_op(_group(q, R, kv_active), k, v,
                                          causal=causal, kv_len=kv_len),
                       R, kv_active)
    out = out.reshape(B, S, H * d_head)
    if masked_heads:    # flat head r*K + k is active iff it is < a_heads
        out = mask_dim(out, a_q, -1)
    if tp is not None:
        return _row_parallel(p["o"], out, tp), None
    y = dense_apply(p["o"], out, a_in=a_q, a_out=a_model)
    return y, new_cache


# ---------------------------------------------------------------------------
# Convolutions (NHWC, HWIO kernels) and switchable batch norm
# ---------------------------------------------------------------------------
#
# Routes: the patch embed (stride == kernel size, no padding) is an unfold
# and one elastic matmul; a 1x1 conv is one elastic matmul over the
# (B*H*W, C_in) rows, after x[:, ::s, ::s] at stride s (what SAME gives a
# 1x1 kernel); k x k, depthwise and grouped convs go to
# ``F.conv2d`` (cuDNN on the card) on the NHWC tensor viewed as a
# channels-last NCHW one, as the reference leaves them to XLA's conv
# outside any Pallas kernel.

def conv_init(gen: torch.Generator, ksize: int, c_in: int, c_out: int, *,
              groups: int = 1, bias: bool = False, dtype=torch.float32,
              device=None) -> dict:
    fan_in = ksize * ksize * c_in // groups
    p = {"kernel": _normal(gen, (ksize, ksize, c_in // groups, c_out),
                           1.0 / math.sqrt(fan_in), dtype, device)}
    if bias:
        p["bias"] = torch.zeros((c_out,), dtype=dtype, device=device)
    return p


def same_pads(size: int, k: int, stride: int) -> tuple:
    """(low, high) padding of one spatial dim under JAX's ``SAME``:
    ``total = max((ceil(size / stride) - 1) * stride + k - size, 0)``,
    ``low = total // 2``.  Asymmetric where total is odd (the ResNet stem,
    7x7/2 on 224, pads 2 before and 3 after), which PyTorch's symmetric
    ``padding=`` cannot express."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, kh: int, kw: int, stride: int,
          padding: str) -> tuple:
    if padding == "VALID":
        return (0, 0), (0, 0)
    if padding != "SAME":
        raise ValueError(f"padding {padding!r} is not SAME or VALID")
    return (same_pads(x.shape[1], kh, stride),
            same_pads(x.shape[2], kw, stride))


def _pad_high(x: torch.Tensor, ph: tuple, pw: tuple,
              value: float = 0.0) -> torch.Tensor:
    """Pad NHWC ``x`` by the part of the SAME pads past their symmetric
    low part (the op pads ``low`` on both sides itself)."""
    eh, ew = ph[1] - ph[0], pw[1] - pw[0]
    if eh or ew:
        x = F.pad(x, (0, 0, 0, ew, 0, eh), value=value)
    return x


def _exact_fp32(x: torch.Tensor):
    """cuDNN without TF32 for an fp32 conv on the card (the reference's
    fp32 conv is fp32), inside the block only: :class:`Conv2dFp32` runs
    both its forward and its backward in it."""
    if x.dtype != torch.float32 or x.device.type != "cuda":
        return contextlib.nullcontext()
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


class Conv2dFp32(torch.autograd.Function):
    """``F.conv2d`` of fp32 tensors whose forward, dgrad and wgrad all run
    under :func:`_exact_fp32`: autograd runs a backward after the forward
    has left any ``with`` block, under the process's flags (cuDNN's TF32
    on by default), so the backward sets them again itself."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, groups):
        ctx.save_for_backward(x, w)
        ctx.args = (stride, padding, groups)
        with _exact_fp32(x):
            return F.conv2d(x, w, stride=stride, padding=padding,
                            groups=groups)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        stride, padding, groups = ctx.args
        with _exact_fp32(x):
            dx, dw, _ = torch.ops.aten.convolution_backward(
                dy, x, w, None, (stride, stride), padding, (1, 1), False,
                (0, 0), groups, (ctx.needs_input_grad[0],
                                 ctx.needs_input_grad[1], False))
        return dx, dw, None, None, None


def conv_apply(p: dict, x: torch.Tensor, *, stride: int = 1,
               groups: int = 1, a_in=None, a_out=None,
               a_kernel: Optional[int] = None,
               padding: str = "SAME", tp=None) -> torch.Tensor:
    """NHWC conv with elastic channels and (static) elastic kernel size.

    The reference's function: the kernel centre-cropped to ``a_kernel``
    (OFA), its input channels sliced to ``a_in`` (auto-sliced to x's width
    when x was narrowed upstream) and its output channels to ``a_out``;
    a depthwise conv (``groups > 1``) slices the output channels and
    takes ``a_out`` as its group count, so a depthwise kernel wider than
    x (the reference's F5) convolves 2 output channels per group.
    Widths are static (sliced mode); the conv nets train at static widths.

    ``tp`` (a mesh): the kernel is this rank's block of the output
    channels (the training placement), at full width: the rank computes
    its channels from the whole x (a depthwise conv from x's matching
    channel block), and the output is gathered over ``"model"``
    (``ctx.all_gather_grad``, whose backward reduce-scatters); a bias
    the whole width long is added after the gather.
    """
    if tp is not None:
        return _conv_tp(p, x, tp, stride=stride, groups=groups, a_in=a_in,
                        a_out=a_out, a_kernel=a_kernel, padding=padding)
    w, b = p["kernel"], p.get("bias")
    a_in, a_out = _static(a_in, "conv_apply"), _static(a_out, "conv_apply")
    kh = w.shape[0]
    if a_kernel is not None and a_kernel < kh:
        off = (kh - a_kernel) // 2
        w = w[off:off + a_kernel, off:off + a_kernel]
    depthwise = groups > 1
    if not depthwise and a_in is None and x.shape[-1] < w.shape[2]:
        a_in = x.shape[-1]   # auto-slice: input already narrowed upstream
    if a_in is not None and not depthwise:
        w = take_dim(w, a_in, 2)
    if a_out is not None:
        w = take_dim(w, a_out, 3)
        if b is not None:
            b = take_dim(b, a_out, 0)
        if depthwise:
            groups = a_out
    kh, kw, c_in, c_out = w.shape
    if x.shape[-1] != c_in * groups:
        raise ValueError(f"conv_apply: x width {x.shape[-1]} does not fit "
                         f"kernel {tuple(w.shape)} in {groups} groups")
    ph, pw = _pads(x, kh, kw, stride, padding)
    if groups == 1 and kh == kw == 1:
        y = _conv1x1(w, x, stride)
    elif groups == 1 and kh == kw == stride and ph == pw == (0, 0):
        y = _patch_embed(w, x)
    else:
        xt = _pad_high(x, ph, pw).permute(0, 3, 1, 2)   # NCHW view
        wt = _cast(w, x.dtype).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        if x.dtype == torch.float32:    # forward and backward exact
            y = Conv2dFp32.apply(xt, wt, stride, (ph[0], pw[0]), groups)
        else:
            y = F.conv2d(xt, wt, stride=stride, padding=(ph[0], pw[0]),
                         groups=groups)
        y = y.permute(0, 2, 3, 1)
    if b is not None:
        y = y + _cast(b, x.dtype)
    return y


def _conv_tp(p: dict, x: torch.Tensor, mesh, *, stride, groups, a_in,
             a_out, a_kernel, padding) -> torch.Tensor:
    """:func:`conv_apply` of a kernel split on its output channels over
    ``"model"`` (its module note)."""
    w, b = p["kernel"], p.get("bias")
    n = ctx.axes_size(mesh, ("model",))
    c_blk = w.shape[3]
    depthwise = groups > 1
    whole_in = x.shape[-1] if depthwise else w.shape[2]
    if a_kernel is not None and a_kernel < w.shape[0] \
            or _static(a_out, "conv_apply") not in (None, c_blk * n) \
            or _static(a_in, "conv_apply") not in (None, whole_in) \
            or depthwise and groups != c_blk * n:
        raise NotImplementedError(
            f"a conv split over 'model' runs at full width (kernel block "
            f"{tuple(w.shape)} of {n}, groups {groups}, a_in {a_in}, a_out "
            f"{a_out}, a_kernel {a_kernel})")
    if depthwise:
        x, groups = model_cols(x, c_blk, mesh), c_blk
    whole_bias = b is not None and b.shape[0] != c_blk
    y = conv_apply({"kernel": w} if whole_bias else p, x, stride=stride,
                   groups=groups, padding=padding)
    y = ctx.all_gather_grad(y, mesh, ("model",), y.ndim - 1)
    if whole_bias:
        y = y + _cast(b, y.dtype)
    return y


def _conv1x1(w: torch.Tensor, x: torch.Tensor, stride: int) -> torch.Tensor:
    """A 1x1 conv as K1 over the (B*H*W, C_in) rows: the (C_in, C_out)
    product of the (possibly sliced) view of the full resident kernel."""
    if stride > 1:
        x = x[:, ::stride, ::stride]
    wk = w[0, 0]
    y = elastic_matmul_op(x.reshape(-1, x.shape[-1]), _cast(wk, x.dtype),
                          wk.shape[0], wk.shape[1], n_out=wk.shape[1])
    return y.reshape(*x.shape[:3], wk.shape[1])


def _patch_embed(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The ViT patch embed (stride == kernel size, no padding) as a
    non-overlapping unfold into (B*N, P*P*C) in HWIO order and one elastic
    matmul, which keeps cuDNN (and its TF32 default) out of the path."""
    P, _, C, O = w.shape
    B, Hh, Ww, _ = x.shape
    gh, gw = Hh // P, Ww // P
    x = x[:, :gh * P, :gw * P]
    patches = (x.reshape(B, gh, P, gw, P, C).permute(0, 1, 3, 2, 4, 5)
               .reshape(B * gh * gw, P * P * C))
    wk = _cast(w, x.dtype).reshape(P * P * C, O)
    y = elastic_matmul_op(patches, wk, P * P * C, O, n_out=O)
    return y.reshape(B, gh, gw, O)


def max_pool_apply(x: torch.Tensor, *, window: int = 3,
                   stride: int = 2) -> torch.Tensor:
    """NHWC max over ``window`` x ``window`` at ``stride`` with JAX's SAME
    pads filled with -inf: the reference's ``reduce_window(x, -inf, max,
    (1, k, k, 1), (1, s, s, 1), "SAME")`` (the ResNet stem's pool)."""
    ph, pw = _pads(x, window, window, stride, "SAME")
    xt = _pad_high(x, ph, pw, value=-math.inf).permute(0, 3, 1, 2)
    y = F.max_pool2d(xt, window, stride, padding=(ph[0], pw[0]))
    return y.permute(0, 2, 3, 1)


def groupnorm_init(c: int, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((c,), dtype=dtype, device=device),
            "bias": torch.zeros((c,), dtype=dtype, device=device)}


def groupnorm_apply(p: dict, x: torch.Tensor, *, groups: int = 32,
                    eps: float = 1e-5) -> torch.Tensor:
    """x: (..., C) normalised per group over (spatial..., C/groups)."""
    c = x.shape[-1]
    g = min(groups, c)
    while c % g:
        g -= 1
    xg = x.reshape(x.shape[0], -1, g, c // g)
    mean = torch.mean(xg, (1, 3), keepdim=True)
    var = torch.mean(torch.square(xg - mean), (1, 3), keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return y * _cast(p["scale"], x.dtype) + _cast(p["bias"], x.dtype)


def sbn_init(c: int, n_settings: int = 1, dtype=torch.float32,
             device=None) -> dict:
    """Switchable BatchNorm: independent affine+stats per width setting."""
    kw = dict(dtype=dtype, device=device)
    return {"scale": torch.ones((n_settings, c), **kw),
            "bias": torch.zeros((n_settings, c), **kw),
            "mean": torch.zeros((n_settings, c), **kw),
            "var": torch.ones((n_settings, c), **kw)}


def sbn_apply(p: dict, x: torch.Tensor, *, setting: int = 0,
              train: bool = False, a=None, eps: float = 1e-5, mesh=None):
    """Returns (y, new_stats | None).  ``setting`` indexes the width
    option.  In train mode the statistics are the batch's (``var =
    mean(x^2) - mean^2``, in x's dtype as the reference computes them) and
    are returned, never written into the running ones.

    ``mesh`` (train mode): x holds this rank's rows of a batch split over
    the mesh's batch axes, and the statistics are the whole batch's, as
    GSPMD computes the reference's mean over its split batch: the sums of
    x and x^2 (accumulated in fp32 at least) summed over the batch axes
    by the differentiable all-reduce (``ctx``'s convention: its adjoint
    is an all-reduce), over the whole batch's count."""
    a = _static(a, "sbn_apply")
    scale, bias = p["scale"][setting], p["bias"][setting]
    if a is not None:
        scale, bias = take_dim(scale, a, 0), take_dim(bias, a, 0)
    b_axes = () if mesh is None else tuple(
        ax for ax in mesh.mesh_dim_names
        if ax != "model" and ctx.axes_size(mesh, (ax,)) > 1)
    if train and b_axes:
        axes = tuple(range(x.ndim - 1))
        acc = torch.promote_types(x.dtype, torch.float32)
        sums = torch.stack([torch.sum(x, axes, dtype=acc),
                            torch.sum(torch.square(x), axes, dtype=acc)])
        for ax in b_axes:
            sums = ctx.all_reduce_grad(sums, ctx.axes_group(mesh, (ax,)))
        count = math.prod(x.shape[:-1]) * ctx.axes_size(mesh, b_axes)
        mean, msq = (sums / count).to(x.dtype).unbind(0)
        var = msq - torch.square(mean)
        new_stats = (mean, var)
    elif train:
        axes = tuple(range(x.ndim - 1))
        mean = torch.mean(x, axes)
        var = torch.mean(torch.square(x), axes) - torch.square(mean)
        new_stats = (mean, var)
    else:
        mean, var = p["mean"][setting], p["var"][setting]
        if a is not None:
            mean, var = take_dim(mean, a, 0), take_dim(var, a, 0)
        new_stats = None
    y = (x - _cast(mean, x.dtype)) * torch.rsqrt(_cast(var, x.dtype) + eps)
    y = y * _cast(scale, x.dtype) + _cast(bias, x.dtype)
    return y, new_stats
