"""Decode attention over a sequence-sharded KV cache: the two-pass softmax.

Counterpart of the reference's ``distributed/decode_attn.py``.  Each rank
keeps ``T_loc`` slots of the cache, slots ``shard * T_loc ..`` of the
whole, ``shard`` its flat index over ``seq_axes`` (row-major, as the
reference's): rank r of a mesh sharded over all its axes holds what the
reference's shard r holds.  One decode step:

* the write stays local: only the shard that holds position ``len``
  writes the new key and value there (the others rewrite a slot with its
  own contents); no host read, so a graph could capture the step;
* each rank runs K2's ``decode`` kernel over its slots with its local
  fill ``clamp(len + 1 - shard * T_loc, 0, T_loc)``, a device int32, and
  the kernel's logsumexp output: o = 0 and lse = -inf on a shard that
  holds no valid key yet;
* three collectives over ``seq_axes`` merge the shards, as the
  reference's ``pmax`` / ``psum`` / ``psum``: the max M of the lse, then
  the sums of ``exp(lse - M) * o`` and of ``exp(lse - M)``.

Collective bytes are O(B·H·D) a step where gathering the cache would move
O(B·T·KH·D).  With ``batch_axes`` (the reference's rule at B >= 16: the
sequence over ``"model"`` alone, the batch over the other axes) each rank
holds the cache of its batch block and the outputs are gathered over
those axes, since the port's activations are replicated (ROADMAP §3).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.distributed import ctx
from repro_torch.kernels.ops import flash_attention_op

# batch size from which the sequence is sharded over "model" alone and
# the batch over the other axes (the reference's production data width)
BATCH_SHARD_MIN = 16


def is_sharded(decode_impl: str, mesh) -> bool:
    """Whether decode runs against a sequence-sharded cache: ``decode_impl``
    ``"sharded"`` under a mesh with a ``"model"`` axis.  The one rule that
    the attention, the cache's allocation and the prefill's fill share."""
    return decode_impl == "sharded" and mesh is not None \
        and "model" in mesh.mesh_dim_names


def cache_axes(mesh, batch: int) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(seq_axes, batch_axes) of a decode cache of ``batch`` rows, the
    reference's rule (``core/layers.py`` and ``launch/steps.py:_lm_cell``):
    at B >= 16 the sequence over ``"model"`` and the batch over the other
    axes; below, the sequence over every axis and the batch replicated."""
    names = tuple(mesh.mesh_dim_names)
    if batch >= BATCH_SHARD_MIN:
        return ("model",), tuple(a for a in ("pod", "data") if a in names)
    return tuple(a for a in ("pod", "data", "model") if a in names), ()


def local_cache_shape(mesh, batch: int, max_len: int) -> Tuple[int, int]:
    """(rows, slots) of this rank's block of a (batch, max_len) cache."""
    seq, bat = cache_axes(mesh, batch)
    n_seq, n_bat = ctx.axes_size(mesh, seq), ctx.axes_size(mesh, bat)
    if max_len % n_seq or batch % n_bat:
        raise ValueError(f"a ({batch}, {max_len}) cache does not split over "
                         f"{n_bat} batch and {n_seq} sequence shards")
    return batch // n_bat, max_len // n_seq


def batch_block(mesh, batch: int) -> slice:
    """The rows of a ``batch``-row tensor this rank's cache holds."""
    _, bat = cache_axes(mesh, batch)
    n = ctx.axes_size(mesh, bat)
    i = ctx.axes_index(mesh, bat)
    return slice(i * batch // n, (i + 1) * batch // n)


def seq_start(mesh, batch: int, slots: int) -> int:
    """The first global position of this rank's ``slots`` cache slots."""
    seq, _ = cache_axes(mesh, batch)
    return ctx.axes_index(mesh, seq) * slots


def sharded_decode_attention(q: torch.Tensor, k_new: torch.Tensor,
                             v_new: torch.Tensor, cache: dict, *, mesh,
                             seq_axes: Tuple[str, ...],
                             batch_axes: Tuple[str, ...] = ()
                             ) -> torch.Tensor:
    """One decode step against a sequence-sharded cache.

    q: (B, 1, H, D), query heads grouped by kv head (head ``h`` reads kv
    head ``h // (H / KH)``, K2's layout), rope applied, replicated;
    k_new, v_new: (B, 1, KH, D).  ``cache`` is this rank's block {"k",
    "v": (B_loc, T_loc, KH, D), "len": the global fill as a 0-d int32 on
    the device, "fill": its host mirror}; the new key and value land at
    position ``len`` (in the one shard that holds it) and ``len`` and
    ``fill`` advance by one.  Returns the output (B, 1, H, D) in q's
    dtype, replicated.
    """
    ck, cv, fill = cache["k"], cache["v"], cache["fill"]
    B_loc, T_loc = ck.shape[0], ck.shape[1]
    n_seq = ctx.axes_size(mesh, seq_axes)
    if fill + 1 > n_seq * T_loc:
        raise ValueError(f"sharded kv cache of {n_seq} x {T_loc} slots at "
                         f"len {fill} cannot take another step")
    n_bat = ctx.axes_size(mesh, batch_axes)
    if B_loc * n_bat != q.shape[0]:
        raise ValueError(f"cache rows {B_loc} x {n_bat} batch shards != "
                         f"batch {q.shape[0]}")
    bi = ctx.axes_index(mesh, batch_axes)
    rows = slice(bi * B_loc, (bi + 1) * B_loc)
    q, k_new, v_new = q[rows], k_new[rows], v_new[rows]
    start = ctx.axes_index(mesh, seq_axes) * T_loc
    n = cache["len"]
    # --- the local write: a slot rewritten with itself off this shard ---
    idx = n - start
    here = (idx >= 0) & (idx < T_loc)
    safe = idx.clamp(0, T_loc - 1).reshape(1).long()
    for c, new in ((ck, k_new), (cv, v_new)):
        old = c.index_select(1, safe)
        c.index_copy_(1, safe, torch.where(here, new.to(c.dtype), old))
    n.add_(1)
    cache["fill"] = fill + 1
    # --- the shard's partial: o and lse over its valid keys ---------------
    local = (n - start).clamp(0, T_loc).to(torch.int32)
    o, lse = flash_attention_op(q, ck.to(q.dtype), cv.to(q.dtype),
                                causal=False, kv_len=local, return_lse=True)
    # --- two passes: max, then the weighted sums -------------------------
    group = ctx.axes_group(mesh, seq_axes)
    lse = lse[..., 0]                                      # (B_loc, H)
    m = ctx.all_reduce(lse.clone(), "max", group)
    w = torch.exp(lse - m)                 # 0 on a shard with no key
    num = ctx.all_reduce(w[:, None, :, None] * o.float(), "sum", group)
    den = ctx.all_reduce(w, "sum", group)
    out = (num / den.clamp(min=1e-30)[:, None, :, None]).to(q.dtype)
    if n_bat > 1:
        out = ctx.gather_axes(out, mesh, batch_axes, dim=0)
    return out
