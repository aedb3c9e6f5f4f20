"""Mixture-of-Experts layer: the dense oracle and the GShard dispatch.

Counterpart of the reference ``models/moe.py`` in sliced mode (static
knobs) and masked mode (0-d tensor knobs).  Every routed expert product
goes through the expert-gated
grouped matmul (kernel K3, ``kernels.ops.expert_matmul_op``); the router
and the shared experts run on the elastic matmul (K1).

* ``einsum`` — the reference's GShard dispatch (``_moe_einsum``): tokens
  grouped, a capacity of C slots per (group, expert) computed from the FULL
  expert count, slots counted per expert in (token, k) order and dropped
  past C.  The port keeps that assignment exactly, so the same tokens are
  dropped, but packs each expert's kept slots into one slab: x (E, G*C, d)
  with ``counts[e] = sum_g min(load[g, e], C)`` live rows, built on the
  device with index ops (no host sync, no one-hot dispatch product).  K3
  skips the rows past each count; the outputs are gathered back and
  weighted by the gates in the compute dtype, as the reference combine.
* ``dense`` — every expert on every token, combined by gate weight: the
  numerics oracle, as in the reference.
* ``a2a`` — the reference's expert-parallel dispatch over a device mesh
  (a ``DeviceMesh``; :func:`_moe_a2a`): each rank holds the routed
  experts of its block of the ``"model"`` axis, takes its (batch,
  sequence) block of the tokens (training: its rows are its own already,
  and it takes its sequence block), routes and slots them (capacity per
  rank's token set, ``C = max(4, ceil(T_loc k cf / E))``), sends each
  expert's rows to the rank that holds it and gets them back with
  ``all_to_all``, runs K3 over its local experts' live rows and gathers
  the outputs along the sequence (serving: and the rows); the aux loss
  is the mean over ranks.  Every exchange carries gradients.
  At decode shapes (S not divisible by the ``"model"`` size, where the
  reference falls back to the einsum dispatch over GSPMD-sharded
  experts) each rank runs the GShard dispatch for its own experts and
  one ``all_reduce`` sums the partial combines.  With no mesh the
  reference takes the einsum path, and so does the port.

Elastic knobs: ``a_experts`` routes to the first n experts only (K3 reads
the first n expert weights in place), ``top_k`` and ``a_ff`` (per-expert
hidden width, a strided view of the full weights) shrink compute.  In
masked mode (``a_experts`` or ``a_ff`` a 0-d tensor) the knobs are read
as ints on the host and the layer takes the sliced path, which computes
the reference's masked function: the router gives the experts at or past
``a_experts`` the fp32 minimum in both modes, the capacity comes from the
full expert count in both, and the hidden units past ``a_ff``, zero in
the reference's masked mode, add nothing to an expert's output.  Only
knobs that stayed on the device would need full-width slabs; the LM
reads its widths on the host.
"""
from __future__ import annotations

import contextvars
import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core import layers as L
from repro_torch.distributed import ctx
from repro_torch.kernels.ops import expert_matmul_op


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                     # per-expert hidden
    n_shared: int = 0             # shared (always-on) experts
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    group_size: int = 256         # einsum dispatch group
    dispatch: str = "einsum"      # einsum | a2a | dense
    expert_axis: str = "model"    # mesh axis experts are sharded over (a2a)


def moe_init(gen: torch.Generator, d_model: int, cfg: MoEConfig, *,
             dtype=torch.float32, device=None, keep=None) -> dict:
    """The reference's distributions; the router is fp32 whatever
    ``dtype`` is, as the reference keeps it.  ``keep(name, t)`` (e.g. a
    rank's block of the expert axis) runs on each routed expert weight
    as soon as it is drawn, before the next draw."""
    E, f = cfg.n_experts, cfg.d_ff
    s = 1.0 / math.sqrt(d_model)
    keep = keep or (lambda name, t: t)
    p = {"router": L.dense_init(gen, d_model, E, bias=False,
                                dtype=torch.float32, device=device)}
    p["wi"] = keep("wi", L._normal(gen, (E, d_model, f), s, dtype, device))
    p["wg"] = keep("wg", L._normal(gen, (E, d_model, f), s, dtype, device))
    p["wo"] = keep("wo", L._normal(gen, (E, f, d_model), 1.0 / math.sqrt(f),
                                   dtype, device))
    if cfg.n_shared:
        p["shared"] = L.mlp_init(gen, d_model, cfg.d_ff * cfg.n_shared,
                                 gated=True, dtype=dtype, device=device)
    return p


def _router(p, x, cfg: MoEConfig, a_experts: Optional[int], top_k: int):
    """probs (..., E) fp32 with the experts at or past ``a_experts``
    masked out; top-k gates (renormalised) and indices."""
    logits = L.dense_apply(p["router"], x.to(torch.float32))
    E = cfg.n_experts
    if a_experts is not None and a_experts != E:
        live = torch.arange(E, device=x.device) < a_experts
        logits = torch.where(live, logits,
                             torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = torch.topk(probs, top_k, dim=-1)
    top_vals = top_vals / torch.clamp(top_vals.sum(-1, keepdim=True),
                                      min=1e-9)
    return probs, top_vals, top_idx


def _aux_loss(probs, top_idx, cfg: MoEConfig) -> torch.Tensor:
    """Switch-style load-balance loss: E * sum_e f_e * P_e."""
    E = cfg.n_experts
    f = F.one_hot(top_idx.reshape(-1), E).to(torch.float32).mean(0)
    pbar = probs.reshape(-1, E).mean(0)
    return E * torch.sum(f * pbar)


def _expert_ffn(p, h, counts, *, a_ff=None, slice_e=None):
    """h: (E, C, d) -> (E, C, d) SwiGLU per expert over the rows
    ``c < counts[e]`` (exact zeros past them), through K3.  The sliced
    expert count and width are views of the full weights."""
    wi, wg, wo = p["wi"], p["wg"], p["wo"]
    if slice_e is not None:
        wi, wg, wo = wi[:slice_e], wg[:slice_e], wo[:slice_e]
    if a_ff is not None:
        wi, wg, wo = wi[..., :a_ff], wg[..., :a_ff], wo[:, :a_ff]
    up = expert_matmul_op(h, L._cast(wi, h.dtype), counts)
    gate = expert_matmul_op(h, L._cast(wg, h.dtype), counts)
    hid = F.silu(gate) * up
    return expert_matmul_op(hid, L._cast(wo, h.dtype), counts)


# ---------------------------------------------------------------------------
# dense dispatch (oracle)
# ---------------------------------------------------------------------------

def _moe_dense(p, x, cfg: MoEConfig, a_experts, top_k, a_ff):
    B, S, d = x.shape
    T = B * S
    probs, top_vals, top_idx = _router(p, x, cfg, a_experts, top_k)
    E = cfg.n_experts
    toks = x.reshape(1, T, d).expand(E, T, d)     # stride 0: no copy
    counts = torch.full((E,), T, dtype=torch.int32, device=x.device)
    outs = _expert_ffn(p, toks, counts, a_ff=a_ff)             # (E, T, d)
    comb = torch.zeros((T, E), dtype=torch.float32, device=x.device)
    comb.scatter_add_(1, top_idx.reshape(T, -1), top_vals.reshape(T, -1))
    y = torch.einsum("te,etd->td", comb.to(x.dtype), outs)
    return y.reshape(B, S, d), _aux_loss(probs, top_idx, cfg)


# ---------------------------------------------------------------------------
# GShard dispatch, packed per expert for K3
# ---------------------------------------------------------------------------

def dispatch_plan(top_idx: torch.Tensor, n_experts: int, capacity: int):
    """Where each (token, k) slot goes in the packed per-expert slabs.

    top_idx: (G, g, k), the expert of each slot.  Within each group, slots
    are counted per expert in (token, k) order, as the reference counts
    them, and those at position >= ``capacity`` are dropped.  An expert's
    slab has ``G * capacity`` rows; its kept slots fill rows
    ``0 .. counts[e] - 1``, group after group.  Returns (dest, keep,
    counts): ``dest`` (G*g*k,) the row ``e * G * capacity + r`` of each
    kept slot in the flattened slabs and ``n_experts * G * capacity`` (a
    scratch row) for each dropped one; ``keep`` the kept mask; ``counts``
    (E,) int32.  All on the device, with no host sync.
    """
    G, g, k = top_idx.shape
    E, n_slab = n_experts, G * capacity
    idx = top_idx.reshape(G, g * k)
    oh = F.one_hot(idx, E)                                   # (G, g*k, E)
    loc = (torch.cumsum(oh, 1) - oh).gather(2, idx[..., None])[..., 0]
    keep = loc < capacity                                    # (G, g*k)
    kept = oh.sum(1).clamp(max=capacity)                     # (G, E)
    first = torch.cumsum(kept, 0) - kept                     # rows before g
    row = first.gather(1, idx) + loc
    dest = torch.where(keep, idx * n_slab + row, E * n_slab)
    return dest.reshape(-1), keep.reshape(-1), \
        kept.sum(0).to(torch.int32)


def _moe_einsum(p, x, cfg: MoEConfig, a_experts, top_k, a_ff, slice_e,
                own=None):
    """The GShard dispatch.  ``own`` = (lo, hi): the a2a decode's rank,
    whose ``p`` holds experts lo .. hi - 1 only: it computes those
    experts' slots and returns its partial combine in fp32."""
    B, S, d = x.shape
    # group over FLATTENED tokens, as the reference does: decode-style
    # shapes (B x 1) form one group of B tokens
    T = B * S
    g = min(cfg.group_size, T)
    while T % g:           # fall back to the largest divisor of T
        g -= 1
    G = T // g
    probs, top_vals, top_idx = _router(p, x.reshape(G, g, d), cfg,
                                       a_experts, top_k)
    E = cfg.n_experts if slice_e is None else slice_e
    if slice_e is not None:
        top_idx = torch.clamp(top_idx, max=E - 1)  # already < E by masking
    # capacity from the FULL expert count, so sliced and masked
    # sub-networks drop exactly the same tokens (slice == mask)
    C = max(4, int(math.ceil(g * top_k * cfg.capacity_factor
                             / cfg.n_experts)))
    dest, keep, counts = dispatch_plan(top_idx, E, C)
    _tally(keep)
    n_slab, n_e = G * C, E
    if own is not None:       # the slots of experts lo .. hi - 1 alone
        lo, hi = min(own[0], E), min(own[1], E)
        idx = top_idx.reshape(-1)
        keep = keep & (idx >= lo) & (idx < hi)
        n_e, slice_e, counts = hi - lo, hi - lo, counts[lo:hi]
        dest = torch.where(keep, dest - lo * n_slab, n_e * n_slab)
    if not n_e:               # a rank past the sliced expert count
        y = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    else:
        # each token top_k times, in order (no host sync: graph-capturable)
        tok = torch.div(torch.arange(T * top_k, device=x.device), top_k,
                        rounding_mode="floor")
        xf = x.reshape(T, d)
        slabs = x.new_zeros((n_e * n_slab + 1, d))
        slabs.index_copy_(0, dest, xf[tok])  # dropped slots: the scratch row
        out = _expert_ffn(p, slabs[:-1].view(n_e, n_slab, d), counts,
                          a_ff=a_ff, slice_e=slice_e)
        # index_select, not indexing: its backward adds each slot's
        # gradient into its row (index_add_), where indexing's sorts the
        # indices and accumulates the dropped slots' row 0 serially (7.1
        # of the train_4k step's 25.6 s of device time on an H100:
        # PERF.md).  A dropped slot's gradient is exactly 0 (gate 0), so
        # the sums are the same bits.
        rows = out.reshape(n_e * n_slab, d).index_select(
            0, torch.where(keep, dest, 0))
        gates = (top_vals.reshape(-1) * keep).to(x.dtype)
        y = (rows.to(torch.float32) * gates.to(torch.float32)[:, None]) \
            .reshape(T, top_k, d).sum(1)
    if own is None:
        y = y.to(x.dtype)
    return y.reshape(B, S, d), _aux_loss(probs, top_idx, cfg)


# ---------------------------------------------------------------------------
# all-to-all expert-parallel dispatch over a mesh
# ---------------------------------------------------------------------------

def _a2a_axes(mesh, cfg: MoEConfig) -> tuple:
    """(expert axis, batch axes): the tokens' batch is split over every
    other mesh axis, their sequence over the expert axis."""
    ax = cfg.expert_axis
    names = tuple(mesh.mesh_dim_names)
    if ax not in names:
        raise ValueError(f"a2a: mesh axes {names} lack the expert axis "
                         f"{ax!r}")
    return ax, tuple(a for a in names if a != ax)


def _local_experts(p: dict, cfg: MoEConfig, mesh) -> dict:
    """This rank's block of the routed experts: ``p``'s own when it holds
    a block of the expert axis, else its block cut from the whole
    weights (a placement that replicates them: the reference's
    shard_map reshards them the same way; the cut's backward leaves the
    other blocks' gradient 0, summed over the axis with the replicated
    leaf's)."""
    ax = cfg.expert_axis
    n, E = ctx.axes_size(mesh, (ax,)), cfg.n_experts
    E_loc = E // n
    have = p["wi"].shape[0]
    if have == E_loc:
        return p
    if have == E and E % n == 0:
        e0 = ctx.axes_index(mesh, (ax,)) * E_loc
        return dict(p, **{k: p[k][e0:e0 + E_loc] for k in ("wi", "wg",
                                                          "wo")})
    raise ValueError(f"a2a: {have} local experts on {n} ranks of {E} "
                     f"experts (want this rank's block of the expert axis, "
                     f"or all of them: distributed.sharding)")


def _moe_a2a(p, x, cfg: MoEConfig, a_experts, top_k, a_ff, mesh,
             data_local: bool = False):
    """The reference's shard_map body on this rank, differentiable: every
    exchange is a collective whose backward runs the reverse exchange
    (``ctx``'s convention).  ``x`` (B, S, d) is replicated over the mesh,
    or with ``data_local`` this rank's rows of the batch, replicated over
    the expert axis (training: the batch axes split the rows already).
    The rank takes its sequence slice (and, replicated, its rows), routes,
    exchanges, runs K3 over its local experts' live rows, exchanges back
    and gathers y along the sequence (and the rows).  The aux loss is the
    mean over every rank's, on every rank."""
    B, S, d = x.shape
    ax, b_axes = _a2a_axes(mesh, cfg)
    if data_local:
        b_axes = ()
    n = ctx.axes_size(mesh, (ax,))
    n_b = ctx.axes_size(mesh, b_axes)
    if B % n_b:
        raise ValueError(f"a2a: batch {B} does not split over {n_b} ranks")
    E = cfg.n_experts
    p = _local_experts(p, cfg, mesh)
    E_loc = E // n
    bi, si = ctx.axes_index(mesh, b_axes), ctx.axes_index(mesh, (ax,))
    B_loc, S_loc = B // n_b, S // n
    xl = x[bi * B_loc:(bi + 1) * B_loc, si * S_loc:(si + 1) * S_loc]
    T = B_loc * S_loc
    xf = xl.reshape(T, d)
    probs, top_vals, top_idx = _router(p, xf, cfg, a_experts, top_k)
    # slots counted per expert in (token, k) order: where the reference's
    # stable sort by expert puts them; past C they drop
    C = max(4, int(math.ceil(T * top_k * cfg.capacity_factor / E)))
    dest, keep, counts = dispatch_plan(top_idx.reshape(1, T, top_k), E, C)
    _tally(keep)
    tok = torch.div(torch.arange(T * top_k, device=x.device), top_k,
                    rounding_mode="floor")
    # index_copy (out of place): the dropped slots go to the scratch row
    send = x.new_zeros((E * C + 1, d)).index_copy(0, dest, xf[tok])
    group = ctx.axes_group(mesh, (ax,))
    # rank r gets the (E_loc, C) slabs of its experts from every rank, and
    # how many rows of each are live
    recv = ctx.all_to_all_grad(send[:-1], group).view(n, E_loc, C, d)
    live = ctx.all_to_all(counts, group).view(n, E_loc)
    # pack each local expert's live rows, source after source, into one
    # slab for K3 (it skips the rows past each count)
    pos = torch.arange(C, device=x.device)
    first = torch.cumsum(live, 0) - live                 # rows before src
    e_of = torch.arange(E_loc, device=x.device)[None, :, None]
    alive = pos[None, None, :] < live[:, :, None]        # (n, E_loc, C)
    slot = torch.where(alive, e_of * (n * C) + first[:, :, None] + pos,
                       E_loc * n * C).reshape(-1)
    slabs = x.new_zeros((E_loc * n * C + 1, d)).index_copy(
        0, slot, recv.reshape(-1, d))
    out = _expert_ffn(p, slabs[:-1].view(E_loc, n * C, d),
                      live.sum(0, dtype=torch.int32), a_ff=a_ff)
    out = torch.cat([out.reshape(-1, d), out.new_zeros((1, d))])
    back = ctx.all_to_all_grad(out.index_select(0, slot), group)  # (E*C, d)
    rows = back.index_select(0, torch.where(keep.reshape(-1), dest, 0))
    gates = (top_vals.reshape(-1) * keep.reshape(-1)).to(x.dtype)
    y = (rows.to(torch.float32) * gates.to(torch.float32)[:, None]) \
        .reshape(T, top_k, d).sum(1).to(x.dtype)
    # put the (B_loc, S_loc) blocks back together: sequence blocks over
    # the expert axis, batch blocks over the batch axes (row-major ranks)
    y = ctx.all_gather_grad(y.reshape(B_loc, S_loc, d), mesh, (ax,), 1)
    if b_axes:
        y = ctx.all_gather_grad(y, mesh, b_axes, 0)
    aux = ctx.all_reduce_grad(_aux_loss(probs, top_idx, cfg).reshape(1),
                              ctx.axes_group(mesh, mesh.mesh_dim_names))
    return y, aux[0] / mesh.size()


def _moe_a2a_decode(p, x, cfg: MoEConfig, a_experts, top_k, a_ff, slice_e,
                    mesh):
    """Decode shapes: the GShard dispatch of every token on every rank,
    each rank computing its own experts' slots; one ``all_reduce`` over
    the expert axis sums the partial combines."""
    ax, _ = _a2a_axes(mesh, cfg)
    p = _local_experts(p, cfg, mesh)
    E_loc = p["wi"].shape[0]
    e0 = ctx.axes_index(mesh, (ax,)) * E_loc
    y, aux = _moe_einsum(p, x, cfg, a_experts, top_k, a_ff, slice_e,
                         own=(e0, e0 + E_loc))
    y = ctx.all_reduce_grad(y, ctx.axes_group(mesh, (ax,)))
    return y.to(x.dtype), aux


# the open tally's (kept, routed) slot counts, per thread and context
_TALLY: contextvars.ContextVar = contextvars.ContextVar("moe_tally",
                                                        default=None)


def _tally(keep: torch.Tensor) -> None:
    rows = _TALLY.get()
    if rows is not None:
        rows.append((keep.sum(), keep.numel()))


class dispatch_tally:
    """``with dispatch_tally() as t:`` collects the (kept, routed) slot
    counts of every dispatch (einsum and a2a) in the block as device
    tensors (no sync inside it); ``t.counts()`` reads their sums."""

    def __enter__(self):
        self.rows: list = []
        self._token = _TALLY.set(self.rows)
        return self

    def __exit__(self, *exc):
        _TALLY.reset(self._token)
        return False

    def counts(self) -> tuple:
        return (sum(int(k) for k, _ in self.rows),
                sum(n for _, n in self.rows))


def moe_apply(p: dict, x: torch.Tensor, cfg: MoEConfig, *, a_experts=None,
              top_k: Optional[int] = None, a_ff=None, a_model=None,
              mesh=None, specs=None) -> tuple:
    """Returns (y (B, S, d), aux_loss).  Shared experts added on top.

    ``a_experts`` and ``a_ff`` are ints (sliced mode) or 0-d tensors
    (masked mode, read on the host: the module note); ``top_k`` is an int
    in both, as the reference's.  ``mesh`` (a ``DeviceMesh``) runs the
    ``a2a`` dispatch on this rank, whose ``p`` holds its block of the
    routed experts (or all of them); as the reference's, the a2a router
    masks the experts past ``a_experts`` but never slices them.  ``x`` is
    replicated over the mesh (serving), or, with ``specs`` (the layer's
    leaves' specs under the training placement), this rank's rows of the
    batch, the shared experts then tensor parallel where their kernels
    are split over ``"model"``.  The dispatch, the combine and the aux
    loss carry gradients on both routes and under a mesh (through
    ``ctx``'s differentiable collectives); on the card the routed
    experts' gradients are K3's dgrad and wgrad kernels, through the
    casts of the fp32 weights.  Under a mesh the aux loss is the mean of
    the ranks' own, as the reference's mean over its shards.
    """
    top_k = int(top_k or cfg.top_k)
    a_experts = None if a_experts is None else int(a_experts)
    a_ff = None if a_ff is None else int(a_ff)
    slice_e = None
    if a_experts is not None and a_experts < cfg.n_experts:
        slice_e = a_experts

    if cfg.dispatch == "dense":
        y, aux = _moe_dense(p, x, cfg, a_experts, top_k, a_ff)
    elif cfg.dispatch == "einsum" or (cfg.dispatch == "a2a" and mesh is None):
        y, aux = _moe_einsum(p, x, cfg, a_experts, top_k, a_ff, slice_e)
    elif cfg.dispatch == "a2a":
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"moe_apply: the a2a dispatch wants a "
                            f"torch.distributed DeviceMesh, got "
                            f"{type(mesh).__name__}")
        if x.shape[1] % ctx.axes_size(mesh, (cfg.expert_axis,)):
            if specs is not None:
                raise ValueError("the training placement splits the "
                                 "sequence over the expert axis")
            y, aux = _moe_a2a_decode(p, x, cfg, a_experts, top_k, a_ff,
                                     slice_e, mesh)
        else:
            y, aux = _moe_a2a(p, x, cfg, a_experts, top_k, a_ff, mesh,
                              data_local=specs is not None)
    else:
        raise ValueError(cfg.dispatch)

    if "shared" in p:
        tp = None if specs is None else L.tp_mesh(specs["shared"], "wi",
                                                  "wo", mesh)
        y = y + L.mlp_apply(p["shared"], x, a_model=a_model, a_ff=None,
                            tp=tp)
    return y, aux
