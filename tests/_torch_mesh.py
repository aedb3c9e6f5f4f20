"""The port's side of ``tests/test_torch_mesh_train.py``: the function
each of four gloo ranks runs (a process of its own, spawned by
``repro_torch.distributed.ctx.spawn_ranks``), importing torch and the
port only.  It reads the reference's parameters and the test's inputs
from ``.npz`` files and returns numpy arrays and plain values.
"""
import os

import numpy as np
import torch

from _torch_dist import tree
from repro_torch.checkpoint.manager import restore_checkpoint, \
    save_checkpoint
from repro_torch.convert import lm_params, lm_params_shard, to_torch
from repro_torch.data import microbatch_rows
from repro_torch.distributed import ctx
from repro_torch.distributed import sharding as TS
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import make_lm_train_step, vocab_parallel_nll
from repro_torch.models import moe as TM
from repro_torch.optim import api as TO
from repro_torch.optim import compress as TC

MESH, AXES = (2, 2), ("data", "model")
BATCH = 4                      # the reference's smoke batch at accum 2
ACCUMS = (1, 2)
PLACEMENTS = ("param_specs", "rules")
AUX_C = 0.37                   # the P4 loss's weight on the aux loss
# the MoE layer's specs in its training form (no FSDP: the block gathers
# those): the routed experts and the shared experts split over "model"
MOE_SPECS = {"router": {"kernel": (None, None)},
             "wi": ("model", None, None), "wg": ("model", None, None),
             "wo": ("model", None, None),
             "shared": {"wi": {"kernel": (None, "model")},
                        "wg": {"kernel": (None, "model")},
                        "wo": {"kernel": ("model", None)}}}
# a leaf split over both axes (factored by Adafactor) and a small one
ADA_SPECS = {"w": (("data",), "model"), "b": (None,)}


def _train_steps(ref, cfg, mesh, inp) -> dict:
    """One AdamW step of the mesh train step per placement and accum
    from the reference's parameters: loss, gradient norm and the
    updated blocks."""
    out = {}
    data = ctx.axes_index(mesh, ("data",))
    for placement in PLACEMENTS:
        spec_fn = TS.train_spec_fn(cfg, filtered=placement == "param_specs")
        specs = TS.spec_tree(lm_params(ref), spec_fn)      # whole shapes
        for accum in ACCUMS:
            params = lm_params_shard(ref, mesh, spec_fn=spec_fn)
            for _, p in TO.named_leaves(params):
                p.requires_grad_(True)
            init_fn, update_fn = TO.make_optimizer("adamw")
            step = make_lm_train_step(cfg, update_fn, accum, mesh=mesh,
                                      specs=specs)
            rows = microbatch_rows(BATCH, accum, MESH[0], data)
            batch = {k: torch.from_numpy(inp[k][rows]).long()
                     for k in ("tokens", "labels")}
            params, _, m = step(params, init_fn(params), batch, 0)
            tag = f"{placement}{accum}"
            out[f"{tag}_loss"] = float(m["loss"])
            out[f"{tag}_gnorm"] = float(m["gnorm"])
            out[f"{tag}_params"] = {path: t.detach().numpy() for path, t in
                                    TO.named_leaves(params)}
    return out


def _p4(ref, moe_cfg, mesh, inp) -> dict:
    """Gradients of the a2a ``moe_apply``, serving form (x and the
    non-expert leaves replicated, the routed experts' blocks) and
    training form (this rank's rows; routed and shared experts split over
    "model"): each rank differentiates its share of sum(y * w) + AUX_C *
    aux and returns its gradient blocks."""
    cfg = TM.MoEConfig(**moe_cfg)
    W = mesh.size()
    n_model = ctx.axes_size(mesh, ("model",))
    out = {}
    for form in ("serving", "training"):
        if form == "serving":
            pm = {k: (to_torch(v) if isinstance(v, dict) else
                      torch.from_numpy(TS.shard_leaf(v, TS.serving_spec(
                          f"x/moe/{k}", v.shape), mesh, own=True)))
                  for k, v in ref.items()}
            x = torch.from_numpy(inp["moe_x"].copy())
            w = torch.from_numpy(inp["moe_w"])
            share = W
        else:
            pm = TS.shard_tree(to_torch(ref), mesh, spec_fn=lambda p, s: (
                _spec_at(MOE_SPECS, p)), own=True)
            rows = TS.block_index(inp["moe_x"].shape, (("data",), None,
                                                       None),
                                  *TS.mesh_layout(mesh))
            x = torch.from_numpy(inp["moe_x"][rows].copy())
            w = torch.from_numpy(inp["moe_w"][rows].copy())
            share = n_model
        for _, t in TO.named_leaves(pm):
            t.requires_grad_(True)
        x.requires_grad_(True)
        y, aux = TM.moe_apply(pm, x, cfg, mesh=mesh,
                              specs=MOE_SPECS if form == "training"
                              else None)
        ((y * w).sum() / share + AUX_C * aux / W).backward()
        out[f"p4_{form}_y"] = y.detach().numpy()
        out[f"p4_{form}_grads"] = {
            path: (None if t.grad is None else t.grad.numpy())
            for path, t in TO.named_leaves(pm)}
        out[f"p4_{form}_dx"] = x.grad.numpy()
    return out


def _spec_at(specs, path):
    node = specs
    for k in path.split("/"):
        node = node[k]
    return node


def _ce(mesh, inp) -> dict:
    """The vocab-parallel negative log-likelihood of the rank's vocabulary
    block of the logits, and its share's gradient."""
    z = inp["ce_logits"]
    V = z.shape[-1]
    n, m = ctx.axes_size(mesh, ("model",)), ctx.axes_index(mesh, ("model",))
    blk = torch.from_numpy(z[..., m * V // n:(m + 1) * V // n].copy())
    blk.requires_grad_(True)
    nll = vocab_parallel_nll(blk, torch.from_numpy(inp["ce_labels"]), mesh,
                             True)
    (nll.sum() / n).backward()
    return {"ce_nll": nll.detach().numpy(), "ce_grad": blk.grad.numpy()}


def _clip(mesh, inp) -> dict:
    """clip_by_global_norm over blocks: one leaf split over both axes,
    one replicated on every rank."""
    specs = {"w": (("data",), "model"), "r": (None,)}
    g = {"w": torch.from_numpy(TS.shard_leaf(inp["clip_w"], specs["w"],
                                             mesh, own=True)),
         "r": torch.from_numpy(inp["clip_r"].copy())}
    clipped, gn = TO.clip_by_global_norm(g, 1.0, layout=(mesh, specs))
    return {"clip_gn": float(gn), "clip_w": clipped["w"].numpy()}


def _adafactor(mesh, inp) -> dict:
    """Adafactor's first two steps on this rank's blocks."""
    params = {k: torch.from_numpy(TS.shard_leaf(inp[f"ada_{k}"], sp, mesh,
                                                own=True))
              for k, sp in ADA_SPECS.items()}
    init_fn, update_fn = TO.make_optimizer("adafactor")
    state = init_fn(params)
    for step in range(2):
        grads = {k: torch.from_numpy(TS.shard_leaf(
            inp[f"ada_g{step}_{k}"], sp, mesh, own=True))
            for k, sp in ADA_SPECS.items()}
        params, state = update_fn(params, grads, state, step,
                                  layout=(mesh, ADA_SPECS))
    return {f"ada_{k}": v.numpy() for k, v in params.items()}


def _compress(mesh, inp, rank) -> dict:
    """``compressed_all_reduce`` over "data" on this rank's gradient, and
    F8: two ranks of one data group with g = 1 and g = 2 everywhere."""
    group = ctx.axes_group(mesh, ("data",))
    g = torch.from_numpy(inp["cmp_g"][rank].copy())
    err = torch.from_numpy(inp["cmp_err"][rank].copy())
    mean, new_err = TC.compressed_all_reduce(g, err, group)
    ones = torch.full((8,), 1.0 + ctx.axes_index(mesh, ("data",)))
    f8, _ = TC.compressed_all_reduce(ones, torch.zeros(8), group)
    return {"cmp_mean": mean.numpy(), "cmp_err": new_err.numpy(),
            "f8_mean": f8.numpy()}


def _ckpt_state(ref, cfg, mesh):
    """A training state's blocks (the unfiltered placement: every leaf
    split; AdamW moments drawn whole from a seed a leaf, so that replicas
    agree) and their specs, as the launcher saves them."""
    spec_fn = TS.train_spec_fn(cfg, filtered=False)
    whole = lm_params(ref)
    state, specs = {"params": {}, "opt": {"s": {}}}, {}
    for i, (path, p) in enumerate(TO.named_leaves(whole)):
        spec = spec_fn(path, tuple(p.shape))
        g = torch.Generator().manual_seed(i)
        leaves = {f"params/{path}": p,
                  **{f"opt/s/{path}/{k}": torch.randn(p.shape, generator=g)
                     for k in ("mu", "nu")}}
        for key, t in leaves.items():
            specs[key] = spec
            node = state
            *head, last = key.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = TS.shard_leaf(t, spec, mesh, own=True)
    return state, specs


def mesh_rank(rank: int, world: int, init_dir: str, inputs: str,
              ref_params: str, lm_cfg, moe_cfg: dict, ckpt: str) -> dict:
    torch.manual_seed(0)
    inp = dict(np.load(inputs))
    ref = tree(dict(np.load(ref_params)))
    out = {}
    ctx.init_ranks(rank, world, os.path.join(init_dir, "mesh22"), "cpu")
    mesh = make_mesh(MESH, AXES)
    out.update(_train_steps(ref["lm"], lm_cfg, mesh, inp))
    out.update(_p4(ref["moe"], moe_cfg, mesh, inp))
    out.update(_ce(mesh, inp))
    out.update(_clip(mesh, inp))
    out.update(_adafactor(mesh, inp))
    out.update(_compress(mesh, inp, rank))
    state, specs = _ckpt_state(ref["lm"], lm_cfg, mesh)
    save_checkpoint(ckpt, 3, state, shard={"mesh": mesh, "specs": specs})
    torch.distributed.barrier()       # every rank's blocks published
    out["ckpt_saved"] = {p: t.numpy() for p, t in
                         TO.named_leaves(state)}
    ctx.close_ranks()
    if rank < 2:          # restored onto a (1, 2) mesh: ranks 0 and 1
        ctx.init_ranks(rank, 2, os.path.join(init_dir, "mesh12"), "cpu")
        torch.distributed.barrier()
        mesh12 = make_mesh((1, 2), AXES)
        step, st = restore_checkpoint(ckpt, mesh=mesh12)
        out["ckpt_step"] = step
        out["ckpt_restored"] = {p: t.numpy() for p, t in
                                TO.named_leaves(st)}
        ctx.close_ranks()
    return out


# --- the dense and GQA/MQA configs' mesh steps ----------------------------------
# (tests/test_torch_lm_train_configs.py)

CFG_BATCH = 4                  # the reference's smoke batch on the mesh


def configs_rank(rank: int, world: int, init_dir: str, inputs: str,
                 ref_params: str, cfgs: dict) -> dict:
    """One rank of the three configs' mesh steps: for each ``arch_id:
    (cfg, optimizer)`` of ``cfgs`` (the configs as the launcher trains
    them under a mesh), one step of its optimizer at accum 1 from the
    reference's parameters (prefix ``arch_id``) under the unfiltered
    rules (every TP and FSDP split made: granite's MQA k and v columns
    split inside their one head), on the rank's rows of the batch:
    loss, gradient norm and the updated blocks."""
    torch.manual_seed(0)
    inp = dict(np.load(inputs))
    ref = tree(dict(np.load(ref_params)))
    ctx.init_ranks(rank, world, os.path.join(init_dir, "cfg22"), "cpu")
    mesh = make_mesh(MESH, AXES)
    rows = microbatch_rows(CFG_BATCH, 1, MESH[0],
                           ctx.axes_index(mesh, ("data",)))
    out = {}
    for arch_id, (cfg, opt_name) in cfgs.items():
        spec_fn = TS.train_spec_fn(cfg, filtered=False)
        specs = TS.spec_tree(lm_params(ref[arch_id]), spec_fn)
        params = lm_params_shard(ref[arch_id], mesh, spec_fn=spec_fn)
        for _, p in TO.named_leaves(params):
            p.requires_grad_(True)
        init_fn, update_fn = TO.make_optimizer(opt_name)
        step = make_lm_train_step(cfg, update_fn, 1, mesh=mesh, specs=specs)
        batch = {k: torch.from_numpy(inp[f"{arch_id}/{k}"][rows]).long()
                 for k in ("tokens", "labels")}
        params, _, m = step(params, init_fn(params), batch, 0)
        out[arch_id] = {"loss": float(m["loss"]), "gnorm": float(m["gnorm"]),
                        "params": {path: t.detach().numpy() for path, t in
                                   TO.named_leaves(params)}}
    ctx.close_ranks()
    return out
