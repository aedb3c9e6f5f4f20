"""The port's side of ``tests/test_torch_vision_mesh.py``: the function
each of four gloo ranks runs (a process of its own, spawned by
``repro_torch.distributed.ctx.spawn_ranks``), importing torch and the
port only.  It reads the reference's parameters and the test's inputs
from ``.npz`` files and returns numpy arrays and plain values.
"""
import dataclasses
import os

import numpy as np
import torch

from _torch_dist import tree
from repro_torch.checkpoint.manager import save_checkpoint
from repro_torch.configs import get_arch
from repro_torch.convert import to_torch, vision_params_shard, vit_params
from repro_torch.core import layers as TL
from repro_torch.data import microbatch_rows
from repro_torch.distributed import ctx
from repro_torch.distributed import sharding as TS
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import _state_specs
from repro_torch.launch.steps import make_vis_train_step
from repro_torch.models.efficientnet import effnet_apply
from repro_torch.models.resnet import resnet_apply
from repro_torch.optim import api as TO

MESH, AXES = (2, 2), ("data", "model")
ACCUMS = (1, 2)
MB = 8                  # images a microbatch (4 a data block)
# the smoke configs, the conv nets widened past vision_rules' 256-channel
# threshold (and ResNet's classifier past 1024 rows): ResNet width 132 at
# its 2 stages (stage 1's 264 mid channels split only without the 16-way
# filter, its 1056 outputs and the 1056-row classifier with it);
# EfficientNet at B0's widths, one block a stage (expand, depthwise and
# squeeze-excite widths 480-1152, the 1280-channel head and its
# classifier split); the conv nets in float64 (the ReLU-kink trap:
# ROADMAP §3)
OVERRIDES = {
    "dynamic-ofa-supernet": {},
    "resnet-152": {"width": 132},
    "efficientnet-b7": {"width_mult": 1.0, "depth_mult": 0.25},
}
F64 = {"param_dtype": "float64", "compute_dtype": "float64"}
CONV = ("resnet-152", "efficientnet-b7")
# (arch, filtered) of each case, every one at each accum
CASES = (("dynamic-ofa-supernet", True), ("resnet-152", True),
         ("efficientnet-b7", True), ("resnet-152", False),
         ("efficientnet-b7", False))
# the state whose blocks are checkpointed: every kind of conv split
CKPT_CASE = ("resnet-152", False, 1)


def lists(t):
    """A tree read back from flat paths with its dicts keyed 0..n-1 (the
    conv nets' stages, the ViT's exit heads) made lists again."""
    if not isinstance(t, dict):
        return t
    t = {k: lists(v) for k, v in t.items()}
    if t and all(k.isdigit() for k in t):
        return [t[str(i)] for i in range(len(t))]
    return t


def port_cfg(arch_id: str):
    cfg = dataclasses.replace(get_arch(arch_id).make_smoke(),
                              **OVERRIDES[arch_id])
    return dataclasses.replace(cfg, **F64) if arch_id in CONV else cfg


def whole_params(ref: dict):
    return vit_params(ref) if "layers" in ref else to_torch(ref)


def _step(arch_id, cfg, ref, spec_fn, mesh, inp, accum,
          ckpt=None) -> dict:
    """One step of the arch's optimizer on the rank's blocks and rows:
    loss, gradient norm, the clipped gradient blocks the update read and
    the updated blocks; with ``ckpt`` the updated state's blocks (and
    SGD's momentum) saved there as the launcher saves them, and returned
    as saved."""
    specs = TS.spec_tree(whole_params(ref), spec_fn)
    params = vision_params_shard(ref, mesh, spec_fn)
    for _, p in TO.named_leaves(params):
        p.requires_grad_(True)
    init_fn, update_fn = TO.make_optimizer(get_arch(arch_id).optimizer)
    kept = {}

    def keep(params, grads, opt, step, layout=None):
        kept.update({k: g.detach().clone() for k, g in
                     TO.named_leaves(grads)})
        return update_fn(params, grads, opt, step, layout=layout)
    step = make_vis_train_step(arch_id, cfg, keep, accum, mesh=mesh,
                               specs=specs)
    rows = microbatch_rows(MB * accum, accum, MESH[0],
                           ctx.axes_index(mesh, ("data",)))
    batch = {"images": torch.from_numpy(inp[f"{arch_id}/images"][rows]),
             "labels": torch.from_numpy(inp[f"{arch_id}/labels"][rows])}
    out = {}
    if arch_id in CONV and accum == 1:
        # BN's batch statistics of the step's microbatch, as the forward
        # returns them
        apply = resnet_apply if arch_id == "resnet-152" else effnet_apply
        with torch.no_grad():
            _, st = apply(params, batch["images"], cfg, train=True,
                          collect_stats=True, mesh=mesh, specs=specs)
        out["stats"] = [(n, m_.numpy(), v.numpy()) for n, (m_, v) in st]
    params, opt, m = step(params, init_fn(params), batch, 0)
    out.update(loss=float(m["loss"]), gnorm=float(m["gnorm"]),
               grads={k: g.numpy() for k, g in kept.items()},
               params={k: p.detach().numpy()
                       for k, p in TO.named_leaves(params)})
    if ckpt is not None:
        state = {"params": params, "opt": opt}
        save_checkpoint(ckpt, 1, state, shard={
            "mesh": mesh, "specs": _state_specs(state, specs)})
        torch.distributed.barrier()     # every rank's blocks published
        out["ckpt"] = {k: t.detach().numpy()
                       for k, t in TO.named_leaves(state)}
    return out


def vision_rank(rank: int, world: int, init_dir: str, inputs: str,
                ref_params: str, ckpt: str) -> dict:
    """Every case of ``CASES`` at each accum (``CKPT_CASE``'s state saved
    to ``ckpt``), and the per-rank statistics case (ResNet at accum 1
    with BN's mesh dropped: each rank's own rows' statistics)."""
    torch.manual_seed(0)
    torch.set_num_threads(1)
    inp = dict(np.load(inputs))
    ref = lists(tree(dict(np.load(ref_params))))
    ctx.init_ranks(rank, world, os.path.join(init_dir, "vis22"), "cpu")
    mesh = make_mesh(MESH, AXES)
    out = {}
    for arch_id, filtered in CASES:
        cfg = port_cfg(arch_id)
        spec_fn = TS.vision_train_spec_fn(arch_id, cfg, filtered=filtered)
        for accum in ACCUMS:
            out[(arch_id, filtered, accum)] = _step(
                arch_id, cfg, ref[arch_id], spec_fn, mesh, inp, accum,
                ckpt if (arch_id, filtered, accum) == CKPT_CASE else None)
    sbn = TL.sbn_apply

    def local_stats(*a, mesh=None, **kw):
        return sbn(*a, **kw)
    TL.sbn_apply = local_stats
    try:
        cfg = port_cfg("resnet-152")
        out["local_stats"] = _step(
            "resnet-152", cfg, ref["resnet-152"],
            TS.vision_train_spec_fn("resnet-152", cfg), mesh, inp, 1)
    finally:
        TL.sbn_apply = sbn
    ctx.close_ranks()
    return out
