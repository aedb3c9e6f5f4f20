"""ResNet-152 at full depth and width, one train step across a 2 x 2
(data, model) mesh of four gloo ranks on the CPU, against the JAX
reference's ``_vis_cell`` step in one process: both in float64, from the
same seed-0 parameters and batch, at a small image size.

The witness for the bf16 mesh step's distance from one process on the
card (``chip_smoke.py`` phase 31 (c)): where the two agree in float64 to
round-off, the mesh computes the reference's function at full depth, and
what bf16 shows is the step's own sensitivity to the order of its sums.
It prints one line of JSON: the loss and gradient norm relative to the
reference's, each gradient block's largest error as a share of its
leaf's largest entry (the worst leaf named), and the BN statistics of
every microbatch (a mean against the larger of its entries and its
channels' spread, a variance against its largest entry).  It imports JAX
and the port, as the tests do:

    PYTHONPATH=src:tests python tests/_torch_resnet152_witness.py \\
        [--res 64] [--accum 2]
"""
import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np

B_MB = 4                          # images a microbatch (2 a data block)
MESH, AXES = (2, 2), ("data", "model")
SIZES = dict(zip(AXES, MESH))
VANISHING = 1e-2                  # as tests/test_torch_vision_mesh.py
F64 = {"param_dtype": "float64", "compute_dtype": "float64"}


def port_cfg(res: int):
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch("resnet-152").make_config(),
                               img_res=res, **F64)


def rank_fn(rank: int, world: int, tmp: str, res: int, accum: int) -> dict:
    """One rank's mesh step from the reference's parameters: the loss,
    the gradient norm, the clipped gradient blocks and the BN statistics
    of each microbatch (the whole microbatch's, as the forward returns
    them)."""
    import torch

    from _torch_dist import tree
    from _torch_vision_mesh import lists
    from repro_torch.convert import to_torch, vision_params_shard
    from repro_torch.data import microbatch_rows
    from repro_torch.distributed import ctx
    from repro_torch.distributed.sharding import (spec_tree,
                                                  vision_train_spec_fn)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_vis_train_step
    from repro_torch.models.resnet import resnet_apply
    from repro_torch.optim.api import named_leaves
    torch.set_num_threads(2)
    cfg = port_cfg(res)
    ctx.init_ranks(rank, world, os.path.join(tmp, "group"), "cpu")
    mesh = make_mesh(MESH, AXES)
    inp = dict(np.load(os.path.join(tmp, "inputs.npz")))
    ref = lists(tree(dict(np.load(os.path.join(tmp, "params.npz")))))
    spec_fn = vision_train_spec_fn("resnet-152", cfg)
    specs = spec_tree(to_torch(ref), spec_fn)
    params = vision_params_shard(ref, mesh, spec_fn)
    rows = microbatch_rows(B_MB * accum, accum, MESH[0],
                           ctx.axes_index(mesh, ("data",)))
    batch = {k: torch.from_numpy(inp[k][rows]) for k in ("images", "labels")}
    per = B_MB // MESH[0]
    stats = []
    with torch.no_grad():
        for i in range(accum):
            _, st = resnet_apply(params, batch["images"][i * per:
                                                         (i + 1) * per],
                                 cfg, train=True, collect_stats=True,
                                 mesh=mesh, specs=specs)
            stats.append([(m.numpy(), v.numpy()) for _, (m, v) in st])
    for _, p in named_leaves(params):
        p.requires_grad_(True)
    kept = {}

    def keep(params, grads, opt, step, layout=None):
        kept.update({k: g.detach().numpy().copy()
                     for k, g in named_leaves(grads)})
        return params, opt
    step = make_vis_train_step("resnet-152", cfg, keep, accum, mesh=mesh,
                               specs=specs)
    _, _, m = step(params, None, batch, 0)
    ctx.close_ranks()
    return {"loss": float(m["loss"]), "gnorm": float(m["gnorm"]),
            "grads": kept, "stats": stats}


def reference(params: dict, inp: dict, res: int, accum: int) -> dict:
    """The reference's ``_vis_cell`` train step in float64, its body from
    the reference's own functions (``_accum_grads``,
    ``clip_by_global_norm``; the forward as ``_vis_cell`` defines it):
    the loss, the gradient norm, the clipped gradients (flat paths) and
    each microbatch's BN statistics."""
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import get_arch, load_all
    from repro.core.distill import ce_loss
    from repro.launch import steps as JS
    from repro.models.resnet import resnet_apply
    from repro.optim import clip_by_global_norm
    load_all()
    cfg = dataclasses.replace(get_arch("resnet-152").make_config(),
                              img_res=res, **F64)

    def loss_fn(p, mb):
        return ce_loss(resnet_apply(p, mb["images"], cfg, train=True)[0],
                       mb["labels"])

    def run(p, batch):
        loss, grads = JS._accum_grads(loss_fn, p, batch, accum)
        grads, gn = clip_by_global_norm(grads, 1.0)
        stats = [[ms for _, ms in resnet_apply(
            p, batch["images"][i * B_MB:(i + 1) * B_MB], cfg, train=True,
            collect_stats=True)[1]] for i in range(accum)]
        return loss, gn, grads, stats
    with jax.enable_x64(True):
        loss, gn, grads, stats = jax.jit(run)(
            jax.tree_util.tree_map(jnp.asarray, params),
            {k: jnp.asarray(v) for k, v in inp.items()})
        flat = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
            flat["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                          for k in path)] = np.asarray(leaf)
        return {"loss": float(loss), "gnorm": float(gn), "grads": flat,
                "stats": [[(np.asarray(m), np.asarray(v)) for m, v in mb]
                          for mb in stats]}


def stats_err(got: list, want: list) -> float:
    worst = 0.0
    for (m, v), (wm, wv) in zip(got, want, strict=True):
        spread = max(float(np.abs(wm).max()), float(np.abs(wv).max()) ** 0.5)
        worst = max(worst, float(np.abs(m - wm).max()) / spread,
                    float(np.abs(v - wv).max()) / float(np.abs(wv).max()))
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--accum", type=int, default=2)
    args = ap.parse_args(argv)
    import torch

    from repro_torch.distributed import ctx
    from repro_torch.distributed.sharding import (block_index, is_spec,
                                                  spec_tree,
                                                  vision_train_spec_fn)
    from repro_torch.models.resnet import resnet_init
    from repro_torch.optim.api import named_leaves
    t0 = time.perf_counter()
    cfg = port_cfg(args.res)
    whole = resnet_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(5)
    B = B_MB * args.accum
    inp = {"images": rng.normal(size=(B, args.res, args.res, 3)),
           "labels": rng.integers(0, cfg.n_classes, B).astype(np.int32)}
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(os.path.join(tmp, "params.npz"),
                 **{k: v.numpy() for k, v in named_leaves(whole)})
        np.savez(os.path.join(tmp, "inputs.npz"), **inp)
        ranks = ctx.spawn_ranks(rank_fn, 4, (tmp, args.res, args.accum),
                                timeout_s=1800)
    t_port = time.perf_counter() - t0
    import jax
    ref = reference(jax.tree_util.tree_map(lambda t: t.numpy(), whole), inp,
                    args.res, args.accum)
    specs = dict(named_leaves(spec_tree(whole, vision_train_spec_fn(
        "resnet-152", cfg)), is_leaf=is_spec))
    # a leaf whose gradient vanishes in exact arithmetic is round-off:
    # held against VANISHING of the tree's largest entry instead
    floor = VANISHING * max(float(np.abs(w).max())
                            for w in ref["grads"].values())
    grad_err = {}
    for rank, r in enumerate(ranks):
        at = {"data": rank // MESH[1], "model": rank % MESH[1]}
        for k, g in r["grads"].items():
            w = ref["grads"][k]
            blk = w[block_index(w.shape, specs[k], SIZES, at)]
            grad_err[k] = max(grad_err.get(k, 0.0), float(
                np.abs(g - blk).max()) / max(float(np.abs(w).max()), floor))
    worst = max(grad_err, key=grad_err.get)
    split = sum(any(e is not None for e in s) for s in specs.values())
    print(json.dumps({
        "res": args.res, "accum": args.accum, "leaves": len(specs),
        "split_leaves": split,
        "loss": ranks[0]["loss"], "loss_ref": ref["loss"],
        "loss_rel": abs(ranks[0]["loss"] - ref["loss"]) / ref["loss"],
        "gnorm": ranks[0]["gnorm"], "gnorm_ref": ref["gnorm"],
        "gnorm_rel": abs(ranks[0]["gnorm"] - ref["gnorm"]) / ref["gnorm"],
        "grad_err": grad_err[worst], "worst_leaf": worst,
        "stats_err": max(stats_err(g, w) for r in ranks
                         for g, w in zip(r["stats"], ref["stats"],
                                         strict=True)),
        "port_s": t_port, "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
