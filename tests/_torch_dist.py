"""The port's side of ``tests/test_torch_distributed.py``: one function a
rank runs (in a process of its own, spawned by
``repro_torch.distributed.ctx.spawn_ranks``), importing torch and the
port only.  Every scenario reads the reference's parameters and the
test's inputs from ``.npz`` files and returns numpy arrays.
"""
import dataclasses
import os

import numpy as np
import torch

from repro_torch.convert import lm_params_shard, to_torch
from repro_torch.core import layers as TL
from repro_torch.distributed import ctx
from repro_torch.distributed.decode_attn import cache_axes
from repro_torch.distributed.sharding import serving_spec, shard_leaf
from repro_torch.launch.mesh import (make_host_mesh, make_mesh,
                                     make_production_mesh)
from repro_torch.launch.steps import lm_decode, lm_prefill
from repro_torch.models import moe as TM

# decode attention: d_model, query heads, kv heads, head dim, slots, steps
D_MODEL, H, KH, DH, SLOTS, STEPS = 32, 8, 4, 8, 16, 4
# fill before the first step, by batch: the writes cross a shard boundary
# (8 slots a shard at B = 16, 4 at B = 4) and a shard starts with no key
DECODE_FILL = {16: 6, 4: 5}
LM_S, LM_T, LM_STEPS = 8, 12, 4


def tree(flat: dict) -> dict:
    """{"a/b/c": array} -> nested dicts."""
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _decode(p, mesh, inp, B):
    """4 sharded decode steps from this rank's block of the cache."""
    seq, bat = cache_axes(mesh, B)
    n_s, n_b = ctx.axes_size(mesh, seq), ctx.axes_size(mesh, bat)
    s0 = ctx.axes_index(mesh, seq) * SLOTS // n_s
    b0 = ctx.axes_index(mesh, bat) * B // n_b
    rows, slots = slice(b0, b0 + B // n_b), slice(s0, s0 + SLOTS // n_s)
    k = torch.from_numpy(inp[f"dec{B}_k"][rows, slots].copy())
    v = torch.from_numpy(inp[f"dec{B}_v"][rows, slots].copy())
    cache = TL.kv_cache_of(k, v, DECODE_FILL[B])
    x = torch.from_numpy(inp[f"dec{B}_x"])
    ys = []
    for t in range(STEPS):
        y, cache = TL.attention_apply(
            p, x[:, t:t + 1], n_heads=H, n_kv=KH, d_head=DH,
            rope_theta=10000.0, kv_cache=cache, decode_impl="sharded",
            mesh=mesh)
        ys.append(y)
    return {f"dec{B}_y": torch.cat(ys, 1).numpy(),
            f"dec{B}_kblock": cache["k"].numpy(),
            f"dec{B}_vblock": cache["v"].numpy(),
            f"dec{B}_at": np.array([b0, s0]),
            f"dec{B}_len": np.array([int(cache["len"]), cache["fill"]])}


MOE_CASES = {"pre": ("x", {}), "pre_knobs": ("x", {"a_experts": 6,
                                                  "top_k": 1, "a_ff": 8}),
             "dec": ("x1", {}), "dec_knobs": ("x1", {"a_experts": 6,
                                                    "top_k": 1, "a_ff": 8})}


def _moe(pm, cfg, mesh, inp):
    out = {}
    for name, (xk, knobs) in MOE_CASES.items():
        with TM.dispatch_tally() as tally:
            y, aux = TM.moe_apply(pm, torch.from_numpy(inp[f"moe_{xk}"]),
                                  cfg, mesh=mesh, **knobs)
        out[f"moe_{name}_y"] = y.numpy()
        out[f"moe_{name}_aux"] = np.array(float(aux))
        out[f"moe_{name}_kept"] = np.array(tally.counts())
    roomy = dataclasses.replace(cfg, capacity_factor=8.0)
    out["moe_roomy_y"] = TM.moe_apply(pm, torch.from_numpy(inp["moe_x"]),
                                      roomy, mesh=mesh)[0].numpy()
    return out


def _lm(ref, cfg, mesh, inp):
    params = lm_params_shard(ref, mesh)
    toks = torch.from_numpy(inp["lm_tokens"]).long()
    last, caches = lm_prefill(params, toks[:, :LM_S], cfg, max_len=LM_T,
                              mesh=mesh)
    outs = [lm_decode(params, caches, toks[:, i:i + 1], cfg, mesh=mesh)[0]
            for i in range(LM_S, LM_S + LM_STEPS)]
    return {"lm_prefill": last.numpy(),
            "lm_decode": torch.stack(outs, 1).numpy()}


def dist_rank(rank: int, world: int, init_dir: str, inputs: str,
              ref_params: str, moe_cfg: dict, lm_cfg) -> dict:
    torch.manual_seed(0)
    inp = dict(np.load(inputs))
    ref = tree(dict(np.load(ref_params)))
    out = {}
    ctx.init_ranks(rank, world, os.path.join(init_dir, "mesh22"), "cpu")
    with torch.inference_mode():
        mesh = make_mesh((2, 2), ("data", "model"))
        host = make_host_mesh()
        out["host_mesh"] = np.array(host.mesh.shape)
        out["host_axes"] = np.array(host.mesh_dim_names)
        for multi_pod in (False, True):
            try:
                make_production_mesh(multi_pod=multi_pod)
            except ValueError as e:
                out[f"production_{multi_pod}"] = np.array(str(e))
        p = to_torch(ref["attn"])
        for B in DECODE_FILL:
            out.update(_decode(p, mesh, inp, B))
        cfg = TM.MoEConfig(**moe_cfg)
        pm = {k: (to_torch(v) if isinstance(v, dict) else torch.from_numpy(
            shard_leaf(v, serving_spec(f"x/moe/{k}", v.shape), mesh).copy()))
            for k, v in ref["moe"].items()}
        out.update(_moe(pm, cfg, mesh, inp))
    ctx.close_ranks()
    if rank < 2:            # the LM on a (1, 2) mesh: ranks 0 and 1 alone
        ctx.init_ranks(rank, 2, os.path.join(init_dir, "mesh12"), "cpu")
        with torch.inference_mode():
            mesh = make_mesh((1, 2), ("data", "model"))
            out.update(_lm(ref["lm"], lm_cfg, mesh, inp))
        ctx.close_ranks()
    return out


def fails_on_rank_one(rank: int, world: int) -> int:
    if rank == 1:
        raise ValueError("rank one")
    return rank
