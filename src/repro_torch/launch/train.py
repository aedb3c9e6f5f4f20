"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Counterpart of the reference ``launch/train.py`` for the vision
transformers, the conv nets, the diffusion nets and the LMs on one
card: config registry -> train step -> data pipeline -> checkpoint
manager -> watchdog/straggler monitor -> restart supervisor.  ``--smoke`` runs the
reduced config; ``--sandwich`` is the paper's supernet training of a
vision transformer (max + min + 2 random sub-networks a step with
in-place distillation, masked mode: one graph); without it, the plain
``vis_train`` step (cross entropy of the full net; the conv nets with
batch-statistics BN and SGD with momentum) or, for DiT-L/2 and
UNet-SDXL, the ``diff_train`` step (epsilon-prediction MSE of the
denoiser on seeded latents, noise and timesteps: :func:`diffusionize`,
AdamW) or, for an LM, the ``_lm_cell`` train step (next-
token cross entropy plus the MoE aux loss on ``synthetic_lm_batches``,
with the arch's optimizer: AdamW, Adafactor for kimi-k2-1t-a32b), over
``--accum`` microbatches (the reference's ``build_cell`` default: 1 for
the smoke configs, else ``ACCUM_DEFAULTS``, raised where one card cannot
hold the step: ``ONE_CARD_ACCUM``), the gradients summed in fp32.  Where
one card cannot hold the model at all, ``steps.ONE_CARD_CUT`` cuts its
depth at full width (the reference's ``cfg_overrides``: the LMs
deepseek-moe-16b, qwen1.5-110b, granite-20b and kimi-k2-1t-a32b); the
launcher prints both cuts.  Parameters take the config's ``param_dtype``
(fp32, bf16 for kimi-k2-1t-a32b at full size) and the compute dtype is
the config's (bf16 at full size).  The run is on the card unless
``--device cpu``; with no card and no ``--device cpu`` it raises.

``--mesh DATAxMODEL`` trains an LM or a vision net across a (data,
model) mesh: the ranks spawned on this host (the kernels built once,
here, first), each holding its blocks of the parameters and optimizer
state under the reference's placement (the LMs: TP and FSDP,
``distributed.sharding.train_spec_fn``; the vision family: its
``vision_rules``, TP and conv channels over ``"model"`` with no FSDP,
``vision_train_spec_fn``, batch norm over the whole microbatch), its rows
of each microbatch, and its checkpoint blocks (``rank<k>/``).
``--coordinator host:port --num-processes N
--process-id k`` runs one rank of a job of N processes instead (TCP
rendezvous); ``--mesh pod`` and ``multipod`` (the production 16 x 16
and 2 x 16 x 16 meshes) need them, with N the mesh's size, and raise
before any allocation otherwise; such a rank takes a card of its own
unless ``LOCAL_WORLD_SIZE`` says how many ranks share its host.  Where
the ranks on a host share a card (or the CPU), ``steps.SHARED_CARD_CUT``
cuts the depth, the global batch and its microbatches; where each rank
has a card, the whole model trains at the reference's microbatches
(:func:`step_cuts`); the launcher prints the cuts.  A batch that the
batch shards do not divide raises (the reference would split the image
height instead); the diffusion family (ROADMAP item 11 (d)) and
``--sandwich`` train on one card only.

    python -m repro_torch.launch.train --arch dynamic-ofa-supernet \\
        --sandwich --smoke --device cpu --steps 12
    python -m repro_torch.launch.train --arch resnet-152 --smoke \\
        --device cpu --steps 3
    python -m repro_torch.launch.train --arch dit-l2 --smoke \\
        --device cpu --steps 3
    python -m repro_torch.launch.train --arch deepseek-moe-16b --smoke \\
        --device cpu --steps 3
    python -m repro_torch.launch.train --arch deepseek-moe-16b --smoke \\
        --device cpu --steps 3 --mesh 2x2
    python -m repro_torch.launch.train --arch kimi-k2-1t-a32b --steps 2
    python -m repro_torch.launch.train --arch granite-20b --mesh 1x2
    python -m repro_torch.launch.train --arch resnet-152 --mesh 2x2
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import statistics
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.configs.registry import ShapeSpec, vision_family
from repro_torch.core.supernet import make_sandwich_step
from repro_torch.data import (Prefetcher, microbatch_rows,
                              synthetic_image_batches,
                              synthetic_label_batches, synthetic_lm_batches,
                              to_device)
from repro_torch.device import resolve_device, synchronize
from repro_torch.distributed import ctx
from repro_torch.distributed.fault import (SimulatedFailure, StragglerMonitor,
                                           Watchdog, run_with_restarts)
from repro_torch.distributed.sharding import (is_spec, opt_specs_like,
                                              shard_leaf, shard_tree,
                                              spec_tree, train_spec_fn,
                                              vision_train_spec_fn)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import PRODUCTION, make_mesh, mesh_spec
from repro_torch.launch.steps import (ACCUM_DEFAULTS, ONE_CARD_CUT,
                                      SHARED_CARD_CUT, make_diff_train_step,
                                      make_lm_train_step, make_vis_train_step)
from repro_torch.models.dit import dit_init
from repro_torch.models.efficientnet import effnet_init
from repro_torch.models.resnet import resnet_init
from repro_torch.models.transformer import lm_init
from repro_torch.models.unet import unet_init
from repro_torch.models.vit import vit_apply, vit_init
from repro_torch.optim import make_optimizer
from repro_torch.optim.api import named_leaves

# microbatches a step where the reference's default does not fit one 80 GB
# card (its defaults are for a sharded mesh; here the parameters,
# gradients and optimizer state are whole, 41 GB for UNet-SDXL):
# UNet-SDXL's train_256 step runs out of memory at 2 x 128 and at 4 x 64
# (PERF.md, cells); deepseek-moe-16b's (cut by ONE_CARD_CUT) holds 36 GB of
# state, its reference 4 x 64 would need 54 GB for the bf16 logits alone,
# and 32 x 8 runs out of memory at the fp32 log-softmax's gradient; the
# other LMs' cuts hold 23-62 GB of state, and one sequence's fp32
# log-softmax and its gradient take 2 x 2.49 GB at qwen's vocabulary
# (152064), 2 x 0.81 GB at granite's and 2 x 2.68 GB at kimi's (PERF.md,
# cells)
ONE_CARD_ACCUM = {("unet-sdxl", "train_256"): 8,
                  ("deepseek-moe-16b", "train_4k"): 64,
                  ("qwen1.5-110b", "train_4k"): 256,
                  ("granite-20b", "train_4k"): 64,
                  ("kimi-k2-1t-a32b", "train_4k"): 64}
MESH_TIMEOUT_S = 3600.0


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None, help="e.g. cls_224")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--sandwich", action="store_true",
                    help="sandwich-rule supernet training (paper technique)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--save-every", type=int, default=50,
                    help="checkpoint every N steps (step 0 too); 0: never "
                         "(a restart then starts again from step 0)")
    ap.add_argument("--mesh", default="host",
                    help="host (one process), pod, multipod, or DATAxMODEL "
                         "(e.g. 2x2: the ranks spawned on this host)")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step (tests recovery)")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of a multi-process job's rendezvous: "
                         "this process is one rank of --mesh")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--accum", type=int, default=None,
                    help="microbatches a step (default: the reference's, "
                         "or ONE_CARD_ACCUM's)")
    return ap.parse_args(argv)


def init_params(arch, cfg, device) -> dict:
    """The reference's ``_init_params``: each family's init from seed 0,
    drawn on the host for the vision archs and on ``device`` for the
    diffusion nets and the LM (UNet-SDXL's 2.56 B parameters take long to
    draw on the host)."""
    if arch.family == "lm":
        return lm_init(torch.Generator(device=device).manual_seed(0), cfg,
                       device=device)
    if arch.family == "diffusion":
        init = dit_init if arch.arch_id.startswith("dit") else unet_init
        gen = torch.Generator(device=device).manual_seed(0)
        return init(gen, cfg, device=device)
    gen = torch.Generator().manual_seed(0)
    init = {"vit": vit_init, "resnet": resnet_init,
            "effnet": effnet_init}[vision_family(arch.arch_id)]
    return init(gen, cfg, device=device)


def diffusionize(batch: dict, cfg, step: int) -> dict:
    """The reference's ``_diffusionize``: a batch with ``labels`` -> the
    diffusion batch {"latents", "noise", "t", "cond"} as numpy arrays,
    seeded by the step, byte for byte the reference's: latents (B, r, r,
    4) and noise at the config's latent resolution r, t in [0, 1000),
    and ``cond`` {"ctx" (B, 77, ctx_dim), "pooled"} for the UNet or
    {"y": the labels} for DiT."""
    rng = np.random.default_rng((7, step))
    labels = batch["labels"]
    B = labels.shape[0]
    res = cfg.latent_res
    lat = rng.normal(size=(B, res, res, 4)).astype(np.float32)
    out = {"latents": lat,
           "noise": rng.normal(size=lat.shape).astype(np.float32),
           "t": rng.integers(0, 1000, B).astype(np.int32)}
    if hasattr(cfg, "ctx_dim"):
        out["cond"] = {
            "ctx": rng.normal(size=(B, 77, cfg.ctx_dim)).astype(np.float32),
            "pooled": rng.normal(size=(B, cfg.pooled_dim)).astype(np.float32)}
    else:
        out["cond"] = {"y": labels}
    return out


def diffusion_batches(cfg, global_batch: int, start_step: int):
    """The diffusion launcher's stream: the reference's image stream's
    labels (its ``n_classes``: the config's, else 10) through
    :func:`diffusionize` at each step."""
    labels = synthetic_label_batches(
        global_batch=global_batch, n_classes=getattr(cfg, "n_classes", 10),
        start_step=start_step)
    for step, batch in enumerate(labels, start_step):
        yield diffusionize(batch, cfg, step)


def _shape(arch, name, cfg, smoke: bool) -> ShapeSpec:
    name = name or next(n for n, s in arch.shapes.items() if "train" in s.kind)
    shape = arch.shape(name)
    if smoke:   # the reference's reduced-shape smoke variant (batch 2)
        shape = dataclasses.replace(
            shape, global_batch=min(shape.global_batch, 2),
            seq_len=min(shape.seq_len, 64) if shape.seq_len else 0,
            img_res=cfg.img_res if shape.img_res else 0)
    return shape


def describe_cuts(arch_id: str, shape: ShapeSpec, cfg, cut: dict,
                  accum: int, full_batch: Optional[int] = None) -> str:
    """The launcher's line on how the run is cut to one card (or to ranks
    sharing one: ``full_batch``, the shape's batch before the cut)."""
    B = shape.global_batch
    out = f"{arch_id} {shape.name}: batch {B} as {accum} microbatch" \
          f"{'es' if accum > 1 else ''} of {B // accum}"
    if cut:
        out += ", cut to " + ", ".join(f"{k} {v}" for k, v in cut.items())
        if getattr(cfg, "moe", None) is not None:
            out += (f" ({cfg.n_dense_layers} dense + {cfg.n_moe_layers} "
                    f"MoE)")
    if full_batch not in (None, B):
        out += f"; the global batch cut from {full_batch}"
    return out


def mesh_request(args):
    """(shape, axes) of the mesh ``--mesh`` asks for, None for one
    process.  Raises, before anything is allocated, for a production mesh
    without a coordinator or a job whose processes do not make the
    mesh."""
    if args.mesh == "host":
        if args.coordinator:
            raise ValueError("--coordinator starts one rank of a mesh: give "
                             "its --mesh (pod, multipod or DATAxMODEL)")
        return None
    shape, axes = mesh_spec(args.mesh)
    world = math.prod(shape)
    if args.coordinator is None:
        if args.mesh in PRODUCTION:
            raise ValueError(
                f"--mesh {args.mesh} spans {world} processes: run each with "
                f"--coordinator host:port --num-processes {world} "
                f"--process-id k")
        return shape, axes
    if args.num_processes != world or args.process_id is None \
            or not 0 <= args.process_id < world:
        raise ValueError(
            f"--mesh {args.mesh} is {world} ranks: --num-processes "
            f"{args.num_processes} and --process-id {args.process_id} do "
            f"not make it")
    return shape, axes


def main(argv=None):
    """Train; returns {"params", "opt", "restarts", "step_ms", "losses"}
    (``step_ms`` and ``losses`` of every step run, restarts included), or
    under ``--mesh`` one dict a rank (:func:`train_rank`)."""
    args = parse_args(argv)
    arch = get_arch(args.arch)
    if args.mesh != "host" or args.coordinator:
        if arch.family == "diffusion":
            raise NotImplementedError(
                f"{arch.arch_id}: training under a mesh is ported for the "
                f"LMs and the vision family; the diffusion family is the "
                f"second half of ROADMAP item 11 (d)")
        if args.sandwich:
            raise NotImplementedError(
                "--sandwich under a mesh: the reference jits its sandwich "
                "step with no shardings (ROADMAP §3); train it on one card")
    req = mesh_request(args)
    if req is None:
        return run(args, arch)
    argv = list(sys.argv[1:] if argv is None else argv)
    world = math.prod(req[0])
    if args.coordinator:
        return [train_rank(args.process_id, world, args.coordinator, argv)]
    if resolve_device(args.device).type == "cuda":
        from repro_torch.kernels import build
        build.build()           # once, before the ranks load it
    with tempfile.TemporaryDirectory() as tmp:
        return ctx.spawn_ranks(train_rank, world,
                               (os.path.join(tmp, "rendezvous"), argv),
                               timeout_s=MESH_TIMEOUT_S)


def train_rank(rank: int, world: int, rendezvous: str, argv) -> dict:
    """One rank of ``--mesh``: joins the job, builds the mesh and trains
    its blocks.  Returns plain values: its losses, step times, restarts,
    peak device memory and kernel launches (by variant)."""
    args = parse_args(argv)
    shape, axes = mesh_request(args)
    ctx.init_ranks(rank, world, rendezvous, resolve_device(args.device).type,
                   local_world=ctx.local_world_size(world,
                                                    bool(args.coordinator)))
    mesh = make_mesh(shape, axes)
    ops.reset_launch_counts()
    out = run(args, get_arch(args.arch), mesh=mesh)
    dev = ctx.rank_device()
    return {"rank": rank, "restarts": out["restarts"],
            "step_ms": out["step_ms"], "losses": out["losses"],
            "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                         if dev.type == "cuda" else None),
            "launches": ops.launch_counts(),
            "variants": ops.variant_counts()}


def step_cuts(key, global_batch: int, args, shared) -> tuple:
    """(config cut, global batch, microbatches) of a run of ``key`` (arch,
    shape): none at ``--smoke``; on one card ``ONE_CARD_CUT`` (and its
    ``global_batch``, where an entry holds one) and ``ONE_CARD_ACCUM``;
    under a mesh (``shared`` not None) whose ranks share a card
    ``SHARED_CARD_CUT``'s depth, batch and microbatches (else one card's);
    under a mesh of a card a rank, the whole model at the reference's
    microbatches.  ``--accum`` overrides the microbatches."""
    if args.smoke:
        return {}, global_batch, args.accum or 1
    if shared and key in SHARED_CARD_CUT:
        cut = dict(SHARED_CARD_CUT[key])
        B, accum = cut.pop("global_batch"), cut.pop("accum")
        return cut, B, args.accum or accum
    if shared is False:
        return {}, global_batch, args.accum or ACCUM_DEFAULTS.get(key, 1)
    cut = dict(ONE_CARD_CUT.get(key, {}))
    return (cut, cut.pop("global_batch", global_batch),
            args.accum or ONE_CARD_ACCUM.get(key, ACCUM_DEFAULTS.get(key, 1)))


def check_batch_split(arch_id: str, B: int, accum: int,
                      n_batch: int) -> None:
    """Raise where a vision batch of ``B`` images as ``accum``
    microbatches does not split over ``n_batch`` batch shards: the
    reference's ``_image_spec`` would split the image height instead
    (GSPMD halo-exchanges the convs), which the port does not."""
    if B % (accum * n_batch):
        raise ValueError(
            f"{arch_id}: a batch of {B} as {accum} microbatches does not "
            f"split over {n_batch} batch shards (the reference would split "
            f"the image height instead: ROADMAP §3)")


def mesh_state(cfg, mesh, spec_fn, init_fn, device, arch=None) -> tuple:
    """(state, specs): this rank's blocks of the parameters (drawn from
    seed 0 as one process draws them, each whole leaf cut to a contiguous
    copy of its block by ``spec_fn`` of its whole shape: an LM's leaf by
    leaf, a vision net's, ``arch``, whole first) and their optimizer
    state, and the tree of the parameters' specs."""
    if arch is not None and arch.family != "lm":
        whole = init_params(arch, cfg, device)
        specs = spec_tree(whole, spec_fn)
        params = shard_tree(whole, mesh, spec_fn=spec_fn, own=True)
        del whole
        return {"params": params, "opt": init_fn(params)}, specs
    gen = torch.Generator(device=device).manual_seed(0)
    placed = {}

    def cut(path, t):
        placed[path] = spec_fn(path, tuple(t.shape))
        return shard_leaf(t, placed[path], mesh, own=True)
    params = lm_init(gen, cfg, device=device, shard=cut)
    return ({"params": params, "opt": init_fn(params)},
            spec_tree(params, lambda path, _: placed[path]))


def _state_specs(state, pspecs) -> dict:
    """{path: spec} of a training state's leaves (``params/...`` by the
    placement, ``opt/s/...`` by ``opt_specs_like``), for its
    checkpoint."""
    ospecs = opt_specs_like(pspecs, state["opt"], state["params"])
    flat = {}
    for prefix, tree in (("params", pspecs), ("opt", ospecs)):
        for path, sp in named_leaves(tree, is_leaf=is_spec):
            flat[f"{prefix}/{path}"] = sp
    return flat


def run(args, arch, mesh=None) -> dict:
    """The training run of one process, or of one rank of ``mesh``."""
    lm = arch.family == "lm"
    diffusion = arch.family == "diffusion"
    fam = arch.family if lm or diffusion else vision_family(arch.arch_id)
    if fam is None:
        raise NotImplementedError(f"{args.arch}: no ported training path")
    if args.sandwich and fam != "vit":
        raise SystemExit("--sandwich: vision-transformer archs only")
    device = resolve_device(args.device) if mesh is None \
        else ctx.rank_device()
    rank0 = mesh is None or torch.distributed.get_rank() == 0

    def say(msg):
        if rank0:
            print(msg, flush=True)

    cfg = arch.make_smoke() if args.smoke else arch.make_config()
    shape = _shape(arch, args.shape, cfg, args.smoke)
    kind = {"lm": "train", "diffusion": "diff_train"}.get(fam, "vis_train")
    if shape.kind != kind:
        raise ValueError(f"--shape {shape.name} is a {shape.kind} shape")
    if not lm and shape.img_res != cfg.img_res:
        cfg = dataclasses.replace(cfg, img_res=shape.img_res)
    cut, B, accum = step_cuts(
        (arch.arch_id, shape.name), shape.global_batch, args,
        None if mesh is None else ctx.ranks_share_card())
    init_fn, update_fn = make_optimizer(arch.optimizer)

    spec_fn = specs = None
    drawn = []              # the blocks drawn for the specs, used first
    if args.sandwich:
        dims = {"d_model": cfg.d_model, "d_ff": cfg.d_ff,
                "n_heads": cfg.n_heads, "n_layers": cfg.n_layers}

        def apply_fn(p, b, E):
            return vit_apply(p, b["images"], cfg, E=E)[0]
        s_step, s_sample = make_sandwich_step(apply_fn, update_fn, dims)
    elif lm:
        if cut:
            cfg = dataclasses.replace(cfg, **cut)
        if mesh is not None:
            # the experts' dispatch across the mesh is the all-to-all one
            # (the reference's a2a; its einsum dispatch is GSPMD's)
            if cfg.moe is not None:
                cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                    cfg.moe, dispatch="a2a"))
            spec_fn = train_spec_fn(cfg)
            state, specs = mesh_state(cfg, mesh, spec_fn, init_fn, device)
            drawn.append(state)
        step_fn = make_lm_train_step(cfg, update_fn, accum, mesh=mesh,
                                     specs=specs)
    elif diffusion:
        step_fn = make_diff_train_step(arch.arch_id, cfg, update_fn, accum)
    else:
        if mesh is not None:
            check_batch_split(arch.arch_id, B, accum, mesh.size()
                              // ctx.axes_size(mesh, ("model",)))
            spec_fn = vision_train_spec_fn(arch.arch_id, cfg)
            state, specs = mesh_state(cfg, mesh, spec_fn, init_fn, device,
                                      arch)
            drawn.append(state)
        step_fn = make_vis_train_step(arch.arch_id, cfg, update_fn, accum,
                                      mesh=mesh, specs=specs)
    line = describe_cuts(arch.arch_id, dataclasses.replace(
        shape, global_batch=B), cfg, cut, accum, shape.global_batch)
    if mesh is not None:
        per = B // accum // (mesh.size() // ctx.axes_size(mesh, ("model",)))
        moe = getattr(cfg, "moe", None)
        line += (f"; mesh {' x '.join(map(str, mesh.mesh.shape))} "
                 f"({', '.join(mesh.mesh_dim_names)}), {per} "
                 f"row{'s' if per != 1 else ''} of each microbatch a data "
                 f"block"
                 + (", a2a expert dispatch" if moe is not None else "")
                 + (", ranks sharing one card" if ctx.ranks_share_card()
                    and device.type == "cuda" else ""))
    say(line)

    rows = None
    if mesh is not None:
        b_axes = tuple(a for a in mesh.mesh_dim_names if a != "model")
        rows = microbatch_rows(B, accum, ctx.axes_size(mesh, b_axes),
                               ctx.axes_index(mesh, b_axes))

    def data_at(step):
        if lm:
            return Prefetcher(synthetic_lm_batches(
                global_batch=B, seq_len=shape.seq_len, vocab=cfg.vocab_size,
                start_step=step, rows=rows))
        if diffusion:
            return Prefetcher(diffusion_batches(cfg, B, step))
        return Prefetcher(synthetic_image_batches(
            global_batch=B, img_res=cfg.img_res, n_classes=cfg.n_classes,
            start_step=step, rows=rows))

    def init_state():
        if mesh is not None:
            return mesh_state(cfg, mesh, spec_fn, init_fn, device, arch)[0]
        params = init_params(arch, cfg, device)
        return {"params": params, "opt": init_fn(params)}

    shard = group = None
    if mesh is not None:
        import torch.distributed as dist
        # the restart agreement reads CPU tensors: a gloo group
        group = (dist.group.WORLD if ctx.rank_backend() == "gloo"
                 else dist.new_group(backend="gloo"))
        shard = {"mesh": mesh, "specs": _state_specs(drawn[0], specs),
                 "group": group}
    manager = CheckpointManager(args.ckpt_dir, save_every=args.save_every,
                                device=device, shard=shard)
    straggler = StragglerMonitor()
    watchdog = Watchdog(timeout_s=600).start()
    step_ms, losses = [], []

    def train(start_step, state):
        state = state or (drawn.pop() if drawn else init_state())
        params, opt = state["params"], state["opt"]
        for _, p in named_leaves(params):
            p.requires_grad_(True)
        data = data_at(start_step)
        rng = np.random.default_rng(start_step)
        try:
            for step in range(start_step, args.steps):
                batch = to_device(next(data), device)
                t0 = time.perf_counter()
                if args.fail_at is not None and step == args.fail_at:
                    args.fail_at = None  # only once
                    raise SimulatedFailure(f"injected at step {step}")
                if args.sandwich:
                    E_stack = s_sample(cfg.elastic, rng)
                    params, opt, metrics = s_step(params, opt, batch, E_stack,
                                                  step)
                else:
                    params, opt, metrics = step_fn(params, opt, batch, step)
                loss = float(metrics["loss"])       # waits for the step
                synchronize(device)
                dt = time.perf_counter() - t0
                step_ms.append(dt * 1e3)
                losses.append(loss)
                watchdog.beat()
                if straggler.record(step, dt):
                    say(f"[straggler] step {step} took {dt:.2f}s")
                manager.maybe_save(step, {"params": params, "opt": opt})
                if step % args.log_every == 0:
                    say(f"step {step:5d} loss {loss:.4f} gnorm "
                        f"{float(metrics['gnorm']):.2f} {dt * 1e3:.0f}ms")
        finally:
            data.close()
        manager.wait()
        return {"params": params, "opt": opt}

    try:
        state, restarts = run_with_restarts(train, manager=manager,
                                            group=group, logger=say)
    finally:
        watchdog.stop()
    steady = step_ms[1:] or step_ms
    per_step, unit = (B * shape.seq_len, "tokens") if lm else (B, "images")
    median = (f"; step {statistics.median(steady):.1f} ms (median after the "
              f"first), {per_step / statistics.median(steady) * 1e3:.1f} "
              f"{unit}/s" if steady else "")
    if device.type == "cuda":
        median += (f", peak device memory "
                   f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} "
                   f"GiB" + (" (rank 0)" if mesh is not None else ""))
    say(f"done: {args.steps} steps, {restarts} restarts, straggler flags: "
        f"{len(straggler.flags)}{median} on {device}")
    return dict(state, restarts=restarts, step_ms=step_ms, losses=losses)


if __name__ == "__main__":
    main()
