"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Counterpart of the reference ``launch/train.py`` for the vision
transformers, the conv nets, the diffusion nets and the MoE LM on one
card: config registry -> train step -> data pipeline -> checkpoint
manager -> watchdog/straggler monitor -> restart supervisor.  ``--smoke`` runs the
reduced config; ``--sandwich`` is the paper's supernet training of a
vision transformer (max + min + 2 random sub-networks a step with
in-place distillation, masked mode: one graph); without it, the plain
``vis_train`` step (cross entropy of the full net; the conv nets with
batch-statistics BN and SGD with momentum) or, for DiT-L/2 and
UNet-SDXL, the ``diff_train`` step (epsilon-prediction MSE of the
denoiser on seeded latents, noise and timesteps: :func:`diffusionize`,
AdamW) or, for ``deepseek-moe-16b``, the ``_lm_cell`` train step (next-
token cross entropy plus the MoE aux loss on ``synthetic_lm_batches``,
AdamW), over ``--accum`` microbatches (the reference's ``build_cell``
default: 1 for the smoke configs, else ``ACCUM_DEFAULTS``, raised where
one card cannot hold the step: ``ONE_CARD_ACCUM``).  Where one card
cannot hold the model at all, ``steps.ONE_CARD_CUT`` cuts its depth at full
width (the reference's ``cfg_overrides``); the launcher prints both cuts.
qwen1.5-110b, granite-20b and kimi-k2-1t-a32b train at ``--smoke`` only:
at full size they raise before any allocation (ROADMAP item 20).
Parameters are fp32 and the compute dtype is the config's (bf16 at full
size).  The run is on the card unless ``--device cpu``; with no card and
no ``--device cpu`` it raises.

    python -m repro_torch.launch.train --arch dynamic-ofa-supernet \\
        --sandwich --smoke --device cpu --steps 12
    python -m repro_torch.launch.train --arch resnet-152 --smoke \\
        --device cpu --steps 3
    python -m repro_torch.launch.train --arch dit-l2 --smoke \\
        --device cpu --steps 3
    python -m repro_torch.launch.train --arch deepseek-moe-16b --smoke \\
        --device cpu --steps 3
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.configs.registry import ShapeSpec, vision_family
from repro_torch.core.supernet import make_sandwich_step
from repro_torch.data import (Prefetcher, synthetic_image_batches,
                              synthetic_label_batches, synthetic_lm_batches,
                              to_device)
from repro_torch.device import resolve_device, synchronize
from repro_torch.distributed.fault import (SimulatedFailure, StragglerMonitor,
                                           Watchdog, run_with_restarts)
from repro_torch.launch.steps import (ACCUM_DEFAULTS, ONE_CARD_CUT,
                                      make_diff_train_step,
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
# card (its defaults are for a sharded mesh; here fp32 parameters,
# gradients and AdamW moments are whole, 41 GB for UNet-SDXL): UNet-SDXL's
# train_256 step runs out of memory at 2 x 128 and at 4 x 64 (PERF.md,
# cells); deepseek-moe-16b's (cut below) holds 36 GB of state, its
# reference 4 x 64 would need 54 GB for the bf16 logits alone, and 32 x 8
# runs out of memory at the fp32 log-softmax's gradient (PERF.md, cells)
ONE_CARD_ACCUM = {("unet-sdxl", "train_256"): 8,
                  ("deepseek-moe-16b", "train_4k"): 64}
# LMs the port serves on the card but does not train there yet (ROADMAP
# item 20: K2's backward at kimi-k2's head dim 112, their one-card cuts,
# kimi's bf16 Adafactor step); their smoke configs train anywhere
NOT_TRAINED_ON_CARD = ("qwen1.5-110b", "granite-20b", "kimi-k2-1t-a32b")


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
    ap.add_argument("--mesh", choices=("host", "pod", "multipod"),
                    default="host")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step (tests recovery)")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of a multi-process job (not ported)")
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
                  accum: int) -> str:
    """The launcher's line on how the run is cut to one card."""
    B = shape.global_batch
    out = f"{arch_id} {shape.name}: batch {B} as {accum} microbatch" \
          f"{'es' if accum > 1 else ''} of {B // accum}"
    if cut:
        out += ", cut to " + ", ".join(f"{k} {v}" for k, v in cut.items())
        if getattr(cfg, "moe", None) is not None:
            out += (f" ({cfg.n_dense_layers} dense + {cfg.n_moe_layers} "
                    f"MoE)")
    return out


def main(argv=None):
    """Train; returns {"params", "opt", "restarts", "step_ms", "losses"}
    (``step_ms`` and ``losses`` of every step run, restarts included)."""
    args = parse_args(argv)
    if args.mesh != "host" or args.coordinator:
        raise NotImplementedError(
            "multi-device and multi-process training (--mesh pod/multipod, "
            "--coordinator) come with ROADMAP item 11")
    arch = get_arch(args.arch)
    if arch.arch_id in NOT_TRAINED_ON_CARD and not args.smoke:
        raise NotImplementedError(
            f"{arch.arch_id}: training at full size is ROADMAP item 20 (K2's "
            f"backward at head dim 112, a one-card cut, kimi's bf16 "
            f"Adafactor); --smoke trains the reduced config")
    lm = arch.family == "lm"
    diffusion = arch.family == "diffusion"
    fam = arch.family if lm or diffusion else vision_family(arch.arch_id)
    if fam is None:
        raise NotImplementedError(f"{args.arch}: no ported training path")
    if args.sandwich and fam != "vit":
        raise SystemExit("--sandwich: vision-transformer archs only")
    device = resolve_device(args.device)

    cfg = arch.make_smoke() if args.smoke else arch.make_config()
    shape = _shape(arch, args.shape, cfg, args.smoke)
    kind = {"lm": "train", "diffusion": "diff_train"}.get(fam, "vis_train")
    if shape.kind != kind:
        raise ValueError(f"--shape {shape.name} is a {shape.kind} shape")
    if not lm and shape.img_res != cfg.img_res:
        cfg = dataclasses.replace(cfg, img_res=shape.img_res)
    B = shape.global_batch
    key = (arch.arch_id, shape.name)
    accum = args.accum or (1 if args.smoke else ONE_CARD_ACCUM.get(
        key, ACCUM_DEFAULTS.get(key, 1)))
    cut = {} if args.smoke else ONE_CARD_CUT.get(key, {})
    init_fn, update_fn = make_optimizer(arch.optimizer)

    if args.sandwich:
        dims = {"d_model": cfg.d_model, "d_ff": cfg.d_ff,
                "n_heads": cfg.n_heads, "n_layers": cfg.n_layers}

        def apply_fn(p, b, E):
            return vit_apply(p, b["images"], cfg, E=E)[0]
        s_step, s_sample = make_sandwich_step(apply_fn, update_fn, dims)
    elif lm:
        step_fn = make_lm_train_step(cfg, update_fn, accum,
                                     cfg_overrides=cut)
        cfg = step_fn.cfg
    elif diffusion:
        step_fn = make_diff_train_step(arch.arch_id, cfg, update_fn, accum)
    else:
        step_fn = make_vis_train_step(arch.arch_id, cfg, update_fn, accum)
    print(describe_cuts(arch.arch_id, shape, cfg, cut, accum), flush=True)

    def data_at(step):
        if lm:
            return Prefetcher(synthetic_lm_batches(
                global_batch=B, seq_len=shape.seq_len, vocab=cfg.vocab_size,
                start_step=step))
        if diffusion:
            return Prefetcher(diffusion_batches(cfg, B, step))
        return Prefetcher(synthetic_image_batches(
            global_batch=B, img_res=cfg.img_res, n_classes=cfg.n_classes,
            start_step=step))

    manager = CheckpointManager(args.ckpt_dir, save_every=args.save_every,
                                device=device)
    straggler = StragglerMonitor()
    watchdog = Watchdog(timeout_s=600).start()
    step_ms, losses = [], []

    def init_state():
        params = init_params(arch, cfg, device)
        return {"params": params, "opt": init_fn(params)}

    def train(start_step, state):
        state = state or init_state()
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
                    print(f"[straggler] step {step} took {dt:.2f}s")
                manager.maybe_save(step, {"params": params, "opt": opt})
                if step % args.log_every == 0:
                    print(f"step {step:5d} loss {loss:.4f} gnorm "
                          f"{float(metrics['gnorm']):.2f} {dt * 1e3:.0f}ms",
                          flush=True)
        finally:
            data.close()
        manager.wait()
        return {"params": params, "opt": opt}

    try:
        state, restarts = run_with_restarts(train, manager=manager)
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
                   f"GiB")
    print(f"done: {args.steps} steps, {restarts} restarts, straggler flags: "
          f"{len(straggler.flags)}{median} on {device}", flush=True)
    return dict(state, restarts=restarts, step_ms=step_ms, losses=losses)


if __name__ == "__main__":
    main()
