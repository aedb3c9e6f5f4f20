"""Elastic LM serving: the paper's knobs applied to the registry's LMs.

``python -m repro_torch.launch.elastic_moe [--arch ID] [--smoke]
[--device cpu]``

The port's counterpart of the reference's ``examples/elastic_moe.py``,
for every LM of the registry (``--arch``: deepseek-moe-16b, the default,
kimi-k2-1t-a32b, qwen1.5-110b or granite-20b).  An MoE LM runs at five
operating points of the elastic space — full, half the experts, top-1
routing, half the expert width, and the min subnet (all three plus half
the depth); a dense LM at five points of its ``cfg.elastic`` — full, half
the FFN, the fewest heads, half the depth and the min subnet — and each
point's prefill latency is printed next to its analytic FLOPs relative to
full, the table a governor would use to serve the LM under a latency
target.  Then it decodes a few teacher-forced steps at the points the
reference can decode (not at a sliced depth or head count: fault F4).

One card cannot hold qwen1.5-110b or kimi-k2-1t-a32b in bf16, so off
``--smoke`` they are cut in depth at full width (``steps.ONE_CARD_CUT``,
printed): qwen to 8 of its 80 layers, kimi to 2 of its 61 (the dense
first layer and one MoE layer); the depth points then halve the cut's
depth.  granite-20b and deepseek-moe-16b run whole.

Weights are random from ``--seed``, drawn on the device in the compute
dtype (the routers stay fp32).  Every dense product runs on the elastic
matmul, attention on flash attention and every routed expert product on
the expert-gated matmul; ``--device cpu`` runs their plain versions.  On
the card each point's prefill and decode step run as CUDA graphs
(:class:`repro_torch.launch.steps.LMGraphs`, captured before the timing),
and the times are of graph replays.

``--mesh DATAxMODEL`` serves the LM across DATA x MODEL ranks, as the
reference's ``dryrun --moe-dispatch a2a`` does on its mesh: the MoE
layers on the expert-parallel ``a2a`` dispatch (the routed experts split
over ``model``), decode against a cache sharded over the sequence
(``decode_impl="sharded"``: the two-pass softmax, K2's ``decode`` kernel
with its logsumexp), everything else replicated.  The kernels are built
once here, then one process a rank is spawned (each draws the weights
leaf by leaf from the seed and keeps its block: the one-process draws);
NCCL when each rank has a card, gloo when they share one (or on the CPU,
``--device cpu``).  The mesh path runs eagerly; only rank 0 prints, with
the share of routed slots the capacity kept beside each time.  Off
``--smoke`` deepseek-moe-16b runs whole (28 layers) on two ranks of one
H100; the LMs cut for one card (``ONE_CARD_CUT``) keep that cut.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time
from typing import Optional

import torch

from repro_torch.configs import get_arch
from repro_torch.device import resolve_device, synchronize
from repro_torch.distributed import ctx
from repro_torch.distributed.sharding import layer_serving_spec, shard_leaf
from repro_torch.kernels.ops import launch_counts, variant_counts
from repro_torch.launch.flops import lm_model_flops
from repro_torch.launch.mesh import make_mesh, parse_mesh
from repro_torch.launch.steps import (ONE_CARD_CUT, LMGraphs, lm_decode,
                                      lm_prefill)
from repro_torch.models.moe import dispatch_tally
from repro_torch.models.transformer import LMConfig, lm_init

# seconds the ranks of ``--mesh`` may take in all before the run fails
MESH_TIMEOUT_S = 3600.0

def one_card(arch_id: str, cfg: LMConfig) -> LMConfig:
    """``cfg`` with the arch's one-card serving cut applied
    (``steps.ONE_CARD_CUT[(arch_id, "serve")]``; unchanged if none)."""
    return dataclasses.replace(cfg, **ONE_CARD_CUT.get((arch_id, "serve"),
                                                       {}))


def fewest_heads(cfg: LMConfig) -> int:
    """``n_heads x min(heads_mults)``, rounded to whole GQA groups."""
    KH = cfg.n_kv_heads
    h = max(1, int(round(cfg.n_heads * min(cfg.elastic.heads_mults))))
    if KH < cfg.n_heads:
        h = max(KH, h // KH * KH)
    return min(h, cfg.n_heads)


def operating_points(cfg: LMConfig) -> list:
    """(name, E, decodable) for the five points of the reference example,
    scaled to the config: an MoE LM's experts, top-k and expert width; a
    dense LM's FFN width, heads and depth from ``cfg.elastic`` (the heads
    and depth points prefill only: fault F4)."""
    m = cfg.moe
    half_l = max(1, cfg.n_layers // 2)
    if m is None:
        sp = cfg.elastic
        half_f = cfg.d_ff // 2
        min_f = max(1, int(round(cfg.d_ff * min(sp.ffn_mults))))
        min_l = max(1, int(round(cfg.n_layers * min(sp.depth_mults))))
        heads = fewest_heads(cfg)
        return [
            (f"full ({cfg.n_heads}h f{cfg.d_ff})", {}, True),
            ("half FFN", {"a_ff": half_f}, True),
            (f"fewest heads ({heads})", {"a_heads": heads}, False),
            ("half depth", {"a_layers": half_l}, False),
            ("min subnet", {"a_ff": min_f, "a_heads": heads,
                            "a_layers": min_l}, False),
        ]
    half_e, half_f = m.n_experts // 2, m.d_ff // 2
    return [
        (f"full ({m.n_experts}e top{m.top_k} f{m.d_ff})", {}, True),
        ("half experts", {"a_experts": half_e}, True),
        ("top-1 routing", {"top_k": 1}, True),
        ("half expert width", {"a_ff": half_f}, True),
        ("min subnet", {"a_experts": half_e, "top_k": 1, "a_ff": half_f,
                        "a_layers": half_l}, False),
    ]


def rel_flops(cfg: LMConfig, E: dict, B: int, S: int) -> float:
    """Analytic prefill FLOPs at ``E`` over those of the full model."""
    m = cfg.moe
    c2 = dataclasses.replace(cfg, n_layers=E.get("a_layers", cfg.n_layers))
    if m is not None:
        c2 = dataclasses.replace(c2, moe=dataclasses.replace(
            m, top_k=E.get("top_k", m.top_k),
            n_experts=E.get("a_experts", m.n_experts),
            d_ff=E.get("a_ff", m.d_ff)))
    else:
        H = E.get("a_heads", cfg.n_heads)
        c2 = dataclasses.replace(
            c2, d_ff=E.get("a_ff", cfg.d_ff), n_heads=H,
            n_kv_heads=H if cfg.n_kv_heads == cfg.n_heads
            else cfg.n_kv_heads)
    return (lm_model_flops(c2, "prefill", B, S)
            / lm_model_flops(cfg, "prefill", B, S))


def timed(fn, device: torch.device, iters: int):
    """(mean wall-clock ms over ``iters`` calls after one warm-up call,
    the last result); each call ends in a device sync."""
    ms, _, out = timed_events(fn, device, iters)
    return ms, out


def _events(device: torch.device):
    """A pair of timing events on the card, None on the CPU."""
    if device.type != "cuda":
        return None
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def _event_ms(pairs) -> Optional[float]:
    """Mean ms between the recorded (start, end) event pairs (after a
    sync); None on the CPU."""
    pairs = [p for p in pairs if p is not None]
    if not pairs:
        return None
    return sum(a.elapsed_time(b) for a, b in pairs) / len(pairs)


def timed_events(fn, device: torch.device, iters: int):
    """:func:`timed` with the mean ms between CUDA events recorded on the
    stream around each timed call (device time for a graph replay; for an
    eager call it also holds the device's wait for the host's launches):
    (wall ms, event ms or None on the CPU, last result)."""
    out = fn()
    synchronize(device)
    pairs = []
    t0 = time.perf_counter()
    for _ in range(iters):
        ev = _events(device)
        if ev is not None:
            ev[0].record()
        out = fn()
        if ev is not None:
            ev[1].record()
        pairs.append(ev)
        synchronize(device)
    wall = (time.perf_counter() - t0) / iters * 1e3
    return wall, _event_ms(pairs), out


def _since(before: dict) -> dict:
    now = launch_counts()
    return {k: now[k] - before[k] for k in now}


def _variants_since(before: dict) -> dict:
    now = variant_counts()
    return {k: {v: n - before[k][v] for v, n in per.items()}
            for k, per in now.items()}


def mesh_config(cfg: LMConfig) -> LMConfig:
    """``cfg`` as the mesh path serves it: the a2a dispatch and the
    sequence-sharded decode (the reference's dryrun overrides)."""
    moe = cfg.moe and dataclasses.replace(cfg.moe, dispatch="a2a")
    return dataclasses.replace(cfg, moe=moe, decode_impl="sharded")


def rank_shard(mesh):
    """``lm_init``'s ``shard``: a copy of this rank's block of each leaf
    whose placement splits it (so the whole leaf can be freed), the leaf
    itself otherwise."""
    def cut(path, t):
        spec = layer_serving_spec(path, tuple(t.shape))
        if all(e is None for e in spec):
            return t
        return shard_leaf(t, spec, mesh).clone()
    return cut


def kept_share(tally, mesh) -> Optional[float]:
    """The share of routed slots the capacity kept in ``tally``'s
    dispatches, summed over every rank of ``mesh`` (where each rank
    counts every slot, as the decode's dispatch does, the share is the
    same)."""
    kept, routed = tally.counts()
    if mesh is not None:
        t = torch.tensor([float(kept), float(routed)],
                         device=ctx.rank_device())
        ctx.all_reduce(t, "sum", ctx.axes_group(mesh, mesh.mesh_dim_names))
        kept, routed = float(t[0]), float(t[1])
    return kept / routed if routed else None


def run(params: dict, cfg: LMConfig, tokens: torch.Tensor, prefill_len: int,
        *, iters: int = 3, graphs: Optional[bool] = None, mesh=None) -> list:
    """Prefill ``tokens[:, :prefill_len]`` at every operating point, then
    decode the remaining tokens teacher-forced at the decodable ones.

    ``graphs`` (default: on the card) runs both as CUDA graphs, captured
    per point before anything is timed or counted; a decodable point's
    prefill graph also fills the static decode caches, and its decode
    steps replay one graph.  Returns one dict per point: name, E,
    rel_flops, logits (last prefill position), prefill_ms, prefill_tok_s,
    prefill_launches and prefill_variants (kernel launches, in all and by
    variant, over the 1 + ``iters`` prefills), prefill_event_ms, and for
    decodable points decode_ms (mean wall per step), decode_event_ms,
    decode_tok_s, decode_logits ((steps, B, V)), decode_launches and
    decode_variants (both over the steps alone).  The event times are
    means between CUDA events around each prefill and each step (device
    time for graph replays; None on the CPU).  With graphs, the last row
    also carries ``graph_pool_bytes``.  Eager runs also carry
    ``prefill_kept`` and ``decode_kept``: the share of routed slots the
    capacity kept (None for a dense LM).  ``mesh``: this rank's part of a
    mesh run (eager; every rank calls ``run`` alike)."""
    device = tokens.device
    B, total = tokens.shape
    steps = total - prefill_len
    prompt = tokens[:, :prefill_len]
    if graphs is None:
        graphs = device.type == "cuda" and mesh is None
    if graphs and mesh is not None:
        raise ValueError("run: a mesh run is eager (gloo's collectives "
                         "cannot be captured in a CUDA graph)")
    lm = LMGraphs(params, cfg, B, prefill_len, total, device) \
        if graphs else None
    rows = []
    with torch.inference_mode():
        for name, E, decodable in operating_points(cfg):
            fills = decodable and steps > 0
            if lm is not None:
                lm.capture(E, decodable=fills)
                prefill = lambda: lm.prefill(prompt, E, decodable=fills)
            else:
                prefill = lambda: lm_prefill(params, prompt, cfg, E=E,
                                             mesh=mesh)
            c0, v0 = launch_counts(), variant_counts()
            with dispatch_tally() as tally:
                ms, ev_ms, last = timed_events(prefill, device, iters)
            row = {"name": name, "E": E, "logits": last, "prefill_ms": ms,
                   "prefill_event_ms": ev_ms,
                   "prefill_tok_s": B * prefill_len / ms * 1e3,
                   "prefill_launches": _since(c0),
                   "prefill_variants": _variants_since(v0),
                   "rel_flops": rel_flops(cfg, E, B, prefill_len)}
            if lm is None:
                row["prefill_kept"] = kept_share(tally, mesh)
            if fills:
                if lm is None:
                    _, caches = lm_prefill(params, prompt, cfg, E=E,
                                           max_len=total, mesh=mesh)
                    step = lambda t: lm_decode(params, caches, t, cfg,
                                               E=E, mesh=mesh)[0]
                else:      # the timed prefills filled the static caches
                    step = lambda t: lm.decode(t, E)
                outs, pairs = [], []
                synchronize(device)
                c0, v0 = launch_counts(), variant_counts()
                t0 = time.perf_counter()
                with dispatch_tally() as tally:
                    for t in range(prefill_len, total):
                        ev = _events(device)
                        if ev is not None:
                            ev[0].record()
                        outs.append(step(tokens[:, t:t + 1]))
                        if ev is not None:
                            ev[1].record()
                        pairs.append(ev)
                    synchronize(device)
                row["decode_event_ms"] = _event_ms(pairs)
                row["decode_ms"] = (time.perf_counter() - t0) / steps * 1e3
                row["decode_tok_s"] = B / row["decode_ms"] * 1e3
                row["decode_launches"] = _since(c0)
                row["decode_variants"] = _variants_since(v0)
                row["decode_logits"] = torch.stack(outs)
                if lm is None:
                    row["decode_kept"] = kept_share(tally, mesh)
            rows.append(row)
    if lm is not None:
        rows[-1]["graph_pool_bytes"] = lm.pool_bytes()
    return rows


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-moe-16b",
                    help="any LM of the registry: deepseek-moe-16b, "
                         "kimi-k2-1t-a32b, qwen1.5-110b, granite-20b "
                         "(off --smoke the last three but granite are cut "
                         "in depth to fit one card: ONE_CARD_CUT)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the card) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and tokens")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prefill-len", type=int, default=None,
                    help="prompt length (default 32 smoke, 512 full)")
    ap.add_argument("--decode-steps", type=int, default=4)
    ap.add_argument("--iters", type=int, default=3,
                    help="timed prefills per point, after one warm-up")
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL (e.g. 1x2): serve across that many "
                         "ranks (a2a expert dispatch, sequence-sharded "
                         "decode cache)")
    return ap.parse_args(argv)


def serving_config(args) -> tuple:
    """(full config, the config served, prompt length) of ``args``."""
    arch = get_arch(args.arch)
    if arch.family != "lm":
        raise SystemExit("elastic_moe: LM archs only")
    full = arch.make_config()
    cfg = arch.make_smoke() if args.smoke else one_card(arch.arch_id, full)
    if args.mesh:
        cfg = mesh_config(cfg)
    return full, cfg, args.prefill_len or (32 if args.smoke else 512)


def header(args, full: LMConfig, cfg: LMConfig, S: int, where: str) -> None:
    depth = f"{cfg.n_layers}L"
    if not args.smoke and cfg.n_layers < full.n_layers:
        depth = (f"{cfg.n_layers} of {full.n_layers} layers (one-card cut, "
                 f"full width)")
    kind = (f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k} "
            f"(+{cfg.moe.n_shared} shared)" if cfg.moe else
            f"dense, {cfg.n_heads} heads on {cfg.n_kv_heads} kv")
    print(f"{cfg.name}: {depth}, {kind}, {cfg.compute_dtype}, on {where}")
    print(f"prefill {args.batch} x {S} tokens, then {args.decode_steps} "
          f"teacher-forced decode steps\n")


def _share(x) -> str:
    return "n/a" if x is None else f"{100 * x:.1f}%"


def report(rows: list, args) -> bool:
    """Print the table of ``rows`` (the kept shares beside the times where
    the run counted them); returns whether every logit is finite."""
    kept = "prefill_kept" in rows[0]
    print(f"{'operating point':24s} {'prefill':>10s} {'tok/s':>10s} "
          f"{'rel flops':>10s} {'decode/step':>12s}"
          + (f" {'kept (prefill, decode)':>24s}" if kept else ""))
    for r in rows:
        dec = (f"{r['decode_ms']:10.2f}ms" if "decode_ms" in r
               else f"{'n/a (F4)':>12s}")
        ks = (f" {_share(r['prefill_kept']):>12s}"
              f" {_share(r.get('decode_kept')):>11s}" if kept else "")
        print(f"{r['name']:24s} {r['prefill_ms']:8.2f}ms "
              f"{r['prefill_tok_s']:10.0f} {r['rel_flops']:9.2f}x {dec}{ks}")
    full = rows[0]
    per = lambda d, n: {k: v // n for k, v in d.items()}
    print(f"\nkernel launches at {full['name']}: per prefill "
          f"{per(full['prefill_launches'], 1 + args.iters)}"
          + (f", per decode step "
             f"{per(full['decode_launches'], args.decode_steps)}"
             if "decode_launches" in full else ""))
    finite = all(bool(torch.isfinite(r["logits"]).all()) for r in rows)
    print(f"all logits finite: {finite}")
    return finite


def serve_rank(rank: int, world: int, init_file: str, argv) -> dict:
    """One rank of ``--mesh``: bring the rank up, draw the weights keeping
    its block, run every operating point; rank 0 prints.  Returns the
    rank's summary (plain values)."""
    args = parse_args(argv)
    _, cfg, S = serving_config(args)
    nd, nm = parse_mesh(args.mesh)
    dev = ctx.init_ranks(rank, world, init_file, args.device)
    mesh = make_mesh((nd, nm), ("data", "model"))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = lm_init(gen, cfg, device=dev, dtype=cfg.cdtype(),
                     shard=rank_shard(mesh))
    tokens = torch.randint(0, cfg.vocab_size,
                           (args.batch, S + args.decode_steps),
                           generator=gen, device=dev)
    rows = run(params, cfg, tokens, S, iters=args.iters, mesh=mesh)
    finite = report(rows, args) if rank == 0 else all(
        bool(torch.isfinite(r["logits"]).all()) for r in rows)
    return {"finite": finite, "points": [
        {k: r.get(k) for k in ("name", "prefill_ms", "decode_ms",
                               "prefill_kept", "decode_kept")}
        for r in rows]}


def main_mesh(args, argv) -> list:
    """``--mesh``: build the kernels here, then spawn the ranks."""
    full, cfg, S = serving_config(args)
    nd, nm = parse_mesh(args.mesh)
    world = nd * nm
    device = resolve_device(args.device)
    if device.type == "cuda":
        from repro_torch.kernels import build
        build.build()
        n = torch.cuda.device_count()
        where = (f"{world} ranks on {min(world, n)} x "
                 f"{torch.cuda.get_device_name(device)}")
    else:
        where = f"{world} ranks on the CPU"
    header(args, full, cfg, S, f"{where}, mesh {nd} x {nm} (data, model)")
    with tempfile.TemporaryDirectory() as tmp:
        out = ctx.spawn_ranks(serve_rank, world,
                              (os.path.join(tmp, "rendezvous"), argv),
                              timeout_s=MESH_TIMEOUT_S)
    if not all(r["finite"] for r in out):
        raise SystemExit(1)
    return out


def main(argv=None):
    args = parse_args(argv)
    if args.mesh:
        main_mesh(args, list(sys.argv[1:] if argv is None else argv))
        return
    full, cfg, S = serving_config(args)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = lm_init(gen, cfg, device=device, dtype=cfg.cdtype())
    tokens = torch.randint(0, cfg.vocab_size,
                           (args.batch, S + args.decode_steps),
                           generator=gen, device=device)
    where = str(device) + (f" ({torch.cuda.get_device_name(device)})"
                           if device.type == "cuda" else "")
    header(args, full, cfg, S, where)
    rows = run(params, cfg, tokens, S, iters=args.iters)
    if not report(rows, args):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
