"""Elastic MoE LM: the paper's knobs applied to a Mixture-of-Experts LM.

``python -m repro_torch.launch.elastic_moe [--smoke] [--device cpu]``

The port's counterpart of the reference's ``examples/elastic_moe.py``:
it runs ``deepseek-moe-16b`` (or its smoke config) at five operating
points of the elastic space — full, half the experts, top-1 routing, half
the expert width, and the min subnet (all three plus half the depth) —
and prints each point's prefill latency next to its analytic FLOPs
relative to full, the table a governor would use to serve an MoE LM under
a latency target.  Then it decodes a few teacher-forced steps at the
points the reference can decode (not at a sliced depth: fault F4).

Weights are random from ``--seed``, drawn on the device in the compute
dtype (the routers stay fp32).  Every dense product runs on the elastic
matmul, attention on flash attention and every routed expert product on
the expert-gated matmul; ``--device cpu`` runs their plain versions.  On
the card each point's prefill and decode step run as CUDA graphs
(:class:`repro_torch.launch.steps.LMGraphs`, captured before the timing),
and the times are of graph replays.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch.configs import get_arch
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels.ops import launch_counts, variant_counts
from repro_torch.launch.flops import lm_model_flops
from repro_torch.launch.steps import LMGraphs, lm_decode, lm_prefill
from repro_torch.models.transformer import LMConfig, lm_init


def operating_points(cfg: LMConfig) -> list:
    """(name, E, decodable) for the five points of the reference example,
    scaled to the config."""
    m = cfg.moe
    half_e, half_f, half_l = m.n_experts // 2, m.d_ff // 2, cfg.n_layers // 2
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
    c2 = dataclasses.replace(
        cfg, n_layers=E.get("a_layers", cfg.n_layers),
        moe=dataclasses.replace(m, top_k=E.get("top_k", m.top_k),
                                n_experts=E.get("a_experts", m.n_experts),
                                d_ff=E.get("a_ff", m.d_ff)))
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


def run(params: dict, cfg: LMConfig, tokens: torch.Tensor, prefill_len: int,
        *, iters: int = 3, graphs: Optional[bool] = None) -> list:
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
    also carries ``graph_pool_bytes``."""
    device = tokens.device
    B, total = tokens.shape
    steps = total - prefill_len
    prompt = tokens[:, :prefill_len]
    if graphs is None:
        graphs = device.type == "cuda"
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
                prefill = lambda: lm_prefill(params, prompt, cfg, E=E)
            c0, v0 = launch_counts(), variant_counts()
            ms, ev_ms, last = timed_events(prefill, device, iters)
            row = {"name": name, "E": E, "logits": last, "prefill_ms": ms,
                   "prefill_event_ms": ev_ms,
                   "prefill_tok_s": B * prefill_len / ms * 1e3,
                   "prefill_launches": _since(c0),
                   "prefill_variants": _variants_since(v0),
                   "rel_flops": rel_flops(cfg, E, B, prefill_len)}
            if fills:
                if lm is None:
                    _, caches = lm_prefill(params, prompt, cfg, E=E,
                                           max_len=total)
                    step = lambda t: lm_decode(params, caches, t, cfg,
                                               E=E)[0]
                else:      # the timed prefills filled the static caches
                    step = lambda t: lm.decode(t, E)
                outs, pairs = [], []
                synchronize(device)
                c0, v0 = launch_counts(), variant_counts()
                t0 = time.perf_counter()
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
            rows.append(row)
    if lm is not None:
        rows[-1]["graph_pool_bytes"] = lm.pool_bytes()
    return rows


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-moe-16b")
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
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    arch = get_arch(args.arch)
    if arch.family != "lm" or arch.make_config().moe is None:
        raise SystemExit("elastic_moe: MoE LM archs only")
    cfg = arch.make_smoke() if args.smoke else arch.make_config()
    device = resolve_device(args.device)
    S = args.prefill_len or (32 if args.smoke else 512)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = lm_init(gen, cfg, device=device, dtype=cfg.cdtype())
    tokens = torch.randint(0, cfg.vocab_size,
                           (args.batch, S + args.decode_steps),
                           generator=gen, device=device)
    where = str(device) + (f" ({torch.cuda.get_device_name(device)})"
                           if device.type == "cuda" else "")
    print(f"{cfg.name}: {cfg.n_layers}L, {cfg.moe.n_experts} experts "
          f"top-{cfg.moe.top_k} (+{cfg.moe.n_shared} shared), "
          f"{cfg.compute_dtype}, on {where}")
    print(f"prefill {args.batch} x {S} tokens, then {args.decode_steps} "
          f"teacher-forced decode steps\n")
    rows = run(params, cfg, tokens, S, iters=args.iters)
    print(f"{'operating point':24s} {'prefill':>10s} {'tok/s':>10s} "
          f"{'rel flops':>10s} {'decode/step':>12s}")
    for r in rows:
        dec = (f"{r['decode_ms']:10.2f}ms" if "decode_ms" in r
               else f"{'n/a (F4)':>12s}")
        print(f"{r['name']:24s} {r['prefill_ms']:8.2f}ms "
              f"{r['prefill_tok_s']:10.0f} {r['rel_flops']:9.2f}x {dec}")
    full = rows[0]
    per = lambda d, n: {k: v // n for k, v in d.items()}
    print(f"\nkernel launches at {full['name']}: per prefill "
          f"{per(full['prefill_launches'], 1 + args.iters)}"
          + (f", per decode step "
             f"{per(full['decode_launches'], args.decode_steps)}"
             if "decode_launches" in full else ""))
    finite = all(bool(torch.isfinite(r["logits"]).all()) for r in rows)
    print(f"all logits finite: {finite}")
    if not finite:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
