#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each of which fails the run (non-zero exit, no result line):

1. the card's name and power limit, as nvidia-smi reports them;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, all at once) and print the build time and ptxas report;
3. K1 elastic_matmul against its plain version at the serving shapes of the
   full Dynamic-OFA supernet, fp32 and bf16, including widths that are not
   multiples of the tile, with exact zeros past n_act;
4. K2 flash_attention against its plain version: S = T = 197, D = 64,
   BH 6 and 48, non-causal and causal, one GQA case, and the smoke
   configs' head dims (16 and 8);
5. full-config (224 px, 12 layers, d 384) logits of the kernel path against
   the plain path on the card for the max, min and one mid subnet: fp32
   within a stated tolerance, bf16 max-abs error and top-1 agreement;
6. the main path at full width: ``build_server`` on ``make_config()``, the
   measured LUT over the serve launcher's subnets, the governor summaries,
   a ladder warm and 64 requests through the JointGovernor; every future
   answered, zero cold (subnet, bucket) pairs, both kernels' launch
   counters rising while serving, served logits finite and equal to a
   direct forward of the same subnet;
7. each kernel's time over the calls of one full-width forward at bucket 8,
   beside its plain version's time, one PyTorch library call's time (the
   yardstick; the port never calls it) and the bound from bytes and
   operations at the H100 data-sheet peaks.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
rest of the repository beside it, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

# H100 SXM data sheet: bf16 dense tensor-core peak and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BUCKET = 8           # the serve launcher's max batch: the largest bucket
N_REQUESTS = 64
TOL = {"float32": 2e-4, "bfloat16": 2e-2}         # K1, as the ref tests
ATTN_TOL = {"float32": 3e-3, "bfloat16": 3e-2}    # K2, as the ref tests
LOGITS_FP32_TOL = 1e-3   # 12 fp32 layers, logits of order one


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str):
    log(f"\n== {name}")
    return time.perf_counter()


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def close(a, b, tol: float) -> float:
    """Max |a - b|; raises unless |a - b| <= tol + tol*|b| everywhere."""
    import torch
    a, b = a.float(), b.float()
    err = float((a - b).abs().max()) if a.numel() else 0.0
    if not torch.isfinite(a).all() or \
            not bool(((a - b).abs() <= tol + tol * b.abs()).all()):
        raise AssertionError(f"max abs err {err} beyond tolerance {tol}")
    return err


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "src"))
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.core.elastic import spec_to_static
    from repro_torch.core.types import SubnetSpec
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import elastic_matmul as em
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve
    from repro_torch.models.vit import cast_params, vit_apply, vit_init

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)

    t_all = time.perf_counter()
    phase("1. card")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(dev)}")

    phase("2. build kernels")
    logs = build.build(verbose=True)
    log(f"built {sorted(logs)} in {build.build_seconds:.1f} s (parallel nvcc)")
    for name, text in logs.items():
        for line in text.splitlines():
            if re.search(r"Used \d+ registers|spill", line):
                log(f"  {name}: {line.strip()}")

    arch = get_arch("dynamic-ofa-supernet")
    cfg = arch.make_config()
    d, dff, H, Dh = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.d_model // cfg.n_heads
    M = BUCKET * cfg.n_tokens                       # 8 x 197 token rows
    M_patch = BUCKET * (cfg.n_tokens - 1)

    t0 = phase("3. K1 elastic_matmul vs plain at the serving shapes")
    # (label, rows, full weight (K, N), k_act, n_act, n_out): sliced mode
    # (n_out == n_act) at the widths the elastic space produces, and the TPU
    # op's shape (n_out == N) with zeros past n_act
    k1_cases = [
        ("patch", M_patch, (768, d), 768, d, d),
        ("qkv w1-h1", M, (d, d), d, d, d),
        ("wi full", M, (d, dff), d, dff, dff),
        ("wo full", M, (dff, d), dff, d, d),
        ("q w0.5-h0.5", M, (d, d), 192, 192, 192),
        ("q w0.75-h0.75", M, (d, d), 288, 256, 256),
        ("o h0.75-w0.75", M, (d, d), 256, 288, 288),
        ("wi w0.75-f0.75", M, (d, dff), 288, 1152, 1152),
        ("wo f0.25-w0.5", M, (dff, d), 384, 192, 192),
        ("head w0.5", BUCKET, (d, 1000), 192, 1000, 1000),
        ("tpu-shape 129x255", M, (d, dff), 129, 255, dff),
        ("tpu-shape 100x1000", M, (d, dff), 100, 1000, dff),
    ]
    k1_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[str(dtype).split(".")[1]]
        for label, rows, (K, N), ka, na, n_out in k1_cases:
            w = randn(K, N, scale=K ** -0.5, dtype=dtype)
            x = randn(rows, K if n_out == N and n_out != na else ka,
                      dtype=dtype)
            y = ops.elastic_matmul_op(x, w, ka, na, n_out=n_out)
            with ops.plain_kernels():
                yp = ops.elastic_matmul_op(x, w, ka, na, n_out=n_out)
            torch.cuda.synchronize()
            err = close(y, yp, tol)
            if n_out > na and not bool((y[:, na:] == 0).all()):
                raise AssertionError(f"{label}: non-zero past n_act")
            k1_err = max(k1_err, err)
            log(f"  {str(dtype):15s} {label:20s} M={rows:5d} k={ka:4d} "
                f"n={na:4d}/{n_out:4d}  max abs err {err:.3g} (tol {tol})")
    # strided rows: the head reads h[:, 0] of the (B, N, d) tokens in place
    tok = randn(BUCKET, cfg.n_tokens, 192, dtype=torch.bfloat16)
    w = randn(d, 1000, scale=d ** -0.5, dtype=torch.bfloat16)
    y = ops.elastic_matmul_op(tok[:, 0], w, 192, 1000, n_out=1000)
    with ops.plain_kernels():
        yp = ops.elastic_matmul_op(tok[:, 0], w, 192, 1000, n_out=1000)
    k1_err = max(k1_err, close(y, yp, TOL["bfloat16"]))
    log(f"  strided head rows ok; K1 max abs err {k1_err:.3g} "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = phase("4. K2 flash_attention vs plain (S = T = 197, D = 64; "
               "smoke shapes)")
    k2_err = 0.0
    S = cfg.n_tokens
    for dtype in (torch.float32, torch.bfloat16):
        tol = ATTN_TOL[str(dtype).split(".")[1]]
        # (B, S, H, KH, D, causal); the last two are the smoke configs'
        # shapes (ofa smoke: 17 tokens, D 16; deit smoke: 18 tokens, D 8)
        for B, S_, H_, KH, D_, causal in [
                (1, S, H, H, Dh, False), (BUCKET, S, H, H, Dh, False),
                (1, S, H, H, Dh, True), (BUCKET, S, H, H, Dh, True),
                (BUCKET, S, H, 2, Dh, False), (BUCKET, 17, 4, 4, 16, False),
                (BUCKET, 18, 4, 4, 8, False)]:
            # q read in place from a fused (B, S, 2H, D) buffer: strided
            qbuf = randn(B, S_, 2 * H_, D_, scale=0.3, dtype=dtype)
            q = qbuf[:, :, :H_]
            k = randn(B, S_, KH, D_, scale=0.3, dtype=dtype)
            v = randn(B, S_, KH, D_, dtype=dtype)
            o = ops.flash_attention_op(q, k, v, causal=causal)
            with ops.plain_kernels():
                op_ = ops.flash_attention_op(q, k, v, causal=causal)
            torch.cuda.synchronize()
            err = close(o, op_, tol)
            k2_err = max(k2_err, err)
            log(f"  {str(dtype):15s} BH={B * H_:3d} KH={KH} S={S_:3d} D={D_:2d}"
                f" causal={causal!s:5s}  max abs err {err:.3g} (tol {tol})")
    log(f"  K2 max abs err {k2_err:.3g} ({time.perf_counter() - t0:.1f} s)")

    t0 = phase("5. full-config logits: kernel path vs plain path on the card")
    dims = {"d_model": d, "d_ff": dff, "n_heads": H,
            "n_layers": cfg.n_layers}
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    p32 = vit_init(torch.Generator().manual_seed(1), cfg32, device=dev)
    p16 = cast_params(p32, torch.bfloat16)
    imgs = randn(2, cfg.img_res, cfg.img_res, 3)
    mid = SubnetSpec(width_mult=0.75, ffn_mult=0.5, heads_mult=0.75,
                     depth_mult=2.0 / 3.0)
    with torch.inference_mode():
        for name, spec in [("max", cfg.elastic.max_spec()),
                           ("min", cfg.elastic.min_spec()), ("mid", mid)]:
            E = spec_to_static(spec, dims)
            yk, _ = vit_apply(p32, imgs, cfg32, E=E)
            with ops.plain_kernels():
                yp, _ = vit_apply(p32, imgs, cfg32, E=E)
            err32 = close(yk, yp, LOGITS_FP32_TOL)
            yk16, _ = vit_apply(p16, imgs, cfg, E=E)
            with ops.plain_kernels():
                yp16, _ = vit_apply(p16, imgs, cfg, E=E)
            if not torch.isfinite(yk16).all():
                raise AssertionError("non-finite bf16 logits")
            err16 = float((yk16.float() - yp16.float()).abs().max())
            top1 = float((yk16.argmax(-1) == yp16.argmax(-1)).float().mean())
            log(f"  {name} {spec.name():28s} fp32 max abs err {err32:.3g} "
                f"(tol {LOGITS_FP32_TOL}); bf16 max abs err {err16:.3g}, "
                f"top-1 agreement {top1:.2f}")
    del p32, p16
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    t0 = phase("6. main path: full-width server, LUT, governors, 64 requests")
    em.launches = fa.launches = 0
    server = serve.build_server(arch, cfg, max_batch=BUCKET, device="cuda")
    x = torch.randn((BUCKET, cfg.img_res, cfg.img_res, 3),
                    generator=torch.Generator().manual_seed(2)).numpy()
    specs, governors, base_ms = serve.profile(server, cfg, x)
    server.warm(specs, example_input=x[0])
    before = (em.launches, fa.launches)
    outs = serve.serve_requests(server, governors["joint (paper)"], base_ms,
                                x[0], N_REQUESTS)
    launches = {"elastic_matmul": em.launches,
                "flash_attention": fa.launches}
    serving = (em.launches - before[0], fa.launches - before[1])
    answered = [o for o in outs if not o.get("cancelled")]
    if len(answered) != N_REQUESTS:
        raise AssertionError(f"{N_REQUESTS - len(answered)} requests not "
                             f"answered")
    if server.cold_compiles != 0:
        raise AssertionError(f"cold compiles {server.cold_compiles}")
    if min(serving) <= 0:
        raise AssertionError(f"kernels not launched while serving: {serving}")
    by_name = {s.name(): s for s in specs}
    o = answered[-1]
    y = torch.from_numpy(o["y"])
    direct = server.infer(x[:1], by_name[o["subnet"]])[0].float().cpu()
    if y.shape != (1000,) or not torch.isfinite(y).all():
        raise AssertionError(f"bad served logits {tuple(y.shape)}")
    err_served = close(y, direct, 3e-2)
    log(f"  launches on the main path: {launches}; while serving: "
        f"elastic_matmul {serving[0]}, flash_attention {serving[1]}")
    log(f"  served logits vs direct forward of {o['subnet']}: max abs err "
        f"{err_served:.3g}; cold compiles {server.cold_compiles}")
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    t0 = phase("7. kernel times over one full-width forward at bucket 8 "
               "(bf16)")
    bf = torch.bfloat16
    # (label, calls per forward, rows, K, N): the 74 K1 calls of a forward
    k1_calls = [("patch", 1, M_patch, 768, d), ("qkvo", 4 * cfg.n_layers, M,
                                                 d, d),
                ("wi", cfg.n_layers, M, d, dff), ("wo", cfg.n_layers, M, dff, d),
                ("head", 1, BUCKET, d, 1000)]
    k1 = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
          "bytes_s": 0.0, "ops_s": 0.0}
    for label, n, rows, K, N in k1_calls:
        xx = randn(rows, K, dtype=bf)
        ww = randn(K, N, scale=K ** -0.5, dtype=bf)
        wv = ww[:K, :N]
        t_k = cuda_time_ms(lambda: ops.elastic_matmul_op(xx, ww, K, N,
                                                         n_out=N))
        t_p = cuda_time_ms(lambda: em.elastic_matmul_plain(xx, ww, K, N, N))
        t_l = cuda_time_ms(lambda: torch.matmul(xx, wv))
        b = 2 * (rows * K + K * N + rows * N) / HBM_BYTES_PER_S * 1e3
        f = 2 * rows * K * N / PEAK_BF16_FLOPS * 1e3
        for key, t in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l),
                       ("bound_ms", max(b, f)), ("bytes_s", b), ("ops_s", f)):
            k1[key] += n * t
        log(f"  K1 {label:5s} x{n:3d} M={rows:5d} K={K:4d} N={N:4d}: "
            f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms, torch.matmul "
            f"{t_l:.4f} ms, bound {max(b, f):.4f} ms "
            f"({'bytes' if b >= f else 'operations'})")
    q = randn(BUCKET, S, H, Dh, scale=0.3, dtype=bf)
    k = randn(BUCKET, S, H, Dh, scale=0.3, dtype=bf)
    v = randn(BUCKET, S, H, Dh, dtype=bf)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    n = cfg.n_layers
    t_k = cuda_time_ms(lambda: ops.flash_attention_op(q, k, v, causal=False))
    t_p = cuda_time_ms(lambda: fa.flash_attention_plain(q, k, v,
                                                        causal=False))
    t_l = cuda_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    b = 4 * BUCKET * S * H * Dh * 2 / HBM_BYTES_PER_S * 1e3
    f = 4 * BUCKET * H * S * S * Dh / PEAK_BF16_FLOPS * 1e3
    log(f"  K2 x{n} BH={BUCKET * H} S=T={S} D={Dh}: kernel {t_k:.4f} ms, "
        f"plain {t_p:.4f} ms, sdpa {t_l:.4f} ms, bound {max(b, f):.4f} ms "
        f"({'bytes' if b >= f else 'operations'})")
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    record = {"kernels": [
        {"name": "elastic_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/elastic_matmul.cu",
         "replaces": "src/repro/kernels/elastic_matmul.py:68",
         "launches": launches["elastic_matmul"], "max_abs_err": k1_err,
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"],
         "bound_by": "bytes" if k1["bytes_s"] >= k1["ops_s"] else "operations",
         "library_ms": k1["library_ms"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:71",
         "launches": launches["flash_attention"], "max_abs_err": k2_err,
         "ms": n * t_k, "plain_ms": n * t_p, "bound_ms": n * max(b, f),
         "bound_by": "bytes" if b >= f else "operations",
         "library_ms": n * t_l},
    ]}
    log(f"\ncard: {card}; total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
