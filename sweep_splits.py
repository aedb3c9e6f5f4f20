#!/usr/bin/env python3
"""Sweep the split plans of K1's small_m, f32_splitk, K2's decode and K3's
stream variants, and the tiles and split plans of K1's tma backward, on
the card.

    python3 sweep_splits.py      # from the repository root, one CUDA card
    python3 sweep_splits.py --backward   # K1's tma dgrad and wgrad only
    python3 sweep_splits.py --router     # K1's f32_splitk only

Times each variant's C launcher at the LM's shapes under every split of K
(K1 at M = 4: K chunks of 64-512 rows; K3 at C = 4 with 24 live experts of
64: chunks of 128-512 rows) or of the cache (K2 at T = 513: 3-17 splits),
as graph-replayed device time per call (20 calls in a CUDA graph, timed
as ``chip_smoke.py`` times), beside the plan the wrappers choose
(``small_m_plan``, ``decode_plan``, ``stream_plan``), the library call
and, for K3, the bound from the live experts' bytes; then
torch.profiler's per-kernel device time of one default call of each (the
main kernel and its reduce or merge kernel apart).  K1's backward at the
sandwich step's shapes (M = 50,432 token rows, the supernet's full
weights and masked widths): wgrad's tma launcher at split counts up to
two waves of (tile, split) blocks, beside the plan ``wgrad_tma_plan``
chooses; dgrad's tma kernel; each beside the ``wmma_bf16`` kernel
before it, ``torch.matmul`` and the bound.  K1's f32_splitk at the fp32
MoE router's prefill shape (M = 2048 tokens, K = 2048, 64 experts, n_act
64 and 32): its 64 x 64 tiles at 1 to 16 splits of K, beside the plan
``f32_splitk_plan`` chooses, the tile loop it replaced, ``torch.matmul``
in fp32 (TF32 off) and the bound.  It checks no result:
``chip_smoke.py`` holds the kernels against their plain versions.
"""
from __future__ import annotations

import ctypes
import math
import os
import sys

REPS = 20


def k1_splits(cs, dev, g, M: int, K: int, N: int) -> None:
    import torch

    from repro_torch.kernels import elastic_matmul as em
    from repro_torch.kernels import ops
    x = torch.randn(M, K, device=dev, generator=g).bfloat16()
    w = torch.randn(K, N, device=dev, generator=g).bfloat16()
    y = torch.empty(M, N, device=dev, dtype=torch.bfloat16)
    wd = ops.widths_tensor(dev, K, N)
    fn = em._launcher("repro_elastic_matmul_small_m")
    out = []
    for kc in (64, 128, 256, 512):
        splits = math.ceil(K / kc)
        ws = torch.empty(splits, M, N, device=dev)

        def go():
            for _ in range(REPS):
                fn(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                   ws.data_ptr() if splits > 1 else None, wd.data_ptr(), M,
                   K, N, N, N, N, splits, kc, 1, 1,
                   torch.cuda.current_stream().cuda_stream)
        ms, _ = cs.graph_time_ms(go)
        out.append(f"kc={kc} splits={splits}: {ms / REPS * 1e3:.2f} us")
    lib = cs.graph_time_ms(lambda: [torch.matmul(x, w)
                                    for _ in range(REPS)])[0]
    print(f"K1 M={M} K={K} N={N}: " + ", ".join(out) + f"; plan "
          f"{em.small_m_plan(K, N, 2)}; matmul {lib / REPS * 1e3:.2f} us")


def k2_splits(cs, dev, g, B: int, H: int, T: int, D: int) -> None:
    import torch

    from repro_torch.kernels import flash_attention as fa
    q = torch.randn(B, 1, H, D, device=dev, generator=g).bfloat16()
    k = torch.randn(B, T, H, D, device=dev, generator=g).bfloat16()
    v = torch.randn(B, T, H, D, device=dev, generator=g).bfloat16()
    o = torch.empty_like(q)
    st = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, o) for s in t.stride()[:3]))
    fn = fa._launcher("repro_flash_attention_decode")
    out = []
    for splits in (1, 2, 3, 5, 9, 17):
        chunk = math.ceil(T / splits)
        if chunk > fa.DECODE_CHUNK_MAX:
            continue
        splits = math.ceil(T / chunk)
        ws = torch.empty(B * H * splits * (D + 2), device=dev)

        def go():
            for _ in range(REPS):
                fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   ws.data_ptr(), B, H, H, T, D, st, 1 / math.sqrt(D),
                   splits, chunk, torch.cuda.current_stream().cuda_stream)
        ms, _ = cs.graph_time_ms(go)
        out.append(f"splits={splits}: {ms / REPS * 1e3:.2f} us")
    lib = cs.graph_time_ms(lambda: [cs.k2_library(q, k, v, causal=False)
                                    for _ in range(REPS)])[0]
    print(f"K2 decode B={B} H={H} T={T} D={D}: " + ", ".join(out)
          + f"; plan {fa.decode_plan(T, B * H)}; sdpa "
          f"{lib / REPS * 1e3:.2f} us")


def k3_stream_splits(cs, dev, g, K: int, F: int) -> None:
    """K3 decode: C = 4, one row on each of 24 live experts of 64."""
    import torch

    from repro_torch.kernels import expert_matmul as xm
    live = torch.randperm(64, generator=torch.Generator().manual_seed(K))
    counts = [0] * 64
    for e in live[:24].tolist():
        counts[e] = 1
    x = torch.randn(64, 4, K, device=dev, generator=g).bfloat16()
    w = (torch.randn(64, K, F, device=dev, generator=g) / K ** 0.5
         ).bfloat16()
    c = torch.tensor(counts, dtype=torch.int32, device=dev)
    bound = cs.kernel_bound_ms(*cs.k3_work((x, w, c), {}))[0]
    y = torch.empty(64, 4, F, device=dev, dtype=torch.bfloat16)
    fn = xm._launcher("repro_expert_matmul_stream")
    out = []
    for kc in (128, 256, 512):
        splits = math.ceil(K / kc)
        ws = torch.empty(splits, 64, 4, F, device=dev)

        def go():
            for _ in range(REPS):
                fn(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                   ws.data_ptr() if splits > 1 else None, c.data_ptr(), 64,
                   4, K, F, *xm.strides(x, w), splits, kc, 1, 1,
                   torch.cuda.current_stream().cuda_stream)
        ms, _ = cs.graph_time_ms(go)
        out.append(f"kc={kc} splits={splits}: {ms / REPS * 1e3:.2f} us")
    lib = cs.graph_time_ms(lambda: [torch.bmm(x, w) for _ in range(REPS)])[0]
    print(f"K3 stream E=64 C=4 K={K} F={F} 24 live: " + ", ".join(out)
          + f"; plan {xm.stream_plan(64, 4, K, F)}; bmm "
          f"{lib / REPS * 1e3:.2f} us; bound {bound * 1e3:.2f} us")


def k1_router_splits(cs, dev, g, M: int = 2048, K: int = 2048,
                     N: int = 64) -> None:
    """K1 f32_splitk at the router's shape: us per call of its launcher at
    each split count, beside the wrapper's plan, the tile loop
    (``tile_f32``), ``torch.matmul`` and the bound (operations at 67
    TFLOP/s fp32)."""
    import torch

    from repro_torch.kernels import elastic_matmul as em
    from repro_torch.kernels import ops
    x = torch.randn(M, K, device=dev, generator=g)
    w = torch.randn(K, N, device=dev, generator=g) / K ** 0.5
    y = torch.empty(M, N, device=dev)
    cnt = em.tile_counters(dev)
    fn = em._launcher("repro_elastic_matmul_f32_splitk")
    tile = em._launcher("repro_elastic_matmul")

    def stream():       # the capturing stream inside graph_time_ms
        return torch.cuda.current_stream().cuda_stream

    def per_call(go):
        return cs.graph_time_ms(lambda: [go() for _ in range(REPS)])[0] \
            / REPS * 1e3
    for n_act in (N, N // 2):
        wd = ops.widths_tensor(dev, K, n_act)
        out = []
        tiles = math.ceil(M / em.F32_SPLITK_BM) \
            * math.ceil(n_act / em.F32_SPLITK_BN)
        for splits in (1, 2, 4, 6, 8, 12, 16):
            kc = math.ceil(math.ceil(K / splits) / em.F32_SPLITK_BK) \
                * em.F32_SPLITK_BK
            sp = math.ceil(K / kc)
            ws = torch.empty(sp, tiles, em.F32_SPLITK_BM * em.F32_SPLITK_BN,
                             device=dev)

            def go(sp=sp, kc=kc, ws=ws):
                rc = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                        ws.data_ptr(), cnt.data_ptr(), wd.data_ptr(), M, K,
                        N, N, N, K, n_act, sp, kc, stream())
                if rc != 0:
                    raise RuntimeError(f"f32_splitk launch failed ({rc})")
            out.append(f"{sp}x{kc}: {per_call(go):.2f} us")
        old = per_call(lambda: tile(x.data_ptr(), w.data_ptr(),
                                    y.data_ptr(), wd.data_ptr(), M, K, N, N,
                                    N, 0, stream()))
        plan = per_call(lambda: ops.elastic_matmul_op(x, w, K, n_act))
        lib = per_call(lambda: torch.matmul(x, w[:, :n_act]))
        bound = cs.kernel_bound_ms(*cs.k1_work((x, w, K, n_act), {}))[0]
        print(f"K1 f32_splitk M={M} K={K} n_act={n_act}: " + ", ".join(out)
              + f"; plan {em.f32_splitk_plan(M, K, n_act)} {plan:.2f} us; "
              f"tile_f32 {old:.2f} us; matmul {lib:.2f} us; bound "
              f"{bound * 1e3:.2f} us", flush=True)


def _wgrad_tma(cs, dev, x, dy, K, N, splits):
    """(us per call, plan) of wgrad's tma launcher at one split count
    (rounded to whole 64-row chunks), at widths (K, N) of x's and dy's
    columns."""
    import torch

    from repro_torch.kernels import elastic_matmul as em
    from repro_torch.kernels import ops
    M = x.shape[0]
    chunk = math.ceil(math.ceil(M / splits) / 64) * 64
    splits = math.ceil(M / chunk)
    bm, bn = em.BWD_TMA_TILE
    tiles = math.ceil(K / bm) * math.ceil(N / bn)
    ws = torch.empty(splits, tiles, bm * bn, device=dev)
    Kw, Nw = x.shape[1], dy.shape[1]
    dw = torch.empty(Kw, Nw, device=dev, dtype=torch.bfloat16)
    wd = ops.widths_tensor(dev, K, N)
    cnt = em.tile_counters(dev)
    fn = em._launcher("repro_elastic_matmul_wgrad_tma")

    def go():
        for _ in range(REPS):
            rc = fn(x.data_ptr(), dy.data_ptr(), ws.data_ptr(), dw.data_ptr(),
                    cnt.data_ptr(), wd.data_ptr(), M, Kw, Nw, Kw, Nw, K, N,
                    Kw, Nw, splits, chunk,
                    torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"wgrad tma launch failed ({rc})")
    return cs.graph_time_ms(go)[0] / REPS * 1e3, (splits, chunk)


def k1_wgrad_plans(cs, dev, g, M: int, Kw: int, Nw: int, K: int,
                   N: int) -> None:
    """K1 wgrad, dw[:K, :N] = x[:, :K]^T dy[:, :N] for a weight (Kw, Nw):
    x (M, Kw) and dy (M, Nw) as the masked-mode layers pass them."""
    import torch

    from repro_torch.kernels import elastic_matmul as em
    from repro_torch.kernels import ops
    x = torch.randn(M, Kw, device=dev, generator=g).bfloat16()
    dy = torch.randn(M, Nw, device=dev, generator=g).bfloat16()
    wd = ops.widths_tensor(dev, K, N)
    out = []
    tiles = math.ceil(K / em.BWD_TMA_TILE[0]) * \
        math.ceil(N / em.BWD_TMA_TILE[1])
    for splits in sorted({2, 3, 4, 6, 8, 11, 14, 18, 22, 26, 33,
                          em.SMS // tiles, 2 * em.SMS // tiles}):
        if 1 <= splits <= 2 * em.SMS // tiles:
            us, plan = _wgrad_tma(cs, dev, x, dy, K, N, splits)
            out.append(f"{plan}: {us:.1f} us")
    chosen = cs.graph_time_ms(lambda: [em.elastic_matmul_wgrad(
        x, dy, wd, K, N, (Kw, Nw)) for _ in range(REPS)])[0]
    old = cs.graph_time_ms(lambda: [em.elastic_matmul_wgrad(
        x, dy, wd, K, N, (Kw, Nw), variant="wmma_bf16")
        for _ in range(REPS)])[0]
    lib = cs.graph_time_ms(lambda: [torch.matmul(x[:, :K].T, dy[:, :N])
                                    for _ in range(REPS)])[0]
    bound = cs.kernel_bound_ms(*cs.k1_wgrad_work(
        (x, dy, wd, K, N, (Kw, Nw)), {}))[0]
    print(f"K1 wgrad M={M} w=({Kw}, {Nw}) k_act={K} n_act={N}: "
          + ", ".join(out)
          + f"; wrapper's plan {em.wgrad_tma_plan(M, K, N)} "
          f"{chosen / REPS * 1e3:.1f} us; "
          f"wmma_bf16 {old / REPS * 1e3:.1f} us; matmul "
          f"{lib / REPS * 1e3:.1f} us; bound {bound * 1e3:.1f} us")


def k1_dgrad_time(cs, dev, g, M: int, K: int, N: int, k_act: int,
                  n_act: int) -> None:
    """K1 dgrad, dx (M, K) = dy[:, :n_act] w[:k_act, :n_act]^T for a
    weight (K, N), zeros past k_act."""
    import torch

    from repro_torch.kernels import elastic_matmul as em
    from repro_torch.kernels import ops
    dy = torch.randn(M, N, device=dev, generator=g).bfloat16()
    w = torch.randn(K, N, device=dev, generator=g).bfloat16()
    wd = ops.widths_tensor(dev, k_act, n_act)
    new, old = (cs.graph_time_ms(lambda v=v: [em.elastic_matmul_dgrad(
        dy, w, wd, k_act, n_act, K, variant=v) for _ in range(REPS)])[0]
        for v in (None, "wmma_bf16"))
    lib = cs.graph_time_ms(lambda: [torch.matmul(
        dy[:, :n_act], w[:k_act, :n_act].T) for _ in range(REPS)])[0]
    bound = cs.kernel_bound_ms(*cs.k1_dgrad_work(
        (dy, w, wd, k_act, n_act, K), {}))[0]
    print(f"K1 dgrad M={M} kx={K} k_act={k_act} n_act={n_act}: tma "
          f"{new / REPS * 1e3:.1f} us; wmma_bf16 {old / REPS * 1e3:.1f} us; "
          f"matmul {lib / REPS * 1e3:.1f} us; bound {bound * 1e3:.1f} us")


def k1_backward(cs, dev, g) -> None:
    """The sandwich step's K1 backward shapes: the supernet's 384 x 384
    (q, k, v, o), 384 x 1536 (wi), 1536 x 384 (wo) and 768 x 384 (patch
    embed) weights at M = 50,432 (50,176 for the patches), and masked
    widths (the min subnet's among them: dgrad of wo at 384 of 1536
    columns writes zeros past them)."""
    M = 256 * 197
    for Kw, Nw, K, N in ((384, 384, 384, 384), (384, 1536, 384, 1536),
                         (1536, 384, 1536, 384), (384, 1536, 288, 1152),
                         (384, 384, 192, 192)):
        k1_wgrad_plans(cs, dev, g, M, Kw, Nw, K, N)
    k1_wgrad_plans(cs, dev, g, 256 * 196, 768, 384, 768, 384)
    for K, N, k_act, n_act in ((384, 384, 384, 384), (384, 1536, 384, 1536),
                               (1536, 384, 1536, 384),
                               (384, 1536, 288, 1152), (384, 384, 192, 192),
                               (1536, 384, 384, 192)):
        k1_dgrad_time(cs, dev, g, M, K, N, k_act, n_act)


def profile_kernels(label: str, fn) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or \
            getattr(e, "self_cuda_time_total", 0)
        if t:
            print(f"  {label}: {e.key[:60]} x{e.count} "
                  f"{t / e.count:.2f} us")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("sweep_splits: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(0, root)
    import chip_smoke as cs

    from repro_torch.kernels import build, ops
    build.build()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.inference_mode():
        if "--backward" not in sys.argv[1:]:
            k1_router_splits(cs, dev, g)
            if "--router" in sys.argv[1:]:
                return 0
        k1_backward(cs, dev, g)
        if "--backward" in sys.argv[1:]:
            return 0
        for M, K, N in ((4, 2048, 2048), (4, 2048, 2816), (4, 2816, 2048)):
            k1_splits(cs, dev, g, M, K, N)
        k2_splits(cs, dev, g, 4, 16, 513, 128)
        for K, F in ((2048, 1408), (1408, 2048)):
            k3_stream_splits(cs, dev, g, K, F)
        x = torch.randn(4, 2048, device=dev, generator=g).bfloat16()
        w = torch.randn(2048, 2048, device=dev, generator=g).bfloat16()
        profile_kernels("k1 2048^2", lambda: ops.elastic_matmul_op(
            x, w, 2048, 2048))
        profile_kernels("matmul 2048^2", lambda: torch.matmul(x, w))
        q = torch.randn(4, 1, 16, 128, device=dev, generator=g).bfloat16()
        kv = torch.randn(4, 513, 16, 128, device=dev, generator=g).bfloat16()
        profile_kernels("k2 decode", lambda: ops.flash_attention_op(
            q, kv, kv, causal=False))
        xe = torch.randn(64, 4, 2048, device=dev, generator=g).bfloat16()
        we = torch.randn(64, 2048, 1408, device=dev, generator=g).bfloat16()
        ce = torch.zeros(64, dtype=torch.int32, device=dev)
        ce[::3] = 1                       # 22 live experts, one row each
        profile_kernels("k3 decode", lambda: ops.expert_matmul_op(
            xe, we, ce))
    return 0


if __name__ == "__main__":
    sys.exit(main())
