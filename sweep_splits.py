#!/usr/bin/env python3
"""Sweep the split plans of K1's small_m, K2's decode and K3's stream
variants on the card.

    python3 sweep_splits.py      # from the repository root, one CUDA card

Times each variant's C launcher at the LM's shapes under every split of K
(K1 at M = 4: K chunks of 64-512 rows; K3 at C = 4 with 24 live experts of
64: chunks of 128-512 rows) or of the cache (K2 at T = 513: 3-17 splits),
as graph-replayed device time per call (20 calls in a CUDA graph, timed
as ``chip_smoke.py`` times), beside the plan the wrappers choose
(``small_m_plan``, ``decode_plan``, ``stream_plan``), the library call
and, for K3, the bound from the live experts' bytes; then
torch.profiler's per-kernel device time of one default call of each (the
main kernel and its reduce or merge kernel apart).  It checks no result:
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
    with torch.inference_mode():
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
