"""The PyTorch port's LM pieces, the deepseek-moe LM, its prefill and its
decode against the JAX reference.

Params come from the reference initialisers (converted by
``repro_torch.convert``), inputs from seeded numpy generators; both sides
run in fp32 on the CPU (the port's kernels as their plain versions).
Tolerances: 1e-4 for single layers (outputs of order one; the frameworks
sum in different orders) and 2e-4 for the 4-layer smoke LM's logits.
Decode is compared with prefill only with the capacity factor raised to
100: capacity drops depend on how tokens are grouped, so a decode step
and a prefill of the same tokens drop different slots (ROADMAP.md §3).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import deepseek_moe_16b as j_ds  # noqa: E402
from repro.core import layers as JL  # noqa: E402
from repro.launch import flops as jflops  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_caches, lm_params, to_torch  # noqa: E402
from repro_torch.core import layers as TL  # noqa: E402
from repro_torch.launch import elastic_moe, flops as tflops  # noqa: E402
from repro_torch.launch.steps import lm_decode, lm_prefill  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(0)
TOL = 1e-4
LM_TOL = 2e-4
SMOKE = j_ds.make_smoke()


def _torch_cfg(jcfg, smoke=True):
    """The port's deepseek config, checked field by field against ``jcfg``."""
    arch = get_arch("deepseek-moe-16b")
    t = arch.make_smoke() if smoke else arch.make_config()
    for f in dataclasses.fields(jcfg):
        a, b = getattr(t, f.name), getattr(jcfg, f.name)
        if f.name in ("elastic", "moe"):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f.name
    return t


TSMOKE = _torch_cfg(SMOKE)
POINTS = elastic_moe.operating_points(TSMOKE)


def _params(p):
    return to_torch(jax.tree_util.tree_map(np.asarray, p))


def _x(shape, seed=0):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


# --- layers ---------------------------------------------------------------------

@pytest.mark.parametrize("a", [None, 24])
def test_rmsnorm_matches_jax(a):
    pj = {"scale": jax.random.normal(KEY, (40,))}
    xj, xt = _x((2, 5, a or 40), seed=1)
    _close(TL.rmsnorm_apply(_params(pj), xt, a=a, eps=1e-6),
           JL.rmsnorm_apply(pj, xj, a=a, eps=1e-6))


@pytest.mark.parametrize("a", [None, 16])
def test_embedding_matches_jax(a):
    pj = JL.embedding_init(KEY, 50, 32)
    ids = np.random.default_rng(2).integers(0, 50, size=(3, 7))
    pt = _params(pj)
    _close(TL.embedding_apply(pt, torch.from_numpy(ids), a=a,
                              dtype=torch.float32),
           JL.embedding_apply(pj, jnp.asarray(ids), a=a, dtype=jnp.float32),
           tol=0)
    xj, xt = _x((3, 7, a or 32), seed=3)
    _close(TL.embedding_attend(pt, xt, a=a), JL.embedding_attend(pj, xj, a=a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,pos", [((2, 9, 4, 16), "1d"),
                                       ((2, 9, 3, 2, 16), "2d")])
def test_rope_matches_jax(dtype, shape, pos):
    xj, xt = _x(shape, seed=4)
    xj, xt = xj.astype(dtype), xt.to(getattr(torch, dtype))
    p = np.arange(5, 14) if pos == "1d" else \
        np.random.default_rng(5).integers(0, 600, size=(2, 9))
    yt = TL.rope(xt, torch.from_numpy(p), 10000.0)
    yj = JL.rope(xj, jnp.asarray(p), 10000.0)
    assert yt.dtype == xt.dtype
    _close(yt, yj, tol=TOL if dtype == "float32" else 1e-2)


def _ref_cache(kv_j, max_len):
    """A reference decode cache of ``max_len`` slots holding prefill kv."""
    B, S, K, D = kv_j["k"].shape
    pad = lambda a: jnp.zeros((B, max_len, K, D), a.dtype).at[:, :S].set(a)
    return {"k": pad(kv_j["k"]), "v": pad(kv_j["v"]),
            "len": jnp.asarray(S, jnp.int32)}


@pytest.mark.parametrize("n_heads,n_kv", [(4, 4), (4, 2)])
def test_attention_rope_prefill_and_decode_match_jax(n_heads, n_kv):
    d_model, d_head, S, T = 32, 8, 7, 10
    pj = JL.attention_init(KEY, d_model, n_heads, n_kv, d_head)
    pt = _params(pj)
    kw = dict(n_heads=n_heads, n_kv=n_kv, d_head=d_head, rope_theta=10000.0)
    xj, xt = _x((2, T, d_model), seed=n_kv)
    yt, kvt = TL.attention_apply(pt, xt[:, :S], causal=True, return_kv=True,
                                 **kw)
    yj, kvj = JL.attention_apply(pj, xj[:, :S], causal=True, return_kv=True,
                                 **kw)
    _close(yt, yj)
    _close(kvt["k"], kvj["k"])
    _close(kvt["v"], kvj["v"])
    assert int(kvt["len"]) == S
    cj = _ref_cache(kvj, T)
    ct = TL.kv_cache_of(to_torch(np.asarray(cj["k"])),
                        to_torch(np.asarray(cj["v"])), S)
    for t in range(S, T):                          # one token per step
        yj, cj = JL.attention_apply(pj, xj[:, t:t + 1], kv_cache=cj, **kw)
        yt, ct = TL.attention_apply(pt, xt[:, t:t + 1], kv_cache=ct, **kw)
        _close(yt, yj)
        assert int(ct["len"]) == ct["fill"] == int(cj["len"]) == t + 1
    _close(ct["k"], cj["k"])
    _close(ct["v"], cj["v"])


def test_attention_matches_jax_blocked_causal():
    """The reference's exact-causal blocked XLA path, small blocks: the port
    computes the same function through K2."""
    pj = JL.attention_init(KEY, 32, 4, 4, 8)
    xj, xt = _x((2, 32, 32), seed=9)
    kw = dict(n_heads=4, n_kv=4, d_head=8, rope_theta=10000.0, causal=True)
    yj, _ = JL.attention_apply(pj, xj, impl="blocked_causal", block_q=8,
                               block_kv=8, **kw)
    yt, _ = TL.attention_apply(_params(pj), xt, **kw)
    _close(yt, yj)


def test_attention_cache_overflow_raises():
    pt = _params(JL.attention_init(KEY, 16, 2, 2, 8))
    cache = TL.kv_cache_of(torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 2, 8),
                           4)
    with pytest.raises(ValueError, match="cannot take"):
        TL.attention_apply(pt, torch.zeros(1, 1, 16), n_heads=2, n_kv=2,
                           d_head=8, rope_theta=1e4, kv_cache=cache)
    # raised from the host mirror, before any write: len is unchanged
    assert int(cache["len"]) == cache["fill"] == 4


@pytest.mark.parametrize("fill", [1, 6, 11])
@pytest.mark.parametrize("n_heads,n_kv", [(4, 4), (4, 2)])
def test_attention_decode_over_whole_cache_equals_view(monkeypatch, fill,
                                                       n_heads, n_kv):
    """A decode step attends over the WHOLE 12-slot cache with the fill as
    a 0-d int32 (keys past it masked): the same fp32 bits as the view of
    the first ``fill + 1`` slots that the port attended over before, at
    fills 1, mid and capacity - 1; ``len`` and its host mirror advance."""
    pt = _params(JL.attention_init(KEY, 32, n_heads, n_kv, 8))
    kw = dict(n_heads=n_heads, n_kv=n_kv, d_head=8, rope_theta=10000.0)
    rng = np.random.default_rng(fill)
    ck, cv = (torch.from_numpy(rng.normal(size=(2, 12, n_kv, 8))
                               .astype(np.float32)) for _ in range(2))
    x = torch.from_numpy(rng.normal(size=(2, 1, 32)).astype(np.float32))
    real = TL.flash_attention_op

    def view(q, k, v, *, causal, kv_len):
        n = int(kv_len)
        return real(q, k[:, :n], v[:, :n], causal=causal)
    whole = TL.kv_cache_of(ck.clone(), cv.clone(), fill)
    y, c = TL.attention_apply(pt, x, kv_cache=whole, **kw)
    monkeypatch.setattr(TL, "flash_attention_op", view)
    viewed = TL.kv_cache_of(ck.clone(), cv.clone(), fill)
    y_view, _ = TL.attention_apply(pt, x, kv_cache=viewed, **kw)
    assert torch.equal(y, y_view)
    assert torch.equal(c["k"], viewed["k"]) and c is whole
    assert int(c["len"]) == c["fill"] == fill + 1
    assert c["len"].dtype == torch.int32 and c["len"].ndim == 0


# --- the LM ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    jp = JT.lm_init(jax.random.PRNGKey(0), SMOKE)
    tp = lm_params(jax.tree_util.tree_map(np.asarray, jp))
    toks = np.random.default_rng(1).integers(0, SMOKE.vocab_size,
                                             size=(2, 12))
    return jp, tp, toks


@pytest.mark.parametrize("point", POINTS, ids=[p[0] for p in POINTS])
def test_lm_apply_matches_jax_at_operating_points(smoke, point):
    jp, tp, toks = smoke
    _, E, _ = point
    lj, aj, _ = JT.lm_apply(jp, jnp.asarray(toks), SMOKE, E=E)
    lt, at, _ = TT.lm_apply(tp, torch.from_numpy(toks), TSMOKE, E=E)
    assert lt.shape == (2, 12, SMOKE.vocab_size)
    _close(lt, lj, tol=LM_TOL)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("point", [p for p in POINTS if p[2]],
                         ids=[p[0] for p in POINTS if p[2]])
def test_prefill_caches_and_decode_match_jax(smoke, point):
    """Prefill's caches and two decode steps' logits and caches, against
    the reference's decode on the same (converted) caches."""
    jp, tp, toks = smoke
    _, E, _ = point
    S, T = 8, 12
    lj, _, kvj = JT.lm_apply(jp, jnp.asarray(toks[:, :S]), SMOKE, E=E,
                             return_kv=True)
    cj = JT.make_decode_caches(SMOKE, 2, T, dtype=jnp.float32, filled=S)
    for name in cj:
        for kk in ("k", "v"):
            cj[name][kk] = cj[name][kk].at[:, :, :S].set(kvj[name][kk])
    last, ct = lm_prefill(tp, torch.from_numpy(toks[:, :S]), TSMOKE, E=E,
                          max_len=T)
    _close(last, lj[:, -1])
    ref_caches = lm_caches(jax.tree_util.tree_map(np.asarray, cj))
    for name in ct:
        for c, r in zip(ct[name], ref_caches[name]):
            assert int(c["len"]) == int(r["len"]) == c["fill"] == S
            _close(c["k"], r["k"])
            _close(c["v"], r["v"])
    ct_conv = lm_caches(jax.tree_util.tree_map(np.asarray, cj))
    for t in range(S, S + 2):
        dj, _, cj = JT.lm_apply(jp, jnp.asarray(toks[:, t:t + 1]), SMOKE,
                                E=E, caches=cj)
        dt, ct = lm_decode(tp, ct, torch.from_numpy(toks[:, t:t + 1]),
                           TSMOKE, E=E)
        dc, ct_conv = lm_decode(tp, ct_conv,
                                torch.from_numpy(toks[:, t:t + 1]), TSMOKE,
                                E=E)
        _close(dt, dj[:, -1], tol=LM_TOL)
        _close(dc, dj[:, -1], tol=LM_TOL)     # on the converted caches
    ref_caches = lm_caches(jax.tree_util.tree_map(np.asarray, cj))
    for name in ct:
        for c, r in zip(ct[name], ref_caches[name]):
            assert int(c["len"]) == int(r["len"]) == c["fill"] == S + 2
            _close(c["k"], r["k"])


@pytest.mark.parametrize("point", [p for p in POINTS if p[2]],
                         ids=[p[0] for p in POINTS if p[2]])
def test_decode_over_device_len_matches_jax(smoke, point):
    """Prefill into caches made by make_decode_caches (``len`` a 0-d int32
    tensor, set to S by the prefill), then four decode steps over the
    whole cache against the reference's lm_apply decode; every layer's
    ``len`` and host ``fill`` advance by one a step."""
    jp, tp, toks = smoke
    _, E, _ = point
    S, T = 6, 12
    _, _, kvj = JT.lm_apply(jp, jnp.asarray(toks[:, :S]), SMOKE, E=E,
                            return_kv=True)
    cj = JT.make_decode_caches(SMOKE, 2, T, dtype=jnp.float32, filled=S)
    for name in cj:
        for kk in ("k", "v"):
            cj[name][kk] = cj[name][kk].at[:, :, :S].set(kvj[name][kk])
    ct = TT.make_decode_caches(TSMOKE, 2, T, dtype=torch.float32,
                               device="cpu")
    _, ct2 = lm_prefill(tp, torch.from_numpy(toks[:, :S]), TSMOKE, E=E,
                        caches=ct)
    assert ct2 is ct
    for t in range(S, S + 4):
        dj, _, cj = JT.lm_apply(jp, jnp.asarray(toks[:, t:t + 1]), SMOKE,
                                E=E, caches=cj)
        dt, ct = lm_decode(tp, ct, torch.from_numpy(toks[:, t:t + 1]),
                           TSMOKE, E=E)
        _close(dt, dj[:, -1], tol=LM_TOL)
        for layers in ct.values():
            for c in layers:
                assert c["len"].dtype == torch.int32 and c["len"].ndim == 0
                assert int(c["len"]) == c["fill"] == t + 1


@pytest.mark.parametrize("point", [p for p in POINTS if p[2]],
                         ids=[p[0] for p in POINTS if p[2]])
def test_decode_matches_prefill_without_drops(smoke, point):
    """tests/test_models.py:120's property, with no capacity drops."""
    _, tp, toks = smoke
    _, E, _ = point
    cfg = dataclasses.replace(TSMOKE, moe=dataclasses.replace(
        TSMOKE.moe, capacity_factor=100.0))
    t = torch.from_numpy(toks)
    full, _, _ = TT.lm_apply(tp, t, cfg, E=E)
    last, caches = lm_prefill(tp, t[:, :6], cfg, E=E, max_len=12)
    outs = [last]
    for i in range(6, 12):
        lg, caches = lm_decode(tp, caches, t[:, i:i + 1], cfg, E=E)
        outs.append(lg)
    dec = torch.stack(outs, 1)
    torch.testing.assert_close(dec[:, :-1], full[:, 5:11], rtol=5e-5,
                               atol=5e-5)


@pytest.mark.parametrize("E", [{"a_layers": 2}, {"a_heads": 2}])
def test_decode_at_sliced_depth_or_heads_raises_as_reference(smoke, E):
    """Fault F4: the reference's decode fails at a sliced depth or head
    count; the port raises a clear NotImplementedError there."""
    jp, tp, toks = smoke
    cj = JT.make_decode_caches(SMOKE, 2, 12, dtype=jnp.float32, filled=8)
    with pytest.raises((ValueError, TypeError)):
        JT.lm_apply(jp, jnp.asarray(toks[:, 8:9]), SMOKE, E=E, caches=cj)
    ct = TT.make_decode_caches(TSMOKE, 2, 12, dtype=torch.float32, filled=8,
                               device="cpu")
    with pytest.raises(NotImplementedError, match="F4"):
        lm_decode(tp, ct, torch.from_numpy(toks[:, 8:9]), TSMOKE, E=E)
    with pytest.raises(NotImplementedError, match="F4"):
        lm_prefill(tp, torch.from_numpy(toks[:, :8]), TSMOKE, E=E,
                   max_len=12)


@pytest.mark.cuda
def test_cuda_decode_graph_advances_len():
    """On the card the LM's prefill and decode step run as CUDA graphs
    (LMGraphs): each decode replay writes its k and v at ``len`` and
    advances ``len`` on the device, the host mirror follows, the logits
    equal the eager steps' (the same kernels in the same order), and a
    full cache raises before the replay.  A bf16 config with head dim 64,
    where K2 takes its decode variant."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode)")
    from repro_torch.launch.steps import LMGraphs
    dev = torch.device("cuda")
    cfg = dataclasses.replace(TSMOKE, d_model=256, d_head=64,
                              compute_dtype="bfloat16")
    params = TT.lm_init(torch.Generator(device=dev).manual_seed(0), cfg,
                        device=dev, dtype=torch.bfloat16)
    toks = torch.randint(0, cfg.vocab_size, (2, 12), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    S, total = 8, 12
    with torch.inference_mode():
        eager_last, caches = lm_prefill(params, toks[:, :S], cfg,
                                        max_len=total)
        eager = [lm_decode(params, caches, toks[:, t:t + 1], cfg)[0]
                 for t in range(S, total)]
        lm = LMGraphs(params, cfg, 2, S, total, dev)
        lm.capture()
        assert lm.captures == 2
        last = lm.prefill(toks[:, :S])
        layers = [c for stack in lm.caches.values() for c in stack]
        assert all(int(c["len"]) == c["fill"] == S for c in layers)
        for i, t in enumerate(range(S, total)):
            lg = lm.decode(toks[:, t:t + 1])
            torch.cuda.synchronize()
            assert all(int(c["len"]) == c["fill"] == t + 1 for c in layers)
            assert torch.equal(lg, eager[i])
        assert torch.equal(last, eager_last)
        with pytest.raises(ValueError, match="cannot take"):
            lm.decode(toks[:, :1])
        assert all(int(c["len"]) == total for c in layers)


def test_lm_init_layout_matches_reference(smoke):
    _, tp, _ = smoke
    p = TT.lm_init(torch.Generator().manual_seed(0), TSMOKE, device="cpu",
                   dtype=torch.bfloat16)

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return tuple(t.shape)

    assert shapes(p) == shapes(tp)
    assert len(p["moe_layers"]) == SMOKE.n_moe_layers
    assert p["moe_layers"][0]["moe"]["router"]["kernel"].dtype == \
        torch.float32
    assert p["lm_head"]["kernel"].dtype == torch.bfloat16
    emb = p["embed"]["embedding"].float()
    assert abs(float(emb.std()) - 0.02) < 0.005
    assert torch.all(p["final_norm"]["scale"] == 1)


def test_lm_init_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.lm_init(torch.Generator().manual_seed(0), TSMOKE)


def test_full_config_fields_and_flops_match_reference():
    jcfg = j_ds.make_config()
    tcfg = _torch_cfg(jcfg, smoke=False)
    n, jn = tflops.lm_param_counts(tcfg), jflops.lm_param_counts(jcfg)
    assert n == {k: jn[k] for k in n}
    for kind, B, S in (("prefill", 4, 512), ("decode", 4, 528),
                       ("train", 2, 64), ("train", 256, 4096)):
        assert tflops.lm_model_flops(tcfg, kind, B, S) == \
            jflops.lm_model_flops(jcfg, kind, B, S)
    with pytest.raises(ValueError, match="train"):
        tflops.lm_model_flops(tcfg, "serve", 2, 64)
    # the embedding table is as large as the (untied) head
    assert 16.0e9 < n["body_total"] + 2 * n["unembed"] < 16.9e9


def test_elastic_moe_launcher_runs_on_cpu(capsys):
    elastic_moe.main(["--smoke", "--device", "cpu", "--batch", "2",
                      "--prefill-len", "8", "--decode-steps", "2",
                      "--iters", "1"])
    out = capsys.readouterr().out
    for name, _, _ in POINTS:
        assert name in out
    assert "n/a (F4)" in out
    assert "all logits finite: True" in out


def parity_report():
    """Max |port - reference| per module of the LM slice on the CPU, at the
    sizes of the tests above and of tests/test_torch_moe.py
    (``python tests/test_torch_lm.py``)."""
    from repro.kernels import expert_matmul as jxm
    from repro.models import moe as JM
    from repro_torch.kernels import ops
    from repro_torch.models import moe as TM

    rng = np.random.default_rng(0)
    err = lambda t, j: float(np.max(np.abs(
        t.detach().float().numpy() - np.asarray(j, np.float32))))
    rows = []
    x = rng.normal(size=(4, 128, 64)).astype(np.float32) * 0.5
    w = rng.normal(size=(4, 64, 128)).astype(np.float32) * 0.5
    counts = [128, 0, 64, 5]
    for dtype, tol in (("float32", 3e-4), ("bfloat16", 3e-2)):
        xj, wj = (jnp.asarray(a).astype(dtype) for a in (x, w))
        y = ops.expert_matmul_op(
            *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, w)),
            torch.tensor(counts, dtype=torch.int32))
        rows.append((f"kernels.ops.expert_matmul_op {dtype}, counts "
                     f"{counts}, vs JAX kernel (interpret)",
                     err(y, jxm.expert_matmul(xj, wj, jnp.asarray(
                         counts, jnp.int32), interpret=True)), tol))
    cfg = JM.MoEConfig(n_experts=8, top_k=2, d_ff=64, n_shared=1,
                       capacity_factor=4.0, group_size=16)
    jp = JM.moe_init(KEY, 32, cfg)
    tp = _params(jp)
    xm = rng.normal(size=(2, 16, 32)).astype(np.float32)
    for label, c, kw in (
            ("dense", dataclasses.replace(cfg, dispatch="dense"), {}),
            ("einsum", cfg, {}),
            ("einsum, a_experts 4 top-1 a_ff 32", cfg,
             {"a_experts": 4, "top_k": 1, "a_ff": 32}),
            ("einsum, capacity factor 0.5 (drops)",
             dataclasses.replace(cfg, capacity_factor=0.5), {})):
        yj, aj = JM.moe_apply(jp, jnp.asarray(xm), c, **kw)
        yt, at = TM.moe_apply(tp, torch.from_numpy(xm),
                              TM.MoEConfig(**dataclasses.asdict(c)), **kw)
        rows.append((f"models.moe.moe_apply {label} (aux loss rel "
                     f"{abs(float(at) / float(aj) - 1):.1e})",
                     err(yt, yj), 2e-4))
    pr = {"scale": jax.random.normal(KEY, (40,))}
    xj, xt = _x((2, 5, 24), seed=1)
    rows.append(("core.layers.rmsnorm_apply (a=24 of 40)",
                 err(TL.rmsnorm_apply(_params(pr), xt, a=24),
                     JL.rmsnorm_apply(pr, xj, a=24)), TOL))
    pe = JL.embedding_init(KEY, 50, 32)
    xj, xt = _x((3, 7, 32), seed=3)
    rows.append(("core.layers.embedding_attend",
                 err(TL.embedding_attend(_params(pe), xt),
                     JL.embedding_attend(pe, xj)), TOL))
    xj, xt = _x((2, 9, 4, 16), seed=4)
    p = np.random.default_rng(5).integers(0, 600, size=(2, 9))
    rows.append(("core.layers.rope (positions < 600)",
                 err(TL.rope(xt, torch.from_numpy(p)),
                     JL.rope(xj, jnp.asarray(p))), TOL))
    pa = JL.attention_init(KEY, 32, 4, 2, 8)
    kw = dict(n_heads=4, n_kv=2, d_head=8, rope_theta=10000.0)
    xj, xt = _x((2, 10, 32), seed=2)
    yt, _ = TL.attention_apply(_params(pa), xt[:, :7], return_kv=True, **kw)
    yj, kvj = JL.attention_apply(pa, xj[:, :7], return_kv=True, **kw)
    rows.append(("core.layers.attention_apply rope prefill (GQA 4/2)",
                 err(yt, yj), TOL))
    cj = _ref_cache(kvj, 10)
    ct = TL.kv_cache_of(to_torch(np.asarray(cj["k"])),
                        to_torch(np.asarray(cj["v"])), 7)
    worst = 0.0
    for t in range(7, 10):
        yj, cj = JL.attention_apply(pa, xj[:, t:t + 1], kv_cache=cj, **kw)
        yt, ct = TL.attention_apply(_params(pa), xt[:, t:t + 1],
                                    kv_cache=ct, **kw)
        worst = max(worst, err(yt, yj))
    rows.append(("core.layers.attention_apply decode, 3 steps on a "
                 "converted cache", worst, TOL))
    pb = JL.attention_init(KEY, 32, 4, 4, 8)
    xj, xt = _x((2, 32, 32), seed=9)
    kb = dict(n_heads=4, n_kv=4, d_head=8, rope_theta=10000.0, causal=True)
    rows.append(("core.layers.attention_apply vs reference blocked_causal "
                 "(blocks of 8)",
                 err(TL.attention_apply(_params(pb), xt, **kb)[0],
                     JL.attention_apply(pb, xj, impl="blocked_causal",
                                        block_q=8, block_kv=8, **kb)[0]),
                 TOL))
    jp = JT.lm_init(jax.random.PRNGKey(0), SMOKE)
    tp = lm_params(jax.tree_util.tree_map(np.asarray, jp))
    toks = np.random.default_rng(1).integers(0, SMOKE.vocab_size,
                                             size=(2, 12))
    worst = 0.0
    for _, E, _ in POINTS:
        worst = max(worst, err(
            TT.lm_apply(tp, torch.from_numpy(toks), TSMOKE, E=E)[0],
            JT.lm_apply(jp, jnp.asarray(toks), SMOKE, E=E)[0]))
    rows.append((f"models.transformer.lm_apply smoke, {len(POINTS)} "
                 f"operating points", worst, LM_TOL))
    worst = 0.0
    for _, E, decodable in POINTS:
        if not decodable:
            continue
        lj, _, kvj = JT.lm_apply(jp, jnp.asarray(toks[:, :8]), SMOKE, E=E,
                                 return_kv=True)
        cj = JT.make_decode_caches(SMOKE, 2, 12, dtype=jnp.float32, filled=8)
        for name in cj:
            for kk in ("k", "v"):
                cj[name][kk] = cj[name][kk].at[:, :, :8].set(kvj[name][kk])
        last, ct = lm_prefill(tp, torch.from_numpy(toks[:, :8]), TSMOKE, E=E,
                              max_len=12)
        worst = max(worst, err(last, lj[:, -1]))
        for t in range(8, 10):
            dj, _, cj = JT.lm_apply(jp, jnp.asarray(toks[:, t:t + 1]), SMOKE,
                                    E=E, caches=cj)
            dt, ct = lm_decode(tp, ct, torch.from_numpy(toks[:, t:t + 1]),
                               TSMOKE, E=E)
            worst = max(worst, err(dt, dj[:, -1]))
    rows.append(("launch.steps lm_prefill + 2 lm_decode steps, 4 decodable "
                 "points", worst, LM_TOL))
    print("| module | max abs err (CPU) | tolerance |")
    print("| --- | --- | --- |")
    for name, e, tol in rows:
        print(f"| {name} | {e:.3g} | {tol:g} |")


if __name__ == "__main__":
    parity_report()
