"""The port's other LM configs (qwen1.5-110b, granite-20b, kimi-k2-1t-a32b)
and the LM's masked mode against the JAX reference.

Each config's smoke model is initialised once by the reference (one jitted
call) and converted; every reference output a config's tests read (logits
at each operating point, prefill caches and two decode steps at each
decodable point, masked-mode logits) is computed once per module by jitted
calls compiled in parallel.  Both sides run in fp32 on the CPU, the port's
kernels as their plain versions.  Tolerances are those of
tests/test_torch_lm.py: 1e-4 for single layers and caches, 2e-4 for a
4-layer smoke LM's logits.  Masked against sliced mode in the port is
held to 2e-4, as tests/test_models.py:77 and tests/test_moe.py:43 hold the
reference's two modes.

The masked depth gate is a deliberate difference (ROADMAP §3): the port
runs the first ``a_layers`` layers and skips the rest, where the
reference runs every layer and adds nothing past ``a_layers``.  The
logits are the same; the port's aux loss counts the layers run, as
sliced mode's does, and the reference's masked aux loss also counts the
gated layers' routers.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import get_arch as j_get_arch  # noqa: E402
from repro.configs.registry import load_all as j_load_all  # noqa: E402
from repro.core import layers as JL  # noqa: E402
from repro.launch import flops as jflops  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_caches, lm_params, to_torch  # noqa: E402
from repro_torch.core import layers as TL  # noqa: E402
from repro_torch.launch import elastic_moe, flops as tflops  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.steps import (ONE_CARD_CUT, lm_decode,  # noqa
                                      lm_prefill)
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

# a test file run earlier in this process may have imported one reference
# config alone, and the reference's registry loads the rest only when empty
j_load_all()

torch.set_num_threads(2)
TOL = 1e-4
LM_TOL = 2e-4
NEW = ("qwen1.5-110b", "granite-20b", "kimi-k2-1t-a32b")
S, T = 8, 12                      # prefill length, cache slots
BATCH = 2


def _fields_equal(t, j) -> None:
    for f in dataclasses.fields(j):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if f.name in ("elastic", "moe") and b is not None:
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f.name


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _run_jitted(calls):
    """Each ``(fn, args)`` jitted: traced here, compiled on threads at once
    (XLA's compiler releases the GIL), then run in order; the outputs as
    numpy trees."""
    lowered = [jax.jit(fn).lower(*args) for fn, args in calls]
    with ThreadPoolExecutor(4) as pool:
        compiled = list(pool.map(lambda lo: lo.compile(), lowered))
    return [_np_tree(c(*args)) for c, (_, args) in zip(compiled, calls)]


def _masked_E(cfg) -> dict:
    """tests/test_models.py:77's knobs: half the FFN, the kv heads' count
    of heads, half the depth; half the experts and top-1 for an MoE."""
    E = {"a_ff": max(1, cfg.d_ff // 2), "a_heads": cfg.n_kv_heads,
         "a_layers": max(1, cfg.n_layers // 2)}
    if cfg.moe:
        E["a_experts"] = cfg.moe.n_experts // 2
        E["top_k"] = 1
    return E


def _tensor_E(E: dict, as_tensor) -> dict:
    return {k: v if k == "top_k" else as_tensor(v) for k, v in E.items()}


def _reference(jcfg, points, toks):
    """Every reference output of one config, in one batch of jitted
    calls: lm_apply at each point; prefill of S tokens with its caches and
    two decode steps at each decodable point; masked-mode logits and aux
    loss on tensor widths."""
    init = jax.jit(lambda k: JT.lm_init(k, jcfg))(jax.random.PRNGKey(0))
    tj = jnp.asarray(toks)
    calls = [(lambda p, t, E=E: JT.lm_apply(p, t, jcfg, E=E)[:2], (init, tj))
             for _, E, _ in points]

    def decode_run(p, t, E):
        _, _, kv = JT.lm_apply(p, t[:, :S], jcfg, E=E, return_kv=True)
        last = JT.lm_apply(p, t[:, :S], jcfg, E=E)[0][:, -1]
        c = JT.make_decode_caches(jcfg, BATCH, T, dtype=jnp.float32,
                                  filled=S)
        for name in c:
            for kk in ("k", "v"):
                c[name][kk] = c[name][kk].at[:, :, :S].set(kv[name][kk])
        start = c
        outs = []
        for i in range(S, S + 2):
            lg, _, c = JT.lm_apply(p, t[:, i:i + 1], jcfg, E=E, caches=c)
            outs.append(lg[:, -1])
        return last, start, jnp.stack(outs, 1), c
    decodable = [(name, E) for name, E, d in points if d]
    calls += [(lambda p, t, E=E: decode_run(p, t, E), (init, tj))
              for _, E in decodable]
    E_m = _tensor_E(_masked_E(jcfg), lambda v: jnp.asarray(v, jnp.int32))
    calls.append((lambda p, t: JT.lm_apply(p, t, jcfg, E=E_m)[:2],
                  (init, tj)))
    outs = _run_jitted(calls)
    n = len(points)
    return {"params": _np_tree(init), "apply": outs[:n],
            "decode": dict(zip([name for name, _ in decodable],
                               outs[n:n + len(decodable)])),
            "masked": outs[-1]}


_REFS = {}


@pytest.fixture(scope="module")
def ref():
    """(jcfg, tcfg, points, toks, reference outputs, port params) of a
    config's smoke model, once per config for the module."""
    def get(arch_id):
        if arch_id not in _REFS:
            jcfg = j_get_arch(arch_id).make_smoke()
            tcfg = get_arch(arch_id).make_smoke()
            points = elastic_moe.operating_points(tcfg)
            toks = np.random.default_rng(1).integers(
                0, jcfg.vocab_size, size=(BATCH, T))
            out = _reference(jcfg, points, toks)
            _REFS[arch_id] = (jcfg, tcfg, points, toks, out,
                              lm_params(out["params"]))
        return _REFS[arch_id]
    return get


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


def _point_ids(arch_id, decodable_only=False):
    cfg = get_arch(arch_id).make_smoke()
    return [(arch_id, i) for i, (_, _, d)
            in enumerate(elastic_moe.operating_points(cfg))
            if d or not decodable_only]


# --- configs --------------------------------------------------------------------

@pytest.mark.parametrize("arch_id", NEW)
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_config_fields_match_reference(arch_id, size):
    j, t = j_get_arch(arch_id), get_arch(arch_id)
    make = (lambda a: a.make_config()) if size == "full" else \
        (lambda a: a.make_smoke())
    _fields_equal(make(t), make(j))
    assert (t.family, t.optimizer, t.source) == (j.family, j.optimizer,
                                                 j.source)
    assert sorted(t.shapes) == sorted(j.shapes)


@pytest.mark.parametrize("arch_id", NEW)
def test_model_flops_match_reference(arch_id):
    jcfg, tcfg = (j_get_arch(arch_id).make_config(),
                  get_arch(arch_id).make_config())
    n, jn = tflops.lm_param_counts(tcfg), jflops.lm_param_counts(jcfg)
    assert n == {k: jn[k] for k in n}
    for kind, B, L in (("prefill", 4, 512), ("decode", 4, 528),
                       ("train", 256, 4096)):
        assert tflops.lm_model_flops(tcfg, kind, B, L) == \
            jflops.lm_model_flops(jcfg, kind, B, L)


@pytest.mark.parametrize("arch_id,layers,params", [
    ("qwen1.5-110b", 8, 13.36e9), ("granite-20b", 52, 20.32e9),
    ("kimi-k2-1t-a32b", 2, 19.93e9), ("deepseek-moe-16b", 28, 16.38e9)])
def test_one_card_cut_keeps_full_width(arch_id, layers, params):
    """The serving launcher's one-card cut: the depth (the first layers:
    kimi's dense layer and one MoE layer) and the parameters it leaves in
    bf16, every width as the full config's."""
    full = get_arch(arch_id).make_config()
    cut = elastic_moe.one_card(arch_id, full)
    assert cut.n_layers == layers
    assert dataclasses.replace(cut, n_layers=full.n_layers) == full
    n = tflops.lm_param_counts(cut)
    total = n["body_total"] + 2 * n["unembed"]     # untied head
    assert abs(total - params) < 0.01e9
    assert 2 * total < 41e9                        # bytes in bf16


@pytest.mark.parametrize("arch_id,names,heads", [
    ("qwen1.5-110b", ["full", "half FFN", "fewest heads", "half depth",
                      "min subnet"], 32),
    ("granite-20b", ["full", "half FFN", "fewest heads", "half depth",
                     "min subnet"], 32),
    ("kimi-k2-1t-a32b", ["full", "half experts", "top-1 routing",
                         "half expert width", "min subnet"], None)])
def test_operating_points_of_full_configs(arch_id, names, heads):
    """A dense LM's five points from its elastic space (the heads and
    depth points prefill only: fault F4); kimi's MoE points at 384
    experts; the depth points halve the one-card cut's depth."""
    cfg = elastic_moe.one_card(arch_id, get_arch(arch_id).make_config())
    pts = elastic_moe.operating_points(cfg)
    assert [p[0].split(" (")[0] for p in pts] == names
    for name, E, decodable in pts:
        sliced = E.get("a_layers", cfg.n_layers) < cfg.n_layers or \
            E.get("a_heads", cfg.n_heads) < cfg.n_heads
        assert decodable == (not sliced), name
        assert E.get("a_layers", cfg.n_layers) in (
            cfg.n_layers, cfg.n_layers // 2,
            round(cfg.n_layers * min(cfg.elastic.depth_mults)))
        assert 0.1 < elastic_moe.rel_flops(cfg, E, 4, 512) <= 1.0
    if heads is not None:
        by_name = {p[0]: p[1] for p in pts}
        assert by_name[f"fewest heads ({heads})"]["a_heads"] == heads
        assert heads % cfg.n_kv_heads == 0
    else:
        assert pts[1][1] == {"a_experts": 192}
        assert pts[3][1] == {"a_ff": 1024} and pts[4][1]["a_layers"] == 1


# --- the smoke models against the reference -------------------------------------

@pytest.mark.parametrize("arch_id,i", [p for a in NEW for p in _point_ids(a)])
def test_lm_apply_matches_jax_at_operating_points(ref, arch_id, i):
    jcfg, tcfg, points, toks, out, tp = ref(arch_id)
    name, E, _ = points[i]
    lt, at, _ = TT.lm_apply(tp, torch.from_numpy(toks), tcfg, E=E)
    lj, aj = out["apply"][i]
    assert lt.shape == (BATCH, T, jcfg.vocab_size)
    _close(lt, lj, LM_TOL)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("arch_id,i", [p for a in NEW
                                       for p in _point_ids(a, True)])
def test_prefill_caches_and_decode_match_jax(ref, arch_id, i):
    """Prefill's last logits and caches, then two decode steps' logits and
    caches, against the reference on the same caches (granite's single kv
    head included)."""
    jcfg, tcfg, points, toks, out, tp = ref(arch_id)
    name, E, _ = points[i]
    last_j, start_j, dec_j, end_j = out["decode"][name]
    last, ct = lm_prefill(tp, torch.from_numpy(toks[:, :S]), tcfg, E=E,
                          max_len=T)
    _close(last, last_j)
    for stack, want in lm_caches(start_j).items():
        for c, r in zip(ct[stack], want):
            assert int(c["len"]) == c["fill"] == int(r["len"]) == S
            _close(c["k"], r["k"])
            _close(c["v"], r["v"])
    for n, t in enumerate(range(S, S + 2)):
        dt, ct = lm_decode(tp, ct, torch.from_numpy(toks[:, t:t + 1]), tcfg,
                           E=E)
        _close(dt, dec_j[:, n], LM_TOL)
    for stack, want in lm_caches(end_j).items():
        for c, r in zip(ct[stack], want):
            assert int(c["len"]) == c["fill"] == int(r["len"]) == S + 2
            _close(c["k"], r["k"])
            _close(c["v"], r["v"])


def test_head_dim_112_matches_jax():
    """kimi-k2's head dim 112 (its smoke config has 8) through the plain
    kernels: a 2-layer model (dense + MoE) at d_head 112, logits and a
    decode step against the reference."""
    j = dataclasses.replace(j_get_arch("kimi-k2-1t-a32b").make_smoke(),
                            n_layers=2, d_head=112)
    t = dataclasses.replace(get_arch("kimi-k2-1t-a32b").make_smoke(),
                            n_layers=2, d_head=112)
    jp = jax.jit(lambda k: JT.lm_init(k, j))(jax.random.PRNGKey(1))
    tp = lm_params(_np_tree(jp))
    toks = np.random.default_rng(2).integers(0, j.vocab_size, size=(2, 7))
    lj = JT.lm_apply(jp, jnp.asarray(toks), j)[0]
    _close(TT.lm_apply(tp, torch.from_numpy(toks), t)[0], lj, LM_TOL)
    _, _, kv = JT.lm_apply(jp, jnp.asarray(toks[:, :6]), j, return_kv=True)
    cj = JT.make_decode_caches(j, 2, 8, dtype=jnp.float32, filled=6)
    for name in cj:
        for kk in ("k", "v"):
            cj[name][kk] = cj[name][kk].at[:, :, :6].set(kv[name][kk])
    dj = JT.lm_apply(jp, jnp.asarray(toks[:, 6:]), j, caches=cj)[0]
    _, ct = lm_prefill(tp, torch.from_numpy(toks[:, :6]), t, max_len=8)
    assert ct["dense"][0]["k"].shape[-1] == 112
    dt, _ = lm_decode(tp, ct, torch.from_numpy(toks[:, 6:]), t)
    _close(dt, dj[:, -1], LM_TOL)


# --- masked mode ----------------------------------------------------------------

@pytest.mark.parametrize("arch_id", ["qwen1.5-110b", "deepseek-moe-16b"])
def test_elastic_subnets_slice_eq_mask(arch_id):
    """tests/test_models.py:77 in the port: sliced == masked, logits and
    the aux loss (the masked depth gate runs the same layers)."""
    cfg = get_arch(arch_id).make_smoke()
    tp = TT.lm_init(torch.Generator().manual_seed(3), cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(2, 12)))
    E_s = _masked_E(cfg)
    E_m = _tensor_E(E_s, lambda v: torch.tensor(v, dtype=torch.int32))
    a, aux_a, _ = TT.lm_apply(tp, toks, cfg, E=E_s)
    b, aux_b, _ = TT.lm_apply(tp, toks, cfg, E=E_m)
    assert b.shape == a.shape
    torch.testing.assert_close(b, a, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(aux_b, aux_a, rtol=1e-5, atol=0)


@pytest.mark.parametrize("arch_id", NEW + ("deepseek-moe-16b",))
def test_masked_lm_matches_reference_masked(ref, arch_id):
    """The port's masked mode against the reference's on the same tensor
    widths: the logits; the aux loss against the port's sliced mode (the
    gated layers' routers are the deliberate difference: module note)."""
    if arch_id == "deepseek-moe-16b":
        jcfg = j_get_arch(arch_id).make_smoke()
        tcfg = get_arch(arch_id).make_smoke()
        toks = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                                 size=(BATCH, T))
        jp = jax.jit(lambda k: JT.lm_init(k, jcfg))(jax.random.PRNGKey(0))
        E_j = _tensor_E(_masked_E(jcfg), lambda v: jnp.asarray(v, jnp.int32))
        lj, _ = _np_tree(jax.jit(lambda p, t: JT.lm_apply(
            p, t, jcfg, E=E_j)[:2])(jp, jnp.asarray(toks)))
        tp = lm_params(_np_tree(jp))
    else:
        jcfg, tcfg, _, toks, out, tp = ref(arch_id)
        lj, _ = out["masked"]
    E_s = _masked_E(tcfg)
    E_m = _tensor_E(E_s, lambda v: torch.tensor(v, dtype=torch.int32))
    lt, at, _ = TT.lm_apply(tp, torch.from_numpy(toks), tcfg, E=E_m)
    _close(lt, lj, LM_TOL)
    assert float((lt[..., :] != 0).float().mean()) > 0.5
    _, at_s, _ = TT.lm_apply(tp, torch.from_numpy(toks), tcfg, E=E_s)
    np.testing.assert_allclose(float(at), float(at_s), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("a", [None, 5, 16])
def test_masked_embedding_matches_jax(a):
    """The embedding and the tied head in masked mode: the rows masked
    past a 0-d ``a`` (the reference's core/layers.py:122-136), and equal
    to sliced mode over the active columns."""
    pj = JL.embedding_init(jax.random.PRNGKey(4), 50, 16)
    pt = to_torch(_np_tree(pj))
    ids = np.random.default_rng(4).integers(0, 50, size=(3, 7))
    aj = None if a is None else jnp.asarray(a, jnp.int32)
    at = None if a is None else torch.tensor(a, dtype=torch.int32)
    yt = TL.embedding_apply(pt, torch.from_numpy(ids), a=at,
                            dtype=torch.float32)
    yj = JL.embedding_apply(pj, jnp.asarray(ids), a=aj, dtype=jnp.float32)
    _close(yt, yj, 0)
    if a is not None:
        assert torch.all(yt[..., a:] == 0)
        ys = TL.embedding_apply(pt, torch.from_numpy(ids), a=a,
                                dtype=torch.float32)
        assert torch.equal(yt[..., :a], ys)
    x = np.random.default_rng(5).normal(size=(3, 7, 16)).astype(np.float32)
    if a is not None:
        x[..., a:] = 0
    lt = TL.embedding_attend(pt, torch.from_numpy(x), a=at)
    _close(lt, JL.embedding_attend(pj, jnp.asarray(x), a=aj))
    if a is not None:
        ls = TL.embedding_attend(pt, torch.from_numpy(x[..., :a]), a=a)
        torch.testing.assert_close(lt, ls, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dispatch", ["einsum", "dense"])
def test_moe_masked_knobs_match_sliced_and_reference(dispatch):
    """tests/test_moe.py:43 in the port (sliced == masked), and the port's
    masked MoE layer against the reference's: the masked experts get no
    slot, the capacity stays the full expert count's, and the port's
    slice past a_ff equals the reference's zeros past it."""
    jcfg = JM.MoEConfig(n_experts=8, top_k=2, d_ff=64, n_shared=1,
                        capacity_factor=4.0, group_size=16,
                        dispatch=dispatch)
    tcfg = TM.MoEConfig(**dataclasses.asdict(jcfg))
    jp = JM.moe_init(jax.random.PRNGKey(0), 32, jcfg)
    tp = to_torch(_np_tree(jp))
    x = np.random.default_rng(6).normal(size=(2, 16, 32)).astype(np.float32)
    xt = torch.from_numpy(x)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)
    y_s, _ = TM.moe_apply(tp, xt, tcfg, a_experts=4, top_k=1, a_ff=32)
    y_m, aux_m = TM.moe_apply(tp, xt, tcfg, a_experts=i32(4), top_k=1,
                              a_ff=i32(32))
    torch.testing.assert_close(y_m, y_s, rtol=2e-4, atol=2e-4)
    y_j, aux_j = JM.moe_apply(jp, jnp.asarray(x), jcfg,
                              a_experts=jnp.asarray(4), top_k=1,
                              a_ff=jnp.asarray(32))
    _close(y_m, y_j, 2e-4)
    np.testing.assert_allclose(float(aux_m), float(aux_j), rtol=1e-5)


def test_masked_experts_get_no_slot():
    """Masked knobs take the sliced path: the K3 slabs hold the first
    ``a_experts`` experts only, at ``a_ff``, so the masked-out experts get
    no slot and every routed slot lands in a live expert."""
    cfg = TM.MoEConfig(n_experts=8, top_k=2, d_ff=16, capacity_factor=4.0,
                       group_size=16)
    p = TM.moe_init(torch.Generator().manual_seed(0), 32, cfg,
                    device="cpu")
    seen = []
    real = TM.expert_matmul_op

    def spy(x, w, counts):
        seen.append((x.shape, w.shape, counts.clone()))
        return real(x, w, counts)
    TM.expert_matmul_op = spy
    try:
        TM.moe_apply(p, torch.randn(2, 16, 32,
                                    generator=torch.Generator().manual_seed(1)),
                     cfg, a_experts=torch.tensor(3, dtype=torch.int32),
                     a_ff=torch.tensor(8, dtype=torch.int32))
    finally:
        TM.expert_matmul_op = real
    assert len(seen) == 3
    for xs, ws, counts in seen:
        assert xs[0] == ws[0] == 3 and ws[-1] in (8, 32)
        assert counts.shape == (3,) and int(counts.sum()) == 64


def test_masked_decode_at_a_sliced_depth_raises():
    """Decode at a masked depth or head count raises as at a sliced one
    (fault F4); at full masked widths it runs."""
    cfg = get_arch("qwen1.5-110b").make_smoke()
    tp = TT.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    caches = TT.make_decode_caches(cfg, 1, 4, dtype=torch.float32,
                                   filled=1, device="cpu")
    tok = torch.zeros(1, 1, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="F4"):
        lm_decode(tp, caches, tok, cfg,
                  E={"a_layers": torch.tensor(2, dtype=torch.int32)})
    full = {"a_layers": torch.tensor(cfg.n_layers, dtype=torch.int32),
            "a_ff": torch.tensor(cfg.d_ff, dtype=torch.int32)}
    lg, _ = lm_decode(tp, caches, tok, cfg, E=full)
    assert lg.shape == (1, cfg.vocab_size) and torch.isfinite(lg).all()


# --- launchers ------------------------------------------------------------------

@pytest.mark.parametrize("arch_id", NEW)
def test_elastic_moe_launcher_runs_each_config_on_cpu(arch_id, capsys):
    elastic_moe.main(["--arch", arch_id, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prefill-len", "8",
                      "--decode-steps", "2", "--iters", "1"])
    out = capsys.readouterr().out
    cfg = get_arch(arch_id).make_smoke()
    for name, _, _ in elastic_moe.operating_points(cfg):
        assert name in out
    assert "n/a (F4)" in out and "all logits finite: True" in out
    assert ("dense" in out) == (cfg.moe is None)


@pytest.mark.parametrize("arch_id", NEW)
def test_train_launcher_plans_full_size(arch_id, monkeypatch, capsys,
                                        tmp_path):
    """Off ``--smoke`` on the CPU the launcher prints its one-card cut and
    microbatches (``ONE_CARD_CUT``, ``ONE_CARD_ACCUM``), then reaches the
    parameters' init (``lm_init`` raises here: nothing is allocated)."""
    def no_init(*a, **k):
        raise AssertionError("initialised parameters")
    monkeypatch.setattr(ttrain, "lm_init", no_init)
    with pytest.raises(AssertionError, match="initialised parameters"):
        ttrain.main(["--arch", arch_id, "--device", "cpu", "--steps", "1",
                     "--save-every", "0", "--ckpt-dir", str(tmp_path)])
    key = (arch_id, "train_4k")
    accum = ttrain.ONE_CARD_ACCUM[key]
    out = capsys.readouterr().out
    assert (f"{arch_id} train_4k: batch 256 as {accum} microbatches of "
            f"{256 // accum}, cut to n_layers "
            f"{ONE_CARD_CUT[key]['n_layers']}") in out, out


@pytest.mark.parametrize("arch_id", NEW)
def test_train_launcher_takes_a_one_card_global_batch(arch_id, monkeypatch,
                                                      capsys, tmp_path):
    """A ``ONE_CARD_CUT`` entry that holds ``global_batch`` (as
    ``SHARED_CARD_CUT``'s entries do) sets the one-card run's batch,
    printed in the cut line; the depth cut stays, and ``--accum`` splits
    the batch."""
    def no_init(*a, **k):
        raise AssertionError("initialised parameters")
    monkeypatch.setattr(ttrain, "lm_init", no_init)
    key = (arch_id, "train_4k")
    cut = ONE_CARD_CUT[key]
    monkeypatch.setitem(ONE_CARD_CUT, key, {**cut, "global_batch": 8})
    with pytest.raises(AssertionError, match="initialised parameters"):
        ttrain.main(["--arch", arch_id, "--device", "cpu", "--steps", "1",
                     "--save-every", "0", "--accum", "2", "--ckpt-dir",
                     str(tmp_path)])
    out = capsys.readouterr().out
    assert (f"{arch_id} train_4k: batch 8 as 2 microbatches of 4, cut to "
            f"n_layers {cut['n_layers']}") in out, out
    assert "global_batch" not in out, out
