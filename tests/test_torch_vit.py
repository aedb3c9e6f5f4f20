"""The PyTorch port's ViT against the JAX reference ``vit_apply``.

Params come from the reference ``vit_init`` (converted), images from a
seeded numpy generator; both run in sliced mode with the same static
``E``.  Tolerances (fp32 logits of order one): 2e-4 for the smoke configs
(a few layers; the two frameworks sum in different orders), 1e-3 for the
full 12-layer, 197-token supernet.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import numpy as np  # noqa: E402

from repro.configs import dynamic_ofa_supernet as j_ofa  # noqa: E402
from repro.configs import deit_b as j_deit  # noqa: E402
from repro.core.elastic import spec_to_static  # noqa: E402
from repro.models import vit as JV  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import vit_params  # noqa: E402
from repro_torch.models import vit as TV  # noqa: E402

torch.set_num_threads(2)
SMOKE = j_ofa.make_smoke()
SPECS = SMOKE.elastic.enumerate()


def _dims(cfg):
    return {"d_model": cfg.d_model, "d_ff": cfg.d_ff,
            "n_heads": cfg.n_heads, "n_layers": cfg.n_layers}


def _torch_cfg(arch_id, jcfg, smoke=True):
    """The port's config of ``arch_id``, checked field by field against the
    reference's ``jcfg`` and given its compute dtype."""
    arch = get_arch(arch_id)
    t = arch.make_smoke() if smoke else arch.make_config()
    t = dataclasses.replace(t, compute_dtype=jcfg.compute_dtype)
    for f in dataclasses.fields(jcfg):
        a, b = getattr(t, f.name), getattr(jcfg, f.name)
        assert (dataclasses.asdict(a) == dataclasses.asdict(b)
                if f.name == "elastic" else a == b), f.name
    return t


def _setup(jcfg, batch, seed=0):
    jp = JV.vit_init(jax.random.PRNGKey(seed), jcfg)
    tp = vit_params(jax.tree_util.tree_map(np.asarray, jp))
    x = np.random.default_rng(seed).normal(
        size=(batch, jcfg.img_res, jcfg.img_res, 3)).astype(np.float32)
    return jp, tp, x


TSMOKE = _torch_cfg("dynamic-ofa-supernet", SMOKE)


@pytest.fixture(scope="module")
def smoke():
    return _setup(SMOKE, batch=2)


@pytest.mark.parametrize("spec", SPECS, ids=[s.name() for s in SPECS])
def test_smoke_logits_match_jax_every_spec(smoke, spec):
    jp, tp, x = smoke
    E = spec_to_static(spec, _dims(SMOKE))
    yj, _ = JV.vit_apply(jp, x, SMOKE, E=E)
    yt, _ = TV.vit_apply(tp, torch.from_numpy(x), TSMOKE, E=E)
    assert yt.shape == (2, SMOKE.n_classes)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("E", [{}, {"a_model": 16, "a_heads": 2, "a_ff": 32,
                                    "a_layers": 2}])
def test_deit_distill_token_and_exits_match_jax(E):
    jcfg = j_deit.make_smoke()
    jp, tp, x = _setup(jcfg, batch=3, seed=1)
    yj, aj = JV.vit_apply(jp, x, jcfg, E=E, return_exits=True)
    yt, at = TV.vit_apply(tp, torch.from_numpy(x), _torch_cfg("deit-b", jcfg),
                          E=E, return_exits=True)
    close = lambda t, j: np.testing.assert_allclose(
        t.numpy(), np.asarray(j), rtol=2e-4, atol=2e-4)
    close(yt, yj)
    close(at["logits_dist"], aj["logits_dist"])
    assert len(at["exit_logits"]) == len(aj["exit_logits"]) == 2
    for t, j in zip(at["exit_logits"], aj["exit_logits"]):
        close(t, j)


def test_smoke_exits_match_jax(smoke):
    jp, tp, x = smoke
    E = spec_to_static(SPECS[-1], _dims(SMOKE))
    _, aj = JV.vit_apply(jp, x, SMOKE, E=E, return_exits=True)
    _, at = TV.vit_apply(tp, torch.from_numpy(x), TSMOKE, E=E,
                         return_exits=True)
    for t, j in zip(at["exit_logits"], aj["exit_logits"]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-4,
                                   atol=2e-4)


@pytest.fixture(scope="module")
def full():
    jcfg = dataclasses.replace(j_ofa.make_config(), compute_dtype="float32")
    return (jcfg,) + _setup(jcfg, batch=1, seed=2)


@pytest.mark.parametrize("which", ["max", "min"])
def test_full_config_224px_matches_jax(full, which):
    jcfg, jp, tp, x = full
    spec = getattr(jcfg.elastic, f"{which}_spec")()
    E = spec_to_static(spec, _dims(jcfg))
    yj, _ = JV.vit_apply(jp, x, jcfg, E=E)
    yt, _ = TV.vit_apply(tp, torch.from_numpy(x),
                         _torch_cfg("dynamic-ofa-supernet", jcfg, smoke=False),
                         E=E)
    assert yt.shape == (1, 1000)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-3,
                               atol=1e-3)


def test_torch_init_distributions_match_reference_layout():
    """The port's own init: same tree and shapes as the converted JAX
    params, the reference's scales, and the same weights for one seed."""
    cfg = get_arch("dynamic-ofa-supernet").make_smoke()
    p = TV.vit_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    q = TV.vit_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    jp = vit_params(jax.tree_util.tree_map(
        np.asarray, JV.vit_init(jax.random.PRNGKey(0), SMOKE)))

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return tuple(t.shape)

    assert shapes(p) == shapes(jp)
    assert torch.equal(p["layers"][3]["mlp"]["wi"]["kernel"],
                       q["layers"][3]["mlp"]["wi"]["kernel"])
    wi = p["layers"][0]["mlp"]["wi"]["kernel"]
    scale = cfg.d_model ** -0.5
    assert abs(float(wi.std()) - scale) < 0.1 * scale
    assert abs(float(p["pos"].std()) - 0.02) < 0.005
    assert torch.all(p["final_ln"]["scale"] == 1)
    assert torch.all(p["head"]["bias"] == 0)
    assert p["head"]["kernel"].device == torch.device("cpu")


def test_vit_init_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("dynamic-ofa-supernet").make_smoke()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TV.vit_init(torch.Generator().manual_seed(0), cfg)


def parity_report():
    """Max |port - reference| per ported module on the CPU, at the sizes of
    the tests above (``python tests/test_torch_vit.py``)."""
    import jax.numpy as jnp
    from repro.core import layers as JL
    from repro.kernels import ops as jops
    from repro_torch.convert import to_torch
    from repro_torch.core import layers as TL
    from repro_torch.kernels import ops as tops

    key = jax.random.PRNGKey(0)
    rng = np.random.default_rng(0)
    conv = lambda p: to_torch(jax.tree_util.tree_map(np.asarray, p))
    err = lambda t, j: float(np.max(np.abs(
        (t.float() if isinstance(t, torch.Tensor) else t).numpy()
        - np.asarray(j, np.float32))))
    rows = []

    def pair(shape):
        a = rng.normal(size=shape).astype(np.float32)
        return jnp.asarray(a), torch.from_numpy(a)

    xj, xt = pair((64, 256))
    wj, wt = pair((256, 384))
    rows.append(("kernels.ops.elastic_matmul_op fp32 (129, 255)",
                 err(tops.elastic_matmul_op(xt, wt, 129, 255),
                     jops.elastic_matmul_op(xj, wj, 129, 255, bm=32)),
                 2e-4))
    qj, qt = pair((2, 197, 6, 64))
    kj, kt = pair((2, 197, 6, 64))
    vj, vt = pair((2, 197, 6, 64))
    from repro.kernels.ref import flash_attention_ref
    flat = lambda a: a.transpose(0, 2, 1, 3).reshape(12, 197, 64)
    oref = np.asarray(flash_attention_ref(flat(qj * 0.3), flat(kj * 0.3),
                                          flat(vj), causal=False))
    oref = oref.reshape(2, 6, 197, 64).transpose(0, 2, 1, 3)
    rows.append(("kernels.ops.flash_attention_op fp32 T=197",
                 err(tops.flash_attention_op(qt * 0.3, kt * 0.3, vt,
                                             causal=False), oref), 3e-3))
    pd = JL.dense_init(key, 48, 40)
    xj, xt = pair((3, 5, 24))
    rows.append(("core.layers.dense_apply (24 -> 40 of 48 x 40)",
                 err(TL.dense_apply(conv(pd), xt, a_in=24),
                     JL.dense_apply(pd, xj, a_in=24)), 1e-4))
    pl = {"scale": jax.random.normal(key, (48,)),
          "bias": jax.random.normal(key, (48,))}
    xj, xt = pair((2, 5, 13))
    rows.append(("core.layers.layernorm_apply (a=13 of 48)",
                 err(TL.layernorm_apply(conv(pl), xt, a=13),
                     JL.layernorm_apply(pl, xj, a=13)), 1e-4))
    pm = JL.mlp_init(key, 32, 128, gated=False, bias=True)
    xj, xt = pair((2, 7, 16))
    rows.append(("core.layers.mlp_apply gelu (16, 24)",
                 err(TL.mlp_apply(conv(pm), xt, a_model=16, a_ff=24,
                                  act="gelu"),
                     JL.mlp_apply(pm, xj, a_model=16, a_ff=24, act="gelu")),
                 1e-4))
    pa = JL.attention_init(key, 32, 6, 6, 8, qkv_bias=True)
    xj, xt = pair((2, 17, 24))
    rows.append(("core.layers.attention_apply (heads 4 of 6, d 24)",
                 err(TL.attention_apply(conv(pa), xt, n_heads=6, n_kv=6,
                                        d_head=8, causal=False, a_model=24,
                                        a_heads=4)[0],
                     JL.attention_apply(pa, xj, n_heads=6, n_kv=6, d_head=8,
                                        causal=False, rope_theta=None,
                                        a_model=24, a_heads=4)[0]), 1e-4))
    pc = JL.conv_init(key, 16, 3, 48, bias=True)
    xj, xt = pair((2, 224, 224, 3))
    rows.append(("core.layers.conv_apply patch embed 224 px / 16",
                 err(TL.conv_apply(conv(pc), xt, stride=16),
                     JL.conv_apply(pc, xj, stride=16, padding="VALID")),
                 1e-4))
    jp, tp, x = _setup(SMOKE, batch=2)
    worst = 0.0
    for spec in SPECS:
        E = spec_to_static(spec, _dims(SMOKE))
        worst = max(worst, err(TV.vit_apply(tp, torch.from_numpy(x), TSMOKE,
                                            E=E)[0],
                               JV.vit_apply(jp, x, SMOKE, E=E)[0]))
    rows.append((f"models.vit.vit_apply smoke, all {len(SPECS)} specs",
                 worst, 2e-4))
    jcfg = dataclasses.replace(j_ofa.make_config(), compute_dtype="float32")
    jp, tp, x = _setup(jcfg, batch=1, seed=2)
    tcfg = _torch_cfg("dynamic-ofa-supernet", jcfg, smoke=False)
    for which in ("max", "min"):
        E = spec_to_static(getattr(jcfg.elastic, f"{which}_spec")(),
                           _dims(jcfg))
        rows.append((f"models.vit.vit_apply full 224 px fp32, {which} spec",
                     err(TV.vit_apply(tp, torch.from_numpy(x), tcfg, E=E)[0],
                         JV.vit_apply(jp, x, jcfg, E=E)[0]), 1e-3))
    print("| module | max abs err (CPU) | tolerance |")
    print("| --- | --- | --- |")
    for name, e, tol in rows:
        print(f"| {name} | {e:.3g} | {tol:g} |")


if __name__ == "__main__":
    parity_report()
