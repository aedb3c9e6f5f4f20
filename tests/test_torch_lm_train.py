"""LM training in the PyTorch port against the JAX reference.

K2's plain backward (causal, head dims 16 and 128, and GQA) and K3's
plain dgrad and wgrad against ``jax.vjp`` of the reference's oracles; one
AdamW train step of ``deepseek-moe-16b``'s smoke config (``accum`` 1 and
2) against the reference's ``build_cell(.., "train_4k", smoke=True)``
step; per-layer remat against no remat; the token-file reader; the
launcher's LM family end to end; the backward kernels' variant choices.
All on the CPU in fp32: the kernels themselves run on the card only
(``tests/test_torch_kernels.py``'s ``cuda`` tests, ``chip_smoke.py``).

Tolerances: oracle gradients 1e-5 (values of order one); the step's loss
1e-5 and gradient norm 1e-4 relative; each updated parameter as the
diffusion step's AdamW test allows (1e-3 of the learning rate where the
reference's |u| >= 0.99, else the learning rate).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import get_arch as j_get_arch  # noqa: E402
from repro.data import memmap_token_batches as j_memmap  # noqa: E402
from repro.kernels.expert_matmul import expert_matmul_ref  # noqa: E402
from repro.kernels.ref import flash_attention_ref  # noqa: E402
from repro.launch import flops as JF  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import make_optimizer as j_make_optimizer  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_params  # noqa: E402
from repro_torch.data import memmap_token_batches  # noqa: E402
from repro_torch.kernels import expert_matmul as xm  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import flops as TF  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch import train as TT  # noqa: E402
from repro_torch.models import transformer as TM  # noqa: E402
from repro_torch.optim import api as TO  # noqa: E402

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(0)
ARCH = "deepseek-moe-16b"
LR = 1e-4          # AdamW's default learning rate
ORACLE_TOL = 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# --- the backward oracles --------------------------------------------------------

@pytest.mark.parametrize("D,S,H,KH,causal", [(16, 33, 4, 4, True),
                                             (128, 17, 2, 2, True),
                                             (16, 40, 4, 2, True),
                                             (128, 9, 2, 1, False),
                                             # ragged: the wgmma kernel's
                                             # 64-query chunks, 128-key
                                             # tiles
                                             (64, 127, 4, 2, True),
                                             (64, 129, 4, 2, False),
                                             (128, 127, 2, 2, False),
                                             (128, 129, 4, 2, True),
                                             # kimi-k2's head dim, causal,
                                             # GQA and MQA
                                             (112, 65, 8, 2, True),
                                             (112, 129, 8, 1, True),
                                             (112, 40, 4, 4, False)])
def test_flash_attention_bwd_plain_matches_jax_vjp(D, S, H, KH, causal):
    """The plain backward (the formulas the kernels compute, from P) at
    the LMs' head dims 128 and 112 and the smoke config's 16, causal, with
    GQA's
    kv-head gradients summed over their query heads: ``jax.vjp`` of the
    reference's oracle on the kv heads repeated to H."""
    B, R = 2, H // KH
    rng = np.random.default_rng(D + S)
    q, do = (rng.normal(size=(B, S, H, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(B, S, KH, D)).astype(np.float32)
            for _ in range(2))

    def heads(t):       # (B, S, h, D) -> (B*h, S, D)
        return jnp.swapaxes(t, 1, 2).reshape(-1, S, D)

    def ref(q_, k_, v_):
        rep = (lambda t: jnp.repeat(t, R, axis=2)) if R > 1 else (lambda t: t)
        o = flash_attention_ref(heads(q_), heads(rep(k_)), heads(rep(v_)),
                                causal=causal)
        return jnp.swapaxes(o.reshape(B, H, S, D), 1, 2)
    o, vjp = jax.vjp(ref, *(jnp.asarray(t) for t in (q, k, v)))
    want = vjp(jnp.asarray(do))
    got = fa.flash_attention_bwd_plain(
        *(torch.from_numpy(t) for t in (q, k, v)),
        torch.from_numpy(np.asarray(o)), torch.from_numpy(do), causal=causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=ORACLE_TOL, atol=ORACLE_TOL)


def test_expert_matmul_bwd_plain_matches_jax_vjp():
    """K3's plain dgrad and wgrad (the functions the kernels compute) are
    ``jax.vjp`` of the reference's oracle, with NaN in dy past every count
    (the forward wrote constant zeros there: no gradient flows back) and
    a dead expert's dw exactly 0."""
    E, C, K, F = 4, 16, 8, 6
    counts = [16, 0, 7, 3]
    rng = np.random.default_rng(12)
    x, w, dy = (rng.normal(size=s).astype(np.float32)
                for s in ((E, C, K), (E, K, F), (E, C, F)))
    cj = jnp.asarray(counts, jnp.int32)
    _, vjp = jax.vjp(lambda a, b: expert_matmul_ref(a, b, cj),
                     jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    ct = torch.tensor(counts, dtype=torch.int32)
    dyt = torch.from_numpy(dy)
    for e, n in enumerate(counts):
        dyt[e, n:] = float("nan")
    dx = xm.expert_matmul_dgrad_plain(dyt, torch.from_numpy(w), ct)
    dw = xm.expert_matmul_wgrad_plain(torch.from_numpy(x), dyt, ct)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=ORACLE_TOL,
                               atol=ORACLE_TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=ORACLE_TOL,
                               atol=ORACLE_TOL)
    assert torch.all(dw[1] == 0)
    for e, n in enumerate(counts):
        assert torch.all(dx[e, n:] == 0)


# --- the backward kernels' variants (chosen on the host) --------------------------

def test_backward_variant_choices():
    """K3's dgrad and its wgrad go to ``persistent`` for bf16 TMA can
    read, whatever the counts; ``tile_bf16`` for a stride-0
    expert axis (the dense oracle's tokens), an unaligned row stride or
    dy rows TMA cannot take; ``tile_f32`` for fp32.  K2's backward takes
    causal and D = 128 on ``wgmma``, keeps ``resident`` for the
    non-causal D = 64 sandwich step, and raises for a head dim no kernel
    takes."""
    bf, f32 = torch.bfloat16, torch.float32
    pick = xm.choose_bwd_variant
    for kind, want in (("dgrad", "persistent"), ("wgrad", "persistent")):
        assert pick(1408, bf, (2048 * 1408, 1408), True, kind) == want
        assert pick(2048, bf, (2048 * 1408, 1408), True,
                    kind) == want                       # a_ff view
        assert pick(1408, bf, (0, 2048), True, kind) == "tile_bf16"
        assert pick(1408, bf, (2048 * 1408, 1404), True, kind) == "tile_bf16"
        assert pick(1412, bf, (2048 * 1408, 1408), True, kind) == "tile_bf16"
        assert pick(1408, bf, (2048 * 1408, 1408), False,
                    kind) == "tile_bf16"
        assert pick(1408, f32, (2048 * 1408, 1408), True, kind) == "tile_f32"
    x = torch.zeros(4, 32, 64, dtype=bf)
    dy = torch.zeros(4, 32, 48, dtype=bf)
    assert xm.bwd_variant_of(x, dy, "wgrad") == "persistent"
    assert xm.bwd_variant_of(x[:1].expand(4, 32, 64), dy,
                             "wgrad") == "tile_bf16"
    assert xm.bwd_variant_of(x.float(), dy.float(), "wgrad") == "tile_f32"
    w = torch.zeros(4, 64, 48, dtype=bf)
    assert xm.bwd_variant_of(w, dy) == "persistent"
    assert xm.bwd_variant_of(w[:1].expand(4, 64, 48), dy) == "tile_bf16"
    choose = fa.choose_bwd_variant
    assert choose(4096, 4096, 128, bf, True) == "wgmma"
    assert choose(197, 197, 64, bf, True) == "wgmma"
    assert choose(197, 197, 128, bf, False) == "wgmma"
    assert choose(197, 197, 64, bf, False) == "resident"
    assert choose(64, 64, 16, f32, True) == "fma_f32"
    for D, dt in ((16, bf), (32, f32), (128, f32)):
        with pytest.raises(NotImplementedError):
            choose(64, 64, D, dt, True)


# --- the train step ---------------------------------------------------------------

STEP_ACCUMS = (1, 2)


def _j_cfg():
    return j_get_arch(ARCH).make_smoke()


def _ref_init():
    return _np_tree(JT.lm_init(KEY, _j_cfg()))


def _step_batch(B=2, S=64, seed=5):
    toks = np.random.default_rng(seed).integers(
        0, _j_cfg().vocab_size, size=(B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.fixture(scope="module")
def step_ref():
    """The reference's ``build_cell(.., "train_4k", smoke=True).fn`` at
    accum 1 and 2 from one init, jitted, on one seeded batch of 2 x 64."""
    jp = jax.tree_util.tree_map(jnp.asarray, _ref_init())
    opt = j_make_optimizer("adamw")[0](jp)
    batch = {k: jnp.asarray(v) for k, v in _step_batch().items()}
    out = {}
    for accum in STEP_ACCUMS:
        cell = JS.build_cell(j_get_arch(ARCH), "train_4k", smoke=True,
                             accum=accum)
        new, _, m = jax.jit(cell.fn)(jp, opt, batch, jnp.asarray(0))
        out[accum] = (_np_tree(new), {k: float(v) for k, v in m.items()})
    return out


def _trainable(jp):
    params = lm_params(jp)
    for _, p in TO.named_leaves(params):
        p.requires_grad_(True)
    return params


@pytest.mark.parametrize("accum", STEP_ACCUMS)
def test_lm_train_step_adamw_matches_jax(step_ref, accum):
    jnew, jm = step_ref[accum]
    arch = get_arch(ARCH)
    init_fn, update_fn = TO.make_optimizer(arch.optimizer)
    step = TS.make_lm_train_step(arch.make_smoke(), update_fn, accum)
    params = _trainable(_ref_init())
    batch = {k: torch.from_numpy(v) for k, v in _step_batch().items()}
    params, _, m = step(params, init_fn(params), batch, 0)
    assert abs(float(m["loss"]) - jm["loss"]) <= 1e-5 * abs(jm["loss"]), \
        (float(m["loss"]), jm["loss"])
    assert abs(float(m["gnorm"]) - jm["gnorm"]) <= 1e-4 * abs(jm["gnorm"]), \
        (float(m["gnorm"]), jm["gnorm"])
    want = dict(TO.named_leaves(lm_params(jnew)))
    got = dict(TO.named_leaves(params))
    old = dict(TO.named_leaves(lm_params(_ref_init())))
    assert set(got) == set(want)
    saturated = total = 0
    for path, t in got.items():
        # the first AdamW step moves p by lr * (u + wd * p), u = g / (|g|
        # + eps): where the reference's |u| >= 0.99 u is insensitive to the
        # gradients' round-off and the step is held to 1e-3 of lr;
        # elsewhere |g| is at eps's scale (an expert no token reached, a
        # router column) and u is round-off in either package: held to lr
        p0, w = old[path].numpy(), want[path].numpy()
        u = (p0 - w) / LR - (0.1 * p0 if TO._wd_ok(path) else 0.0)
        sat = np.abs(u) >= 0.99
        err = np.abs(t.detach().numpy() - w)
        assert np.all(err <= np.where(sat, 1e-3 * LR, LR)), \
            (path, float(err.max()))
        saturated, total = saturated + int(sat.sum()), total + sat.size
    assert saturated >= 0.8 * total, (saturated, total)


def test_lm_remat_gives_the_same_gradients():
    """remat (checkpoint per layer) recomputes each layer, MoE routing
    included, in the backward: the same loss and gradients as without."""
    batch = {k: torch.from_numpy(v) for k, v in _step_batch(seed=6).items()}
    cfg = get_arch(ARCH).make_smoke()
    grads = []
    for remat in ("none", "dots_nb"):
        params = _trainable(_ref_init())
        c = dataclasses.replace(cfg, remat=remat)
        logits, aux, _ = TM.lm_apply(params, batch["tokens"], c)
        (logits.square().mean() + aux).backward()
        grads.append({k: p.grad for k, p in TO.named_leaves(params)})
    for k, g in grads[0].items():
        assert g is not None, k
        torch.testing.assert_close(grads[1][k], g, rtol=1e-6, atol=1e-7)


def test_lm_cfg_overrides_and_train_flops_match_reference():
    """``make_lm_train_step``'s ``cfg_overrides`` is the reference's
    ``build_cell`` one (the launcher's one-card depth cut), and the
    model-FLOPs count of a train_4k step is the reference's."""
    _, update_fn = TO.make_optimizer("adamw")
    cut = TT.ONE_CARD_CUT[(ARCH, "train_4k")]
    step = TS.make_lm_train_step(get_arch(ARCH).make_config(), update_fn,
                                 cfg_overrides=cut)
    jcfg = dataclasses.replace(j_get_arch(ARCH).make_config(), **cut)
    assert (step.cfg.n_layers, step.cfg.n_dense_layers,
            step.cfg.n_moe_layers) == (4, 1, 3)
    for f in ("n_layers", "d_model", "vocab_size", "d_ff_dense"):
        assert getattr(step.cfg, f) == getattr(jcfg, f)
    n = TF.lm_param_counts(step.cfg)
    total = n["body_total"] + 2 * n["unembed"]
    assert 2.26e9 < total < 2.28e9        # the launcher's reckoning
    assert TF.lm_model_flops(step.cfg, "train", 256, 4096) == \
        JF.lm_model_flops(jcfg, "train", 256, 4096)


# --- data and the launcher --------------------------------------------------------

@pytest.mark.parametrize("start_step", [0, 5])
def test_memmap_token_batches_match_reference(tmp_path, start_step):
    """The token-file reader, batch for batch the reference's (wrapping
    past the file's last whole step)."""
    data = np.random.default_rng(3).integers(
        0, 1000, size=4 * 2 * 9 + 5).astype(np.int32)
    path = tmp_path / "toks.bin"
    data.tofile(path)
    got = memmap_token_batches(str(path), global_batch=2, seq_len=8,
                               start_step=start_step)
    want = j_memmap(str(path), global_batch=2, seq_len=8,
                    start_step=start_step)
    for _ in range(6):
        b, r = next(got), next(want)
        assert b["tokens"].shape == (2, 8)
        assert b["tokens"].dtype == np.int32
        np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(b[k], r[k])


def test_train_cli_lm_smoke_with_failure_recovery(tmp_path, capsys):
    """``--arch deepseek-moe-16b --smoke --device cpu``: finite losses and
    one restart after the injected failure, from the last checkpoint or,
    with none (``--save-every 0``, as ``chip_smoke.py`` runs the full
    width), from step 0 with that step's loss repeated bit for bit; the
    cut line printed."""
    base = ["--arch", ARCH, "--smoke", "--device", "cpu", "--log-every",
            "100"]
    out = TT.main(base + ["--steps", "4", "--save-every", "2", "--fail-at",
                          "3", "--ckpt-dir", str(tmp_path / "a")])
    assert out["restarts"] == 1 and len(out["losses"]) == 4
    assert all(np.isfinite(out["losses"]))
    out = TT.main(base + ["--steps", "3", "--save-every", "0", "--fail-at",
                          "1", "--ckpt-dir", str(tmp_path / "b")])
    assert out["restarts"] == 1 and len(out["losses"]) == 4
    assert out["losses"][1] == out["losses"][0]    # step 0 ran twice
    assert "train_4k: batch 2 as 1 microbatch of 2" in capsys.readouterr().out
    with pytest.raises(ValueError, match="prefill shape"):
        TT.main(base + ["--shape", "prefill_32k", "--ckpt-dir",
                        str(tmp_path / "c")])
