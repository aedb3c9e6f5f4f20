"""The diffusion nets of the PyTorch port against the JAX reference.

The DDPM schedule, ``q_sample`` and the DDIM loop (on a fixed x_T, with a
linear denoiser and with the DiT-smoke denoiser), ``dit_apply`` and
``unet_apply`` on their smoke configs at full width and at each elastic
knob, DiT's sliced mode against its masked mode, one ``diff_train`` step
with AdamW (accum 1 and 2), the launcher's seeded batches, the model-FLOPs
counts and the launcher end to end, on the CPU in fp32.  Parameters come
from the reference's init, converted, with the zero-init leaves (DiT's
``ada`` and ``final_ada``, the UNet's ``proj_out``) drawn from a seeded
normal: at init they gate every block's output to exactly 0, and a
comparison would check none of the blocks.  Each reference result is
computed once per module, from one reference init per net; the
reference's jitted functions of a fixture compile in parallel.

Tolerances: the substrate 1e-5 (values of order one); denoiser outputs
1e-4 of the largest output; a step's loss and gradient norm 1e-4
relative, each updated parameter as the sandwich step's AdamW test allows
(``tests/test_torch_train.py``: 1e-3 of the learning rate).
"""
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import get_arch as j_get_arch  # noqa: E402
from repro.data import synthetic_image_batches as j_images  # noqa: E402
from repro.launch import flops as JF  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.launch import train as JT  # noqa: E402
from repro.models import diffusion as JD  # noqa: E402
from repro.models import dit as JDiT  # noqa: E402
from repro.models import unet as JU  # noqa: E402
from repro.optim import make_optimizer as j_make_optimizer  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import to_torch, vit_params  # noqa: E402
from repro_torch.data import synthetic_label_batches  # noqa: E402
from repro_torch.launch import flops as TF  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch import train as TT  # noqa: E402
from repro_torch.models import diffusion as TD  # noqa: E402
from repro_torch.models import dit as TDiT  # noqa: E402
from repro_torch.models import unet as TU  # noqa: E402
from repro_torch.optim import api as TO  # noqa: E402

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(0)
SUB_TOL = 1e-5
OUT_TOL = 1e-4
BATCH = 2
LR = 1e-4          # AdamW's default learning rate
ARCHS = ("dit-l2", "unet-sdxl")
CONVERT = {"dit-l2": vit_params, "unet-sdxl": to_torch}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _run_jitted(calls):
    """Each ``(fn, args)`` of ``calls`` jitted: traced here, compiled on
    threads at once (XLA's compiler releases the GIL), then run in
    order; the outputs."""
    lowered = [jax.jit(fn).lower(*args) for fn, args in calls]
    with ThreadPoolExecutor(4) as pool:
        compiled = list(pool.map(lambda lo: lo.compile(), lowered))
    return [c(*args) for c, (_, args) in zip(compiled, calls)]


def _ungate(tree, rng):
    """The zero-init leaves (``ada``, ``final_ada``, ``proj_out``) drawn
    from a seeded normal: kernels at 0.5/sqrt(fan_in), biases at 0.1."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k in ("ada", "final_ada", "proj_out"):
                ker = v["kernel"]
                fan_in = ker.shape[-2]
                out[k] = {"kernel": (rng.normal(size=ker.shape) * 0.5
                                     / np.sqrt(fan_in)).astype(np.float32),
                          "bias": (rng.normal(size=v["bias"].shape)
                                   * 0.1).astype(np.float32)}
            else:
                out[k] = _ungate(v, rng)
        return out
    if isinstance(tree, list):
        return [_ungate(v, rng) for v in tree]
    return tree


@functools.lru_cache(maxsize=None)
def _ref_init(arch_id):
    """The reference's init of the smoke config in one jitted call, with
    the zero-init leaves drawn non-zero, as numpy leaves; once per net."""
    init = {"dit-l2": JDiT.dit_init, "unet-sdxl": JU.unet_init}[arch_id]
    cfg = j_get_arch(arch_id).make_smoke()
    params = _np_tree(jax.jit(functools.partial(init, cfg=cfg))(KEY))
    return _ungate(params, np.random.default_rng(11))


def _inputs(arch_id, B=BATCH, seed=0):
    """Seeded latents, t and conditioning of the smoke config (numpy)."""
    cfg = j_get_arch(arch_id).make_smoke()
    rng = np.random.default_rng(seed)
    r = cfg.latent_res
    out = {"latents": rng.normal(size=(B, r, r, 4)).astype(np.float32),
           "t": rng.integers(0, 1000, B).astype(np.int32)}
    if arch_id == "dit-l2":
        out["cond"] = {"y": rng.integers(0, cfg.n_classes, B)
                       .astype(np.int32)}
    else:
        out["cond"] = {
            "ctx": rng.normal(size=(B, 77, cfg.ctx_dim)).astype(np.float32),
            "pooled": rng.normal(size=(B, cfg.pooled_dim))
            .astype(np.float32)}
    return out


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def _j_denoise(arch_id, cfg, E=None):
    if arch_id == "dit-l2":
        return lambda p, x, t, c: JDiT.dit_apply(p, x, t, c["y"], cfg, E=E)
    return lambda p, x, t, c: JU.unet_apply(p, x, t, c["ctx"], c["pooled"],
                                            cfg, E=E)


def _of_largest(got, want, tol=OUT_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert np.isfinite(got).all() and err <= tol * scale, (err, scale)


# --- the substrate --------------------------------------------------------------

@pytest.mark.parametrize("dim", [256, 32, 320])
def test_timestep_embedding_matches_jax(dim):
    """1e-5, plus what one ulp of the fp32 frequency does to cos and sin
    at t: XLA's exp and torch's differ by an ulp at some frequencies (14
    of 128 at dim 256), which t up to 999 turns into an argument error of
    up to t * f * 2^-23 (3e-5 at t = 999)."""
    t = np.array([0, 1, 17, 250, 999], np.int32)
    got = TDiT.timestep_embedding(torch.from_numpy(t), dim).numpy()
    want = np.asarray(JDiT.timestep_embedding(jnp.asarray(t), dim))
    half = dim // 2
    freqs = np.exp(-np.log(10000.0) * np.arange(half) / half)
    arg = np.abs(t[:, None] * freqs[None])
    tol = SUB_TOL + np.concatenate([arg, arg], -1) * 2.0 ** -22
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


def test_schedule_and_q_sample_match_jax():
    sj, st = JD.make_schedule(), TD.make_schedule()
    for k in ("betas", "alphas", "alphas_bar"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]),
                                   rtol=SUB_TOL, atol=0)
    rng = np.random.default_rng(2)
    x0 = rng.normal(size=(6, 4, 4, 4)).astype(np.float32)
    noise = rng.normal(size=x0.shape).astype(np.float32)
    t = np.array([0, 1, 500, 998, 999, 3], np.int32)
    got = TD.q_sample(st, *map(torch.from_numpy, (x0, t, noise)))
    want = JD.q_sample(sj, *map(jnp.asarray, (x0, t, noise)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SUB_TOL,
                               atol=SUB_TOL)


@pytest.mark.parametrize("steps", [1, 2, 3, 4, 10, 50, 100])
def test_ddim_timesteps_match_jax(steps):
    """The sampler's timesteps at the repo's step counts (gen_fast's 4,
    gen_1024's 50) and others, with the reference's fp32 round-off (4
    steps: 999, 665, 332, 0)."""
    want = np.asarray(jnp.linspace(999, 0, steps).astype(jnp.int32))
    assert TD.ddim_timesteps(1000, steps) == want.tolist()
    if steps == 4:
        assert want.tolist() == [999, 665, 332, 0]


def _ddim_pair(j_fn, t_fn, shape, steps):
    """The reference's ``ddim_sample`` (its x_T drawn from KEY) and the
    port's ``ddim_loop`` from that same x_T."""
    sj = JD.make_schedule()
    want = jax.jit(lambda k: JD.ddim_sample(j_fn, sj, shape, k,
                                            steps=steps))(KEY)
    x_T = np.asarray(jax.random.normal(KEY, shape, jnp.float32))
    got = TD.ddim_loop(t_fn, TD.make_schedule(), torch.from_numpy(x_T),
                       steps=steps)
    return got, want


@pytest.mark.parametrize("steps", [1, 4, 10])
def test_ddim_loop_linear_denoiser_matches_jax(steps):
    """A linear denoiser whose output depends on t: eps = 0.3 x + t/1000."""
    def j_fn(x, t):
        return 0.3 * x + (t.astype(jnp.float32) / 1000.0)[:, None, None,
                                                             None]

    def t_fn(x, t):
        return 0.3 * x + (t.float() / 1000.0)[:, None, None, None]
    got, want = _ddim_pair(j_fn, t_fn, (3, 4, 4, 4), steps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SUB_TOL,
                               atol=SUB_TOL)


def test_ddim_loop_dit_smoke_denoiser_matches_jax():
    """Four DDIM steps through the DiT-smoke denoiser (8 output channels:
    the first 4 are the noise estimate)."""
    jp = _ref_init("dit-l2")
    cfg, tcfg = (j_get_arch("dit-l2").make_smoke(),
                 get_arch("dit-l2").make_smoke())
    tp = vit_params(jp)
    y = np.array([1, 7], np.int32)
    r = cfg.latent_res
    got, want = _ddim_pair(
        lambda x, t: JDiT.dit_apply(_j(jp), x, t, jnp.asarray(y), cfg),
        lambda x, t: TDiT.dit_apply(tp, x, t, torch.from_numpy(y), tcfg),
        (2, r, r, 4), 4)
    # of the largest value: each step divides by sqrt(alphas_bar[t])
    # (1/157 at t = 999), so the iterate grows to a few hundred
    _of_largest(got, want, SUB_TOL)


# --- the denoisers --------------------------------------------------------------

def _dit_cases(cfg):
    """Full width, each knob at half alone, and all four at half."""
    half = {"a_model": cfg.d_model // 2, "a_layers": cfg.n_layers // 2,
            "a_heads": cfg.n_heads // 2, "a_ff": cfg.d_ff // 2}
    return dict([("full", {})] + [(k, {k: v}) for k, v in half.items()]
                + [("all", half)])


DIT_CASES = _dit_cases(j_get_arch("dit-l2").make_smoke())
UNET_CASES = {"full": {}, "depth_mult": {"depth_mult": 0.5},
              "a_ff": {"a_ff": 64}}


@pytest.fixture(scope="module")
def denoise_ref():
    """The reference's denoiser outputs of both smoke nets at every case
    (sliced), and DiT's masked mode at all four knobs, jitted, compiled at
    once."""
    calls, keys = [], []
    for arch_id, cases in (("dit-l2", DIT_CASES), ("unet-sdxl", UNET_CASES)):
        cfg = j_get_arch(arch_id).make_smoke()
        inp = _j(_inputs(arch_id))
        args = (_j(_ref_init(arch_id)), inp["latents"], inp["t"],
                inp["cond"])
        for name, E in cases.items():
            calls.append((_j_denoise(arch_id, cfg, E), args))
            keys.append((arch_id, name, "sliced"))
        if arch_id == "dit-l2":
            E = {k: jnp.asarray(v) for k, v in DIT_CASES["all"].items()}
            calls.append((_j_denoise(arch_id, cfg, E), args))
            keys.append((arch_id, "all", "masked"))
    return {k: np.asarray(v) for k, v in zip(keys, _run_jitted(calls))}


def _t_denoise(arch_id, E):
    cfg = get_arch(arch_id).make_smoke()
    inp = _t(_inputs(arch_id))
    tp = CONVERT[arch_id](_ref_init(arch_id))
    with torch.no_grad():
        return TS.diff_denoise(arch_id, cfg, E)(tp, inp["latents"], inp["t"],
                                                inp["cond"])


@pytest.mark.parametrize("case", sorted(DIT_CASES))
def test_dit_apply_matches_jax(denoise_ref, case):
    _of_largest(_t_denoise("dit-l2", DIT_CASES[case]),
                denoise_ref[("dit-l2", case, "sliced")])


def test_dit_apply_masked_matches_jax(denoise_ref):
    """Masked mode (0-d width tensors) at all four knobs against the
    reference's masked mode."""
    E = {k: torch.tensor(v, dtype=torch.int32)
         for k, v in DIT_CASES["all"].items()}
    _of_largest(_t_denoise("dit-l2", E),
                denoise_ref[("dit-l2", "all", "masked")])


@pytest.mark.parametrize("case", sorted(UNET_CASES))
def test_unet_apply_matches_jax(denoise_ref, case):
    _of_largest(_t_denoise("unet-sdxl", UNET_CASES[case]),
                denoise_ref[("unet-sdxl", case, "sliced")])


def test_dit_sliced_equals_masked():
    """The paper's knob on DiT: sliced == masked (tests/test_models.py's
    test_elastic_subnets_slice_eq_mask for dit-l2)."""
    cfg = get_arch("dit-l2").make_smoke()
    tp = vit_params(_ref_init("dit-l2"))
    inp = _t(_inputs("dit-l2"))
    E_s = {"a_model": cfg.d_model // 2, "a_ff": cfg.d_ff // 2,
           "a_heads": cfg.n_heads // 2, "a_layers": cfg.n_layers // 2}
    E_m = {k: torch.tensor(v, dtype=torch.int32) for k, v in E_s.items()}
    with torch.no_grad():
        a = TDiT.dit_apply(tp, inp["latents"], inp["t"], inp["cond"]["y"],
                           cfg, E=E_s)
        b = TDiT.dit_apply(tp, inp["latents"], inp["t"], inp["cond"]["y"],
                           cfg, E=E_m)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_upsample_picks_the_nearest_row_and_column():
    h = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 5)
    want = jax.image.resize(jnp.asarray(h.numpy()), (2, 6, 8, 5), "nearest")
    assert np.array_equal(TU._upsample2x(h).numpy(), np.asarray(want))


def test_dit_remat_gives_the_same_gradients():
    """remat (checkpoint per block) recomputes the block in the backward:
    the same loss and gradients as without it."""
    cfg = get_arch("dit-l2").make_smoke()
    inp = _t(_inputs("dit-l2"))
    grads = []
    for remat in ("none", "dots"):
        tp = vit_params(_ref_init("dit-l2"))
        for _, p in TO.named_leaves(tp):
            p.requires_grad_(True)
        c = dataclasses.replace(cfg, remat=remat)
        out = TDiT.dit_apply(tp, inp["latents"], inp["t"], inp["cond"]["y"],
                             c)
        out.square().mean().backward()
        grads.append({k: p.grad for k, p in TO.named_leaves(tp)})
    for k, g in grads[0].items():
        torch.testing.assert_close(grads[1][k], g, rtol=1e-6, atol=1e-7)


# --- the training step ----------------------------------------------------------

STEP_CASES = [(a, n) for a in ARCHS for n in (1, 2)]
STEP_B = 4


def _step_batch(arch_id, seed=5):
    b = _inputs(arch_id, B=STEP_B, seed=seed)
    b["noise"] = np.random.default_rng(seed + 1).normal(
        size=b["latents"].shape).astype(np.float32)
    return b


@pytest.fixture(scope="module")
def step_ref():
    """The reference's ``build_cell(arch, "train_256", smoke=True).fn``
    (and with ``accum=2``), jitted, from the smoke init with the gates
    drawn non-zero, on one seeded batch of 4."""
    calls = []
    for arch_id, accum in STEP_CASES:
        cell = JS.build_cell(j_get_arch(arch_id), "train_256", smoke=True,
                             accum=accum)
        jp = _j(_ref_init(arch_id))
        opt = j_make_optimizer("adamw")[0](jp)
        calls.append((cell.fn, (jp, opt, _j(_step_batch(arch_id)),
                                jnp.asarray(0))))
    return {case: (_np_tree(new), {k: float(v) for k, v in m.items()})
            for case, (new, _, m) in zip(STEP_CASES, _run_jitted(calls))}


@pytest.mark.parametrize("arch_id,accum", STEP_CASES)
def test_diff_train_step_adamw_matches_jax(step_ref, arch_id, accum):
    jnew, jm = step_ref[(arch_id, accum)]
    arch = get_arch(arch_id)
    cfg = arch.make_smoke()
    params = CONVERT[arch_id](_ref_init(arch_id))
    for _, p in TO.named_leaves(params):
        p.requires_grad_(True)
    init_fn, update_fn = TO.make_optimizer(arch.optimizer)
    step = TS.make_diff_train_step(arch_id, cfg, update_fn, accum)
    params, _, m = step(params, init_fn(params), _t(_step_batch(arch_id)), 0)
    for k in ("loss", "gnorm"):
        assert abs(float(m[k]) - jm[k]) <= 1e-4 * abs(jm[k]), \
            (k, float(m[k]), jm[k])
    want = dict(TO.named_leaves(CONVERT[arch_id](jnew)))
    got = dict(TO.named_leaves(params))
    old = dict(TO.named_leaves(CONVERT[arch_id](_ref_init(arch_id))))
    assert set(got) == set(want)
    saturated = total = 0
    for path, t in got.items():
        # the first AdamW step moves p by lr * (u + wd * p), u = g / (|g| +
        # eps): where the reference's |u| >= 0.99 (|g| >= 99 eps) u is
        # insensitive to the gradients' round-off and the step is held to
        # 1e-3 of lr; elsewhere |g| is at eps's scale (a key bias, whose
        # true gradient is 0, or a bias before a group norm of one channel
        # a group) and u is round-off in either package: held to lr
        p0, w = old[path].numpy(), want[path].numpy()
        u = (p0 - w) / LR - (0.1 * p0 if TO._wd_ok(path) else 0.0)
        sat = np.abs(u) >= 0.99
        atol = np.where(sat, 1e-3 * LR, LR)
        err = np.abs(t.detach().numpy() - w)
        assert np.all(err <= atol), (path, float(err.max()))
        saturated, total = saturated + int(sat.sum()), total + sat.size
    assert saturated >= 0.9 * total, (saturated, total)


# --- the launcher, the FLOPs counts ----------------------------------------------

@pytest.mark.parametrize("arch_id", ARCHS)
@pytest.mark.parametrize("step", [0, 3])
def test_diffusionize_matches_reference_byte_for_byte(arch_id, step):
    """The launcher's batch at a step: the reference's image stream's
    labels (drawn before its images) through ``_diffusionize``."""
    for smoke in (True, False):
        jcfg = (j_get_arch(arch_id).make_smoke() if smoke
                else j_get_arch(arch_id).make_config())
        tcfg = (get_arch(arch_id).make_smoke() if smoke
                else get_arch(arch_id).make_config())
        B = 2 if smoke else 3
        res = 64 if smoke else 256
        jb = next(j_images(global_batch=B, img_res=res,
                           n_classes=getattr(jcfg, "n_classes", 10),
                           start_step=step))
        tb = next(synthetic_label_batches(
            global_batch=B, n_classes=getattr(tcfg, "n_classes", 10),
            start_step=step))
        assert tb["labels"].tobytes() == jb["labels"].tobytes()
        want = JT._diffusionize({k: jnp.asarray(v) for k, v in jb.items()},
                                dataclasses.replace(jcfg, img_res=res), step)
        got = TT.diffusionize(tb, dataclasses.replace(tcfg, img_res=res),
                              step)
        wl = jax.tree_util.tree_leaves_with_path(want)
        gl = jax.tree_util.tree_leaves_with_path(got)
        assert [p for p, _ in wl] == [p for p, _ in gl]
        for (path, w), (_, g) in zip(wl, gl):
            w = np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape, path
            assert g.tobytes() == w.tobytes(), path


@pytest.mark.parametrize("arch_id", ARCHS)
def test_configs_and_model_flops_match_reference(arch_id):
    ja, ta = j_get_arch(arch_id), get_arch(arch_id)
    assert ta.family == ja.family == "diffusion"
    for name, js in ja.shapes.items():
        assert dataclasses.asdict(ta.shape(name)) == dataclasses.asdict(js)
    for make in ("make_config", "make_smoke"):
        jc, tc = getattr(ja, make)(), getattr(ta, make)()
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        for name in ja.shapes:
            shape = ja.shape(name)
            jr = dataclasses.replace(jc, img_res=shape.img_res)
            tr = dataclasses.replace(tc, img_res=shape.img_res)
            assert TF.model_flops(ta, tr, ta.shape(name)) == \
                JF.model_flops(ja, jr, shape)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_train_cli_diffusion_with_failure_recovery(tmp_path, arch_id):
    """Smoke training on the CPU: checkpoints at steps 0, 2 and 4, a
    failure injected at step 4, one restart from step 2's checkpoint; the
    resumed step 3 repeats the first run's step 3 bit for bit."""
    out = TT.main(["--arch", arch_id, "--smoke", "--steps", "5",
                   "--save-every", "2", "--fail-at", "4", "--ckpt-dir",
                   str(tmp_path), "--log-every", "100", "--device", "cpu"])
    assert out["restarts"] == 1 and len(out["losses"]) == 6
    assert out["losses"][4] == out["losses"][3]
    assert all(np.isfinite(out["losses"]))
    for _, p in TO.named_leaves(out["params"]):
        assert torch.isfinite(p).all()
