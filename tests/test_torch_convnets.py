"""The conv nets of the PyTorch port against the JAX reference.

The conv family of ``core/layers.py`` (conv with JAX's asymmetric SAME
pads, sliced channels, the OFA kernel crop, depthwise and the reference's
F5 grouping, switchable BN, group norm, the stem's max-pool), ResNet and
EfficientNet on their smoke configs, one ``vis_train`` step with SGD
momentum (accum 1 and 2) and the launcher, on the CPU in fp32.
Parameters come from the reference's init, converted; inputs from numpy
seeds.  Each reference result is computed once per module, from one
reference init per net, and the reference's jitted functions of a
fixture compile in parallel.

Tolerances: layers 1e-5 (rtol and atol; outputs of order one); logits
1e-4 of the largest |logit| (a dozen fp32 conv and BN layers summed in
another order); a step's loss and gradient norm 1e-4 relative, each
updated parameter 1e-5, against the reference's step computed in
float64 (see ``step_ref``).  The models run at batch 8 (and the steps at 8
images a microbatch): at the reference's smoke batch of 2,
EfficientNet-smoke's 1x1 stages normalise over 2 values, where fp32
round-off over a near-zero variance is noise, not parity.
"""
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import efficientnet_b7 as j_eff  # noqa: E402
from repro.configs import resnet_152 as j_res  # noqa: E402
from repro.configs.registry import get_arch as j_get_arch  # noqa: E402
from repro.core import layers as JL  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import efficientnet as JEff  # noqa: E402
from repro.models import resnet as JRes  # noqa: E402
from repro.optim import make_optimizer as j_make_optimizer  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.core import layers as TL  # noqa: E402
from repro_torch.core.types import round_channels  # noqa: E402
from repro_torch.launch import flops as TF  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import efficientnet as TEff  # noqa: E402
from repro_torch.models import resnet as TRes  # noqa: E402
from repro_torch.optim import api as TO  # noqa: E402

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(0)
LAYER_TOL = 1e-5
LOGIT_TOL = 1e-4
BATCH = 8


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _x(shape, seed=0):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _close(t, j, tol=LAYER_TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               rtol=tol, atol=tol)


def _conv(ksize, c_in, c_out, groups=1, bias=False, seed=0):
    pj = JL.conv_init(jax.random.PRNGKey(seed), ksize, c_in, c_out,
                      groups=groups, bias=bias)
    if bias:
        pj["bias"] = jax.random.normal(jax.random.PRNGKey(seed + 1),
                                       (c_out,))
    return pj, to_torch(_np_tree(pj))


# --- layers -------------------------------------------------------------------

@pytest.mark.parametrize("size", [8, 9])
@pytest.mark.parametrize("k", [1, 3, 5, 7])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_same_pads_match_jax(stride, k, size):
    """Stride 1 and 2 at every kernel size on even and odd inputs: JAX's
    SAME pads the extra row and column after (7x7/2 on 8 pads 2 and 3)."""
    pj, pt = _conv(k, 6, 10, bias=True, seed=k)
    xj, xt = _x((2, size, size + 1, 6), seed=size)
    yt = TL.conv_apply(pt, xt, stride=stride)
    yj = JL.conv_apply(pj, xj, stride=stride)
    assert yt.shape == yj.shape
    _close(yt, yj)


@pytest.mark.parametrize("stride,groups,pad", [(1, 1, (1, 1)),
                                                (2, 1, (0, 0)),
                                                (1, 4, (2, 1))])
def test_conv2d_fp32_function_gradients_match_autograd(stride, groups, pad):
    """The fp32 conv's autograd Function (forward and backward under the
    same cuDNN flags) gives autograd's gradients through ``F.conv2d``."""
    g = torch.Generator().manual_seed(stride + groups)
    x = torch.randn(2, 8, 9, 9, generator=g, requires_grad=True)
    w = torch.randn(12, 8 // groups, 3, 3, generator=g, requires_grad=True)
    y = TL.Conv2dFp32.apply(x, w, stride, pad, groups)
    want = torch.nn.functional.conv2d(x, w, stride=stride, padding=pad,
                                      groups=groups)
    dy = torch.randn(y.shape, generator=g)
    got = (y,) + torch.autograd.grad(y, (x, w), dy)
    for a, b in zip(got, (want,) + torch.autograd.grad(want, (x, w), dy)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_fp32_conv_backward_is_exact_under_default_tf32_flags():
    """P3: an fp32 3x3 conv of the UNet-smoke config (32 -> 64 channels,
    batch 2 at 8 x 8) on the card, with cuDNN's TF32 left at torch's
    default (on): dx and dw within 1e-4 of their largest value of a
    float64 conv on the CPU.  TF32 (10 mantissa bits) is off by ~1e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                     allow_tf32=True):
        g = torch.Generator().manual_seed(21)
        pt = {"kernel": torch.randn(3, 3, 32, 64, generator=g) / 17.0,
              "bias": torch.zeros(64)}
        x = torch.randn(2, 8, 8, 32, generator=g)
        dy = torch.randn(2, 8, 8, 64, generator=g)
        grads = []
        for dev, dt in (("cuda", torch.float32), ("cpu", torch.float64)):
            p = {k: v.to(dev, dt).requires_grad_() for k, v in pt.items()}
            xx = x.to(dev, dt).requires_grad_()
            y = TL.conv_apply(p, xx)
            grads.append(torch.autograd.grad(y, (xx, p["kernel"]),
                                             dy.to(dev, dt)))
    for a, b in zip(*grads):
        b = b.float()
        err = float((a.cpu() - b).abs().max()) / float(b.abs().max())
        assert err <= 1e-4, err


def test_same_pads_formula():
    assert TL.same_pads(224, 7, 2) == (2, 3)      # the ResNet stem
    assert TL.same_pads(56, 3, 2) == (0, 1)
    assert TL.same_pads(112, 3, 2) == (0, 1)      # the stem's max-pool
    assert TL.same_pads(56, 3, 1) == (1, 1)
    assert TL.same_pads(57, 1, 2) == (0, 0)


@pytest.mark.parametrize("k,a_in,a_out,a_kernel,stride", [
    (5, None, 8, 3, 1),            # tests/test_elastic_layers.py:92
    (3, 5, 7, None, 1), (3, 5, 7, None, 2),
    (1, 5, 7, None, 1), (1, 5, 7, None, 2), (1, 8, 3, None, 1),
    (5, 6, None, 3, 2), (7, 2, 16, 5, 1)])
def test_conv_sliced_channels_and_kernel_crop_match_jax(k, a_in, a_out,
                                                        a_kernel, stride):
    pj, pt = _conv(k, 8, 16, bias=True, seed=3)
    xj, xt = _x((2, 8, 8, a_in or 8), seed=k)
    kw = dict(stride=stride, a_in=a_in, a_out=a_out, a_kernel=a_kernel)
    _close(TL.conv_apply(pt, xt, **kw), JL.conv_apply(pj, xj, **kw))


def test_conv_auto_slices_a_narrowed_input():
    """x narrower than the kernel's input channels: a_in = x's width."""
    pj, pt = _conv(1, 16, 12, bias=True, seed=5)
    xj, xt = _x((3, 1, 1, 9), seed=5)
    _close(TL.conv_apply(pt, xt, a_out=4), JL.conv_apply(pj, xj, a_out=4))


@pytest.mark.parametrize("a,k,a_kernel,stride", [
    (None, 3, None, 1), (None, 5, None, 2), (16, 5, 3, 1), (8, 3, None, 2),
    (24, 5, 3, 2)])
def test_depthwise_conv_matches_jax(a, k, a_kernel, stride):
    c = 24
    pj, pt = _conv(k, c, c, groups=c, seed=7)
    xj, xt = _x((2, 9, 9, a or c), seed=a or 1)
    kw = dict(stride=stride, groups=a or c, a_in=a, a_out=a,
              a_kernel=a_kernel)
    _close(TL.conv_apply(pt, xt, **kw), JL.conv_apply(pj, xj, **kw))


def test_depthwise_kernel_wider_than_x_groups_like_the_reference():
    """F5: EfficientNet's stage-0 block at setting 1 of the smoke config:
    8 input channels, kernel (3, 3, 1, 16), groups 8 -> 16 outputs, 2 a
    group."""
    pj, pt = _conv(3, 16, 16, groups=16, seed=9)
    xj, xt = _x((2, 8, 8, 8), seed=9)
    yt = TL.conv_apply(pt, xt, groups=8)
    yj = JL.conv_apply(pj, xj, groups=8)
    assert yt.shape == yj.shape == (2, 8, 8, 16)
    _close(yt, yj)


@pytest.mark.parametrize("a", [None, 5])
@pytest.mark.parametrize("setting", [0, 1])
@pytest.mark.parametrize("train", [False, True])
def test_sbn_matches_jax(train, setting, a):
    """Mirrors tests/test_elastic_layers.py:106 with random affine and
    running stats per setting and a sliced width."""
    rng = np.random.default_rng(11)
    pj = {k: jnp.asarray(rng.normal(size=(2, 8)).astype(np.float32))
          for k in ("scale", "bias", "mean")}
    pj["var"] = jnp.asarray(rng.uniform(0.5, 2.0, (2, 8)).astype(np.float32))
    xj, xt = _x((4, 3, 3, a or 8), seed=setting)
    yt, st_t = TL.sbn_apply(to_torch(_np_tree(pj)), xt, setting=setting,
                            train=train, a=a)
    yj, st_j = JL.sbn_apply(pj, xj, setting=setting, train=train, a=a)
    _close(yt, yj)
    assert (st_t is None) == (st_j is None) == (not train)
    if train:
        for t, j in zip(st_t, st_j):
            _close(t, j)


@pytest.mark.parametrize("c,groups", [(12, 4), (12, 32), (10, 4)])
def test_groupnorm_matches_jax(c, groups):
    """Mirrors tests/test_elastic_layers.py:116; 10 channels take 2
    groups (the largest divisor at or under 4)."""
    rng = np.random.default_rng(c)
    pj = {"scale": jnp.asarray(rng.normal(size=c).astype(np.float32)),
          "bias": jnp.asarray(rng.normal(size=c).astype(np.float32))}
    xj, xt = _x((2, 4, 4, c), seed=c)
    _close(TL.groupnorm_apply(to_torch(_np_tree(pj)), xt, groups=groups),
           JL.groupnorm_apply(pj, xj, groups=groups))


@pytest.mark.parametrize("size", [8, 9, 16, 112])
def test_max_pool_matches_reduce_window(size):
    """The ResNet stem's pool: 3x3/2, SAME, -inf init; negative inputs so
    a zero pad would show."""
    xj, xt = _x((2, size, size, 3), seed=size)
    xj, xt = xj - 4.0, xt - 4.0
    yj = jax.lax.reduce_window(xj, -jnp.inf, jax.lax.max, (1, 3, 3, 1),
                               (1, 2, 2, 1), "SAME")
    yt = TL.max_pool_apply(xt, window=3, stride=2)
    assert yt.shape == yj.shape
    _close(yt, yj)


def test_round_channels_and_effnet_rounding_match_reference():
    from repro.core.types import round_channels as j_round
    for dim in (8, 16, 64, 100, 256, 2048):
        for mult in (1.0, 0.75, 0.5, 0.25, 0.1):
            for of in (1, 8):
                assert round_channels(dim, mult, of) == j_round(dim, mult,
                                                                of)
    jc, tc = j_eff.make_config(), get_arch("efficientnet-b7").make_config()
    for c in (16, 24, 32, 40, 80, 112, 192, 320, 1280):
        assert tc.round_filters(c) == jc.round_filters(c)
    assert [tc.round_repeats(r) for r in range(1, 5)] == \
        [jc.round_repeats(r) for r in range(1, 5)]


# --- models -------------------------------------------------------------------

RES_CASES = [(s, d, t) for s in (0, 1) for d in (0.5, 1.0)
             for t in (False, True)]
# every value of each knob four times and every pair of values twice (a
# half of the 16 combinations: train BN where the other three knobs have
# odd parity)
EFF_CASES = [(s, d, k, (s + (d == 1.0) + (k is None)) % 2 == 1)
             for s in (0, 1) for d in (0.5, 1.0) for k in (3, None)]


def _random_bn_stats(params, rng):
    """Give every switchable BN random running stats, so eval mode is not
    the identity."""
    def walk(t):
        if isinstance(t, dict):
            if set(t) == {"scale", "bias", "mean", "var"}:
                return dict(t, mean=rng.normal(0, 0.1, t["mean"].shape)
                            .astype(np.float32),
                            var=rng.uniform(0.5, 2.0, t["var"].shape)
                            .astype(np.float32))
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return t
    return walk(params)


@functools.lru_cache(maxsize=None)
def _ref_init(arch_id):
    """The reference's init of the smoke config in one jitted call
    (eagerly, every random draw of a new shape compiles on its own), as
    numpy leaves; once per net for the module."""
    init = {"resnet-152": JRes.resnet_init,
            "efficientnet-b7": JEff.effnet_init}[arch_id]
    cfg = j_get_arch(arch_id).make_smoke()
    return _np_tree(jax.jit(functools.partial(init, cfg=cfg))(KEY))


def _run_jitted(calls):
    """Each ``(fn, args)`` of ``calls`` jitted: traced here, compiled on
    threads at once (XLA's compiler releases the GIL), then run in
    order; the outputs."""
    lowered = [jax.jit(fn).lower(*args) for fn, args in calls]
    with ThreadPoolExecutor(4) as pool:
        compiled = list(pool.map(lambda lo: lo.compile(), lowered))
    return [c(*args) for c, (_, args) in zip(compiled, calls)]


def _images(cfg, seed):
    return np.random.default_rng(seed).normal(
        size=(BATCH, cfg.img_res, cfg.img_res, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def resnet_ref():
    cfg = j_res.make_smoke()
    jp = _random_bn_stats(_ref_init("resnet-152"), np.random.default_rng(1))
    x = _images(cfg, 2)
    calls, names = [], {}
    for s, d, t in RES_CASES:
        def fwd(p, images, s=s, d=d, t=t, names=names.setdefault((s, d, t),
                                                                  [])):
            y, st = JRes.resnet_apply(p, images, cfg, setting=s,
                                      depth_mult=d, train=t, collect_stats=t)
            names += [n for n, _ in st or ()]
            return y, [ms for _, ms in st or ()]
        calls.append((fwd, (jp, jnp.asarray(x))))
    out = {}
    for (s, d, t), (y, st) in zip(RES_CASES, _run_jitted(calls)):
        out[(s, d, t)] = (np.asarray(y), [
            (n, np.asarray(m), np.asarray(v))
            for n, (m, v) in zip(names[(s, d, t)], st)] if t else None)
    return jp, x, out


@pytest.fixture(scope="module")
def effnet_ref():
    cfg = j_eff.make_smoke()
    jp = _random_bn_stats(_ref_init("efficientnet-b7"),
                          np.random.default_rng(3))
    x = _images(cfg, 4)
    ys = _run_jitted([(functools.partial(
        JEff.effnet_apply, cfg=cfg, setting=s, depth_mult=d, kernel_size=k,
        train=t), (jp, jnp.asarray(x))) for s, d, k, t in EFF_CASES])
    return jp, x, {case: np.asarray(y) for case, (y, _) in zip(EFF_CASES,
                                                             ys)}


def _logits_close(t, j):
    t = t.detach().float().numpy()
    scale = float(np.abs(j).max())
    err = float(np.abs(t - j).max())
    assert t.shape == j.shape
    assert err <= LOGIT_TOL * scale, f"{err} > {LOGIT_TOL} x {scale}"


@pytest.mark.parametrize("setting,depth_mult,train", RES_CASES)
def test_resnet_logits_match_jax(resnet_ref, setting, depth_mult, train):
    jp, x, out = resnet_ref
    cfg = get_arch("resnet-152").make_smoke()
    want, want_stats = out[(setting, depth_mult, train)]
    y, stats = TRes.resnet_apply(to_torch(jp), torch.from_numpy(x), cfg,
                                 setting=setting, depth_mult=depth_mult,
                                 train=train, collect_stats=train)
    _logits_close(y, want)
    if train:    # the batch statistics each BN returns, in the same order
        assert [n for n, _ in stats] == [n for n, _, _ in want_stats]
        for (_, (m, v)), (_, jm, jv) in zip(stats, want_stats):
            np.testing.assert_allclose(m.numpy(), jm, rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(v.numpy(), jv, rtol=1e-4, atol=1e-4)
    else:
        assert stats is None


@pytest.mark.parametrize("setting,depth_mult,kernel_size,train", EFF_CASES)
def test_effnet_logits_match_jax(effnet_ref, setting, depth_mult,
                                 kernel_size, train):
    jp, x, out = effnet_ref
    cfg = get_arch("efficientnet-b7").make_smoke()
    y, _ = TEff.effnet_apply(to_torch(jp), torch.from_numpy(x), cfg,
                             setting=setting, depth_mult=depth_mult,
                             kernel_size=kernel_size, train=train)
    _logits_close(y, out[(setting, depth_mult, kernel_size, train)])


@pytest.mark.parametrize("arch_id", ["resnet-152", "efficientnet-b7"])
def test_configs_init_and_flops_match_reference(arch_id):
    """The full and smoke configs' fields, the analytic FLOPs of a cls_224
    step, and the port's own init (smoke size) against the reference's
    parameter tree: the same paths and shapes."""
    from repro.launch import flops as JF
    ja, ta = j_get_arch(arch_id), get_arch(arch_id)
    for make in ("make_config", "make_smoke"):
        assert dataclasses.asdict(getattr(ja, make)()) == \
            dataclasses.asdict(getattr(ta, make)())
    assert ta.optimizer == ja.optimizer == "sgdm"
    shape = ta.shape("cls_224")
    assert TF.model_flops(ta, ta.make_config(), shape) == \
        JF.model_flops(ja, ja.make_config(), shape)
    init, tinit = {"resnet-152": (JRes.resnet_init, TRes.resnet_init),
                   "efficientnet-b7": (JEff.effnet_init,
                                       TEff.effnet_init)}[arch_id]
    js = jax.eval_shape(functools.partial(init, KEY, ja.make_smoke()))
    tp = tinit(torch.Generator().manual_seed(0), ta.make_smoke(),
               device="cpu")
    assert {p: tuple(v.shape) for p, v in _flat(js).items()} == \
        {p: tuple(v.shape) for p, v in TO.named_leaves(tp)}


def _flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)] = leaf
    return out


# --- one vis_train step with SGD momentum ----------------------------------

STEP_CASES = [(a, acc) for a in ("resnet-152", "efficientnet-b7")
              for acc in (1, 2)]


@pytest.fixture(scope="module")
def step_ref():
    """The reference's ``build_cell(arch, "cls_224", smoke=True).fn``
    (and with ``accum=2``), jitted as the reference's launcher runs it,
    on one seeded batch of 8 images a microbatch, from the reference's
    fp32 init, computed in float64 (``jax.enable_x64``, the smoke config
    at float64).  In fp32 the step's gradient is discontinuous at the
    ReLU kinks: at this seed one pre-activation of 128 a channel sits
    within the reference's fp32 round-off of 0 and flips, so the
    reference's fp32 gradient is off its own float64 one by up to 7% of
    a leaf (ROADMAP, traps in the reference), while the port's fp32
    gradient is within 1e-5 of it."""
    inputs, calls = [], []
    with jax.enable_x64(True):
        for arch_id, accum in STEP_CASES:
            arch = j_get_arch(arch_id)
            params = _ref_init(arch_id)
            rng = np.random.default_rng(5)
            B = BATCH * accum      # BN over 8 images a microbatch
            cfg = arch.make_smoke()
            batch = {"images": rng.normal(
                size=(B, cfg.img_res, cfg.img_res, 3)).astype(np.float32),
                "labels": rng.integers(0, cfg.n_classes, B).astype(np.int32)}
            cell = JS.build_cell(arch, "cls_224", smoke=True, accum=accum,
                                 cfg_overrides={"param_dtype": "float64",
                                                "compute_dtype": "float64"})
            p64 = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), params)
            opt = j_make_optimizer("sgdm")[0](p64)
            inputs.append((params, batch))
            calls.append((cell.fn, (p64, opt, {k: jnp.asarray(v) for k, v
                                               in batch.items()},
                                    jnp.asarray(0))))
        outs = _run_jitted(calls)
    return {case: (params, batch, _np_tree(new),
                   {k: float(v) for k, v in metrics.items()})
            for case, (params, batch), (new, _, metrics)
            in zip(STEP_CASES, inputs, outs)}


@pytest.mark.parametrize("arch_id,accum", STEP_CASES)
def test_vis_train_step_sgdm_matches_jax(step_ref, arch_id, accum):
    jp, batch, jnew, jm = step_ref[(arch_id, accum)]
    arch = get_arch(arch_id)
    cfg = arch.make_smoke()
    params = to_torch(jp)
    for _, p in TO.named_leaves(params):
        p.requires_grad_(True)
    init_fn, update_fn = TO.make_optimizer(arch.optimizer)
    step = TS.make_vis_train_step(arch_id, cfg, update_fn, accum)
    params, _, metrics = step(params, init_fn(params),
                              {k: torch.from_numpy(v)
                               for k, v in batch.items()}, 0)
    for k in ("loss", "gnorm"):
        assert abs(float(metrics[k]) - jm[k]) <= 1e-4 * abs(jm[k]), \
            (k, float(metrics[k]), jm[k])
    want = _flat(jnew)
    got = dict(TO.named_leaves(params))
    assert set(got) == set(want)
    for path, t in got.items():
        np.testing.assert_allclose(t.detach().numpy(), want[path],
                                   rtol=0, atol=1e-5, err_msg=path)


def test_accum_grads_refuses_a_ragged_split():
    with pytest.raises(ValueError):
        TS.accum_grads(lambda p, b: None, {}, {"x": torch.zeros(5)}, 2)


# --- the launcher ---------------------------------------------------------------

@pytest.mark.parametrize("arch_id", ["resnet-152", "efficientnet-b7"])
def test_train_cli_conv_net_with_failure_recovery(tmp_path, arch_id):
    """Smoke training on the CPU, a failure injected at step 3 and one
    restart from step 2's checkpoint."""
    from repro_torch.launch import train as T
    out = T.main(["--arch", arch_id, "--smoke", "--steps", "5",
                  "--save-every", "2", "--fail-at", "3", "--ckpt-dir",
                  str(tmp_path), "--log-every", "100", "--device", "cpu"])
    assert out["restarts"] == 1 and len(out["losses"]) == 5
    assert all(np.isfinite(out["losses"]))
    for _, p in TO.named_leaves(out["params"]):
        assert torch.isfinite(p).all()


def test_train_cli_refuses_sandwich_for_a_conv_net(tmp_path):
    """As the reference's launcher: --sandwich is for the vision
    transformers."""
    from repro_torch.launch import train as T
    with pytest.raises(SystemExit, match="vision-transformer"):
        T.main(["--arch", "resnet-152", "--smoke", "--sandwich",
                "--ckpt-dir", str(tmp_path), "--device", "cpu"])
