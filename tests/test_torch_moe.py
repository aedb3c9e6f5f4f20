"""The PyTorch port's MoE layer and its expert matmul against the JAX
reference.

Same params (JAX ``moe_init``, converted) and the same seeded numpy inputs
through ``repro.models.moe.moe_apply`` and ``repro_torch.models.moe``; the
port's ``expert_matmul_op`` runs its plain version on the CPU and is held
against the JAX kernel in Pallas interpret mode (as
tests/test_expert_matmul.py runs it) and its oracle.

Tolerances: expert matmul fp32 3e-4 and bf16 3e-2 (those of
tests/test_expert_matmul.py); moe_apply fp32 2e-4 and aux loss rtol 1e-5
(those of tests/test_moe.py, dense oracle against einsum dispatch).
"""
import contextlib
import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import expert_matmul as jxm  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.core.layers import cast_params  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(0)
# tests/test_moe.py's config
CFG = JM.MoEConfig(n_experts=8, top_k=2, d_ff=64, n_shared=1,
                   capacity_factor=4.0, group_size=16)
TOL = {"float32": 3e-4, "bfloat16": 3e-2}


def _tcfg(jcfg):
    return TM.MoEConfig(**dataclasses.asdict(jcfg))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, np.float32)


# --- K3 expert matmul -----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("counts", [
    [128, 128, 128, 128],          # full
    [128, 0, 64, 5],               # ragged + empty expert
    [0, 0, 0, 0],                  # all empty
    [1, 127, 128, 3],
])
def test_expert_matmul_matches_jax_kernel(dtype, counts):
    E, C, d, F = 4, 128, 64, 128
    rng = np.random.default_rng(sum(counts))
    x = rng.normal(size=(E, C, d)).astype(np.float32) * 0.5
    w = rng.normal(size=(E, d, F)).astype(np.float32) * 0.5
    xj, wj = (jnp.asarray(a).astype(dtype) for a in (x, w))
    xt, wt = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, w))
    cj = jnp.asarray(counts, jnp.int32)
    ct = torch.tensor(counts, dtype=torch.int32)
    y = ops.expert_matmul_op(xt, wt, ct)
    assert y.shape == (E, C, F) and y.dtype == xt.dtype
    tol = TOL[dtype]
    np.testing.assert_allclose(
        _np(y), _np(jxm.expert_matmul(xj, wj, cj, interpret=True)),
        rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(y), _np(jxm.expert_matmul_ref(xj, wj, cj)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(y), _np(ref.expert_matmul_ref(xt, wt, ct)),
                               rtol=tol, atol=tol)
    for e, n in enumerate(counts):                  # exact zeros past counts
        assert torch.all(y[e, n:] == 0)


def test_expert_matmul_strided_weight_views():
    """Sliced expert count and width are read as views of the full weight:
    the result equals the product with a sliced copy."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(3, 40, 24)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(5, 24, 70)).astype(np.float32))
    counts = torch.tensor([40, 0, 13], dtype=torch.int32)
    view = w[:3, :, :33]                    # a_experts 3, a_ff 33
    assert not view.is_contiguous()
    y = ops.expert_matmul_op(x, view, counts)
    torch.testing.assert_close(
        y, ref.expert_matmul_ref(x, view.contiguous(), counts),
        rtol=3e-4, atol=3e-4)
    down = torch.from_numpy(rng.normal(size=(5, 70, 24)).astype(np.float32))
    y2 = ops.expert_matmul_op(y, down[:3, :33], counts)  # wo[:, :a_ff]
    torch.testing.assert_close(
        y2, ref.expert_matmul_ref(y, down[:3, :33].contiguous(), counts),
        rtol=3e-4, atol=3e-4)


def test_expert_matmul_rejects_bad_args():
    x = torch.zeros(2, 4, 8)
    c = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):                     # K mismatch
        ops.expert_matmul_op(x, torch.zeros(2, 7, 3), c)
    with pytest.raises(ValueError):                     # counts dtype
        ops.expert_matmul_op(x, torch.zeros(2, 8, 3), c.long())
    with pytest.raises(TypeError):
        ops.expert_matmul_op(x, torch.zeros(2, 8, 3, dtype=torch.float64), c)


# --- dispatch -------------------------------------------------------------------

def _reference_kept(top_idx: np.ndarray, E: int, C: int):
    """The reference's kept slots (moe.py:145-149), in numpy."""
    G, g, k = top_idx.shape
    oh = np.eye(E, dtype=np.int64)[top_idx.reshape(G, g * k)]
    return ((np.cumsum(oh, 1) - oh) * oh).sum(-1) < C


@pytest.mark.parametrize("C", [1, 3, 4, 100])
def test_dispatch_plan_packs_the_reference_assignment(C):
    rng = np.random.default_rng(C)
    G, g, k, E = 3, 16, 2, 8
    top_idx = np.stack([np.stack([rng.choice(E, k, replace=False)
                                  for _ in range(g)]) for _ in range(G)])
    dest, keep, counts = TM.dispatch_plan(torch.from_numpy(top_idx), E, C)
    keep_ref = _reference_kept(top_idx, E, C)
    np.testing.assert_array_equal(keep.numpy(), keep_ref.reshape(-1))
    load = np.stack([np.bincount(top_idx[i].reshape(-1), minlength=E)
                     for i in range(G)])
    np.testing.assert_array_equal(counts.numpy(),
                                  np.minimum(load, C).sum(0))
    n_slab = G * C
    d = dest.numpy()
    assert np.all(d[~keep_ref.reshape(-1)] == E * n_slab)   # scratch row
    kept = d[keep_ref.reshape(-1)]
    assert len(set(kept.tolist())) == len(kept)              # no collisions
    e, r = kept // n_slab, kept % n_slab
    np.testing.assert_array_equal(e, top_idx.reshape(-1)[
        keep_ref.reshape(-1)])
    assert np.all(r < counts.numpy()[e])                     # packed rows


def test_expert_matmul_op_gradients_match_jax_vjp():
    """With a gradient wanted, the plain route (CPU) gives x and w the
    gradients of jax.vjp of the reference's oracle, zeros past each
    count, fp32 within 1e-5."""
    E, C, d, F = 4, 16, 24, 40
    counts = [16, 0, 7, 3]
    rng = np.random.default_rng(11)
    x, w, dy = (rng.normal(size=s).astype(np.float32)
                for s in ((E, C, d), (E, d, F), (E, C, F)))
    cj = jnp.asarray(counts, jnp.int32)
    _, vjp = jax.vjp(lambda a, b: jxm.expert_matmul_ref(a, b, cj),
                     jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = ops.expert_matmul_op(xt, wt, torch.tensor(counts, dtype=torch.int32))
    dx, dw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(dy))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=1e-5,
                               atol=1e-5)
    for e, n in enumerate(counts):
        assert torch.all(dx[e, n:] == 0)


def test_expert_matmul_op_kernel_route_backward_raises(monkeypatch):
    """On the kernel route K3 runs inside an autograd Function whose
    backward is K3's dgrad and wgrad (it raised before they existed): x
    and w get ``jax.vjp``'s gradients of the reference's oracle, dx exact
    zeros past each count.  (No card here: the kernel route is forced and
    its kernels are the plain versions.)"""
    monkeypatch.setattr(ops, "_use_kernel", lambda t: True)
    for name in ("expert_matmul", "expert_matmul_dgrad",
                 "expert_matmul_wgrad"):
        monkeypatch.setattr(ops._xm, name, getattr(ops._xm, name + "_plain"))
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 4, 8, generator=g, requires_grad=True)
    w = torch.randn(2, 8, 6, generator=g, requires_grad=True)
    dy = torch.randn(2, 4, 6, generator=g)
    counts = torch.tensor([4, 1], dtype=torch.int32)
    y = ops.expert_matmul_op(x, w, counts)
    assert y.grad_fn is not None
    torch.testing.assert_close(y, ops._xm.expert_matmul_plain(x, w, counts))
    y.backward(dy)
    cj = jnp.asarray(counts.numpy())
    _, vjp = jax.vjp(lambda a, b: jxm.expert_matmul_ref(a, b, cj),
                     jnp.asarray(x.detach().numpy()),
                     jnp.asarray(w.detach().numpy()))
    jdx, jdw = vjp(jnp.asarray(dy.numpy()))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(jdw), rtol=1e-5,
                               atol=1e-5)
    assert torch.all(x.grad[1, 1:] == 0)
    with torch.no_grad():      # no gradient wanted: the forward alone
        assert ops.expert_matmul_op(x, w, counts).grad_fn is None


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.mark.cuda
def test_cuda_moe_apply_backward_raises(setup):
    """On the card a backward through moe_apply reaches K3's dgrad and
    wgrad kernels (it raised before they existed): in fp32, x's and the
    routed experts' gradients equal the plain route's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _, tp, x = setup
    grads = []
    for plain in (False, True):
        p = _to(tp, dev)
        for leaf in (p["wi"], p["wg"], p["wo"]):
            leaf.requires_grad_(True)
        xt = torch.from_numpy(x).to(dev).requires_grad_()
        before = ops.launch_counts()
        with ops.plain_kernels() if plain else contextlib.nullcontext():
            y, aux = TM.moe_apply(p, xt, _tcfg(CFG))
            (y.square().sum() + aux).backward()
        ran = {k: n - before[k] for k, n in ops.launch_counts().items()}
        assert (ran["expert_matmul_dgrad"] > 0) != plain
        assert (ran["expert_matmul_wgrad"] > 0) != plain
        grads.append([xt.grad, p["wi"].grad, p["wg"].grad, p["wo"].grad])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# --- moe_apply ------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    p = JM.moe_init(KEY, 32, CFG)
    x = np.random.default_rng(0).normal(size=(2, 16, 32)).astype(np.float32)
    return p, to_torch(jax.tree_util.tree_map(np.asarray, p)), x


def _both(setup, jcfg, **kw):
    jp, tp, x = setup
    yj, aj = JM.moe_apply(jp, jnp.asarray(x), jcfg, **kw)
    yt, at = TM.moe_apply(tp, torch.from_numpy(x), _tcfg(jcfg), **kw)
    return yt, at, yj, aj


@pytest.mark.parametrize("dispatch", ["dense", "einsum"])
@pytest.mark.parametrize("knobs", [{}, {"a_experts": 4, "top_k": 1,
                                        "a_ff": 32}])
def test_moe_apply_matches_jax(setup, dispatch, knobs):
    yt, at, yj, aj = _both(setup, dataclasses.replace(CFG, dispatch=dispatch),
                           **knobs)
    assert yt.shape == (2, 16, 32)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-5)


@pytest.mark.parametrize("knobs", [{}, {"a_experts": 4, "top_k": 1}])
def test_moe_apply_capacity_drops_match_jax(setup, knobs):
    """Capacity factor 0.5 drops slots: the port drops the same ones."""
    tight = dataclasses.replace(CFG, capacity_factor=0.5, dispatch="einsum")
    yt, at, yj, aj = _both(setup, tight, **knobs)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-5)
    # the drops matter: without them the output differs
    y_roomy, _, _, _ = _both(setup, dataclasses.replace(tight,
                                                        capacity_factor=4.0),
                             **knobs)
    assert float((y_roomy - yt).abs().max()) > 1e-2


def test_moe_apply_a2a_and_masked_knobs(setup):
    _, tp, x = setup
    xt = torch.from_numpy(x)
    a2a = _tcfg(dataclasses.replace(CFG, dispatch="a2a"))
    y_none, _ = TM.moe_apply(tp, xt, a2a)             # no mesh: einsum path
    y_ein, _ = TM.moe_apply(tp, xt, _tcfg(CFG))
    torch.testing.assert_close(y_none, y_ein, rtol=0, atol=0)
    # a mesh runs the all-to-all dispatch (tests/test_torch_distributed.py);
    # anything but a DeviceMesh is refused
    with pytest.raises(TypeError, match="DeviceMesh"):
        TM.moe_apply(tp, xt, a2a, mesh=object())
    # masked knobs (0-d tensors) equal the sliced ones: read on the host,
    # they take the sliced path
    y_s, aux_s = TM.moe_apply(tp, xt, _tcfg(CFG), a_experts=4, top_k=1,
                              a_ff=32)
    y_m, aux_m = TM.moe_apply(tp, xt, _tcfg(CFG),
                              a_experts=torch.tensor(4, dtype=torch.int32),
                              top_k=1,
                              a_ff=torch.tensor(32, dtype=torch.int32))
    torch.testing.assert_close(y_m, y_s, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(aux_m, aux_s, rtol=1e-5, atol=0)


def test_moe_init_layout_and_router_stays_fp32(setup):
    _, tp, _ = setup
    p = TM.moe_init(torch.Generator().manual_seed(0), 32, _tcfg(CFG),
                    dtype=torch.bfloat16, device="cpu")
    shapes = lambda t: ({k: shapes(v) for k, v in t.items()}
                        if isinstance(t, dict) else tuple(t.shape))
    assert shapes(p) == shapes(tp)
    assert p["router"]["kernel"].dtype == torch.float32
    assert p["wi"].dtype == torch.bfloat16
    assert abs(float(p["wi"].float().std()) - 32 ** -0.5) < 0.02
    cast = cast_params(tp, torch.bfloat16)
    assert cast["router"]["kernel"].dtype == torch.float32
    assert cast["wo"].dtype == cast["shared"]["wi"]["kernel"].dtype \
        == torch.bfloat16
