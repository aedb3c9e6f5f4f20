"""Kernel wrappers of the PyTorch port against the JAX reference.

On the CPU the wrappers run the kernels' plain versions; they are held
against the JAX ops (Pallas interpret mode, as tests/test_kernels.py runs
them) and the oracles of kernels/ref.py on the same numpy inputs.  The
CUDA kernels themselves are compared with their plain versions by the
``cuda``-marked tests, which skip on a host without a card.

Tolerances: fp32 2e-4 (matmul) and 3e-3 (attention), as the reference's
kernel tests; bf16 2e-2, the bf16 rounding of outputs of order one.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import elastic_matmul as em  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

torch.set_num_threads(2)

TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    t = torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))
    return j, t


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# --- K1 elastic matmul --------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ka,na", [(256, 384), (128, 384), (256, 200),
                                   (100, 100), (1, 1), (129, 255)])
def test_elastic_matmul_matches_jax(dtype, ka, na):
    rng = np.random.default_rng(ka * 1000 + na)
    xj, xt = _pair(rng.normal(size=(64, 256)), dtype)
    wj, wt = _pair(rng.normal(size=(256, 384)), dtype)
    y = ops.elastic_matmul_op(xt, wt, ka, na)
    y_jax = jops.elastic_matmul_op(xj, wj, ka, na, bm=32)
    y_ref = jref.elastic_matmul_ref(xj, wj, ka, na)
    tol = TOL[dtype]
    assert y.shape == (64, 384) and y.dtype == xt.dtype
    np.testing.assert_allclose(_np(y), _np(y_jax), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(y), _np(y_ref), rtol=tol, atol=tol)
    assert np.all(_np(y)[:, na:] == 0)          # exact zeros past n_act


@pytest.mark.parametrize("m,k_act,n_act", [(1, 1, 1), (17, 129, 255),
                                           (40, 256, 384), (3, 64, 1)])
def test_elastic_matmul_torch_ref_and_sliced_mode(m, k_act, n_act):
    """The op in the TPU shape equals the port's ref oracle; in sliced mode
    (x of width k_act, only the active columns out) it equals the slice of
    the same product read from the full resident weight."""
    rng = np.random.default_rng(m)
    x = torch.from_numpy(rng.normal(size=(m, 256)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(256, 384)).astype(np.float32))
    full = ops.elastic_matmul_op(x, w, k_act, n_act)
    torch.testing.assert_close(full, ref.elastic_matmul_ref(x, w, k_act, n_act),
                               rtol=2e-4, atol=2e-4)
    sliced = ops.elastic_matmul_op(x[:, :k_act], w, k_act, n_act,
                                   n_out=n_act)
    assert sliced.shape == (m, n_act)
    torch.testing.assert_close(sliced, full[:, :n_act], rtol=0, atol=0)


def test_elastic_matmul_batched_lead_dims():
    x = torch.randn(2, 5, 48, generator=torch.Generator().manual_seed(0))
    w = torch.randn(48, 32, generator=torch.Generator().manual_seed(1))
    y = ops.elastic_matmul_op(x, w, 40, 20)
    assert y.shape == (2, 5, 32)
    torch.testing.assert_close(y[..., :20], x[..., :40] @ w[:40, :20])


def test_elastic_matmul_rejects_bad_args():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        ops.elastic_matmul_op(x, torch.zeros(8, 6), 9, 3)     # k_act > K
    with pytest.raises(ValueError):
        ops.elastic_matmul_op(x, torch.zeros(8, 6), 8, 7)     # n_act > N
    with pytest.raises(TypeError):
        ops.elastic_matmul_op(x, torch.zeros(8, 6, dtype=torch.float64), 8, 6)
    with pytest.raises(ValueError):                           # no such device
        ops.elastic_matmul_op(x.to("meta"), torch.zeros(8, 6, device="meta"),
                              8, 6)


# --- K2 flash attention -------------------------------------------------------

def _qkv(rng, B, S, T, H, KH, D):
    q = rng.normal(size=(B, S, H, D)) * 0.3
    k = rng.normal(size=(B, T, KH, D)) * 0.3
    v = rng.normal(size=(B, T, KH, D))
    return q, k, v


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,H,KH", [(17, 4, 4), (17, 4, 2), (256, 2, 1)])
def test_flash_attention_matches_jax_op(causal, S, H, KH):
    """T a multiple of the reference's KV block: the JAX op is exact there."""
    rng = np.random.default_rng(S + H + KH)
    q, k, v = _qkv(rng, 2, S, S, H, KH, 32)
    o = ops.flash_attention_op(*(torch.from_numpy(a.astype(np.float32))
                                 for a in (q, k, v)), causal=causal)
    bq = 128 if S % 128 == 0 else S
    o_jax = jops.flash_attention_op(*(jnp.asarray(a, jnp.float32)
                                      for a in (q, k, v)),
                                    causal=causal, bq=bq, bkv=bq)
    np.testing.assert_allclose(_np(o), _np(o_jax), rtol=3e-3, atol=3e-3)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [17, 197])
@pytest.mark.parametrize("H,KH", [(6, 6), (6, 2)])
def test_flash_attention_matches_ref(causal, T, H, KH):
    """Against the JAX oracle at the ViT's token counts (not the JAX op,
    whose zero-padded keys are wrong at T=197: fault F1)."""
    rng = np.random.default_rng(T * 10 + KH)
    q, k, v = _qkv(rng, 2, T, T, H, KH, 64)
    o = ops.flash_attention_op(*(torch.from_numpy(a.astype(np.float32))
                                 for a in (q, k, v)), causal=causal)
    kr, vr = np.repeat(k, H // KH, 2), np.repeat(v, H // KH, 2)
    flat = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3).reshape(
        -1, a.shape[1], a.shape[3]), jnp.float32)
    o_ref = jref.flash_attention_ref(flat(q), flat(kr), flat(vr),
                                     causal=causal)
    o_ref = np.asarray(o_ref).reshape(2, H, T, 64).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_np(o), o_ref, rtol=3e-3, atol=3e-3)


def test_flash_attention_rejects_bad_args():
    q = torch.zeros(1, 4, 3, 8)
    with pytest.raises(ValueError):                     # H % KH != 0
        ops.flash_attention_op(q, torch.zeros(1, 4, 2, 8),
                               torch.zeros(1, 4, 2, 8))
    with pytest.raises(TypeError):
        ops.flash_attention_op(q, q.double(), q.double())


# --- build and routing (no nvcc here) -----------------------------------------

def test_build_command_targets_hopper():
    cmd = build.nvcc_command("nvcc", "elastic_matmul",
                             build.BUILD_DIR / "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert {"-O3", "-shared", "-fPIC"} <= set(cmd)
    assert cmd[-1].endswith("csrc/elastic_matmul.cu")
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").exists()
        assert build.library_path(name).parent == build.BUILD_DIR


def test_plain_kernels_context_is_thread_local_and_restores():
    assert not getattr(ops._state, "plain", False)
    with ops.plain_kernels():
        assert ops._state.plain
    assert not ops._state.plain


# --- on the card --------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_elastic_matmul_matches_plain(cuda, dtype):
    g = torch.Generator().manual_seed(0)
    dt = getattr(torch, dtype)
    x = torch.randn(1576, 384, generator=g).to(cuda, dt)
    w = (torch.randn(384, 1536, generator=g) / 384 ** 0.5).to(cuda, dt)
    before = em.launches
    for ka, na, n_out in [(384, 1536, 1536), (288, 1152, 1536),
                          (192, 1000, 1000), (129, 255, 1536)]:
        y = ops.elastic_matmul_op(x, w, ka, na, n_out=n_out)
        with ops.plain_kernels():
            y_plain = ops.elastic_matmul_op(x, w, ka, na, n_out=n_out)
        torch.cuda.synchronize()
        tol = TOL[dtype]
        torch.testing.assert_close(y.float(), y_plain.float(), rtol=tol,
                                   atol=tol)
        assert torch.all(y[:, na:] == 0)
    assert em.launches == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S,H,KH,D", [(197, 6, 6, 64), (197, 6, 3, 64),
                                      (17, 4, 4, 16), (18, 4, 4, 8)])
def test_cuda_flash_attention_matches_plain(cuda, causal, S, H, KH, D):
    g = torch.Generator().manual_seed(1)
    q = (torch.randn(8, S, H, D, generator=g) * 0.3).to(cuda)
    k = (torch.randn(8, S, KH, D, generator=g) * 0.3).to(cuda)
    v = torch.randn(8, S, KH, D, generator=g).to(cuda)
    before = fa.launches
    o = ops.flash_attention_op(q, k, v, causal=causal)
    with ops.plain_kernels():
        o_plain = ops.flash_attention_op(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(o, o_plain, rtol=3e-3, atol=3e-3)
    assert fa.launches == before + 1
