"""Kernel wrappers of the PyTorch port against the JAX reference.

On the CPU the wrappers run the kernels' plain versions; they are held
against the JAX ops (Pallas interpret mode, as tests/test_kernels.py runs
them) and the oracles of kernels/ref.py on the same numpy inputs.  The
CUDA kernels themselves are compared with their plain versions by the
``cuda``-marked tests, which skip on a host without a card.

Tolerances: fp32 2e-4 (matmul) and 3e-3 (attention), as the reference's
kernel tests; bf16 2e-2, the bf16 rounding of outputs of order one.
"""
import math
import re

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import elastic_matmul as em  # noqa: E402
from repro_torch.kernels import expert_matmul as xm  # noqa: E402
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
    # plain bf16 products accumulate in fp32, as the kernels do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
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


# --- variant choice and split plans (plain Python, as the wrappers run it) ---

@pytest.mark.parametrize("M,k_act,n_act,dtype,ldx,ldw,aligned,want", [
    (1, 2048, 2048, torch.bfloat16, 2048, 2048, True, "small_m"),
    (4, 2048, 102400, torch.bfloat16, 2048, 102400, True, "small_m"),
    (16, 129, 255, torch.bfloat16, 129, 384, False, "small_m"),
    (4, 2048, 64, torch.float32, 2048, 64, True, "small_m"),
    (17, 384, 384, torch.bfloat16, 384, 384, True, "tma"),
    (1576, 288, 1152, torch.bfloat16, 288, 1536, True, "tma"),
    (2048, 10944, 2048, torch.bfloat16, 10944, 2048, True, "tma"),
    (2048, 129, 255, torch.bfloat16, 129, 384, True, "tile_bf16"),
    (2048, 128, 256, torch.bfloat16, 128, 388, True, "tile_bf16"),
    # the conv nets: ResNet-152's stage 0 at batch 256, its width 0.25,
    # EfficientNet-B7's squeeze-excite widths 20 and 12 (no TMA), fp32 SE
    (802816, 64, 256, torch.bfloat16, 64, 256, True, "tma"),
    (802816, 16, 16, torch.bfloat16, 16, 64, True, "tma"),
    (64, 480, 20, torch.bfloat16, 480, 20, True, "tile_bf16"),
    (64, 12, 288, torch.bfloat16, 12, 288, True, "tile_bf16"),
    (256, 288, 12, torch.float32, 288, 12, True, "f32_splitk"),
    (2048, 128, 256, torch.bfloat16, 128, 384, False, "tile_bf16"),
    (2048, 0, 256, torch.bfloat16, 128, 384, True, "tile_bf16"),
    (2048, 2048, 64, torch.float32, 2048, 64, True, "f32_splitk"),  # router
    (2048, 2048, 32, torch.float32, 2048, 64, True, "f32_splitk"),
    (17, 2048, 64, torch.float32, 2048, 64, True, "f32_splitk"),
    (2048, 2048, 64, torch.float32, 2050, 64, True, "tile_f32"),   # ldx
    (2048, 2048, 64, torch.float32, 2048, 66, True, "tile_f32"),   # ldw
    (2048, 2048, 64, torch.float32, 2048, 64, False, "tile_f32"),  # base
])
def test_elastic_matmul_variant_choice(M, k_act, n_act, dtype, ldx, ldw,
                                       aligned, want):
    assert em.choose_variant(M, k_act, n_act, dtype, ldx, ldw,
                             aligned) == want


@pytest.mark.parametrize("M,n_act,want", [
    (2048, 2048, (2, 256)),        # LM prefill: 128 tiles of 128 x 256
    (2048, 102400, (2, 256)),      # lm_head
    (2048, 10944, (2, 256)),       # 688 tiles: 87% of 6 waves
    (2048, 2816, (2, 128)),        # 176 of 264 wave slots: too idle
    (1576, 1536, (2, 128)),        # ViT wi at bucket 8: 156 tiles
    (2048, 1536, (2, 128)),
    (1576, 384, (1, 128)),         # ViT q/k/v/o: 75 tiles of 64 x 128
    (17, 1536, (1, 128)),
])
def test_tma_tile(M, n_act, want):
    assert em.tma_tile(M, n_act) == want


@pytest.mark.parametrize("k_act,n_act,elem,want", [
    (2048, 2048, 2, (8, 256)),        # decode q/k/v/o: 256 blocks
    (2048, 102400, 2, (4, 512)),      # lm_head: x staging caps a split
    (10944, 2048, 2, (22, 512)),      # dense wo
    (2816, 2048, 2, (11, 256)),       # shared experts' down product
    (384, 1000, 2, (1, 384)),         # ViT head: one split, no reduce
    (2048, 64, 4, (8, 256)),          # fp32 router: 16 rows at once
    (129, 255, 4, (1, 144)),
    (1, 1, 2, (1, 32)),
    (0, 5, 2, (1, 32)),
])
def test_small_m_plan(k_act, n_act, elem, want):
    splits, kc = em.small_m_plan(k_act, n_act, elem)
    assert (splits, kc) == want
    assert kc <= em.SMALL_M_KC_MAX and splits * kc >= k_act
    assert (splits - 1) * kc < max(k_act, 1)      # no empty split


@pytest.mark.parametrize("M,k_act,n_act,want", [
    (2048, 2048, 64, (8, 256)),     # the router at prefill: 256 blocks
    (2048, 2048, 32, (8, 256)),     # at the half-expert points
    (17, 2048, 63, (16, 128)),      # one tile: 16 splits, capped
    (4096, 2048, 64, (4, 512)),     # 64 tiles
    (1576, 384, 1536, (1, 384)),    # 600 tiles: more than 2 an SM
    (64, 17, 96, (1, 32)),          # k_act under the 128 a split takes
    (2048, 2000, 64, (8, 256)),     # 8 splits of 250 -> of 256
    (2048, 0, 64, (1, 16)),
])
def test_f32_splitk_plan(M, k_act, n_act, want):
    """f32_splitk's split of K over its 64 x 64 tiles: rows per split a
    multiple of the 16 a stage holds, the splits covering k_act exactly
    once, none under 128 rows, at most 16, and (tile, split) blocks that
    fill at least one wave of 132 SMs at the router's prefill shape."""
    splits, kc = em.f32_splitk_plan(M, k_act, n_act)
    assert (splits, kc) == want
    bm = em.F32_SPLITK_BM
    assert kc % em.F32_SPLITK_BK == 0
    assert (splits - 1) * kc < max(k_act, 1) <= splits * kc or k_act == 0
    assert splits <= em.F32_SPLITK_SPLITS_MAX
    assert splits == 1 or kc >= em.F32_SPLITK_KC_MIN
    bn = em.F32_SPLITK_BN
    tiles = -(-M // bm) * max(1, -(-n_act // bn))
    assert tiles * splits <= em.F32_SPLITK_BLOCKS_PER_SM * em.SMS \
        or splits == 1
    if (M, k_act) == (2048, 2048):
        assert tiles * splits >= em.SMS


def test_router_shapes_take_f32_splitk_at_prefill_and_small_m_at_decode():
    """The fp32 MoE router (d_model 2048 -> 64 experts) at prefill (4 x 512
    tokens) goes to f32_splitk, at decode (M = 4) to small_m."""
    for M, want in ((2048, "f32_splitk"), (4, "small_m")):
        assert em.choose_variant(M, 2048, 64, torch.float32, 2048, 64,
                                 True) == want


@pytest.mark.parametrize("S,T,D,dtype,causal,want", [
    (197, 197, 64, torch.bfloat16, False, "resident"),  # sandwich step
    (1, 1, 64, torch.bfloat16, False, "resident"),
    (2, 1, 64, torch.bfloat16, False, "resident"),      # one key: dS = 0
    (1, 197, 64, torch.bfloat16, False, "resident"),    # one query
    (256, 256, 64, torch.bfloat16, False, "resident"),
    (65, 77, 64, torch.bfloat16, False, "resident"),
    (577, 577, 64, torch.bfloat16, False, "wgmma"),     # ViT at 336 px
    (257, 100, 64, torch.bfloat16, False, "wgmma"),
    (100, 300, 64, torch.bfloat16, False, "wgmma"),     # keys past 256
    (197, 197, 64, torch.float32, False, "fma_f32"),
    (577, 577, 64, torch.float32, False, "fma_f32"),
])
def test_flash_attention_bwd_variant_choice(S, T, D, dtype, causal, want):
    """From shapes and dtype only: the wrapper copies rows the kernels
    cannot read with 16-byte loads before it launches either."""
    assert fa.choose_bwd_variant(S, T, D, dtype, causal) == want


@pytest.mark.parametrize("S,T,D,causal", [
    (197, 197, 64, True), (512, 512, 128, True), (197, 197, 128, False),
    (17, 17, 16, False)])
def test_flash_attention_bwd_variant_choice_refuses(S, T, D, causal):
    """A head dim no kernel takes raises: bf16 takes 64 and 128 (causal
    or not, on wgmma since its long-sequence redesign), fp32 8, 16 and 64
    (fma_f32); causal no longer raises anywhere."""
    for dtype, dims in ((torch.bfloat16, (64, 128)),
                        (torch.float32, (8, 16, 64))):
        if D in dims:
            want = "fma_f32" if dtype == torch.float32 else "wgmma"
            assert fa.choose_bwd_variant(S, T, D, dtype, causal) == want
            continue
        with pytest.raises(NotImplementedError):
            fa.choose_bwd_variant(S, T, D, dtype, causal)


def test_new_kernels_match_their_source_constants():
    """The wrappers' plans and limits agree with the constants the CUDA
    sources were written for (no nvcc here: read as text)."""
    k1 = (build.CSRC / "elastic_matmul.cu").read_text()
    for decl in (f"SK_BN = {em.F32_SPLITK_BN};",
                 f"SK_BK = {em.F32_SPLITK_BK};",
                 f"__launch_bounds__(SK_THREADS, "
                 f"{em.F32_SPLITK_BLOCKS_PER_SM})",
                 f"SK_BM = {em.F32_SPLITK_BM};"):
        assert decl in k1, decl
    k2 = (build.CSRC / "flash_attention.cu").read_text()
    assert f"R_T_MAX = {fa.RESIDENT_MAX};" in k2
    assert f"W_KEYS = {fa.WGMMA_KEYS};" in k2
    assert f"W_BQ = {fa.WGMMA_CHUNK};" in k2
    k3 = (build.CSRC / "expert_matmul.cu").read_text()
    assert "P_BM = {};".format(xm.PERSISTENT_TILE[0]) in k3
    assert "P_BN = {};".format(xm.PERSISTENT_TILE[1]) in k3
    assert f"P_E_MAX = {xm.PERSISTENT_E_MAX};" in k3


# --- K2's wgmma backward and K3's persistent dgrad: choices and plans -------

@pytest.mark.parametrize("S,T,D,dtype,causal,want", [
    (256, 256, 64, torch.bfloat16, False, "resident"),   # the boundary
    (257, 256, 64, torch.bfloat16, False, "wgmma"),
    (256, 257, 64, torch.bfloat16, False, "wgmma"),
    (1, 1, 64, torch.bfloat16, True, "wgmma"),           # causal, any size
    (1, 1, 128, torch.bfloat16, False, "wgmma"),         # D = 128, any size
    (127, 129, 128, torch.bfloat16, False, "wgmma"),
    (4096, 4096, 128, torch.bfloat16, True, "wgmma"),    # the LM's train_4k
    (4096, 4096, 64, torch.float32, True, "fma_f32"),    # fp32 stays
    (300, 300, 16, torch.float32, False, "fma_f32"),
    (129, 129, 8, torch.float32, True, "fma_f32"),
])
def test_flash_attention_bwd_wgmma_boundaries(S, T, D, dtype, causal, want):
    """bf16 calls that resident does not take -- causal, D = 128, S or T
    past 256 -- go to wgmma; fp32 keeps fma_f32 at every size."""
    assert fa.choose_bwd_variant(S, T, D, dtype, causal) == want


@pytest.mark.parametrize("B,H,KH,S,T,want", [
    (4, 16, 16, 4096, 4096, (4 * 16 * 32, 4 * 16 * 4096, 4 * 16 * 64)),
    (2, 4, 2, 129, 129, (2 * 2 * 2, 2 * 4 * 129, 2 * 4 * 3)),
    (2, 4, 2, 127, 300, (2 * 2 * 3, 2 * 4 * 127, 2 * 4 * 2)),
    (1, 2, 2, 1, 1, (2, 2, 2)),
])
def test_wgmma_backward_plan(B, H, KH, S, T, want):
    """A block per (128-key tile, batch, kv head); the fp32 dQ workspace
    (B, H, S, D) rows and one ticket per (batch, head, 64-query chunk)."""
    assert fa.wgmma_plan(B, H, KH, S, T) == want


@pytest.mark.parametrize("F,K,E,aligned,kind,dtype,want", [
    (1408, 2048, 64, True, "dgrad", torch.bfloat16, "persistent"),
    (2048, 1408, 64, True, "dgrad", torch.bfloat16, "persistent"),
    (2048, 1056, 64, True, "dgrad", torch.bfloat16, "persistent"),
    (2048, 1060, 64, True, "dgrad", torch.bfloat16, "tma"),  # dx rows
    (2048, 1408, 513, True, "dgrad", torch.bfloat16, "tma"),  # the scan
    (2048, 1408, 512, True, "dgrad", torch.bfloat16, "persistent"),
    (2048, 1408, 64, True, "wgrad", torch.bfloat16, "persistent"),
    (1408, 2048, 64, True, "wgrad", torch.bfloat16, "persistent"),
    (1408, 2048, 512, True, "wgrad", torch.bfloat16, "persistent"),
    (1408, 2048, 513, True, "wgrad", torch.bfloat16, "tma"),  # the order
    (1408, 1060, 64, True, "wgrad", torch.bfloat16, "persistent"),  # dw K
    (1408, 2048, 64, True, "wgrad", torch.float32, "tile_f32"),
    (2048, 1408, 64, False, "dgrad", torch.bfloat16, "tile_bf16"),
    (2048, 1408, 64, True, "dgrad", torch.float32, "tile_f32"),
])
def test_expert_matmul_persistent_dgrad_choice(F, K, E, aligned, kind,
                                               dtype, want):
    """dgrad takes persistent where TMA reads dy and w and stores dx (K a
    multiple of 8) and the scan holds the experts; wgrad where TMA reads
    x and dy and its prologue orders the experts; else tma."""
    st = (K * F, F)
    assert xm.choose_bwd_variant(F, dtype, st, aligned, kind, K,
                                 E) == want


@pytest.mark.parametrize("E,how,dtype,want", [
    (512, "contiguous", torch.bfloat16, "persistent"),
    (513, "contiguous", torch.bfloat16, "tma"),
    (64, "a_ff view", torch.bfloat16, "persistent"),   # x strided in place
    (64, "stride-0 experts", torch.bfloat16, "tile_bf16"),
    (64, "contiguous", torch.float32, "tile_f32"),
])
def test_expert_matmul_wgrad_variant_of(E, how, dtype, want):
    """The wgrad a call's tensors send it to: persistent up to 512
    experts, tma past them, tile_bf16 for the dense oracle's stride-0
    expert axis, tile_f32 in fp32."""
    x = torch.zeros(E, 3, 64 if how == "a_ff view" else 48, dtype=dtype)
    if how == "a_ff view":
        x = x[..., :48]
    elif how == "stride-0 experts":
        x = x[:1].expand(E, 3, 48)
    dy = torch.zeros(E, 3, 40, dtype=dtype)
    assert xm.bwd_variant_of(x, dy, "wgrad") == want


@pytest.mark.parametrize("E,K,F,sms,want", [
    (64, 2048, 1408, 132, 132),      # the train_4k up and gate slabs
    (64, 1408, 2048, 132, 132),      # the down projection
    (1, 64, 8, 132, 1),              # one item
    (2, 300, 512, 132, 2 * 3 * 2),   # fewer items than SMs
    (64, 2048, 1408, 114, 114),      # another card's SM count
    (1, 128, 256, 132, 1),           # one 256-column item
    (1, 128, 264, 132, 2),           # a second, mostly past F
    (1, 128, 128, 132, 1),           # F 128: half of one item
    (1, 256, 8, 132, 2),             # two K tiles
    (3, 1408, 704, 132, 3 * 11 * 3),  # the a_ff 704 slice
    (2, 1056, 1408, 132, 2 * 9 * 6),  # a_ff 1056 as dw's K
])
def test_wgrad_persistent_plan(E, K, F, sms, want):
    """One block an SM, never more than the 128-row, 256-column items
    every expert would make live."""
    assert xm.wgrad_persistent_plan(E, K, F, sms) == want


def test_expert_matmul_bwd_choice_refuses_an_unknown_kind():
    with pytest.raises(ValueError):
        xm.choose_bwd_variant(64, torch.bfloat16, (64, 64), True, "fwd")


@pytest.mark.parametrize("E,C,K,sms,want", [
    (64, 1920, 2048, 132, 132),      # the train_4k slab
    (64, 1920, 704, 132, 132),
    (1, 17, 64, 132, 1),             # one item
    (2, 300, 512, 132, 2 * 3 * 2),   # fewer items than SMs
    (64, 1920, 2048, 114, 114),      # another card's SM count
])
def test_dgrad_persistent_plan(E, C, K, sms, want):
    """One block an SM, never more than the 128 x 256 items all C rows of
    every expert would make."""
    assert xm.dgrad_persistent_plan(E, C, K, sms) == want


@pytest.mark.parametrize("S,T,H,KH,D,dtype,aligned,want", [
    (1, 528, 16, 16, 128, torch.bfloat16, True, "decode"),
    (1, 1, 16, 8, 64, torch.bfloat16, True, "decode"),
    (1, 0, 16, 16, 128, torch.bfloat16, True, "mma"),    # nothing to see
    (512, 0, 16, 16, 128, torch.bfloat16, True, "mma"),
    # R = 16: two groups of 8 query heads a kv head (any R decodes)
    (1, 528, 32, 2, 128, torch.bfloat16, True, "decode"),
    (512, 512, 16, 16, 128, torch.bfloat16, True, "wgmma"),  # LM prefill
    (197, 197, 6, 6, 64, torch.bfloat16, True, "wgmma"),     # ViT, sandwich
    (4096, 4096, 16, 16, 128, torch.bfloat16, True, "wgmma"),   # train_4k
    (256, 256, 16, 16, 64, torch.bfloat16, True, "wgmma"),   # DiT-L/2
    (512, 512, 64, 8, 128, torch.bfloat16, True, "wgmma"),   # qwen
    (512, 512, 48, 1, 128, torch.bfloat16, True, "wgmma"),   # granite MQA
    (512, 512, 64, 8, 112, torch.bfloat16, True, "wgmma"),   # kimi D 112
    (256, 256, 10, 10, 64, torch.bfloat16, True, "wgmma"),   # UNet 16 x 16
    (256, 77, 10, 10, 64, torch.bfloat16, True, "wgmma"),    # its cross
    # the UNet's 8 x 8 latent: half a 128-row tile, mma measured faster
    (64, 64, 20, 20, 64, torch.bfloat16, True, "mma"),
    (64, 77, 20, 20, 64, torch.bfloat16, True, "mma"),
    (65, 65, 4, 4, 64, torch.bfloat16, True, "wgmma"),
    (2, 2, 4, 4, 128, torch.bfloat16, True, "mma"),
    (197, 197, 6, 6, 64, torch.bfloat16, False, "fma_bf16"),
    (17, 17, 4, 4, 16, torch.bfloat16, True, "fma_bf16"),
    (1, 528, 16, 16, 128, torch.float32, True, "fma_f32"),
    (197, 197, 6, 6, 64, torch.float32, True, "fma_f32"),
])
def test_flash_attention_variant_choice(S, T, H, KH, D, dtype, aligned,
                                        want):
    assert fa.choose_variant(S, T, H, KH, D, dtype, aligned) == want


@pytest.mark.parametrize("T,bkh,want", [
    (528, 64, (5, 106)), (513, 64, (5, 103)), (1, 64, (1, 1)),
    (63, 16, (2, 32)), (65, 16, (3, 22)), (300, 16, (10, 30)),
    (4096, 1, (128, 32)), (40, 264, (1, 40)),
])
def test_decode_plan(T, bkh, want):
    splits, chunk = fa.decode_plan(T, bkh)
    assert (splits, chunk) == want
    assert chunk <= fa.DECODE_CHUNK_MAX and (splits - 1) * chunk < T \
        <= splits * chunk


def _split_merge(q, k, v, fill, splits, chunk):
    """The decode kernel's algorithm in fp32: a partial (max, denominator,
    accumulator) per chunk of keys, a chunk at or past ``fill`` empty
    (-inf, 0, zeros), merged in split order skipping the empty ones.
    q (BH, D), k/v (BH, T, D)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    parts = []
    for s in range(splits):
        t0, t1 = s * chunk, min(fill, (s + 1) * chunk)
        if t1 <= t0:
            parts.append((torch.full(q.shape[:1], -math.inf),
                          torch.zeros(q.shape[:1]), torch.zeros(q.shape)))
            continue
        sc = torch.einsum("bd,btd->bt", q, k[:, t0:t1]) * scale
        m = sc.max(-1).values
        p = torch.exp(sc - m[:, None])
        parts.append((m, p.sum(-1), torch.einsum("bt,btd->bd", p,
                                                 v[:, t0:t1])))
    mx = torch.stack([m for m, _, _ in parts]).max(0).values
    num, den = torch.zeros(q.shape), torch.zeros(q.shape[:1])
    for m, l, acc in parts:
        f = torch.where(l > 0, torch.exp(m - mx), torch.zeros(()))
        num, den = num + f[:, None] * acc, den + f * l
    return num / torch.clamp(den, min=1e-30)[:, None]


@pytest.mark.parametrize("cap,bkh", [(528, 64), (300, 16), (64, 8),
                                     (40, 264)])
@pytest.mark.parametrize("where", ["one", "mid", "cap"])
def test_decode_plan_from_capacity_with_empty_splits(cap, bkh, where):
    """The decode grid is planned from the cache's capacity alone; at a
    fill of 1 or half the capacity the trailing splits hold no valid key,
    and the merge of the kernel's partials (empty ones included) is the
    oracle over the first ``fill`` keys."""
    fill = {"one": 1, "mid": cap // 2, "cap": cap}[where]
    splits, chunk = fa.decode_plan(cap, bkh)
    live = -(-fill // chunk)
    assert 1 <= live <= splits and (splits - 1) * chunk < cap
    if where != "cap" and splits > 1:
        assert live < splits                   # some splits are empty
    rng = np.random.default_rng(cap + fill)
    q = torch.from_numpy(rng.normal(size=(3, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(3, cap, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(3, cap, 16)).astype(np.float32))
    o = _split_merge(q, k, v, fill, splits, chunk)
    o_ref = jref.flash_attention_ref(*(jnp.asarray(a.numpy()) for a in (
        q[:, None], k[:, :fill], v[:, :fill])), causal=False)
    assert torch.isfinite(o).all()
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref)[:, 0],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fill", [1, 17, 31, 32])
@pytest.mark.parametrize("H,KH", [(4, 4), (4, 2), (8, 1), (6, 3)])
def test_flash_attention_plain_kv_len_matches_ref(fill, H, KH):
    """A decode step over a whole 32-slot cache with the count of valid
    keys as a 0-d int32 tensor: the plain version (and the op on the CPU)
    is the JAX oracle over the first ``fill`` keys; large values past the
    fill do not leak in."""
    rng = np.random.default_rng(fill * 10 + H + KH)
    q, k, v = _qkv(rng, 2, 1, 32, H, KH, 32)
    k[:, fill:], v[:, fill:] = 1e4, -1e4
    n = torch.tensor(fill, dtype=torch.int32)
    tq, tk, tv = (torch.from_numpy(a.astype(np.float32)) for a in (q, k, v))
    o = fa.flash_attention_plain(tq, tk, tv, causal=False, kv_len=n)
    o_op = ops.flash_attention_op(tq, tk, tv, causal=False, kv_len=n)
    kr, vr = (np.repeat(a[:, :fill], H // KH, 2) for a in (k, v))
    flat = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3).reshape(
        -1, a.shape[1], a.shape[3]), jnp.float32)
    o_ref = jref.flash_attention_ref(flat(q), flat(kr), flat(vr),
                                     causal=False)
    o_ref = np.asarray(o_ref).reshape(2, H, 1, 32).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_np(o), o_ref, rtol=1e-5, atol=1e-5)
    assert torch.equal(o, o_op)
    assert int(n) == fill                     # read, never written


def test_flash_attention_kv_len_rejects_bad_args():
    q, k = torch.zeros(1, 1, 2, 8), torch.zeros(1, 4, 2, 8)
    for bad in (torch.tensor(2), torch.tensor([1, 2], dtype=torch.int32)):
        with pytest.raises(ValueError, match="kv_len"):
            ops.flash_attention_op(q, k, k, causal=False, kv_len=bad)
    with pytest.raises(NotImplementedError, match="kv_len"):
        ops.flash_attention_op(q.requires_grad_(), k, k, causal=False,
                               kv_len=torch.tensor(2, dtype=torch.int32))


def test_launch_counts_survive_graph_replay():
    """Calls made while a graph is captured launch nothing and are kept on
    the capturing thread's tape; each replay adds the tape to the kernels'
    counters, so launch_counts() and variant_counts() still count
    launches on the device.  Another thread's launches during a capture
    count at once."""
    import threading

    from repro_torch.kernels import counting
    ops.reset_launch_counts()
    with counting.recording() as tape:
        counting.count(em, "tma")
        counting.count(em, "tma")
        counting.count(em, "small_m")
        counting.count(fa, "decode")
        counting.count(em, "tma", "dgrad_launches", "dgrad_variant_launches")
        other = threading.Thread(target=counting.count, args=(xm, "stream"))
        other.start()
        other.join()
    assert ops.launch_counts() == dict.fromkeys(ops.launch_counts(), 0) | {
        "expert_matmul": 1}
    for _ in range(3):
        counting.replayed(tape)
    got, per = ops.launch_counts(), ops.variant_counts()
    assert got["elastic_matmul"] == 9 and got["flash_attention"] == 3
    assert got["elastic_matmul_dgrad"] == 3 and got["expert_matmul"] == 1
    assert per["elastic_matmul"]["tma"] == 6
    assert per["elastic_matmul"]["small_m"] == 3
    assert per["flash_attention"]["decode"] == 3
    assert per["elastic_matmul_dgrad"]["tma"] == 3
    with counting.recording() as inner:
        with counting.recording() as nested:
            counting.count(fa, "mma")
        assert nested and not inner           # the innermost tape records
    ops.reset_launch_counts()


_BF, _F32 = torch.bfloat16, torch.float32
_LM_UP = (491520, 2048, 2883584, 1408)      # x (64, 240, 2048), wi[..., :F]


@pytest.mark.parametrize("C,dtype,strides,aligned,want", [
    (4, _BF, (8192, 2048, 2883584, 1408), True, "stream"),     # LM decode
    (16, _BF, (32768, 2048, 2883584, 1408), True, "stream"),
    (16, _F32, (32768, 2048, 2883584, 1408), False, "stream"),
    (4, _BF, (0, 2048, 2883584, 1408), True, "stream"),        # stride 0
    (17, _BF, (34816, 2048, 2883584, 1408), True, "tma"),
    (240, _BF, _LM_UP, True, "tma"),                           # LM prefill
    (240, _BF, (337920, 1408, 2883584, 2048), True, "tma"),    # down, 1408
    (240, _BF, (168960, 704, 2883584, 2048), True, "tma"),     # down, 704
    (240, _BF, _LM_UP, False, "tile_bf16"),                    # base
    (240, _BF, (0, 2048, 2883584, 1408), True, "tile_bf16"),   # stride 0
    (240, _BF, (491520, 2048, 2883584, 1412), True, "tile_bf16"),
    (240, _BF, (241, 2049, 2883584, 1408), True, "tile_bf16"),
    (240, _F32, _LM_UP, True, "tile_f32"),
    (17, _F32, (34816, 2048, 2883584, 1408), True, "tile_f32"),
])
def test_expert_matmul_variant_choice(C, dtype, strides, aligned, want):
    assert xm.choose_variant(C, dtype, strides, aligned) == want


def test_expert_matmul_variant_of_the_lm_slabs():
    """The wrapper's strides and alignment on the LM's own tensors: the
    dispatch slab and a width-sliced weight view go to tma at C = 240 and
    stream at C = 4; the dense oracle's expanded tokens, to tile."""
    slab = torch.zeros(64 * 240 + 1, 2048, dtype=_BF)[:-1].view(64, 240,
                                                                 2048)
    wi = torch.zeros(64, 2048, 1408, dtype=_BF)[..., :1056]
    st = xm.strides(slab, wi)
    assert st == (491520, 2048, 2883584, 1408)
    assert xm.choose_variant(240, _BF, st, True) == "tma"
    assert xm.choose_variant(4, _BF, xm.strides(slab[:, :4], wi),
                             True) == "stream"
    toks = torch.zeros(1, 240, 2048, dtype=_BF).expand(64, 240, 2048)
    assert xm.strides(toks, wi)[0] == 0
    assert xm.choose_variant(240, _BF, xm.strides(toks, wi),
                             True) == "tile_bf16"


@pytest.mark.parametrize("shape,strides_of,want", [
    ((1, 240, 2048), None, (240 * 2048, 2048)),   # one expert: C * row
    ((1, 1, 2048), None, (2048, 2048)),           # one row too
    ((64, 1, 2048), None, (2048, 2048)),
    ((1, 240, 704), (1408,), (240 * 1408, 1408)),  # a width-sliced view
])
def test_expert_strides_of_size_one_dims(shape, strides_of, want):
    """A tensor map needs a valid stride on a size-1 dim: the extent of
    the dims inside it, in the rows' own stride."""
    if strides_of is None:
        t = torch.zeros(shape)
    else:
        t = torch.zeros(shape[0], shape[1], strides_of[0])[..., :shape[2]]
    assert xm._dim_strides(t) == want


def test_expert_tma_tile_matches_source():
    """TMA_TILE is the block the source launches: 64 rows per consumer
    warpgroup, X_BN columns (no nvcc here: the constants are read as
    text)."""
    text = (build.CSRC / "expert_matmul.cu").read_text()
    cwg = int(re.search(r"constexpr int X_CWG = (\d+);", text).group(1))
    bn = int(re.search(r"constexpr int X_BN = (\d+);", text).group(1))
    assert xm.TMA_TILE == (64 * cwg, bn)


def _aligned_zeros(shape, dtype, offset=0):
    """Zeros of ``shape`` whose base lies ``offset`` elements past a
    16-byte boundary."""
    n = math.prod(shape)
    buf = torch.zeros(n + 16, dtype=dtype)
    skip = (-buf.data_ptr() // buf.element_size()) % (16 // buf.element_size())
    return buf[skip + offset:skip + offset + n].view(shape)


@pytest.mark.parametrize("case,want", [
    ("prefill", "tma"),           # the dispatch slab, a width-sliced weight
    ("decode", "stream"),
    ("one_expert", "tma"),        # E = 1: the size-1 expert axis
    ("oracle", "tile_bf16"),      # the dense oracle's stride-0 expert axis
    ("unaligned", "tile_bf16"),   # x's base off a 16-byte boundary
    ("empty_k", "tile_bf16"),     # K = 0: a tensor map has no empty dim
    ("fp32", "tile_f32"),
])
def test_expert_matmul_variant_of(case, want):
    """The variant the wrapper launches, from the tensors themselves."""
    dt = _F32 if case == "fp32" else _BF
    E, C, K = {"one_expert": (1, 240, 2048), "decode": (64, 4, 2048),
               "empty_k": (64, 240, 0)}.get(case, (64, 240, 2048))
    x = _aligned_zeros((E, C, K), dt, offset=1 if case == "unaligned" else 0)
    if case == "oracle":
        x = _aligned_zeros((1, C, K), dt).expand(E, C, K)
    w = _aligned_zeros((E, K, 1408), dt)[..., :1056]
    assert xm.variant_of(x, w) == want


@pytest.mark.parametrize("E,C,K,F,elem,want", [
    (64, 4, 2048, 1408, 2, (4, 512)),    # LM decode up/gate
    (64, 4, 1408, 2048, 2, (3, 480)),    # LM decode down
    (64, 4, 704, 2048, 2, (2, 352)),     # down at a_ff 704
    (32, 4, 2048, 1056, 2, (4, 512)),
    (1, 4, 2048, 1408, 2, (8, 256)),     # one expert: more splits
    (8, 16, 2048, 704, 4, (6, 352)),     # fp32: 16 rows at once
    (64, 4, 200, 2048, 2, (1, 224)),
    (64, 4, 0, 2048, 2, (1, 32)),
])
def test_stream_plan(E, C, K, F, elem, want):
    splits, kc = xm.stream_plan(E, C, K, F, elem)
    assert (splits, kc) == want
    assert kc <= xm.STREAM_KC_MAX and splits * kc >= K
    assert (splits - 1) * kc < max(K, 1)           # no empty split


def test_expert_matmul_kernel_entry_takes_only_cuda():
    """No fallback: the kernel entry raises on CPU tensors (the op routes
    those to the plain version before it)."""
    x = torch.zeros(2, 4, 8, dtype=_BF)
    with pytest.raises(ValueError):
        xm.expert_matmul(x, torch.zeros(2, 8, 6, dtype=_BF),
                         torch.zeros(2, dtype=torch.int32))


def test_variant_counts_cover_every_kernel_with_variants():
    xm.variant_launches["stream"] += 3
    em.variant_launches["f32_splitk"] += 2
    fa.bwd_variant_launches["resident"] += 1
    assert ops.variant_counts()["expert_matmul"]["stream"] >= 3
    assert ops.variant_counts()["elastic_matmul"]["f32_splitk"] >= 2
    assert ops.variant_counts()["flash_attention_bwd"]["resident"] >= 1
    ops.reset_launch_counts()
    for per in ops.variant_counts().values():
        assert set(per.values()) == {0}
    assert set(ops.variant_counts()["expert_matmul"]) == set(xm.VARIANTS)
    assert set(ops.variant_counts()["elastic_matmul"]) == set(em.VARIANTS) \
        == {"small_m", "tma", "f32_splitk", "tile_bf16", "tile_f32"}


def test_attention_alignment_ignores_size_one_dims():
    q = torch.zeros(2, 1, 16, 128, dtype=torch.bfloat16)
    assert fa._aligned(q, q[:, :, :8], q.as_strided((2, 1, 4, 8),
                                                     (2048, 3, 128, 1)))
    rows68 = torch.zeros(2, 5, 3, 68, dtype=torch.bfloat16)[..., :64]
    assert not fa._aligned(rows68)                 # head stride 68
    shifted = torch.zeros(4100, dtype=torch.bfloat16)[4:].view(2, 1, 16, 128)
    assert not fa._aligned(q, shifted)             # base off by 8 bytes


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


def test_every_launcher_is_exported_by_its_source():
    """The C entry points the wrappers bind are defined in the sources the
    build compiles (no nvcc here: the symbols are checked as text)."""
    for name, mod in (("elastic_matmul", em), ("flash_attention", fa),
                      ("expert_matmul", xm)):
        text = (build.CSRC / f"{name}.cu").read_text()
        for fn in mod._ARGTYPES:
            assert f'extern "C" int {fn}(' in text, fn
    for name in ("elastic_matmul", "expert_matmul"):
        text = (build.CSRC / f"{name}.cu").read_text()
        for header in ("tile_matmul.cuh", "hopper_gemm.cuh"):
            assert f'#include "{header}"' in text, (name, header)


def test_library_name_tracks_shared_headers(tmp_path, monkeypatch):
    """A kernel that includes a csrc/*.cuh header is rebuilt when only the
    header changes."""
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    for header in ("tile_matmul.cuh", "hopper_gemm.cuh"):
        before = {n: build.library_path(n)
                  for n in ("elastic_matmul", "expert_matmul")}
        (csrc / header).write_text((csrc / header).read_text()
                                   + "\n// edited\n")
        for name, path in before.items():
            assert build.library_path(name) != path, (header, name)


def test_loaded_as_serves_another_library_and_restores(monkeypatch):
    """build.loaded_as swaps one source's library for the block only (no
    nvcc here: stand-in objects play the libraries)."""
    ours, other = object(), object()
    monkeypatch.setattr(build, "_libs", {"expert_matmul": ours})
    with build.loaded_as("expert_matmul", other):
        assert build.library("expert_matmul") is other
    assert build.library("expert_matmul") is ours
    with pytest.raises(RuntimeError):
        with build.loaded_as("expert_matmul", other):
            raise RuntimeError
    assert build.library("expert_matmul") is ours


def test_plain_kernels_context_is_thread_local_and_restores():
    assert not getattr(ops._state, "plain", False)
    with ops.plain_kernels():
        assert ops._state.plain
    assert not ops._state.plain


# --- on the card --------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 4, 16, 17, 197, 1576, 2048])
def test_cuda_elastic_matmul_matches_plain(cuda, dtype, M):
    """Every variant (small_m to M = 16, tma above in bf16, tile in fp32
    and for x of width 129), in the TPU op's shape and in sliced mode
    with k_act not a multiple of 64."""
    g = torch.Generator().manual_seed(0)
    dt = getattr(torch, dtype)
    x = torch.randn(M, 384, generator=g).to(cuda, dt)
    w = (torch.randn(384, 1536, generator=g) / 384 ** 0.5).to(cuda, dt)
    before = em.launches
    cases = [(x, 384, 1536, 1536), (x, 288, 1152, 1536),
             (x, 192, 1000, 1000), (x, 129, 255, 1536),
             (x[:, :200].contiguous(), 200, 1000, 1000),
             (x[:, :129].contiguous(), 129, 255, 255)]
    for xx, ka, na, n_out in cases:
        y = ops.elastic_matmul_op(xx, w, ka, na, n_out=n_out)
        with ops.plain_kernels():
            y_plain = ops.elastic_matmul_op(xx, w, ka, na, n_out=n_out)
        torch.cuda.synchronize()
        tol = TOL[dtype]
        torch.testing.assert_close(y.float(), y_plain.float(), rtol=tol,
                                   atol=tol)
        assert torch.all(y[:, na:] == 0)
    assert em.launches == before + len(cases)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S,H,KH,D", [(197, 6, 6, 64), (197, 6, 3, 64),
                                      (577, 4, 4, 64), (17, 4, 4, 16),
                                      (18, 4, 4, 8)])
def test_cuda_flash_attention_matches_plain(cuda, dtype, causal, S, H, KH,
                                            D):
    """fp32 on the fma variant; bf16 on wgmma at D = 64 (including the
    ragged T = 577) and on fma at the smoke head dims."""
    g = torch.Generator().manual_seed(1)
    dt = getattr(torch, dtype)
    tol = 3e-3 if dtype == "float32" else 3e-2
    q = (torch.randn(8, S, H, D, generator=g) * 0.3).to(cuda, dt)
    k = (torch.randn(8, S, KH, D, generator=g) * 0.3).to(cuda, dt)
    v = torch.randn(8, S, KH, D, generator=g).to(cuda, dt)
    before = fa.launches
    o = ops.flash_attention_op(q, k, v, causal=causal)
    with ops.plain_kernels():
        o_plain = ops.flash_attention_op(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), o_plain.float(), rtol=tol,
                               atol=tol)
    assert fa.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("a_ff", [1408, 704])
def test_cuda_expert_matmul_matches_plain(cuda, dtype, a_ff):
    """The LM's up and down products at d 2048 with ragged counts (0, a
    partial tile, the full C), the expert width read as a strided view."""
    g = torch.Generator().manual_seed(2)
    dt = getattr(torch, dtype)
    E, C, d = 8, 240, 2048
    x = torch.randn(E, C, d, generator=g).to(cuda, dt)
    wi = (torch.randn(E, d, 1408, generator=g) / d ** 0.5).to(cuda, dt)
    wo = (torch.randn(E, 1408, d, generator=g) / 1408 ** 0.5).to(cuda, dt)
    counts = torch.tensor([240, 0, 37, 64, 1, 200, 239, 128],
                          dtype=torch.int32, device=cuda)
    before = xm.launches
    up = ops.expert_matmul_op(x, wi[..., :a_ff], counts)
    down = ops.expert_matmul_op(up, wo[:, :a_ff], counts)
    with ops.plain_kernels():
        up_p = ops.expert_matmul_op(x, wi[..., :a_ff], counts)
        down_p = ops.expert_matmul_op(up, wo[:, :a_ff], counts)
    torch.cuda.synchronize()
    tol = 3e-4 if dtype == "float32" else 3e-2
    for y, yp in ((up, up_p), (down, down_p)):
        torch.testing.assert_close(y.float(), yp.float(), rtol=tol, atol=tol)
        for e, n in enumerate(counts.tolist()):
            assert torch.all(y[e, n:] == 0)
    assert xm.launches == before + 2


def _k3_case(cuda, dt, E, C, K, F, counts, seed, nan_past=False):
    """x (E, C, K) (NaN past each count with ``nan_past``), a width-sliced
    view of a wider weight, device counts; holds the op against its plain
    version and returns the variants that launched."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(E, C, K, generator=g).to(cuda, dt)
    if nan_past:
        for e, n in enumerate(counts):
            x[e, n:] = float("nan")
    w = (torch.randn(E, K, F + 64, generator=g) / K ** 0.5).to(cuda, dt)
    c = torch.tensor(counts, dtype=torch.int32, device=cuda)
    before = dict(xm.variant_launches)
    y = ops.expert_matmul_op(x, w[..., :F], c)
    ran = {v for v, n in xm.variant_launches.items() if n != before[v]}
    with ops.plain_kernels():
        yp = ops.expert_matmul_op(x, w[..., :F], c)
    torch.cuda.synchronize()
    tol = 3e-4 if dt == torch.float32 else 3e-2
    torch.testing.assert_close(y.float(), yp.float(), rtol=tol, atol=tol)
    for e, n in enumerate(counts):
        assert torch.all(y[e, n:] == 0)
    return ran


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,F", [(2048, 1408), (1408, 2048)])
def test_cuda_expert_matmul_decode_stream(cuda, dtype, K, F):
    """Decode: C = 4 with one to four rows on 24 live experts of 64."""
    live = torch.randperm(64, generator=torch.Generator().manual_seed(K))
    counts = [0] * 64
    for i, e in enumerate(live[:24].tolist()):
        counts[e] = 1 + i % 4
    ran = _k3_case(cuda, getattr(torch, dtype), 64, 4, K, F, counts, 4)
    assert ran == {"stream"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,want", [("bfloat16", "tma"),
                                        ("float32", "tile_f32")])
@pytest.mark.parametrize("K,F", [(2048, 1408), (2048, 1056), (704, 2048)])
def test_cuda_expert_matmul_prefill_variant(cuda, dtype, want, K, F):
    """Prefill: C = 240 with the ragged counts above (0, partial tiles,
    the full C); bf16 on tma, fp32 on the tile loop."""
    counts = [240, 0, 37, 64, 1, 200, 239, 128]
    ran = _k3_case(cuda, getattr(torch, dtype), 8, 240, K, F, counts, 5)
    assert ran == {want}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,count", [(4, 3), (16, 16), (17, 9), (240, 100)])
def test_cuda_expert_matmul_one_expert(cuda, dtype, C, count):
    """E = 1: the size-1 expert axis (a tensor map needs a valid stride
    there) on each variant."""
    dt = getattr(torch, dtype)
    ran = _k3_case(cuda, dt, 1, C, 2048, 1408, [count], 6)
    want = "stream" if C <= 16 else ("tma" if dt == torch.bfloat16
                                     else "tile_f32")
    assert ran == {want}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [4, 240])
def test_cuda_expert_matmul_rows_past_counts_do_not_leak(cuda, dtype, C):
    """NaN in x past every count: each variant computes or skips those
    rows, and its output there is exact zeros all the same."""
    counts = [min(C, n) for n in (3, 0, 1, 2, 200, 64, 37, 128)]
    _k3_case(cuda, getattr(torch, dtype), 8, C, 2048, 1408, counts, 7,
             nan_past=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_attention_head_dim_128(cuda, dtype):
    """The LM's causal prefill (S = T = 512) and decode (S = 1) against a
    strided slice of a 528-slot cache, at D = 128."""
    g = torch.Generator().manual_seed(3)
    dt = getattr(torch, dtype)
    tol = 3e-3 if dtype == "float32" else 3e-2
    q = (torch.randn(2, 512, 16, 128, generator=g) * 0.3).to(cuda, dt)
    k = (torch.randn(2, 512, 16, 128, generator=g) * 0.3).to(cuda, dt)
    v = torch.randn(2, 512, 16, 128, generator=g).to(cuda, dt)
    cases = [(q, k, v, True)]
    cache_k = (torch.randn(2, 528, 16, 128, generator=g) * 0.3).to(cuda, dt)
    cache_v = torch.randn(2, 528, 16, 128, generator=g).to(cuda, dt)
    for T in (1, 63, 64, 65, 300, 528):
        cases.append((q[:, :1], cache_k[:, :T], cache_v[:, :T], False))
        # GQA R = 2: 16 query heads over the cache's first 8 kv heads
        cases.append((q[:, :1], cache_k[:, :T, :8], cache_v[:, :T, :8],
                      False))
    for qq, kk, vv, causal in cases:
        o = ops.flash_attention_op(qq, kk, vv, causal=causal)
        with ops.plain_kernels():
            o_plain = ops.flash_attention_op(qq, kk, vv, causal=causal)
        torch.cuda.synchronize()
        torch.testing.assert_close(o.float(), o_plain.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("KH", [16, 8])
def test_cuda_flash_attention_decode_device_length(cuda, KH):
    """K2 decode over a whole 528-slot cache with the valid key count on
    the device: against the plain version at fills 1, mid and capacity,
    then captured once in a CUDA graph and replayed as the count changes
    on the device (the grid stays planned from the capacity)."""
    from repro_torch.graphs import Graph, new_pool
    g = torch.Generator().manual_seed(5)
    bf = torch.bfloat16
    q = (torch.randn(4, 1, 16, 128, generator=g) * 0.3).to(cuda, bf)
    ck = (torch.randn(4, 528, KH, 128, generator=g) * 0.3).to(cuda, bf)
    cv = torch.randn(4, 528, KH, 128, generator=g).to(cuda, bf)
    n = torch.full((), 1, dtype=torch.int32, device=cuda)

    def want(fill):
        with ops.plain_kernels():
            return ops.flash_attention_op(q, ck[:, :fill], cv[:, :fill],
                                          causal=False).float()
    for fill in (1, 264, 528):
        n.fill_(fill)
        before = fa.variant_launches["decode"]
        o = ops.flash_attention_op(q, ck, cv, causal=False, kv_len=n)
        assert fa.variant_launches["decode"] == before + 1
        torch.testing.assert_close(o.float(), want(fill), rtol=3e-2,
                                   atol=3e-2)
    graph = Graph(lambda t: ops.flash_attention_op(q, ck, cv, causal=False,
                                                   kv_len=t), [n],
                  pool=new_pool(), stream=torch.cuda.Stream())
    for fill in (1, 100, 527, 528):
        before = fa.variant_launches["decode"]
        o = graph.run(torch.tensor(fill, dtype=torch.int32, device=cuda))
        torch.cuda.synchronize()
        assert fa.variant_launches["decode"] == before + 1
        torch.testing.assert_close(o.float(), want(fill), rtol=3e-2,
                                   atol=3e-2)


# --- K2 at the LM configs' shapes: kimi-k2's D = 112, granite-20b's R = 48 ----

# (H, KH, D) of the LMs' attention: deepseek-moe-16b, qwen1.5-110b,
# granite-20b (MQA: 48 query heads on one kv head), kimi-k2-1t-a32b; and
# R = 12 (a last group of 4)
LM_HEADS = [(16, 16, 128), (64, 8, 128), (48, 1, 128), (64, 8, 112),
            (24, 2, 64)]


@pytest.mark.parametrize("H,KH,D", LM_HEADS)
@pytest.mark.parametrize("T", [1, 264, 528])
def test_decode_never_leaves_the_decode_kernel(H, KH, D, T):
    """A bf16 S = 1 call with 16-byte rows at any query heads a kv head
    takes ``decode``, never ``wgmma`` or ``mma`` (whose ``kv_len`` is read
    on the host: no CUDA graph) nor ``fma_bf16``; prefill takes ``wgmma``
    at every head layout, D = 112 among them, and every prefill length of
    the port (the ViT's 197, DiT's 256, the LMs' 512, train_4k's 4096),
    ``mma`` at the UNet's S = 64."""
    assert fa.choose_variant(1, T, H, KH, D, torch.bfloat16, True) == \
        "decode"
    for S in (197, 256, 512, 4096):
        assert fa.choose_variant(S, S, H, KH, D, torch.bfloat16, True) == \
            "wgmma"
    assert fa.choose_variant(64, 64, H, KH, D, torch.bfloat16, True) == \
        "mma"
    assert D in fa.MMA_HEAD_DIMS and D in fa.HEAD_DIMS


@pytest.mark.parametrize("H,KH,D", LM_HEADS)
def test_decode_head_groups_cover_each_head_once(H, KH, D):
    """The decode kernel's grid over (batch, kv head, group): block x =
    (b * KH + kvh) * groups + g takes query heads kvh * R + 8 g .. + Rg - 1
    with Rg = min(8, R - 8 g), as flash_attention.cu computes them: every
    head of every batch once; ``decode_plan`` sees the groups' blocks."""
    B, R = 4, H // KH
    groups = fa.decode_groups(H, KH)
    assert groups == -(-R // fa.DECODE_R_MAX)
    seen = []
    for x in range(B * KH * groups):
        bkh, r0 = x // groups, (x % groups) * fa.DECODE_R_MAX
        Rg = min(fa.DECODE_R_MAX, R - r0)
        b, kvh = bkh // KH, bkh % KH
        assert 1 <= Rg <= fa.DECODE_R_MAX
        seen += [(b, kvh * R + r0 + r) for r in range(Rg)]
    assert sorted(seen) == [(b, h) for b in range(B) for h in range(H)]
    splits, chunk = fa.decode_plan(528, B * KH * groups)
    assert splits * chunk >= 528 and chunk <= fa.DECODE_CHUNK_MAX


def test_head_dim_112_kernel_instances_in_the_source():
    """K2's mma and decode launchers instantiate D = 112 (the wrapper's
    MMA_HEAD_DIMS), the decode kernel takes any R (no D_R_MAX refusal),
    the wgmma backward and the fma forward instantiate every head dim the
    wrapper sends them (kimi-k2's 112 among them), and the fp32 backward
    stays refused at 112 (no nvcc here: read as text)."""
    k2 = (build.CSRC / "flash_attention.cu").read_text()
    for D in fa.MMA_HEAD_DIMS:
        assert f"launch_mma<{D}>(" in k2 and f"launch_decode<{D}>(" in k2
    assert f"D_R_MAX = {fa.DECODE_R_MAX};" in k2
    assert "H / KH > D_R_MAX" not in k2
    for D in fa.BWD_HEAD_DIMS:
        assert f"launch_bwd_wgmma<{D}>(" in k2
    for D in fa.HEAD_DIMS:
        assert f"case {D}: REPRO_FA_LAUNCH({D});" in k2
    for D in fa.BWD_F32_HEAD_DIMS:
        assert f"launch_bwd_f32<{D}>(" in k2
    assert "launch_bwd_f32<112>" not in k2
    assert fa.choose_bwd_variant(4096, 4096, 112, torch.bfloat16,
                                 True) == "wgmma"
    with pytest.raises(NotImplementedError, match="fp32"):
        fa.choose_bwd_variant(512, 512, 112, torch.float32, True)



@pytest.mark.parametrize("B,H,KH,S,T,D,causal,sms,dynamic", [
    (4, 16, 16, 4096, 4096, 128, True, 132, True),   # train_4k: 4 groups
    (256, 16, 16, 256, 256, 64, False, 132, True),   # DiT-L/2
    (4, 64, 8, 512, 512, 128, True, 132, False),     # qwen1.5-110b prefill
    (4, 48, 1, 512, 512, 128, True, 132, False),     # granite-20b's MQA
    (4, 64, 8, 512, 512, 112, True, 132, False),     # kimi-k2's
    (8, 6, 6, 197, 197, 64, False, 132, True),       # the ViT: ragged tiles
    (3, 5, 5, 300, 300, 128, True, 114, False),      # another card's SMs
    (1, 1, 1, 1, 1, 64, True, 132, False),           # one tile
    (2, 3, 3, 129, 77, 64, False, 4, True),          # more tiles than blocks
    (3, 7, 7, 4096, 65536, 128, True, 132, True),    # groups of 2, then 1
])
def test_wgmma_fwd_tiles_cover_each_query_tile_once(B, H, KH, S, T, D,
                                                   causal, sms, dynamic):
    """The wgmma forward's schedule, as flash_attention.cu's fwd_tile and
    its producer walk it: every (batch, head, 128-row query tile) once,
    dealt in alternating rounds (causal calls whose K and V fit in L2 at
    once) or taken from a counter; causal, the (batch, head) pairs in
    groups whose K and V fit the L2 budget, each group's tiles together,
    the tiles that see the most keys first within a group, and the dealt
    blocks' keys even; otherwise a head's tiles follow each other."""
    nq = -(-S // fa.WGMMA_FWD_ROWS)
    blocks, tiles, group, dyn = fa.wgmma_fwd_plan(B, H, KH, S, T, D, causal,
                                                  sms)
    assert tiles == B * H * nq and blocks == min(tiles, sms)
    assert dyn == dynamic and 1 <= group <= B * H
    assert group == B * H or group * 4 * T * D // (H // KH) <= \
        fa.WGMMA_FWD_L2_BYTES
    order = [fa.wgmma_fwd_tile(t, B, H, S, causal, group)
             for t in range(tiles)]
    assert sorted(order) == [(b, h, qt) for b in range(B) for h in range(H)
                             for qt in range(nq)]
    dealt = [fa.wgmma_fwd_block_tiles(x, blocks, tiles)
             for x in range(blocks)]
    assert sorted(t for ts in dealt for t in ts) == list(range(tiles))
    if causal:
        for g in range(0, tiles, group * nq):
            part = order[g:g + group * nq]
            heads = {b * H + h for b, h, _ in part}
            assert len(heads) * nq == len(part) and max(heads) - \
                min(heads) < group
            qts = [qt for _, _, qt in part]
            assert qts == sorted(qts, reverse=True) and qts[0] == nq - 1
        if not dynamic:
            keys = [sum(order[t][2] + 1 for t in ts) for ts in dealt]
            assert max(keys) <= sum(keys) / blocks + nq
    else:
        assert order == sorted(order)


def test_wgmma_forward_kernel_instances_in_the_source():
    """K2's wgmma forward: its launcher instantiates every head dim the
    wrapper routes to it, its tile sizes are the wrapper's, its C entry
    point is the one the wrapper binds, and its schedule is
    ``wgmma_fwd_tile``'s (no nvcc here: read as text)."""
    k2 = (build.CSRC / "flash_attention.cu").read_text()
    for D in fa.MMA_HEAD_DIMS:
        assert f"launch_fwd_wgmma<{D}>(" in k2
    assert f"F_BQ = {fa.WGMMA_FWD_ROWS};" in k2
    assert f"F_BKV = {fa.WGMMA_FWD_KEYS};" in k2
    assert 'extern "C" int repro_flash_attention_wgmma(' in k2
    assert "repro_flash_attention_wgmma" in fa._ARGTYPES
    assert "qt = nq - 1 - i / gh;" in k2 and "qt = t % nq;" in k2
    assert "atomicAdd(next_tile, 1) + (int)gridDim.x" in k2
    assert "(r % 2 == 0 ? blockIdx.x" in k2
    assert "wgmma" in fa.VARIANTS

@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention_head_dim_112(cuda, causal):
    """kimi-k2's D = 112: the causal prefill (S = T = 512, H 64 on KH 8)
    on wgmma and decode over slices of a 528-slot cache on decode, against
    the plain version on fp32 copies of the inputs (in bf16 it rounds the
    scores to bf16, an error of its own at this spread), q and k at 1.5 x
    randn (scores spread ~2, so wrong scores miss the tolerance); an fp32
    call on fma_f32 and bf16 rows that are not 16-byte aligned on
    fma_bf16, the same way."""
    g = torch.Generator().manual_seed(112)
    bf = torch.bfloat16
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).to(
        cuda, bf)
    q, k, v = rnd(2, 512, 64, 112, scale=1.5), rnd(2, 512, 8, 112,
                                                    scale=1.5), \
        rnd(2, 512, 8, 112)
    ck, cv = rnd(2, 528, 8, 112, scale=1.5), rnd(2, 528, 8, 112)
    wide = rnd(2, 64, 64, 113)
    cases = [(q, k, v, causal, "wgmma")]
    cases += [(q[:, :1], ck[:, :T], cv[:, :T], False, "decode")
              for T in (1, 65, 300, 528)]
    cases += [(q.float(), k.float(), v.float(), causal, "fma_f32"),
              (wide[..., :112], k[:, :64], v[:, :64], causal, "fma_bf16")]
    for qq, kk, vv, c, want in cases:
        before = dict(fa.variant_launches)
        o = ops.flash_attention_op(qq, kk, vv, causal=c)
        ran = [n for n, m in fa.variant_launches.items() if m != before[n]]
        with ops.plain_kernels():     # fp32 scores, as the kernels keep
            o_plain = ops.flash_attention_op(qq.float(), kk.float(),
                                             vv.float(), causal=c)
        torch.cuda.synchronize()
        assert ran == [want]
        torch.testing.assert_close(o.float(), o_plain.float(), rtol=3e-2,
                                   atol=3e-2)



@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,T,H,KH,D,lse,fused", [
    (1, 4096, 4096, 4, 4, 128, True, False),  # train_4k's length and width
    (2, 256, 256, 16, 16, 64, True, False),   # DiT-L/2
    (4, 197, 197, 6, 6, 64, True, True),      # the ViT's (B, S, 3 H D) rows
    (2, 300, 300, 16, 8, 128, True, False),   # ragged S and T, R = 2
    (2, 256, 77, 10, 10, 64, True, False),    # the UNet's cross-attention
    (2, 512, 512, 64, 8, 128, False, False),  # qwen1.5-110b, R = 8
    (2, 512, 512, 48, 1, 128, False, True),   # granite-20b's MQA
    (2, 512, 512, 64, 8, 112, True, True),    # kimi-k2's D = 112
])
def test_cuda_flash_attention_forward_wgmma_matches_plain(
        cuda, causal, B, S, T, H, KH, D, lse, fused):
    """K2's wgmma forward at the port's call classes (causal or not, D 64,
    112 and 128, T 77 to 4096, GQA and MQA, q k v as strided views of one
    (B, S, (H + 2 KH) D) buffer, the logsumexp) against the plain version
    on fp32 copies of the same bf16 inputs, q and k at 1.5 x randn (scores
    spread ~2: wrong scores miss the tolerance); one wgmma launch a
    call."""
    g = torch.Generator().manual_seed(S + T + H + D)
    bf = torch.bfloat16
    if fused:
        buf = torch.randn(B, S, H + 2 * KH, D, generator=g)
        buf[:, :, :H + KH] *= 1.5
        buf = buf.to(cuda, bf)
        q, k, v = buf[:, :, :H], buf[:, :, H:H + KH], buf[:, :, H + KH:]
    else:
        q = (torch.randn(B, S, H, D, generator=g) * 1.5).to(cuda, bf)
        k = (torch.randn(B, T, KH, D, generator=g) * 1.5).to(cuda, bf)
        v = torch.randn(B, T, KH, D, generator=g).to(cuda, bf)
    assert fa.choose_variant(S, T, H, KH, D, bf, fa._aligned(q, k, v)) == \
        "wgmma"
    before = dict(fa.variant_launches)
    got = fa.flash_attention(q, k, v, causal=causal, return_lse=lse)
    torch.cuda.synchronize()
    assert {n: c - before[n] for n, c in fa.variant_launches.items()
            if c != before[n]} == {"wgmma": 1}
    want = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                    causal=causal, return_lse=lse)
    for a, b in zip(got if lse else (got,), want if lse else (want,)):
        torch.testing.assert_close(a.float(), b.float(), rtol=3e-2,
                                   atol=3e-2)

@pytest.mark.cuda
@pytest.mark.parametrize("H,KH,D", [(48, 1, 128), (64, 8, 112), (24, 2, 64)])
def test_cuda_decode_any_heads_a_kv_head_in_a_graph(cuda, H, KH, D):
    """granite-20b's 48 query heads on one kv head (6 groups), kimi's D =
    112 and R = 12 (a last group of 4): decode over a whole 528-slot cache
    with the fill on the device, captured once in a CUDA graph and
    replayed as the fill advances, against the plain version on fp32
    copies of the inputs (q and k at 1.5 x randn: a wrong head group's
    scores miss the tolerance)."""
    from repro_torch.graphs import Graph, new_pool
    g = torch.Generator().manual_seed(H + KH + D)
    bf = torch.bfloat16
    q = (torch.randn(4, 1, H, D, generator=g) * 1.5).to(cuda, bf)
    ck = (torch.randn(4, 528, KH, D, generator=g) * 1.5).to(cuda, bf)
    cv = torch.randn(4, 528, KH, D, generator=g).to(cuda, bf)
    n = torch.full((), 1, dtype=torch.int32, device=cuda)
    graph = Graph(lambda t: ops.flash_attention_op(q, ck, cv, causal=False,
                                                   kv_len=t), [n],
                  pool=new_pool(), stream=torch.cuda.Stream())
    for fill in (1, 100, 264, 527, 528):
        before = dict(fa.variant_launches)
        o = graph.run(torch.tensor(fill, dtype=torch.int32, device=cuda))
        torch.cuda.synchronize()
        assert {v for v, m in fa.variant_launches.items()
                if m != before[v]} == {"decode"}
        with ops.plain_kernels():     # fp32 scores, as the kernel keeps
            want = ops.flash_attention_op(q.float(), ck[:, :fill].float(),
                                          cv[:, :fill].float(), causal=False)
        torch.testing.assert_close(o.float(), want, rtol=3e-2, atol=3e-2)


# --- backward (the training path) ---------------------------------------------

@pytest.mark.parametrize("M,K,N,ka,na", [(7, 48, 40, 48, 40), (7, 48, 40, 24, 17),
                                         (5, 32, 16, 1, 16), (6, 40, 24, 33, 1)])
def test_elastic_matmul_plain_backward_matches_jax_grad(M, K, N, ka, na):
    """K1's plain dgrad and wgrad against jax.vjp of kernels/ref.py's
    oracle (the TPU op's shape: x and w at full width, zeros past the
    widths), fp32 within 1e-5."""
    rng = np.random.default_rng(M + K + ka)
    x, w = rng.normal(size=(M, K)), rng.normal(size=(K, N))
    dy = rng.normal(size=(M, N))
    _, vjp = jax.vjp(lambda a, b: jref.elastic_matmul_ref(a, b, ka, na),
                     jnp.asarray(x, jnp.float32), jnp.asarray(w, jnp.float32))
    jdx, jdw = vjp(jnp.asarray(dy, jnp.float32))
    tdy = torch.tensor(dy, dtype=torch.float32)
    dx = em.elastic_matmul_dgrad_plain(tdy, torch.tensor(w, dtype=torch.float32),
                                       ka, na, K)
    dw = em.elastic_matmul_wgrad_plain(torch.tensor(x, dtype=torch.float32),
                                       tdy, ka, na, (K, N))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=1e-5,
                               atol=1e-5)


def test_elastic_matmul_op_autograd_on_cpu():
    """elastic_matmul_op's gradient (the autograd Function on the plain
    backward) equals autograd of the plain forward in sliced mode, and in
    the TPU op's shape gives zeros past k_act."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(48, 40, generator=g, requires_grad=True)
    x = torch.randn(3, 5, 48, generator=g, requires_grad=True)
    y = ops.elastic_matmul_op(x, w, 24, 17)
    assert y.shape == (3, 5, 40) and bool((y[..., 17:] == 0).all())
    gy = torch.randn(y.shape, generator=g)
    dx, dw = torch.autograd.grad(y, (x, w), gy)
    rx, rw = torch.autograd.grad(x[..., :24] @ w[:24, :17], (x, w),
                                 gy[..., :17])
    torch.testing.assert_close(dx, rx, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(dw, rw, rtol=1e-6, atol=1e-6)
    assert bool((dx[..., 24:] == 0).all())
    with torch.no_grad():     # no gradient wanted: the forward alone
        assert ops.elastic_matmul_op(x, w, 24, 17).grad_fn is None


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S,T", [(17, 17), (9, 13)])
def test_flash_attention_plain_backward_matches_jax(causal, S, T):
    """K2's plain backward against jax.vjp of kernels/ref.py's oracle on
    (B*H, S, D) and the plain forward's logsumexp against the scores', fp32
    within 1e-5."""
    if causal and S != T:
        pytest.skip("the causal oracle aligns query and key positions")
    rng = np.random.default_rng(S + T)
    B, H, D = 2, 3, 16
    q, k, v, do = (rng.normal(size=(B, n, H, D)).astype(np.float32) * sc
                   for n, sc in ((S, 0.5), (T, 0.5), (T, 1.0), (S, 1.0)))

    def bh(a):
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(B * H, -1, D))
    o_j, vjp = jax.vjp(lambda a, b, c: jref.flash_attention_ref(
        a, b, c, causal=causal), bh(q), bh(k), bh(v))
    jdq, jdk, jdv = vjp(bh(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = fa.flash_attention_plain(tq, tk, tv, causal=causal,
                                      return_lse=True)
    dq, dk, dv = fa.flash_attention_bwd_plain(tq, tk, tv, o, tdo,
                                              causal=causal)

    def back(a, n):
        return np.asarray(a).reshape(B, H, n, D).transpose(0, 2, 1, 3)
    for t, j, n in ((dq, jdq, S), (dk, jdk, T), (dv, jdv, T)):
        np.testing.assert_allclose(t.numpy(), back(j, n), rtol=1e-5,
                                   atol=1e-5)
    s = np.einsum("bshd,bthd->bhst", q, k) / math.sqrt(D)
    if causal:
        s = np.where(np.arange(S)[:, None] >= np.arange(T)[None], s, -np.inf)
    np.testing.assert_allclose(lse.numpy(), np.asarray(
        jax.nn.logsumexp(jnp.asarray(s), -1)), rtol=1e-5, atol=1e-5)


def test_flash_attention_op_autograd_gqa_on_cpu():
    """flash_attention_op's gradient (the autograd Function on the plain
    backward, GQA's kv-head gradients summed over their query heads)
    equals autograd of the plain forward."""
    g = torch.Generator().manual_seed(4)
    q = torch.randn(2, 11, 6, 16, generator=g, requires_grad=True)
    k = torch.randn(2, 11, 2, 16, generator=g, requires_grad=True)
    v = torch.randn(2, 11, 2, 16, generator=g, requires_grad=True)
    do = torch.randn(2, 11, 6, 16, generator=g)
    got = torch.autograd.grad(ops.flash_attention_op(q, k, v, causal=False),
                              (q, k, v), do)
    ref_ = torch.autograd.grad(fa.flash_attention_plain(q, k, v,
                                                        causal=False),
                               (q, k, v), do)
    for a, b in zip(got, ref_):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_backward_kernels_refuse_what_they_do_not_take():
    q = torch.zeros(1, 4, 2, 64)
    lse = torch.zeros(1, 2, 4)
    q16 = torch.zeros(1, 4, 2, 16, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):        # D 16 in bf16
        fa.flash_attention_bwd(q16, q16, q16, q16, lse, q16, causal=False)
    q128 = torch.zeros(1, 4, 2, 128, dtype=torch.bfloat16)
    # causal and D = 128 have kernels since LM training: these CPU
    # tensors are refused for their device, not their case
    for t, causal in ((q, True), (q128, False), (q128, True)):
        with pytest.raises(ValueError, match="CUDA device"):
            fa.flash_attention_bwd(t, t, t, t, lse, t, causal=causal)
    with pytest.raises(ValueError):                 # CPU tensors
        fa.flash_attention_bwd(q, q, q, q, lse, q, causal=False)
    w = torch.zeros(8, 8)
    with pytest.raises(ValueError):
        em.elastic_matmul_dgrad(w, w, torch.zeros(2, dtype=torch.int32), 4,
                                4, 8)
    with pytest.raises(ValueError):
        em.elastic_matmul_wgrad(w, w, torch.zeros(2, dtype=torch.int32), 4,
                                4, (8, 8))


@pytest.mark.parametrize("M,k_act,n_act,want", [
    (50432, 384, 384, (30, 1696)), (50432, 1536, 384, (8, 6304)),
    (50432, 384, 1536, (8, 6304)), (256, 384, 1000, (1, 256)),
    (100, 384, 384, (1, 128)), (50176, 768, 384, (15, 3360)),
    (50432, 192, 192, (66, 768))])
def test_wgrad_plan(M, k_act, n_act, want):
    splits, chunk = em.wgrad_plan(M, k_act, n_act)
    assert (splits, chunk) == want
    assert chunk % 32 == 0 and (splits - 1) * chunk < M <= splits * chunk


@pytest.mark.parametrize("M,k_act,n_act,want", [
    (50432, 384, 384, (14, 3648)), (50432, 1536, 384, (3, 16832)),
    (50432, 384, 1536, (3, 16832)), (50176, 768, 384, (7, 7168)),
    (256, 384, 1000, (1, 256)), (50432, 288, 1152, (4, 12608)),
    (50432, 192, 192, (14, 3648)), (100, 384, 384, (1, 128)),
    (1, 8, 8, (1, 64)),
    # ResNet-152's step at batch 256 and EfficientNet-B7's SE at 64
    (802816, 64, 64, (14, 57344)), (802816, 256, 64, (14, 57344)),
    (200704, 128, 512, (14, 14336)), (12544, 1024, 2048, (1, 12544)),
    (12544, 2048, 512, (2, 6272)), (64, 1344, 56, (1, 64))])
def test_wgrad_tma_plan(M, k_act, n_act, want):
    """The tma wgrad kernel's split of M at the training step's shapes:
    chunks of whole 64-row TMA boxes (a box cannot be clipped to a chunk's
    end) that cover M exactly once, no more (tile, split) blocks than one
    wave of 132 SMs holds, and no more splits than the cap."""
    splits, chunk = em.wgrad_tma_plan(M, k_act, n_act)
    assert (splits, chunk) == want
    assert chunk % em.TMA_BOX == 0
    assert (splits - 1) * chunk < M <= splits * chunk
    bm, bn = em.BWD_TMA_TILE
    tiles = -(-k_act // bm) * -(-n_act // bn)
    assert splits == 1 or tiles * splits <= em.SMS
    assert splits <= em.WGRAD_TMA_SPLITS_MAX


@pytest.mark.parametrize("M,dtype,lds,aligned,widths,want", [
    (50432, _BF, (384, 384), True, (384, 384), "tma"),     # the step's calls
    (50432, _BF, (1536, 1536), True, (288, 1152), "tma"),  # masked widths
    (256, _BF, (1000, 1000), True, (384, 1000), "tma"),    # the head
    (50432, _BF, (384, 384), False, (384, 384), "wmma_bf16"),  # base offset
    (300, _BF, (77, 200), True, (129, 77), "wmma_bf16"),   # ldy = 77
    (300, _BF, (80, 130), True, (129, 77), "wmma_bf16"),   # ldw = 130
    (300, _BF, (80, 200, 77), True, (64, 77), "wmma_bf16"),  # dx's 77
    (300, _BF, (80, 200), True, (0, 77), "wmma_bf16"),     # k_act = 0
    (0, _BF, (80, 200), True, (8, 8), "wmma_bf16"),        # no rows
    (50432, _F32, (384, 384), True, (384, 384), "fma_f32"),
    # the conv nets: ResNet-152's stage 0 dgrad, the SE widths 20 and 12
    (802816, _BF, (256, 256, 64), True, (64, 256), "tma"),
    (64, _BF, (20, 20, 480), True, (480, 20), "wmma_bf16"),
    (64, _BF, (12, 288), True, (12, 288), "wmma_bf16"),
])
def test_choose_bwd_variant(M, dtype, lds, aligned, widths, want):
    assert em.choose_bwd_variant(M, *widths, dtype, lds, aligned) == want


def test_backward_variant_can_be_named_only_where_it_fits():
    """A caller may name wmma_bf16 for bf16 (the parent kernel's route);
    a variant the call cannot take raises, nothing falls back."""
    dy = _aligned_zeros((64, 384), _BF)
    w = _aligned_zeros((384, 384), _BF)
    assert em._bwd_variant(dy, w, 384, 384, None) == "tma"
    assert em._bwd_variant(dy, w, 384, 384, None, 77) == "wmma_bf16"
    assert em._bwd_variant(dy, w, 384, 384, "wmma_bf16") == "wmma_bf16"
    with pytest.raises(ValueError):
        em._bwd_variant(dy.float(), w.float(), 384, 384, "wmma_bf16")
    with pytest.raises(ValueError):
        em._bwd_variant(dy[:, 1:], w, 200, 383, "tma")


def _c_params(text: str, fn: str) -> list:
    """The parameter types of ``extern "C" int fn(...)`` in a source."""
    m = re.search(r'extern "C" int ' + fn + r"\((.*?)\)\s*\{", text, re.S)
    assert m, fn
    return [" ".join(p.split()[:-1]) + ("*" if "*" in p else "")
            for p in m.group(1).split(",")]


@pytest.mark.parametrize("fn", sorted(em._ARGTYPES))
def test_elastic_matmul_argtypes_match_the_source(fn):
    """Each K1 launcher is bound with the argument types its C declaration
    has: a pointer for each pointer, an int for each int (no nvcc here:
    the declarations are read as text)."""
    import ctypes
    text = (build.CSRC / "elastic_matmul.cu").read_text()
    want = [ctypes.c_void_p if "*" in t else
            {"int": ctypes.c_int}[t.replace("const ", "")]
            for t in _c_params(text, fn)]
    assert em._ARGTYPES[fn] == want


def test_launch_counts_cover_the_backward_kernels():
    assert {"elastic_matmul_dgrad", "elastic_matmul_wgrad",
            "flash_attention_bwd"} <= set(ops.launch_counts())
    em.wgrad_variant_launches["wmma_bf16"] += 2
    em.dgrad_variant_launches["tma"] += 1
    fa.bwd_launches += 1
    assert ops.variant_counts()["elastic_matmul_wgrad"]["wmma_bf16"] >= 2
    assert ops.variant_counts()["elastic_matmul_dgrad"]["tma"] >= 1
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}
    assert set(ops.variant_counts()["flash_attention_bwd"]) == \
        set(fa.BWD_VARIANTS) == {"wgmma", "resident", "fma_f32"}
    assert set(ops.variant_counts()["elastic_matmul_wgrad"]) == \
        {"tma", "wmma_bf16", "fma_f32"}


def _bwd_operands(cuda, dt, M, K, N, kx, offset, seed):
    """w (K, N), dy (M, N) and x (M, kx) on the card; dy's and x's bases
    ``offset`` elements past an allocation (1 puts a bf16 base off a
    16-byte boundary, which TMA cannot read)."""
    g = torch.Generator().manual_seed(seed)
    w = (torch.randn(K, N, generator=g) / K ** 0.5).to(cuda, dt)

    def shifted(rows, cols):
        buf = torch.randn(rows * cols + offset, generator=g).to(cuda, dt)
        return buf[offset:].view(rows, cols)
    return w, shifted(M, N), shifted(M, kx)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,ka,na,kx,offset,want", [
    (2048, 384, 1536, 384, 1536, 384, 0, "tma"),
    (1000, 384, 1536, 288, 1152, 384, 0, "tma"),
    (256, 384, 1000, 192, 1000, 384, 0, "tma"),
    (300, 200, 130, 129, 77, 200, 0, "wmma_bf16"),   # row strides 130
    (50432, 384, 384, 384, 384, 384, 0, "tma"),      # the step's shapes
    (50432, 1536, 384, 1536, 384, 1536, 0, "tma"),
    (50432, 384, 1536, 288, 1152, 384, 0, "tma"),    # masked, kx > k_act
    (50176, 768, 384, 768, 384, 768, 0, "tma"),      # the patch embed
    (50432, 384, 1536, 288, 1152, 384, 1, "wmma_bf16"),   # bases off 16 B
])
def test_cuda_elastic_matmul_backward_matches_plain(cuda, dtype, M, K, N, ka,
                                                    na, kx, offset, want):
    """K1's dgrad and wgrad kernels against their plain versions, exact
    zeros past k_act (dx) and outside the active block (dw), and the
    variant each call took (fp32 always fma_f32)."""
    dt = getattr(torch, dtype)
    w, dy, x = _bwd_operands(cuda, dt, M, K, N, kx, offset, 5)
    want = want if dtype == "bfloat16" else "fma_f32"
    wd = ops.widths_tensor(cuda, ka, na)
    before = (dict(em.dgrad_variant_launches),
              dict(em.wgrad_variant_launches))
    dx = em.elastic_matmul_dgrad(dy, w, wd, ka, na, kx)
    dw = em.elastic_matmul_wgrad(x, dy, wd, ka, na, (K, N))
    torch.cuda.synchronize()
    for was, now in zip(before, (em.dgrad_variant_launches,
                                 em.wgrad_variant_launches)):
        assert {v: n - was[v] for v, n in now.items() if n != was[v]} == \
            {want: 1}
    tol = TOL[dtype] * (4 if dtype == "float32" else 1)   # sums over M rows
    torch.testing.assert_close(
        dx.float(), em.elastic_matmul_dgrad_plain(dy, w, ka, na, kx).float(),
        rtol=tol, atol=tol)
    torch.testing.assert_close(
        dw.float(),
        em.elastic_matmul_wgrad_plain(x, dy, ka, na, (K, N)).float(),
        rtol=tol, atol=tol)
    assert torch.all(dx[:, ka:] == 0) and torch.all(dw[ka:] == 0) \
        and torch.all(dw[:, na:] == 0)


@pytest.mark.cuda
def test_cuda_wgrad_tma_one_split_past_the_tile_counters(cuda):
    """qwen1.5-110b's head (K 8192, N 152064: 76,032 tiles of 128 x 128,
    more than the 65,536 tickets) at one split of M stores in place: no
    ticket needed, no refusal; against the plain version."""
    M, K, N = 256, 8192, 152064
    w, dy, x = _bwd_operands(cuda, _BF, M, K, N, K, 0, 11)
    assert em.wgrad_tma_plan(M, K, N)[0] == 1
    dw = em.elastic_matmul_wgrad(x, dy, ops.widths_tensor(cuda, K, N), K, N,
                                 (K, N))
    torch.cuda.synchronize()
    torch.testing.assert_close(
        dw.float(), em.elastic_matmul_wgrad_plain(x, dy, K, N, (K, N)).float(),
        rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,ka,na", [(384, 384, 384, 384),
                                       (384, 1536, 288, 1152)])
def test_cuda_wgrad_tma_is_deterministic_and_replays_in_a_graph(cuda, K, N,
                                                                 ka, na):
    """The fused split-K reduce adds the partials in split order: two calls
    agree bit for bit; and it resets its tile counters: a call captured in
    a CUDA graph and replayed three times gives the plain version's result
    each time."""
    M = 50432
    w, dy, x = _bwd_operands(cuda, torch.bfloat16, M, K, N, K, 0, 7)
    wd = ops.widths_tensor(cuda, ka, na)
    assert em.wgrad_tma_plan(M, ka, na)[0] > 1
    before = em.wgrad_variant_launches["tma"]
    a = em.elastic_matmul_wgrad(x, dy, wd, ka, na, (K, N))
    b = em.elastic_matmul_wgrad(x, dy, wd, ka, na, (K, N))
    torch.cuda.synchronize()
    assert em.wgrad_variant_launches["tma"] - before == 2
    assert torch.equal(a, b)
    want = em.elastic_matmul_wgrad_plain(x, dy, ka, na, (K, N)).float()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = em.elastic_matmul_wgrad(x, dy, wd, ka, na, (K, N))
    for _ in range(3):
        out.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), want, rtol=2e-2, atol=2e-2)
        assert torch.equal(out, a)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,H,KH", [(197, 6, 6), (100, 6, 2), (65, 4, 4)])
def test_cuda_flash_attention_backward_matches_plain(cuda, dtype, S, H, KH):
    """K2's logsumexp and backward kernels against the plain versions at
    D = 64, T a multiple of the tile or not, GQA."""
    g = torch.Generator().manual_seed(6)
    dt = getattr(torch, dtype)
    tol = 3e-3 if dtype == "float32" else 3e-2
    q = (torch.randn(4, S, H, 64, generator=g) * 0.5).to(cuda, dt)
    k = (torch.randn(4, S, KH, 64, generator=g) * 0.5).to(cuda, dt)
    v = torch.randn(4, S, KH, 64, generator=g).to(cuda, dt)
    do = torch.randn(4, S, H, 64, generator=g).to(cuda, dt)
    o, lse = fa.flash_attention(q, k, v, causal=False, return_lse=True)
    _, lse_p = fa.flash_attention_plain(q, k, v, causal=False,
                                        return_lse=True)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=False)
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, causal=False)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, lse_p, rtol=1e-3, atol=1e-3)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


def test_fp32_backward_takes_the_smoke_head_dims():
    """K2's fp32 backward at the smoke configs' head dims (DiT-smoke 8,
    UNet-smoke 16) and 64 goes to fma_f32, causal too (the LM smoke's
    16); bf16 takes 64 and 128 alone."""
    for D in (8, 16, 64):
        for causal in (False, True):
            assert fa.choose_bwd_variant(16, 77, D, torch.float32,
                                         causal) == "fma_f32"
    for D in (8, 16):
        with pytest.raises(NotImplementedError):
            fa.choose_bwd_variant(16, 16, D, torch.bfloat16, False)
    assert fa.choose_bwd_variant(16, 16, 128, torch.bfloat16,
                                 False) == "wgmma"


@pytest.mark.cuda
@pytest.mark.parametrize("D,S,T,H,KH", [
    (8, 16, 16, 4, 4),        # DiT-smoke self-attention
    (16, 16, 16, 4, 4),       # UNet-smoke self-attention
    (16, 16, 77, 4, 4),       # UNet-smoke cross-attention
    (8, 100, 37, 6, 2),       # ragged tiles, GQA
    (16, 197, 197, 4, 4)])
def test_cuda_flash_attention_fp32_backward_at_head_dims_8_and_16(
        cuda, D, S, T, H, KH):
    """K2's fp32 backward at the smoke configs' head dims against the
    plain backward: one launch on fma_f32, fp32 tolerance."""
    g = torch.Generator().manual_seed(D + S + T)
    q = (torch.randn(3, S, H, D, generator=g) * 0.5).to(cuda)
    k = (torch.randn(3, T, KH, D, generator=g) * 0.5).to(cuda)
    v = torch.randn(3, T, KH, D, generator=g).to(cuda)
    do = torch.randn(3, S, H, D, generator=g).to(cuda)
    o, lse = fa.flash_attention(q, k, v, causal=False, return_lse=True)
    before = fa.bwd_variant_launches["fma_f32"]
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=False)
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, causal=False)
    torch.cuda.synchronize()
    assert fa.bwd_variant_launches["fma_f32"] - before == 1
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=3e-3, atol=3e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D", [("bfloat16", 128), ("bfloat16", 64),
                                     ("float32", 16), ("float32", 64)])
@pytest.mark.parametrize("S,H,KH", [(257, 4, 2), (64, 4, 4), (1, 2, 2)])
def test_cuda_flash_attention_causal_backward_matches_plain(cuda, dtype, D,
                                                             S, H, KH):
    """K2's causal backward (the LM's, D = 128 in bf16, the smoke config's
    16 in fp32) against the plain backward, ragged tiles and GQA: one
    launch on wgmma or fma_f32, within tolerance of the largest
    gradient."""
    g = torch.Generator().manual_seed(D + S)
    dt = getattr(torch, dtype)
    tol = 3e-3 if dtype == "float32" else 1e-2
    q = torch.randn(2, S, H, D, generator=g).to(cuda, dt)
    k = torch.randn(2, S, KH, D, generator=g).to(cuda, dt)
    v = torch.randn(2, S, KH, D, generator=g).to(cuda, dt)
    do = torch.randn(2, S, H, D, generator=g).to(cuda, dt)
    o, lse = fa.flash_attention_plain(q, k, v, causal=True, return_lse=True)
    o = o.to(dt).contiguous()
    want_v = "fma_f32" if dtype == "float32" else "wgmma"
    before = fa.bwd_variant_launches[want_v]
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, causal=True)
    torch.cuda.synchronize()
    assert fa.bwd_variant_launches[want_v] - before == 1
    # of the largest gradient: at a single key dq and dk are round-off of 0
    scale = max(float(b.float().abs().max()) for b in want)
    for a, b in zip(got, want):
        assert float((a.float() - b.float()).abs().max()) <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,F,C", [(2048, 1408, 480), (1408, 2048, 17),
                                   (2048, 1056, 16)])
def test_cuda_expert_matmul_backward_matches_plain(cuda, dtype, K, F, C):
    """K3's dgrad and wgrad (the routed experts' gradients) against their
    plain versions: ragged counts with a dead expert, NaN in x and dy past
    every count, the expert width a strided view; dgrad exact zeros past
    the counts, the dead expert's dw exactly 0, wgrad the same bits twice;
    persistent in bf16, tile_f32 in fp32."""
    g = torch.Generator().manual_seed(K + F + C)
    dt = getattr(torch, dtype)
    E = 8
    counts = torch.tensor([C, 0, 1, C // 2, C - 1, 5, C, 3],
                          dtype=torch.int32, device=cuda)
    live = (torch.arange(C, device=cuda)[None, :]
            < counts[:, None])[..., None]
    nan = torch.tensor(float("nan"), dtype=dt, device=cuda)
    x = torch.where(live, torch.randn(E, C, K, generator=g).to(cuda, dt), nan)
    dy = torch.where(live, torch.randn(E, C, F, generator=g).to(cuda, dt),
                     nan)
    w = (torch.randn(E, K, F + 64, generator=g) / K ** 0.5).to(cuda, dt)
    w = w[..., :F]
    want_d, want_w = ("tile_f32", "tile_f32") if dtype == "float32" \
        else ("persistent", "persistent")
    before = (xm.dgrad_variant_launches[want_d],
              xm.wgrad_variant_launches[want_w])
    dx = xm.expert_matmul_dgrad(dy, w, counts)
    dw = xm.expert_matmul_wgrad(x, dy, counts)
    dw2 = xm.expert_matmul_wgrad(x, dy, counts)
    torch.cuda.synchronize()
    assert (xm.dgrad_variant_launches[want_d] - before[0],
            xm.wgrad_variant_launches[want_w] - before[1]) == (1, 2)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for got, want in ((dx, xm.expert_matmul_dgrad_plain(dy, w, counts)),
                      (dw, xm.expert_matmul_wgrad_plain(x, dy, counts))):
        scale = float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= \
            tol * scale
    assert torch.all(dx.masked_select(~live) == 0)
    assert torch.all(dw[1] == 0)
    assert torch.equal(dw, dw2)


@pytest.mark.cuda
@pytest.mark.parametrize("S,T,H,KH,D,causal", [
    *((S, T, H, KH, D, causal)
      for S, T, H, KH in ((127, 127, 4, 2), (129, 129, 4, 2),
                          (300, 100, 4, 4), (100, 300, 2, 1), (1, 1, 2, 2))
      for D, causal in ((64, True), (128, False), (128, True))),
    # non-causal D = 64 past resident's 256 queries or keys
    (300, 100, 4, 4, 64, False), (100, 300, 2, 1, 64, False),
    (257, 257, 4, 2, 64, False), (1, 257, 2, 2, 64, False)])
def test_cuda_flash_attention_backward_wgmma_matches_plain(cuda, S, T, H,
                                                           KH, D, causal):
    """K2's wgmma backward against the plain version at ragged S and T
    (64-query chunks, 128-key tiles), causal and not, GQA, at the shapes
    the choice sends it: one launch on wgmma, within 1e-2 of the largest
    gradient, and dQ's ordered sum the same bits twice and under 3 graph
    replays."""
    g = torch.Generator().manual_seed(D + S + T)
    q, do = (torch.randn(2, S, H, D, generator=g).to(cuda, _BF)
             for _ in range(2))
    k, v = (torch.randn(2, T, KH, D, generator=g).to(cuda, _BF)
            for _ in range(2))
    o, lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                      return_lse=True)
    o = o.to(_BF).contiguous()
    before = fa.bwd_variant_launches["wgmma"]
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert fa.bwd_variant_launches["wgmma"] - before == 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, causal=causal)
    scale = max(float(b.float().abs().max()) for b in want)
    for a, b in zip(got, want):
        assert float((a.float() - b.float()).abs().max()) <= 1e-2 * scale
    _graph_replays_equal(lambda: fa.flash_attention_bwd(
        q, k, v, o, lse, do, causal=causal), got)


@pytest.mark.cuda
@pytest.mark.parametrize("S,T,H,KH,causal", [
    (512, 512, 64, 8, True),      # kimi-k2's heads, a prefill's length
    (300, 300, 8, 1, True),       # MQA, ragged chunks and key tiles
    (129, 77, 4, 2, False),       # fewer keys than queries
    (65, 1, 2, 2, False)])        # one key
def test_cuda_flash_attention_backward_wgmma_d112_matches_plain(
        cuda, S, T, H, KH, causal):
    """K2's wgmma backward at kimi-k2's head dim 112 (two 64-column boxes,
    the second zero-filled past 48 columns; 448-byte dQ rows) against the
    plain version: one launch on wgmma, within 1e-2 of the largest
    gradient (a store past column 112 would overwrite the next row of the
    contiguous dq, dk or dv), the same bits twice and under 3 graph
    replays."""
    g = torch.Generator().manual_seed(112 + S + T)
    D = 112
    q, do = (torch.randn(2, S, H, D, generator=g).to(cuda, _BF)
             for _ in range(2))
    k, v = (torch.randn(2, T, KH, D, generator=g).to(cuda, _BF)
            for _ in range(2))
    o, lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                      return_lse=True)
    o = o.to(_BF).contiguous()
    before = fa.bwd_variant_launches["wgmma"]
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert fa.bwd_variant_launches["wgmma"] - before == 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, causal=causal)
    scale = max(float(b.float().abs().max()) for b in want)
    for a, b in zip(got, want):
        assert a.shape[-1] == D
        assert float((a.float() - b.float()).abs().max()) <= 1e-2 * scale
    _graph_replays_equal(lambda: fa.flash_attention_bwd(
        q, k, v, o, lse, do, causal=causal), got)


@pytest.mark.cuda
@pytest.mark.parametrize("K,F,C", [(2048, 1408, 1920), (1408, 2048, 480),
                                   (1056, 2048, 17), (704, 2048, 300)])
def test_cuda_expert_matmul_dgrad_persistent_matches_plain(cuda, K, F, C):
    """K3's persistent dgrad against the plain version: counts 0, 1, a
    partial tile, C - 1 and C, NaN in dy past every count, a strided
    a_ff view of w; one launch on persistent, exact zeros past the
    counts, within bf16 tolerance, the same bits twice and under 3 graph
    replays."""
    g = torch.Generator().manual_seed(K + F + C)
    E = 16
    counts = torch.tensor([0, 1, C // 3, C - 1, C, 65 % (C + 1), 130 % (
        C + 1), C // 2] * 2, dtype=torch.int32, device=cuda)
    live = (torch.arange(C, device=cuda)[None, :]
            < counts[:, None])[..., None]
    nan = torch.tensor(float("nan"), dtype=_BF, device=cuda)
    dy = torch.where(live, torch.randn(E, C, F, generator=g).to(cuda, _BF),
                     nan)
    w = (torch.randn(E, K, F + 64, generator=g) / F ** 0.5).to(cuda, _BF)
    w = w[..., :F]
    before = xm.dgrad_variant_launches["persistent"]
    dx = xm.expert_matmul_dgrad(dy, w, counts)
    dx2 = xm.expert_matmul_dgrad(dy, w, counts)
    torch.cuda.synchronize()
    assert xm.dgrad_variant_launches["persistent"] - before == 2
    assert torch.equal(dx, dx2)
    assert torch.all(dx.masked_select(~live) == 0)
    want = xm.expert_matmul_dgrad_plain(dy, w, counts)
    scale = float(want.float().abs().max())
    assert float((dx.float() - want.float()).abs().max()) <= 2e-2 * scale
    _graph_replays_equal(lambda: xm.expert_matmul_dgrad(dy, w, counts), dx)


def _wgrad_matches_plain(cuda, E, K, F, C, counts, want):
    """K3's wgrad on ``want`` against the plain version: NaN in x and dy
    past every count, x a strided view; one launch a call on ``want``, a
    dead expert's dw exactly 0, within bf16 tolerance, the same bits twice
    and under 3 graph replays."""
    g = torch.Generator().manual_seed(E + K + F + C)
    ragged = [0, 1, C // 3, C - 1, C, 65 % (C + 1), 130 % (C + 1), C // 2]
    c = {"ragged": (ragged * E)[:E], "all dead": [0] * E, "all C": [C] * E,
         "one": [C - 70]}[counts]
    counts = torch.tensor(c, dtype=torch.int32, device=cuda)
    live = (torch.arange(C, device=cuda)[None, :]
            < counts[:, None])[..., None]
    nan = torch.tensor(float("nan"), dtype=_BF, device=cuda)
    x = torch.randn(E, C, K + 64, generator=g).to(cuda, _BF)
    x = torch.where(live, x, nan)[..., :K]
    dy = torch.where(live, torch.randn(E, C, F, generator=g).to(cuda, _BF),
                     nan)
    assert xm.bwd_variant_of(x, dy, "wgrad") == want
    before = xm.wgrad_variant_launches[want]
    dw = xm.expert_matmul_wgrad(x, dy, counts)
    dw2 = xm.expert_matmul_wgrad(x, dy, counts)
    torch.cuda.synchronize()
    assert xm.wgrad_variant_launches[want] - before == 2
    assert torch.equal(dw, dw2)
    assert torch.all(dw[counts == 0] == 0)
    want_dw = xm.expert_matmul_wgrad_plain(x, dy, counts)
    scale = max(float(want_dw.float().abs().max()), 1e-30)
    assert torch.isfinite(dw).all()
    assert float((dw.float() - want_dw.float()).abs().max()) <= 2e-2 * scale
    _graph_replays_equal(lambda: xm.expert_matmul_wgrad(x, dy, counts), dw)


@pytest.mark.cuda
@pytest.mark.parametrize("E,K,F,C,counts", [
    (16, 2048, 1408, 480, "ragged"), (8, 1408, 2048, 300, "all dead"),
    (8, 1408, 2048, 300, "all C"), (1, 2048, 1408, 1920, "one"),
    (4, 704, 2048, 17, "ragged"), (8, 704, 128, 300, "ragged")])
def test_cuda_expert_matmul_wgrad_persistent_matches_plain(cuda, E, K, F, C,
                                                           counts):
    """K3's persistent wgrad: counts 0, 1, a partial box, C - 1 and C,
    every expert dead, E = 1, F = 128 (half of a 256-column item)."""
    _wgrad_matches_plain(cuda, E, K, F, C, counts, "persistent")


@pytest.mark.cuda
@pytest.mark.parametrize("K,F,C", [(2048, 1408, 16), (1408, 2048, 17)])
def test_cuda_expert_matmul_wgrad_tma_past_512_experts(cuda, K, F, C):
    """K3's tma wgrad, which takes the bf16 calls with more experts than
    the persistent kernel's prologue holds: 513 experts, ragged counts."""
    _wgrad_matches_plain(cuda, 513, K, F, C, "ragged", "tma")


# --- the fp32 router's split-K kernel and K2's resident backward ------------

def _graph_replays_equal(fn, first):
    """Capture fn() in a CUDA graph, replay it 3 times over NaN-filled
    outputs, and check each replay equals ``first`` bit for bit."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    outs = out if isinstance(out, tuple) else (out,)
    firsts = first if isinstance(first, tuple) else (first,)
    for _ in range(3):
        for t in outs:
            t.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(outs, firsts))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [17, 64, 129, 2048])
@pytest.mark.parametrize("n_act", [64, 63, 32, 1])
def test_cuda_f32_splitk_matches_plain(cuda, M, n_act):
    """f32_splitk at the fp32 MoE router's shape (K = d_model 2048, 64
    experts) against the plain version: one launch on f32_splitk, fp32
    tolerance, exact zeros past n_act."""
    g = torch.Generator().manual_seed(M + n_act)
    x = torch.randn(M, 2048, generator=g).to(cuda)
    w = (torch.randn(2048, 64, generator=g) / 2048 ** 0.5).to(cuda)
    before = em.variant_launches["f32_splitk"]
    y = ops.elastic_matmul_op(x, w, 2048, n_act, n_out=64)
    torch.cuda.synchronize()
    assert em.variant_launches["f32_splitk"] - before == 1
    want = em.elastic_matmul_plain(x, w, 2048, n_act, 64)
    torch.testing.assert_close(y, want, rtol=TOL["float32"],
                               atol=TOL["float32"])
    assert torch.all(y[:, n_act:] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("M,k_act", [(2048, 2048), (300, 509)])
def test_cuda_f32_splitk_is_deterministic_and_replays_in_a_graph(cuda, M,
                                                                 k_act):
    """The fused split-K reduce adds the partials in split order: two
    calls agree bit for bit; it resets its tile counters: 3 replays of a
    captured call give the eager result."""
    g = torch.Generator().manual_seed(9)
    x = torch.randn(M, 2048, generator=g).to(cuda)
    w = (torch.randn(2048, 64, generator=g) / 2048 ** 0.5).to(cuda)
    assert em.f32_splitk_plan(M, k_act, 64)[1] > 1
    a = ops.elastic_matmul_op(x, w, k_act, 64)
    b = ops.elastic_matmul_op(x, w, k_act, 64)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    _graph_replays_equal(lambda: ops.elastic_matmul_op(x, w, k_act, 64), a)


# a gradient whose largest value is under this share of the largest of
# the call's three is 0 but for fp32 round-off (as chip_smoke.py holds
# the key biases of the fp32 training step)
ZERO_GRAD_REL = 1e-5


def _k2_bwd_case(cuda, B, S, T, H, KH, seed):
    g = torch.Generator().manual_seed(seed)
    q = (torch.randn(B, S, H, 64, generator=g) * 0.5).to(cuda, _BF)
    k = (torch.randn(B, T, KH, 64, generator=g) * 0.5).to(cuda, _BF)
    v = torch.randn(B, T, KH, 64, generator=g).to(cuda, _BF)
    do = torch.randn(B, S, H, 64, generator=g).to(cuda, _BF)
    # the decode forward (S = 1) keeps no logsumexp: the plain one does
    fwd = fa.flash_attention_plain if S == 1 else fa.flash_attention
    o, lse = fwd(q, k, v, causal=False, return_lse=True)
    return q, k, v, o, lse, do


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,H,KH,want", [
    (8, 197, 197, 6, 6, "resident"),    # the sandwich step's heads
    (4, 100, 77, 4, 2, "resident"),     # T off the 16 and 64 grids, GQA 2
    (4, 40, 50, 4, 4, "resident"),      # one warpgroup of keys
    (4, 150, 150, 6, 3, "resident"),    # GQA R = 2, three warpgroups
    (2, 256, 230, 4, 4, "resident"),
    (3, 2, 1, 2, 2, "resident"),        # one key: P = 1, dQ = dK = 0
    (4, 1, 77, 4, 2, "resident"),       # one query
    (2, 300, 300, 4, 2, "wgmma"),       # past the resident limit
])
def test_cuda_flash_attention_backward_resident_matches_plain(
        cuda, B, S, T, H, KH, want):
    """K2's backward on the variant the shape takes against the plain
    version, bf16 tolerance, each gradient also within tol of its
    largest value (a kernel writing zeros fails).  A gradient whose true
    value is 0 (dQ and dK at one key, where P = 1 and dS = P (dP - delta)
    vanishes) has a plain value of fp32 round-off, under
    ``ZERO_GRAD_REL`` of the largest gradient: there the kernel's must be
    round-off too."""
    q, k, v, o, lse, do = _k2_bwd_case(cuda, B, S, T, H, KH, S + T)
    before = dict(fa.bwd_variant_launches)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=False)
    torch.cuda.synchronize()
    took = {n: c - before[n] for n, c in fa.bwd_variant_launches.items()
            if c != before[n]}
    assert took == {want: 1}
    want_g = fa.flash_attention_bwd_plain(q, k, v, o, do, causal=False)
    zero = ZERO_GRAD_REL * max(float(b.abs().max()) for b in want_g)
    for a, b in zip(got, want_g):
        a, b = a.float(), b.float()
        torch.testing.assert_close(a, b, rtol=3e-2, atol=3e-2)
        if float(b.abs().max()) < zero:
            assert float(a.abs().max()) < zero
        else:
            assert float((a - b).abs().max()) \
                <= 3e-2 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("H,KH", [(6, 6), (6, 2)])
def test_cuda_resident_backward_is_deterministic_and_replays_in_a_graph(
        cuda, H, KH):
    """No atomics: two calls agree bit for bit, and 3 replays of a
    captured call give the eager result."""
    q, k, v, o, lse, do = _k2_bwd_case(cuda, 8, 197, 197, H, KH, 11)
    a = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=False)
    b = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=False)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    _graph_replays_equal(lambda: fa.flash_attention_bwd(
        q, k, v, o, lse, do, causal=False), a)
