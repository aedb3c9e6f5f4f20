"""Main-path layers of the PyTorch port against the JAX reference layers.

Same params (JAX init, converted) and the same numpy inputs through
``repro.core.layers`` and ``repro_torch.core.layers`` at static (sliced)
widths, mirroring tests/test_elastic_layers.py.  Tolerance: 1e-4 in fp32
(the two frameworks sum in different orders; outputs are of order one).
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import layers as JL  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.core import layers as TL  # noqa: E402
from repro_torch.core import elastic as TE  # noqa: E402
from repro_torch.core.types import SubnetSpec, is_static  # noqa: E402

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(0)
TOL = 1e-4


def _params(p):
    return to_torch(jax.tree_util.tree_map(np.asarray, p))


def _x(shape, seed=0):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("a_in,a_out", [(None, None), (24, 40), (1, 1),
                                        (48, 7), (13, None)])
def test_dense_matches_jax(a_in, a_out):
    pj = JL.dense_init(KEY, 48, 40)
    pj["bias"] = jax.random.normal(KEY, (40,))
    xj, xt = _x((3, 5, a_in or 48))
    _close(TL.dense_apply(_params(pj), xt, a_in=a_in, a_out=a_out),
           JL.dense_apply(pj, xj, a_in=a_in, a_out=a_out))


@pytest.mark.parametrize("d,a", [(64, None), (64, 32), (48, 13)])
def test_layernorm_matches_jax(d, a):
    pj = {"scale": jax.random.normal(KEY, (d,)),
          "bias": jax.random.normal(jax.random.fold_in(KEY, 1), (d,))}
    xj, xt = _x((2, 5, a or d), seed=d)
    _close(TL.layernorm_apply(_params(pj), xt, a=a),
           JL.layernorm_apply(pj, xj, a=a))


@pytest.mark.parametrize("gated,act", [(False, "gelu"), (True, "silu"),
                                       (False, "relu")])
@pytest.mark.parametrize("a_model,a_ff", [(None, None), (32, 64), (16, 24)])
def test_mlp_matches_jax(gated, act, a_model, a_ff):
    pj = JL.mlp_init(KEY, 32, 128, gated=gated, bias=True)
    xj, xt = _x((2, 7, a_model or 32), seed=3)
    _close(TL.mlp_apply(_params(pj), xt, a_model=a_model, a_ff=a_ff, act=act),
           JL.mlp_apply(pj, xj, a_model=a_model, a_ff=a_ff, act=act))


@pytest.mark.parametrize("n_heads,n_kv,a_heads,a_model", [
    (6, 6, None, None), (6, 6, 4, 24), (6, 6, 3, 16), (8, 4, 4, 32),
    (8, 4, None, 16), (6, 2, 4, None), (4, 1, 2, 32),
])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_matches_jax(n_heads, n_kv, a_heads, a_model, causal):
    d_model, d_head = 32, 8
    pj = JL.attention_init(KEY, d_model, n_heads, n_kv, d_head, qkv_bias=True)
    xj, xt = _x((2, 17, a_model or d_model), seed=n_heads + n_kv)
    yt, _ = TL.attention_apply(_params(pj), xt, n_heads=n_heads, n_kv=n_kv,
                               d_head=d_head, causal=causal, a_model=a_model,
                               a_heads=a_heads)
    yj, _ = JL.attention_apply(pj, xj, n_heads=n_heads, n_kv=n_kv,
                               d_head=d_head, causal=causal, rope_theta=None,
                               a_model=a_model, a_heads=a_heads)
    _close(yt, yj)


@pytest.mark.parametrize("res,patch", [(32, 8), (224, 16), (30, 8)])
def test_patch_embed_matches_jax_conv(res, patch):
    """Unfold + elastic matmul == the reference's stride-P VALID conv."""
    pj = JL.conv_init(KEY, patch, 3, 48, bias=True)
    pj["bias"] = jax.random.normal(KEY, (48,))
    xj, xt = _x((2, res, res, 3), seed=res)
    yt = TL.conv_apply(_params(pj), xt, stride=patch, padding="VALID")
    yj = JL.conv_apply(pj, xj, stride=patch, padding="VALID")
    assert yt.shape == yj.shape
    _close(yt, yj)


def test_unported_modes_raise():
    p = _params(JL.dense_init(KEY, 8, 8))
    with pytest.raises(NotImplementedError):     # masked mode: training slice
        TL.dense_apply(p, torch.zeros(2, 8), a_out=torch.tensor(4))
    with pytest.raises(NotImplementedError):     # only the patch embed conv
        TL.conv_apply(_params(JL.conv_init(KEY, 3, 3, 4)),
                      torch.zeros(1, 8, 8, 3), stride=1, padding="SAME")
    pa = _params(JL.attention_init(KEY, 8, 2, 2, 4))
    with pytest.raises(NotImplementedError):     # rope: LM slice
        TL.attention_apply(pa, torch.zeros(1, 3, 8), n_heads=2, n_kv=2,
                           d_head=4, rope_theta=10000.0)


# --- elastic helpers ----------------------------------------------------------

def test_is_static_treats_tensor_as_dynamic():
    assert is_static(None) and is_static(3) and is_static(np.int32(3))
    assert not is_static(torch.tensor(3))


@pytest.mark.parametrize("spec", [
    SubnetSpec(), SubnetSpec(0.5, 0.25, 0.5, 1 / 3),
    SubnetSpec(0.75, 0.75, 0.75, 5 / 6), SubnetSpec(heads_mult=0.75),
])
def test_spec_to_static_and_dynamic_match_jax(spec):
    from repro.core import elastic as JE
    dims = {"d_model": 384, "d_ff": 1536, "n_heads": 6, "n_layers": 12}
    assert TE.spec_to_static(spec, dims) == JE.spec_to_static(spec, dims)
    dyn_t = TE.spec_to_dynamic(spec, dims)
    dyn_j = JE.spec_to_dynamic(spec, dims)
    assert {k: int(v) for k, v in dyn_t.items()} == \
        {k: int(v) for k, v in dyn_j.items()}
    assert all(v.dtype == torch.int32 for v in dyn_t.values())


def test_heads_round_half_to_even():
    dims = {"n_heads": 6}
    assert TE.spec_to_static(SubnetSpec(heads_mult=0.75), dims)["a_heads"] == 4


def test_mask_and_take_dim_match_jax():
    from repro.core import elastic as JE
    xj, xt = _x((3, 10))
    for a in (4, torch.tensor(4)):
        ja = a if isinstance(a, int) else jnp.asarray(4)
        _close(TE.mask_dim(xt, a, -1), JE.mask_dim(xj, ja, -1), tol=0)
    _close(TE.take_dim(xt, 6, 1), JE.take_dim(xj, 6, 1), tol=0)
    _close(TE.active_mask(3, 5), JE.active_mask(3, 5), tol=0)
