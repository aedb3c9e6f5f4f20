"""The port's serving path across a device mesh against the JAX reference.

The reference runs in a subprocess with 8 fake CPU devices (as
tests/test_decode_attn.py and tests/test_moe.py run it); the port runs
in gloo ranks on the CPU, one group of four processes for the module
(``tests/_torch_dist.py``), on the reference's parameters and the same
inputs drawn from a numpy seed.  Both sides are fp32.

* ``sharded_decode_attention`` through ``attention_apply(decode_impl=
  "sharded")`` on a (2, 2) mesh at B = 16 (sequence over ``model``, batch
  over ``data``) and B = 4 (sequence over both): 4 steps whose writes
  cross a shard boundary from a fill where a shard holds no valid key;
  outputs and the caches gathered from the ranks' blocks, within 1e-5.
* the ``a2a`` ``moe_apply`` on a (2, 2) mesh at capacity factor 0.5
  (slots drop), with and without the elastic knobs, at a prefill shape
  and at the decode shape S = 1 (the einsum fallback over each rank's
  experts), within 1e-5; the aux loss within 1e-6 relative.
* the smoke deepseek LM on a (1, 2) mesh: prefill and 4 decode steps
  within 2e-4 of the reference's ``lm_apply`` with a mesh (the smoke
  LMs' tolerance in tests/test_torch_lm_configs.py).
* ``param_specs`` equal to the reference's on every registry arch's smoke
  and full trees, and ``opt_specs_like`` on adafactor's factored state
  of the full deepseek-moe-16b tree.
* the plain K2 decode's logsumexp against ``jax.nn.logsumexp`` of the
  reference's scores (1e-5), and on the card the kernel against it.
"""
import dataclasses
import json
import os
import textwrap
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import _torch_dist as TD  # noqa: E402
from conftest import run_subprocess  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.distributed import ctx  # noqa: E402
from repro_torch.distributed import sharding as TS  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models.transformer import LMConfig  # noqa: E402

TOL = 1e-5             # decode attention and the MoE layer, fp32
LM_TOL = 2e-4          # the 4-layer smoke LM's logits
MOE_CFG = dict(n_experts=8, top_k=2, d_ff=16, n_shared=1,
               capacity_factor=0.5, group_size=16, dispatch="a2a")
LM_BATCH = 2


def _lm_cfg(cfg: LMConfig) -> LMConfig:
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, dispatch="a2a"),
        decode_impl="sharded")


REF = """
import dataclasses, json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs.registry import get_arch
from repro.core import layers as L
from repro.launch.mesh import make_mesh
from repro.models import moe as JM, transformer as JT

inp = dict(np.load({inputs!r}))
out, params = {{}}, {{}}

def flat(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        params[prefix + "/" + key] = np.asarray(leaf)

mesh22 = make_mesh((2, 2), ("data", "model"))
pa = L.attention_init(jax.random.PRNGKey(0), {d}, {h}, {kh}, {dh})
flat("attn", pa)
for B, fill in {fills!r}.items():
    step = jax.jit(lambda p, x, c: L.attention_apply(
        p, x, n_heads={h}, n_kv={kh}, d_head={dh}, kv_cache=c,
        decode_impl="sharded", mesh=mesh22))
    c = {{"k": jnp.asarray(inp[f"dec{{B}}_k"]),
         "v": jnp.asarray(inp[f"dec{{B}}_v"]),
         "len": jnp.asarray(fill, jnp.int32)}}
    ys = []
    with mesh22:
        for t in range({steps}):
            y, c = step(pa, jnp.asarray(inp[f"dec{{B}}_x"][:, t:t + 1]), c)
            ys.append(y)
    out[f"dec{{B}}_y"] = np.asarray(jnp.concatenate(ys, 1))
    out[f"dec{{B}}_k"] = np.asarray(c["k"])
    out[f"dec{{B}}_v"] = np.asarray(c["v"])
    out[f"dec{{B}}_len"] = np.asarray(c["len"])

cfgm = JM.MoEConfig(**{moe_cfg!r})
pm = JM.moe_init(jax.random.PRNGKey(1), {d}, cfgm)
flat("moe", pm)
with mesh22:
    for name, (xk, kn) in {moe_cases!r}.items():
        y, aux = jax.jit(lambda p, x: JM.moe_apply(
            p, x, cfgm, mesh=mesh22, data_axes=("data",), **kn))(
                pm, jnp.asarray(inp["moe_" + xk]))
        out[f"moe_{{name}}_y"] = np.asarray(y)
        out[f"moe_{{name}}_aux"] = np.asarray(aux)

cfg = get_arch("deepseek-moe-16b").make_smoke()
cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                       dispatch="a2a"),
                          decode_impl="sharded")
pl = jax.jit(lambda k: JT.lm_init(k, cfg))(jax.random.PRNGKey(2))
flat("lm", pl)
mesh12 = make_mesh((1, 2), ("data", "model"))
S, T = {lm_s}, {lm_t}

def prefill(p, t):
    logits, _, kv = JT.lm_apply(p, t, cfg, return_kv=True, mesh=mesh12)
    c = JT.make_decode_caches(cfg, t.shape[0], T, dtype=jnp.float32,
                              filled=S)
    for name in c:
        for kk in ("k", "v"):
            c[name][kk] = c[name][kk].at[:, :, :S].set(kv[name][kk])
    return logits[:, -1], c

def decode(p, c, t):
    lg, _, c = JT.lm_apply(p, t, cfg, caches=c, mesh=mesh12)
    return lg[:, -1], c

toks = jnp.asarray(inp["lm_tokens"])
with mesh12:
    last, c = jax.jit(prefill)(pl, toks[:, :S])
    step = jax.jit(decode)
    outs = []
    for i in range(S, S + {lm_steps}):
        lg, c = step(pl, c, toks[:, i:i + 1])
        outs.append(lg)
out["lm_prefill"] = np.asarray(last)
out["lm_decode"] = np.asarray(jnp.stack(outs, 1))
np.savez({params_out!r}, **params)
np.savez({out!r}, **out)
print("OK")
"""

SPECS = """
import json
import jax, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs.registry import get_arch, list_archs
from repro.distributed.sharding import opt_specs_like, param_specs
from repro.models.transformer import lm_init
from repro.optim.api import make_optimizer

def init_fn(arch, cfg):
    key, a = jax.random.PRNGKey(0), arch.arch_id
    if arch.family == "lm":
        return lambda: lm_init(key, cfg)
    if a.startswith("dit"):
        from repro.models.dit import dit_init
        return lambda: dit_init(key, cfg)
    if a.startswith("unet"):
        from repro.models.unet import unet_init
        return lambda: unet_init(key, cfg)
    if a.startswith(("deit", "vit", "dynamic-ofa")):
        from repro.models.vit import vit_init
        return lambda: vit_init(key, cfg)
    if a.startswith("resnet"):
        from repro.models.resnet import resnet_init
        return lambda: resnet_init(key, cfg)
    from repro.models.efficientnet import effnet_init
    return lambda: effnet_init(key, cfg)

def path_str(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)

def spec_json(s):
    return [list(e) if isinstance(e, tuple) else e for e in s]

def dump(shapes, specs):
    sh = {path_str(p): list(l.shape)
          for p, l in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    sp = {path_str(p): spec_json(s) for p, s in
          jax.tree_util.tree_flatten_with_path(
              specs, is_leaf=lambda x: isinstance(x, P))[0]}
    return {k: [sh[k], sp[k]] for k in sh}

out = {}
for a in list_archs():
    arch = get_arch(a)
    fam = "lm" if arch.family == "lm" else "vision"
    for which in ("smoke", "full"):
        cfg = arch.make_smoke() if which == "smoke" else arch.make_config()
        shapes = jax.eval_shape(init_fn(arch, cfg))
        out[f"{a}:{which}"] = dump(shapes, param_specs(shapes, fam))
arch = get_arch("deepseek-moe-16b")
shapes = jax.eval_shape(init_fn(arch, arch.make_config()))
specs = param_specs(shapes, "lm")
init, _ = make_optimizer("adafactor")
oshapes = jax.eval_shape(init, shapes)
out["opt"] = dump(oshapes["s"], opt_specs_like(specs, oshapes, shapes)["s"])
with open(__PATH__, "w") as f:
    json.dump(out, f)
print("OK")
"""


def _inputs(path: str) -> dict:
    rng = np.random.default_rng(0)
    inp = {}
    for B in TD.DECODE_FILL:
        inp[f"dec{B}_x"] = rng.standard_normal(
            (B, TD.STEPS, TD.D_MODEL)).astype(np.float32)
        for kk in ("k", "v"):
            inp[f"dec{B}_{kk}"] = rng.standard_normal(
                (B, TD.SLOTS, TD.KH, TD.DH)).astype(np.float32)
    inp["moe_x"] = rng.standard_normal((4, 16, TD.D_MODEL)).astype(
        np.float32)
    inp["moe_x1"] = rng.standard_normal((4, 1, TD.D_MODEL)).astype(
        np.float32)
    vocab = get_arch("deepseek-moe-16b").make_smoke().vocab_size
    inp["lm_tokens"] = rng.integers(0, vocab, (LM_BATCH, TD.LM_S
                                               + TD.LM_STEPS)).astype(
        np.int32)
    np.savez(path, **inp)
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides once for the module: the reference's outputs, specs and
    parameters, then the port's ranks on those parameters."""
    tmp = tmp_path_factory.mktemp("dist")
    inputs, params = str(tmp / "inputs.npz"), str(tmp / "ref_params.npz")
    ref_out, specs = str(tmp / "ref_out.npz"), str(tmp / "specs.json")
    inp = _inputs(inputs)
    ref_code = textwrap.dedent(REF).format(
        inputs=inputs, d=TD.D_MODEL, h=TD.H, kh=TD.KH, dh=TD.DH,
        fills=TD.DECODE_FILL, steps=TD.STEPS, moe_cfg=MOE_CFG,
        moe_cases=TD.MOE_CASES, lm_s=TD.LM_S, lm_t=TD.LM_T,
        lm_steps=TD.LM_STEPS, params_out=params, out=ref_out)
    spec_code = textwrap.dedent(SPECS).replace("__PATH__", repr(specs))
    with ThreadPoolExecutor(2) as pool:
        spec_job = pool.submit(run_subprocess, spec_code, 1, 600)
        run_subprocess(ref_code, n_devices=8, timeout=600)
        cfg = _lm_cfg(get_arch("deepseek-moe-16b").make_smoke())
        ranks = ctx.spawn_ranks(
            TD.dist_rank, 4, (str(tmp), inputs, params, MOE_CFG, cfg),
            timeout_s=300)
        spec_job.result()
    with open(specs) as f:
        spec_out = json.load(f)
    return {"inp": inp, "ref": dict(np.load(ref_out)), "ranks": ranks,
            "specs": spec_out}


@pytest.mark.parametrize("B", sorted(TD.DECODE_FILL))
def test_sharded_decode_matches_reference(runs, B):
    ref, ranks = runs["ref"], runs["ranks"]
    for r in ranks:        # every rank ends with the whole output
        np.testing.assert_allclose(r[f"dec{B}_y"], ref[f"dec{B}_y"],
                                   rtol=TOL, atol=TOL)
        assert tuple(r[f"dec{B}_len"]) == (TD.DECODE_FILL[B] + TD.STEPS,) * 2
    for kk in ("k", "v"):       # the caches put back together from blocks
        whole = np.full_like(ref[f"dec{B}_{kk}"], np.nan)
        for r in ranks:
            b0, s0 = r[f"dec{B}_at"]
            blk = r[f"dec{B}_{kk}block"]
            whole[b0:b0 + blk.shape[0], s0:s0 + blk.shape[1]] = blk
        np.testing.assert_allclose(whole, ref[f"dec{B}_{kk}"], rtol=TOL,
                                   atol=TOL)
    # the layout: B = 16 splits the batch over data and the sequence over
    # model; B = 4 the sequence over all four ranks
    at = sorted(tuple(int(i) for i in r[f"dec{B}_at"]) for r in ranks)
    want = ([(0, 0), (0, 8), (8, 0), (8, 8)] if B == 16 else
            [(0, 0), (0, 4), (0, 8), (0, 12)])
    assert at == want


@pytest.mark.parametrize("case", sorted(TD.MOE_CASES))
def test_a2a_moe_matches_reference(runs, case):
    ref, ranks = runs["ref"], runs["ranks"]
    for r in ranks:
        np.testing.assert_allclose(r[f"moe_{case}_y"], ref[f"moe_{case}_y"],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(r[f"moe_{case}_aux"],
                                   ref[f"moe_{case}_aux"], rtol=1e-6)
    if case == "pre":
        # slots dropped at this capacity, and the drops matter
        kept = sum(int(r["moe_pre_kept"][0]) for r in ranks)
        routed = sum(int(r["moe_pre_kept"][1]) for r in ranks)
        assert routed == 4 * 16 * MOE_CFG["top_k"] and kept < routed
        assert np.abs(ranks[0]["moe_roomy_y"] - ref["moe_pre_y"]).max() \
            > 1e-2


def test_lm_on_mesh_matches_reference(runs):
    ref, ranks = runs["ref"], runs["ranks"][:2]
    for r in ranks:
        np.testing.assert_allclose(r["lm_prefill"], ref["lm_prefill"],
                                   rtol=LM_TOL, atol=LM_TOL)
        np.testing.assert_allclose(r["lm_decode"], ref["lm_decode"],
                                   rtol=LM_TOL, atol=LM_TOL)


def _nested(flat: dict) -> dict:
    """{"a/b": [shape, spec]} -> nested dicts of shape tuples."""
    out = {}
    for path, (shape, _) in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = tuple(shape)
    return out


def _flat(tree: dict, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = v
    return out


def _spec(entries) -> tuple:
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


ARCHS = ("deepseek-moe-16b", "deit-b", "dit-l2", "dynamic-ofa-supernet",
         "efficientnet-b7", "granite-20b", "kimi-k2-1t-a32b", "qwen1.5-110b",
         "resnet-152", "unet-sdxl", "vit-l16")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(runs, arch):
    fam = "lm" if get_arch(arch).family == "lm" else "vision"
    for which in ("smoke", "full"):
        ref = runs["specs"][f"{arch}:{which}"]
        got = _flat(TS.param_specs(_nested(ref), fam))
        assert set(got) == set(ref)
        bad = {p: (got[p], ref[p][1]) for p in ref
               if got[p] != _spec(ref[p][1])}
        assert not bad, f"{arch} {which}: {bad}"


def test_registry_archs_all_checked(runs):
    assert {k.split(":")[0] for k in runs["specs"] if ":" in k} \
        == set(ARCHS)


def test_opt_specs_like_matches_reference(runs):
    arch = get_arch("deepseek-moe-16b")
    pref = runs["specs"]["deepseek-moe-16b:full"]
    pshapes = _nested(pref)
    # adafactor's states: {param path: {state: shape}}
    states, want = {}, {}
    for path, (shape, spec) in runs["specs"]["opt"].items():
        param, state = path.rsplit("/", 1)
        node = states
        for k in param.split("/"):
            node = node.setdefault(k, {})
        node[state] = tuple(shape)
        want[path] = _spec(spec)
    got = TS.opt_specs_like(TS.param_specs(pshapes, "lm"), {"s": states},
                            pshapes)["s"]
    assert arch.family == "lm"
    assert _flat(got) == want
    # the factored moments drop a trailing dim of a split leaf's spec
    assert any(p.endswith("/vr") for p in want)


def test_meshes_and_ambient_context(runs):
    r = runs["ranks"][0]
    assert tuple(r["host_mesh"]) == (4, 1)
    assert tuple(r["host_axes"]) == ("data", "model")
    # the production meshes build only over 256 or 512 ranks
    assert "needs 256 ranks" in str(r["production_False"])
    assert "needs 512 ranks" in str(r["production_True"])

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
    assert ctx.current_mesh() is None and ctx.batch_axes() == ()
    with ctx.use_mesh(Mesh()) as m:
        assert ctx.current_mesh() is m
        assert ctx.batch_axes() == ("pod", "data")
    assert ctx.current_mesh() is None
    x = torch.ones(3)
    assert ctx.wsc(x, ("pod", "data"), None) is x
    assert ctx.choose_backend(2, "cpu") == "gloo"


def test_serving_spec_splits_only_routed_experts():
    assert TS.serving_spec("moe_layers/moe/wi", (27, 64, 2048, 1408)) == \
        (None, "model", None, None)
    assert TS.layer_serving_spec("moe_layers/3/moe/wo", (64, 1408, 2048)) \
        == ("model", None, None)
    for path, shape in (("moe_layers/moe/shared/wi/kernel", (27, 64, 8)),
                        ("moe_layers/moe/router/kernel", (27, 64, 8)),
                        ("dense_layers/attn/q/kernel", (1, 64, 64)),
                        ("embed/embedding", (512, 64))):
        assert TS.serving_spec(path, shape) == (None,) * len(shape)


def _decode_case(seed: int, fill: int):
    g = torch.Generator().manual_seed(seed)
    B, T, Hq, K, D = 2, 40, 8, 2, 16
    q = torch.randn(B, 1, Hq, D, generator=g)
    k = torch.randn(B, T, K, D, generator=g)
    v = torch.randn(B, T, K, D, generator=g)
    return q, k, v, torch.tensor(fill, dtype=torch.int32)


def _ref_lse(q, k, n):
    """jax.nn.logsumexp of the reference's decode scores over the first
    n keys (``core/layers.py:_attn_core``'s scaled scores)."""
    B, _, Hq, D = q.shape
    K = k.shape[2]
    qj = jnp.asarray(q.numpy()).reshape(B, 1, K, Hq // K, D)
    s = jnp.einsum("bskrd,btkd->bkrst", qj, jnp.asarray(k.numpy())) \
        / np.sqrt(D)
    s = jnp.where(jnp.arange(k.shape[1]) < n, s, -jnp.inf)
    return np.asarray(jax.nn.logsumexp(s, axis=-1)).reshape(B, Hq, 1)


@pytest.mark.parametrize("fill", [0, 1, 17, 40])
def test_plain_decode_lse_matches_reference(fill):
    q, k, v, n = _decode_case(fill, fill)
    o, lse = fa.flash_attention_plain(q, k, v, causal=False, kv_len=n,
                                      return_lse=True)
    np.testing.assert_allclose(lse.numpy(), _ref_lse(q, k, fill), rtol=TOL,
                               atol=TOL)
    if fill == 0:            # no valid key: o 0 and lse -inf, no NaN
        assert torch.all(o == 0) and torch.all(torch.isneginf(lse))
    else:
        want = fa.flash_attention_plain(q[:, :, :, :], k[:, :fill],
                                        v[:, :fill], causal=False)
        torch.testing.assert_close(o, want, rtol=TOL, atol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("fill", [0, 1, 264, 528])
def test_cuda_decode_lse_matches_plain(fill):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode)")
    g = torch.Generator().manual_seed(fill)
    B, T, Hq, K, D = 4, 528, 16, 16, 128
    q, k, v = (torch.randn(s, generator=g).cuda().bfloat16()
               for s in ((B, 1, Hq, D), (B, T, K, D), (B, T, K, D)))
    n = torch.tensor(fill, dtype=torch.int32, device="cuda")
    o, lse = fa.flash_attention(q, k, v, causal=False, kv_len=n,
                                return_lse=True)
    po, plse = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                        causal=False, kv_len=n,
                                        return_lse=True)
    torch.cuda.synchronize()
    assert not torch.isnan(o).any() and not torch.isnan(lse).any()
    torch.testing.assert_close(o.float(), po, rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(lse, plse, rtol=1e-3, atol=1e-3)


def test_dispatch_tally_counts_kept_slots():
    cfg = TM.MoEConfig(n_experts=4, top_k=2, d_ff=8, capacity_factor=0.25,
                       group_size=16)
    p = TM.moe_init(torch.Generator().manual_seed(0), 8, cfg, device="cpu")
    x = torch.randn(1, 16, 8, generator=torch.Generator().manual_seed(1))
    with TM.dispatch_tally() as t:
        TM.moe_apply(p, x, cfg)
    kept, routed = t.counts()
    assert routed == 32 and kept == 4 * 4      # C = 4 a (group, expert)
    assert TM._TALLY.get() is None


def test_spawn_ranks_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        ctx.spawn_ranks(TD.fails_on_rank_one, 2, (), timeout_s=120)


def test_mesh_launcher_on_cpu(tmp_path, capsys):
    from repro_torch.launch import elastic_moe
    out = elastic_moe.main_mesh(elastic_moe.parse_args(
        ["--smoke", "--device", "cpu", "--mesh", "1x2", "--iters", "1",
         "--decode-steps", "2"]), ["--smoke", "--device", "cpu", "--mesh",
                                   "1x2", "--iters", "1",
                                   "--decode-steps", "2"])
    assert len(out) == 2 and all(r["finite"] for r in out)
    pts = out[0]["points"]
    assert [p["name"] for p in pts] == [p["name"] for p in out[1]["points"]]
    assert all(0 < p["prefill_kept"] <= 1 for p in pts)
    assert pts[0]["decode_kept"] is not None
    assert "mesh 1 x 2" in capsys.readouterr().out
    assert os.environ.get("MASTER_PORT") is None   # file rendezvous only
