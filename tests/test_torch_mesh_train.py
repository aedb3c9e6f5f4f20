"""The port's LM training under a (data, model) mesh against the JAX
reference.

The reference runs once in a subprocess with 8 fake CPU devices: its
``build_cell(deepseek-moe-16b, "train_4k", smoke=True, mesh=(2, 2))``
step with the ``a2a`` dispatch at accum 1 and 2 (batch 4), jitted;
``jax.grad`` of its a2a MoE layer under the mesh; ``compressed_psum``
under ``shard_map``.  The port runs in one group of four gloo ranks on
the CPU for the module (``tests/_torch_mesh.py``), on the reference's
parameters and the same inputs drawn from a numpy seed.  Both sides are
fp32.

Tolerances: the step's loss 1e-5 and gradient norm 1e-4 relative, each
updated parameter block as ``tests/test_torch_lm_train.py``'s one-card
step allows (1e-3 of the learning rate where the reference's AdamW step
is saturated, |u| >= 0.99, else the learning rate); gradients, the
cross entropy and Adafactor's update 1e-5; compression ``==``.
"""
import dataclasses
import os
import textwrap
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import _torch_mesh as TMS  # noqa: E402
from conftest import run_subprocess  # noqa: E402
from repro.configs.registry import get_arch as j_get_arch  # noqa: E402
from repro.configs.registry import load_all  # noqa: E402
from repro.core.distill import ce_loss as j_ce_loss  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import make_optimizer as j_make_optimizer  # noqa: E402
from repro.optim import compress as JC  # noqa: E402
from repro_torch.checkpoint.manager import restore_checkpoint  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_params  # noqa: E402
from repro_torch.distributed import ctx  # noqa: E402
from repro_torch.distributed import sharding as TS  # noqa: E402
from repro_torch.launch import train as TT  # noqa: E402
from repro_torch.launch import steps as TST  # noqa: E402
from repro_torch.optim import api as TO  # noqa: E402
from repro_torch.optim import compress as TC  # noqa: E402

load_all()   # every arch, whatever config module another test imported
ARCH = "deepseek-moe-16b"
LR = 1e-4            # AdamW's default learning rate
TOL = 1e-5
MOE_CFG = dict(n_experts=8, top_k=2, d_ff=16, n_shared=1,
               capacity_factor=0.5, group_size=16, dispatch="a2a")
D_MOE = 32
SIZES = {"data": 2, "model": 2}


def _coords(rank: int) -> dict:
    return {"data": rank // 2, "model": rank % 2}


def _cfg(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch="a2a"))


REF = """
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.configs.registry import get_arch
from repro.distributed.ctx import shard_map
from repro.launch import steps as JS
from repro.launch.mesh import make_mesh
from repro.models import moe as JM
from repro.optim import make_optimizer
from repro.optim.compress import compressed_psum

inp = dict(np.load({inputs!r}))
flat = dict(np.load({params!r}))
out = {{}}

def tree(prefix):
    t = {{}}
    for path, v in flat.items():
        if not path.startswith(prefix + "/"):
            continue
        node = t
        *head, last = path[len(prefix) + 1:].split("/")
        for k in head:
            node = node.setdefault(k, {{}})
        node[last] = jnp.asarray(v)
    return t

def put(prefix, t):
    for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[prefix + "/" + key] = np.asarray(leaf)

mesh = make_mesh((2, 2), ("data", "model"))
arch = get_arch("deepseek-moe-16b")
cfg = arch.make_smoke()
over = {{"moe": dataclasses.replace(cfg.moe, dispatch="a2a")}}
jp = tree("lm")
opt = make_optimizer("adamw")[0](jp)
batch = {{"tokens": jnp.asarray(inp["tokens"]),
         "labels": jnp.asarray(inp["labels"])}}
with mesh:
    for accum in (1, 2):
        cell = JS.build_cell(arch, "train_4k", smoke=True, mesh=mesh,
                             cfg_overrides=over, accum=accum,
                             smoke_batch={batch_n})
        new, _, m = cell.jit(mesh)(jp, opt, batch,
                                   jnp.asarray(0, jnp.int32))
        put(f"new{{accum}}", new)
        out[f"loss{{accum}}"] = np.asarray(m["loss"])
        out[f"gnorm{{accum}}"] = np.asarray(m["gnorm"])

    cfgm = JM.MoEConfig(**{moe_cfg!r})
    pm = tree("moe")
    w = jnp.asarray(inp["moe_w"])

    def loss(p, x):
        y, aux = JM.moe_apply(p, x, cfgm, mesh=mesh, data_axes=("data",))
        return jnp.sum(y * w) + {aux_c} * aux, y
    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(pm, jnp.asarray(inp["moe_x"]))
    out["p4_y"] = np.asarray(y)
    put("p4_grad", gp)
    out["p4_dx"] = np.asarray(gx)

    def body(g, e):
        m_, e_ = compressed_psum(g[0, 0], e[0, 0], "data")
        return m_[None, None], e_[None, None]
    spec = P("data", "model", None)
    cm, ce = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec, spec),
                               out_specs=(spec, spec), check_vma=False))(
        jnp.asarray(inp["cmp_g"]).reshape(2, 2, -1),
        jnp.asarray(inp["cmp_err"]).reshape(2, 2, -1))
    out["cmp_mean"] = np.asarray(cm).reshape(4, -1)
    out["cmp_err"] = np.asarray(ce).reshape(4, -1)
np.savez({out_path!r}, **out)
print("OK")
"""


def _flat_jax(prefix, t, out):
    for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[prefix + "/" + key] = np.asarray(leaf)


def _inputs(path: str, ref_lm: dict) -> dict:
    rng = np.random.default_rng(0)
    cfg = j_get_arch(ARCH).make_smoke()
    toks = rng.integers(0, cfg.vocab_size, (TMS.BATCH, 65)).astype(np.int32)
    inp = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    inp["moe_x"] = rng.standard_normal((4, 16, D_MOE)).astype(np.float32)
    inp["moe_w"] = rng.standard_normal((4, 16, D_MOE)).astype(np.float32)
    inp["ce_logits"] = (3 * rng.standard_normal((4, 8, 64))).astype(
        np.float32)
    inp["ce_labels"] = rng.integers(0, 64, (4, 8)).astype(np.int64)
    inp["clip_w"] = rng.standard_normal((8, 6)).astype(np.float32)
    inp["clip_r"] = rng.standard_normal(5).astype(np.float32)
    inp["ada_w"] = rng.standard_normal((256, 256)).astype(np.float32)
    inp["ada_b"] = rng.standard_normal(32).astype(np.float32)
    for step in range(2):
        inp[f"ada_g{step}_w"] = rng.standard_normal((256, 256)).astype(
            np.float32) * (step + 1)
        inp[f"ada_g{step}_b"] = rng.standard_normal(32).astype(np.float32)
    # the ranks' gradients at different scales (F8 shows), and errors
    inp["cmp_g"] = (rng.standard_normal((4, 96)) * np.array(
        [[1.0], [3.0], [0.5], [2.0]])).astype(np.float32)
    inp["cmp_err"] = (0.01 * rng.standard_normal((4, 96))).astype(np.float32)
    np.savez(path, **inp)
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides once for the module: the reference's parameters here,
    its mesh step, layer gradients and compression in a subprocess, the
    port's four ranks beside it."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    inputs, params = str(tmp / "inputs.npz"), str(tmp / "ref_params.npz")
    ref_out, ckpt = str(tmp / "ref_out.npz"), str(tmp / "ckpt")
    flat = {}
    _flat_jax("lm", jax.jit(lambda k: JT.lm_init(k, j_get_arch(
        ARCH).make_smoke()))(jax.random.PRNGKey(0)), flat)
    from repro.models import moe as JM
    _flat_jax("moe", JM.moe_init(jax.random.PRNGKey(1), D_MOE,
                                 JM.MoEConfig(**MOE_CFG)), flat)
    np.savez(params, **flat)
    inp = _inputs(inputs, flat)
    code = textwrap.dedent(REF).format(
        inputs=inputs, params=params, batch_n=TMS.BATCH, moe_cfg=MOE_CFG,
        aux_c=TMS.AUX_C, out_path=ref_out)
    cfg = _cfg(get_arch(ARCH).make_smoke())
    with ThreadPoolExecutor(1) as pool:
        job = pool.submit(run_subprocess, code, 8, 600)
        ranks = ctx.spawn_ranks(TMS.mesh_rank, 4, (
            str(tmp), inputs, params, cfg, MOE_CFG, ckpt), timeout_s=300)
        job.result()
    return {"inp": inp, "ref": dict(np.load(ref_out)), "ranks": ranks,
            "flat": flat, "ckpt": ckpt}


def _ref_tree(flat: dict, prefix: str) -> dict:
    out = {}
    for path, v in flat.items():
        if not path.startswith(prefix + "/"):
            continue
        node = out
        *head, last = path[len(prefix) + 1:].split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


# --- (1) the mesh train step against the reference's -------------------------

@pytest.mark.parametrize("placement", TMS.PLACEMENTS)
@pytest.mark.parametrize("accum", TMS.ACCUMS)
def test_mesh_train_step_matches_reference(runs, placement, accum):
    """Loss, gradient norm and every rank's updated blocks against the
    reference's ``build_cell(.., mesh=(2, 2))`` step, under the
    launcher's placement (``param_specs``: TP on attention, FFNs, the
    embedding and head; the 8 experts replicated, too few for 16-way
    splits; no FSDP below 4M elements) and under the unfiltered rules
    (every TP and FSDP split, the experts' too)."""
    ref, tag = runs["ref"], f"{placement}{accum}"
    jl, jg = float(ref[f"loss{accum}"]), float(ref[f"gnorm{accum}"])
    cfg = _cfg(get_arch(ARCH).make_smoke())
    spec_fn = TS.train_spec_fn(cfg, filtered=placement == "param_specs")
    want = dict(TO.named_leaves(lm_params(_ref_tree(runs["ref"],
                                                     f"new{accum}"))))
    old = dict(TO.named_leaves(lm_params(_ref_tree(runs["flat"], "lm"))))
    split = set()
    saturated = total = 0
    for rank, r in enumerate(runs["ranks"]):
        assert abs(r[f"{tag}_loss"] - jl) <= 1e-5 * abs(jl), \
            (rank, r[f"{tag}_loss"], jl)
        assert abs(r[f"{tag}_gnorm"] - jg) <= 1e-4 * abs(jg), \
            (rank, r[f"{tag}_gnorm"], jg)
        got = r[f"{tag}_params"]
        assert set(got) == set(want)
        for path, blk in got.items():
            spec = spec_fn(path, want[path].shape)
            idx = TS.block_index(want[path].shape, spec, SIZES,
                                 _coords(rank))
            if any(spec):
                split.add(path)
            p0, w = old[path].numpy()[idx], want[path].numpy()[idx]
            u = (p0 - w) / LR - (0.1 * p0 if TO._wd_ok(path) else 0.0)
            sat = np.abs(u) >= 0.99
            err = np.abs(blk - w)
            assert np.all(err <= np.where(sat, 1e-3 * LR, LR)), \
                (rank, path, float(err.max()))
            saturated, total = saturated + int(sat.sum()), total + sat.size
    assert saturated >= 0.8 * total, (saturated, total)
    if placement == "rules":           # every TP and FSDP split was made
        assert any(p.endswith("moe/wi") for p in split)
        assert "embed/embedding" in split and "lm_head/kernel" in split
    else:                              # the 16-way filter keeps TP only
        assert not any(p.endswith("moe/wi") for p in split)
        assert "dense_layers/0/attn/q/kernel" in split


# --- (2) P4: the a2a layer's gradients ---------------------------------------

def _assemble(ranks, key, specs_of, shapes):
    """The sum over ranks of every rank's gradient blocks, placed at
    their blocks: the gradient under the module's convention."""
    out = {p: np.zeros(s, np.float32) for p, s in shapes.items()}
    for rank, r in enumerate(ranks):
        for path, g in r[key].items():
            assert g is not None, (rank, path, "no gradient")
            idx = TS.block_index(shapes[path], specs_of(path), SIZES,
                                 _coords(rank))
            out[path][idx] += g
    return out


@pytest.mark.parametrize("form", ["serving", "training"])
def test_a2a_moe_gradients_match_reference(runs, form):
    """P4: a backward through ``moe_apply(..., mesh=)`` gives the routed
    experts, the router, the shared experts and x their gradients: the
    ranks' gradients, summed where ranks share a tensor, against
    ``jax.grad`` of the reference's a2a layer on the same mesh, at a
    capacity where slots drop.  (Before the collectives carried
    gradients the experts got none and x only its shared part.)"""
    ref, ranks = runs["ref"], runs["ranks"]
    moe = _ref_tree(runs["flat"], "moe")
    shapes = {p: v.shape for p, v in TO.named_leaves(moe)}
    if form == "serving":
        def spec_of(p):
            return TS.serving_spec(f"x/moe/{p}", shapes[p])
        x_spec = (None, None, None)
    else:
        def spec_of(p):
            return TMS._spec_at(TMS.MOE_SPECS, p)
        x_spec = (("data",), None, None)
    got = _assemble(ranks, f"p4_{form}_grads", spec_of, shapes)
    for path, g in got.items():
        want = ref[f"p4_grad/{path}"]
        assert np.abs(want).max() > 0, path
        np.testing.assert_allclose(g, want, rtol=TOL, atol=TOL,
                                   err_msg=path)
    dx = np.zeros(runs["inp"]["moe_x"].shape, np.float32)
    for rank, r in enumerate(ranks):
        idx = TS.block_index(dx.shape, x_spec, SIZES, _coords(rank))
        dx[idx] += r[f"p4_{form}_dx"]
        np.testing.assert_allclose(r[f"p4_{form}_y"], ref["p4_y"][idx],
                                   rtol=TOL, atol=TOL)
    np.testing.assert_allclose(dx, ref["p4_dx"], rtol=TOL, atol=TOL)


# --- (3) - (5) the loss and the optimizer on blocks ----------------------------

def test_vocab_parallel_nll_matches_the_whole_cross_entropy(runs):
    """Each rank's vocabulary block gives the whole log-softmax's
    per-token loss, and its share's gradient is its block of the whole
    cross entropy's gradient (``jax.grad`` of the reference's
    ``ce_loss``)."""
    inp = runs["inp"]
    z, lab = jnp.asarray(inp["ce_logits"]), jnp.asarray(inp["ce_labels"])
    logp = jax.nn.log_softmax(z, -1)
    want = -np.asarray(jnp.take_along_axis(logp, lab[..., None], -1)[..., 0])
    grad = np.asarray(jax.grad(lambda t: j_ce_loss(t, lab) * lab.size)(z))
    V = z.shape[-1]
    for rank, r in enumerate(runs["ranks"]):
        m = _coords(rank)["model"]
        np.testing.assert_allclose(r["ce_nll"], want, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(
            r["ce_grad"], grad[..., m * V // 2:(m + 1) * V // 2],
            rtol=TOL, atol=TOL)


def test_clip_counts_a_replicated_leaf_once(runs):
    inp = runs["inp"]
    want = float(np.sqrt(np.sum(np.square(inp["clip_w"]))
                         + np.sum(np.square(inp["clip_r"]))))
    for rank, r in enumerate(runs["ranks"]):
        assert abs(r["clip_gn"] - want) <= 1e-6 * want, (rank, r["clip_gn"])
        idx = TS.block_index((8, 6), (("data",), "model"), SIZES,
                             _coords(rank))
        np.testing.assert_allclose(r["clip_w"], inp["clip_w"][idx] / want,
                                   rtol=TOL, atol=TOL)


def test_adafactor_on_blocks_matches_reference(runs):
    """Two Adafactor steps on a (256, 256) leaf split over both axes (its
    factored row and column moments reduced over the axes that split
    them) and a small replicated one, against the reference's update on
    the whole leaves."""
    inp = runs["inp"]
    init, update = j_make_optimizer("adafactor")
    p = {k: jnp.asarray(inp[f"ada_{k}"]) for k in ("w", "b")}
    s = init(p)
    for step in range(2):
        g = {k: jnp.asarray(inp[f"ada_g{step}_{k}"]) for k in ("w", "b")}
        p, s = update(p, g, s, jnp.asarray(step))
    for rank, r in enumerate(runs["ranks"]):
        for k, sp in TMS.ADA_SPECS.items():
            idx = TS.block_index(p[k].shape, sp, SIZES, _coords(rank))
            np.testing.assert_allclose(r[f"ada_{k}"], np.asarray(p[k])[idx],
                                       rtol=TOL, atol=TOL)


# --- (6) compression --------------------------------------------------------

def test_quantize_matches_reference():
    rng = np.random.default_rng(3)
    for scale in (1e-3, 1.0, 50.0):
        g = (scale * rng.standard_normal((33, 7))).astype(np.float32)
        jq, js = JC.quantize_int8(jnp.asarray(g))
        q, s = TC.quantize_int8(torch.from_numpy(g))
        assert np.array_equal(q.numpy(), np.asarray(jq))
        assert s.numpy().tobytes() == np.asarray(js).tobytes()
        err = rng.standard_normal(g.shape).astype(np.float32) * 0.01
        jd, je = JC.compress_leaf(jnp.asarray(g), jnp.asarray(err))
        d, e = TC.compress_leaf(torch.from_numpy(g), torch.from_numpy(err))
        assert np.array_equal(d.numpy(), np.asarray(jd))
        assert np.array_equal(e.numpy(), np.asarray(je))
    g = {"a": [torch.ones(3), torch.full((2, 2), -4.0)]}
    out, errs = TC.tree_compress(g, TC.init_errors(g))
    assert torch.equal(out["a"][1], torch.full((2, 2), -4.0))
    assert all(float(e.abs().max()) == 0 for e in errs["a"])


def test_compressed_all_reduce_matches_compressed_psum(runs):
    """``compressed_all_reduce`` over each data group's two ranks gives
    the reference's ``compressed_psum`` under ``shard_map``: the mean bit
    for bit, the new error within a rounding of the gradient (jitted, XLA
    contracts ``g - q * scale`` into one fused multiply-add; eagerly the
    two are ``==``: :func:`test_quantize_matches_reference`); F8: ranks
    with g = 1 and g = 2 everywhere get 2.0, where the true mean is
    1.5."""
    ref, g = runs["ref"], runs["inp"]["cmp_g"]
    for rank, r in enumerate(runs["ranks"]):
        assert np.array_equal(r["cmp_mean"], ref["cmp_mean"][rank]), rank
        np.testing.assert_allclose(r["cmp_err"], ref["cmp_err"][rank],
                                   rtol=0, atol=2 ** -22 * np.abs(
                                       g[rank]).max())
        assert np.all(r["f8_mean"] == 2.0), r["f8_mean"]
    # the biased mean is not the true one where the scales differ
    true = runs["inp"]["cmp_g"][[0, 2]].mean(0)
    assert np.abs(runs["ranks"][0]["cmp_mean"] - true).max() > 0.05


# --- (7) checkpoints of blocks, restored elsewhere ------------------------------

def test_checkpoint_blocks_restore_onto_another_mesh_and_one_process(runs):
    """Four ranks of a (2, 2) mesh save their blocks under ``rank<k>/``;
    restored onto a (1, 2) mesh each of its ranks gets its blocks, and
    onto one process every leaf whole, all ``==`` the saved values."""
    ranks, ckpt = runs["ranks"], runs["ckpt"]
    step_dir = os.path.join(ckpt, "step_00000003")
    assert sorted(os.listdir(step_dir)) == [f"rank{k}" for k in range(4)]
    step, whole = restore_checkpoint(ckpt)
    assert step == 3
    whole = dict(TO.named_leaves(whole))
    cfg = _cfg(get_arch(ARCH).make_smoke())
    spec_fn = TS.train_spec_fn(cfg, filtered=False)

    def spec_of(path):
        if path.startswith("params/"):
            return spec_fn(path[len("params/"):], whole[path].shape)
        return spec_fn(path[len("opt/s/"):].rsplit("/", 1)[0],
                       whole[path].shape)
    for rank, r in enumerate(ranks):
        for path, blk in r["ckpt_saved"].items():
            idx = TS.block_index(whole[path].shape, spec_of(path), SIZES,
                                 _coords(rank))
            assert np.array_equal(whole[path][idx].numpy(), blk), path
    for rank, r in enumerate(ranks[:2]):
        assert r["ckpt_step"] == 3
        for path, blk in r["ckpt_restored"].items():
            idx = TS.block_index(whole[path].shape, spec_of(path),
                                 {"data": 1, "model": 2},
                                 {"data": 0, "model": rank})
            assert np.array_equal(whole[path][idx].numpy(), blk), path


# --- (8) the launcher ----------------------------------------------------------

def test_mesh_launcher_restarts_to_the_same_loss(tmp_path):
    """``launch.train --smoke --mesh 2x2 --device cpu``: a failure at step
    2 and a restart from step 1's checkpoint blocks reach step 2's loss
    of a run without the failure; that run's 5 saves rotate to the newest
    3 (the manager's ``keep``), each with every rank's blocks and nothing
    of the older ones left."""
    base = ["--arch", ARCH, "--smoke", "--device", "cpu", "--mesh", "2x2",
            "--save-every", "1"]
    failed = TT.main(base + ["--steps", "3", "--fail-at", "2", "--ckpt-dir",
                             str(tmp_path / "a")])
    clean = TT.main(base + ["--steps", "5", "--ckpt-dir",
                            str(tmp_path / "b")])
    assert [r["restarts"] for r in failed] == [1] * 4
    assert [r["restarts"] for r in clean] == [0] * 4
    assert failed[0]["losses"][-1] == clean[0]["losses"][2]
    assert len({r["losses"][-1] for r in failed}) == 1
    assert sorted(os.listdir(tmp_path / "a" / "step_00000002")) == \
        [f"rank{k}" for k in range(4)]
    steps = [f"step_{s:08d}" for s in (2, 3, 4)]
    assert sorted(os.listdir(tmp_path / "b")) == steps
    for d in steps:
        assert sorted(os.listdir(tmp_path / "b" / d)) == \
            [f"rank{k}" for k in range(4)]


def test_coordinator_ranks_on_cards_of_their_own_train_the_whole_model(
        monkeypatch):
    """A rank of a ``--coordinator`` job on a host of 8 cards takes a card
    of its own (one, or LOCAL_WORLD_SIZE's 8, ranks on the host): NCCL and
    the whole model at the reference's microbatches, whatever the job's
    world (256 for ``pod``).  Four ranks this host spawns on one card
    share it: gloo and the shared-card cut."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    key = (ARCH, "train_4k")
    args = TT.parse_args(["--arch", ARCH, "--mesh", "pod", "--coordinator",
                          "localhost:1", "--num-processes", "256",
                          "--process-id", "0"])
    assert TT.mesh_request(args) == ((16, 16), ("data", "model"))
    for env in (None, "8"):
        if env:
            monkeypatch.setenv("LOCAL_WORLD_SIZE", env)
        local = ctx.local_world_size(256, True)
        assert local == int(env or 1)
        assert ctx.choose_backend(local, "cuda") == "nccl"
        assert not ctx.shares_card(local, "cuda")
        assert TT.step_cuts(key, 256, args, ctx.shares_card(
            local, "cuda")) == ({}, 256, TST.ACCUM_DEFAULTS[key])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    local = ctx.local_world_size(4, False)
    assert ctx.choose_backend(local, "cuda") == "gloo"
    assert ctx.shares_card(local, "cuda")
    args = TT.parse_args(["--arch", ARCH, "--mesh", "2x2"])
    assert TT.step_cuts(key, 256, args, True) == ({"n_layers": 2}, 4, 2)
    assert TT.step_cuts(key, 256, args, None) == (
        TST.ONE_CARD_CUT[key], 256, TT.ONE_CARD_ACCUM[key])


def test_launcher_mesh_requests_raise_before_allocating():
    with pytest.raises(ValueError, match="coordinator"):
        TT.main(["--arch", ARCH, "--mesh", "pod", "--device", "cpu"])
    with pytest.raises(ValueError, match="do not make it"):
        TT.main(["--arch", ARCH, "--mesh", "2x2", "--coordinator",
                 "localhost:1", "--num-processes", "3", "--process-id", "0",
                 "--device", "cpu"])
    with pytest.raises(NotImplementedError, match=r"11 \(d\)"):
        TT.main(["--arch", "dit-l2", "--smoke", "--mesh", "2x2",
                 "--device", "cpu"])
