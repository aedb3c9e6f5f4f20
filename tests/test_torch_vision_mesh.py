"""The port's vision family trained under a (data, model) mesh against the
JAX reference.

The port runs in one group of four gloo ranks (2 x 2) on the CPU for the
module (``tests/_torch_vision_mesh.py``): the vision placement
(``sharding.vision_train_spec_fn``, the reference's ``vision_rules``;
with and without ``param_specs``' 16-way filter for the conv nets), each
rank's rows of every microbatch, BN's statistics summed over ``data``.
The reference runs here: its ``build_cell(arch, "cls_224", smoke=True,
cfg_overrides=...)`` step on one process (GSPMD computes the same
function on any mesh), jitted once per (arch, accum), from the same
numpy parameters and batch, its clipped gradients kept (``_ref_fn``),
beside the forward's BN statistics.  The conv smokes are
widened past ``vision_rules``' thresholds (``_torch_vision_mesh.
OVERRIDES``) so that every kind of split leaf occurs: attention and MLP
columns and rows, a conv's output channels (1x1 and 3x3), depthwise,
squeeze-excite, the head conv and the row-split classifier.

Tolerances: the ViT in fp32, its loss and gradient norm 1e-5 relative,
each clipped gradient block 1e-5 of its leaf's largest entry, each
updated block as ``tests/test_torch_mesh_train.py`` holds AdamW's first
step; the conv nets in float64 (the ReLU-kink trap, ROADMAP §3), the
loss, gradient norm and gradients 2e-6 (the cross entropy's fp32
round-off: both sides cast the logits to fp32), BN's statistics 1e-8 of
the largest entry (of a mean: or of its channel's spread), each updated
block within the gradient's tolerance and one fp32 rounding (SGD with
momentum updates in fp32 on both sides).  A leaf whose gradient vanishes
in exact arithmetic is held against 1e-2 of the tree's largest entry
(``VANISHING``).  A step whose BN takes each rank's own statistics fails
these checks.
"""
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import _torch_vision_mesh as TVM  # noqa: E402
from repro.configs.registry import get_arch as j_get_arch  # noqa: E402
from repro.configs.registry import load_all  # noqa: E402
from repro.core.distill import ce_loss as j_ce_loss  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import efficientnet as JEff  # noqa: E402
from repro.models import resnet as JRes  # noqa: E402
from repro.models import vit as JV  # noqa: E402
from repro.optim import clip_by_global_norm as j_clip  # noqa: E402
from repro.optim import make_optimizer as j_make_optimizer  # noqa: E402
from repro_torch.checkpoint.manager import restore_checkpoint  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.registry import vision_family  # noqa: E402
from repro_torch.distributed import ctx  # noqa: E402
from repro_torch.distributed import sharding as TS  # noqa: E402
from repro_torch.launch import train as TT  # noqa: E402
from repro_torch.models import efficientnet as TEff  # noqa: E402
from repro_torch.models import resnet as TRes  # noqa: E402
from repro_torch.models import vit as TVit  # noqa: E402
from repro_torch.optim import api as TO  # noqa: E402

load_all()
KEY = jax.random.PRNGKey(0)
SIZES = {"data": 2, "model": 2}
# the ViT's fp32 step; the conv nets' float64 step, whose loss and
# gradients carry the fp32 round-off of the cross entropy (the reference's
# ce_loss casts the logits to fp32, and the port's loss does as it does:
# 2^-24 a softmax entry, the two libraries' fp32 exp an ulp apart), and
# their BN statistics, float64 from end to end
VIT_TOL, CONV_TOL, STATS_TOL = 1e-5, 2e-6, 1e-8
# a leaf whose gradient vanishes in exact arithmetic (the keys' bias, which
# a softmax does not see; a BN's bias that the next conv's BN removes) is
# round-off: held against this share of the tree's largest entry instead
VANISHING = 1e-2
LR = {"adamw": 1e-4, "sgdm": 0.1}
VISION = ("dynamic-ofa-supernet", "deit-b", "vit-l16", "resnet-152",
          "efficientnet-b7")


def _coords(rank: int) -> dict:
    return {"data": rank // 2, "model": rank % 2}


def _flat(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)] = np.asarray(leaf)
    return out


def _port_flat(ref_flat: dict) -> dict:
    """The reference's flat leaves at the port's paths (the ViT's stacked
    ``layers`` leaves one per layer)."""
    out = {}
    for path, v in ref_flat.items():
        head, _, rest = path.partition("/")
        if head == "layers":
            for i in range(v.shape[0]):
                out[f"layers/{i}/{rest}"] = v[i]
        else:
            out[path] = v
    return out


def _j_cfg(arch_id: str):
    cfg = dataclasses.replace(j_get_arch(arch_id).make_smoke(),
                              **TVM.OVERRIDES[arch_id])
    return dataclasses.replace(cfg, **TVM.F64) if arch_id in TVM.CONV \
        else cfg


@functools.lru_cache(maxsize=None)
def _ref_init(arch_id: str) -> dict:
    """Seed-0 parameters of the (widened) smoke config as numpy leaves in
    the reference's layout (the ViT's layers stacked on a leading axis),
    drawn by the port's init (the reference's distributions; its jitted
    init would compile for seconds), float64 for the conv nets."""
    init = {"vit": TVit.vit_init, "resnet": TRes.resnet_init,
            "effnet": TEff.effnet_init}[vision_family(arch_id)]
    p = init(torch.Generator().manual_seed(0), TVM.port_cfg(arch_id),
             device="cpu")
    p = jax.tree_util.tree_map(lambda t: t.numpy(), p)
    if "layers" in p:
        p["layers"] = jax.tree_util.tree_map(lambda *ls: np.stack(ls),
                                             *p["layers"])
    return p


def _cell(arch_id: str, accum: int):
    over = dict(TVM.OVERRIDES[arch_id])
    if arch_id in TVM.CONV:
        over.update(TVM.F64)
    return JS.build_cell(j_get_arch(arch_id), "cls_224", smoke=True,
                         accum=accum, cfg_overrides=over,
                         smoke_batch=TVM.MB * accum)


def _ref_fn(arch_id: str, accum: int):
    """The reference's ``_vis_cell`` train step at ``build_cell``'s config
    and optimizer, its body written out from the reference's own
    functions (``_accum_grads``, ``clip_by_global_norm``, the update; the
    forward as ``_vis_cell`` defines it) so that the clipped gradients
    come out beside the new parameters (it gives ``cell.fn``'s parameters
    to an fp32 ulp and its loss and norm bit for bit), and, for a conv
    net, the BN statistics of its forward on the first microbatch."""
    cell = _cell(arch_id, accum)
    cfg = cell.cfg
    update_fn = j_make_optimizer(j_get_arch(arch_id).optimizer)[1]
    if arch_id == "dynamic-ofa-supernet":
        def fwd(p, x):
            return JV.vit_apply(p, x, cfg)[0], None
    else:
        apply = JRes.resnet_apply if arch_id == "resnet-152" \
            else JEff.effnet_apply

        def fwd(p, x):
            y, st = apply(p, x, cfg, train=True, collect_stats=True)
            return y, [ms for _, ms in st]

    def loss_fn(p, mb):
        return j_ce_loss(fwd(p, mb["images"])[0], mb["labels"])

    def run(params, opt, batch, step):
        loss, grads = JS._accum_grads(loss_fn, params, batch, accum)
        grads, gn = j_clip(grads, 1.0)
        new, _ = update_fn(params, grads, opt, step)
        stats = fwd(params, batch["images"][:TVM.MB])[1]
        return new, {"loss": loss, "gnorm": gn}, grads, stats
    return run


def _inputs(path: str) -> dict:
    rng = np.random.default_rng(5)
    inp = {}
    for arch_id in TVM.OVERRIDES:
        cfg = _j_cfg(arch_id)
        B = TVM.MB * max(TVM.ACCUMS)
        inp[f"{arch_id}/images"] = rng.normal(
            size=(B, cfg.img_res, cfg.img_res, 3)).astype(np.float32)
        inp[f"{arch_id}/labels"] = rng.integers(
            0, cfg.n_classes, B).astype(np.int32)
    np.savez(path, **inp)
    return inp


def _run_reference(inp: dict) -> dict:
    """Every (arch, accum) reference step, traced here and compiled on
    threads at once (XLA's compiler releases the GIL); the conv nets'
    under ``jax.enable_x64``."""
    keys, calls = [], []
    for x64 in (False, True):
        with jax.enable_x64(x64):
            for arch_id in TVM.OVERRIDES:
                if (arch_id in TVM.CONV) != x64:
                    continue
                p = _ref_init(arch_id)
                opt = j_make_optimizer(j_get_arch(arch_id).optimizer)[0](p)
                for accum in TVM.ACCUMS:
                    B = TVM.MB * accum
                    batch = {k: jnp.asarray(inp[f"{arch_id}/{k}"][:B])
                             for k in ("images", "labels")}
                    args = (p, opt, batch, jnp.asarray(0, jnp.int32))
                    keys.append((arch_id, accum))
                    calls.append((jax.jit(_ref_fn(arch_id, accum)).lower(
                        *args), args))
    with ThreadPoolExecutor(len(calls)) as pool:
        compiled = list(pool.map(lambda c: c[0].compile(), calls))
    out = {}
    for key, c, (_, args) in zip(keys, compiled, calls):
        with jax.enable_x64(key[0] in TVM.CONV):
            new, metrics, grads, stats = c(*args)
        out[key] = {"new": _port_flat(_flat(new)),
                    "grads": _port_flat(_flat(grads)),
                    "loss": float(metrics["loss"]),
                    "gnorm": float(metrics["gnorm"]),
                    "stats": None if stats is None else
                    [(np.asarray(m), np.asarray(v)) for m, v in stats]}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's four ranks on a thread, the reference's steps here."""
    tmp = tmp_path_factory.mktemp("vision_mesh")
    inputs, params = str(tmp / "inputs.npz"), str(tmp / "ref_params.npz")
    flat = {}
    for arch_id in TVM.OVERRIDES:
        flat.update({f"{arch_id}/{k}": v
                     for k, v in _flat(_ref_init(arch_id)).items()})
    np.savez(params, **flat)
    inp = _inputs(inputs)
    ckpt = str(tmp / "ckpt")
    with ThreadPoolExecutor(1) as pool:
        job = pool.submit(ctx.spawn_ranks, TVM.vision_rank, 4,
                          (str(tmp), inputs, params, ckpt), timeout_s=600)
        ref = _run_reference(inp)
        ranks = job.result()
    return {"ref": ref, "ranks": ranks, "ckpt": ckpt}


def _spec_fn(arch_id: str, filtered: bool = True):
    return TS.vision_train_spec_fn(arch_id, TVM.port_cfg(arch_id),
                                   filtered=filtered)


def _check_step(ranks, key, ref, arch_id, filtered=True) -> set:
    """Each rank's loss, gradient norm, clipped gradient blocks, updated
    blocks and BN statistics against the reference's (module note);
    returns the leaves the placement split."""
    conv = arch_id in TVM.CONV
    tol = CONV_TOL if conv else VIT_TOL
    spec_fn = _spec_fn(arch_id, filtered)
    old = _port_flat(_flat(_ref_init(arch_id)))
    lr = LR[get_arch(arch_id).optimizer]
    floor = VANISHING * max(float(np.abs(g).max())
                            for g in ref["grads"].values())
    split = set()
    for rank, r in enumerate(ranks):
        got = r[key]
        assert abs(got["loss"] - ref["loss"]) <= tol * abs(ref["loss"]), \
            (rank, got["loss"], ref["loss"])
        assert abs(got["gnorm"] - ref["gnorm"]) <= tol * ref["gnorm"], \
            (rank, got["gnorm"], ref["gnorm"])
        assert set(got["grads"]) == set(ref["grads"])
        for path, g in got["grads"].items():
            shape = ref["grads"][path].shape
            spec = spec_fn(path, shape)
            if any(spec):
                split.add(path)
            idx = TS.block_index(shape, spec, SIZES, _coords(rank))
            want = ref["grads"][path][idx]
            top = max(float(np.abs(ref["grads"][path]).max()), floor)
            err = float(np.abs(g - want).max())
            assert err <= tol * top, (rank, path, err, top)
            w, p0 = ref["new"][path][idx], old[path][idx]
            err = np.abs(got["params"][path] - w)
            if conv:     # SGD with momentum: p - lr m rounded to fp32
                allow = lr * tol * top + 2.0 ** -23 * (
                    np.abs(w).max() + lr * (np.abs(want)
                                            + 1e-4 * np.abs(p0)).max())
                assert np.all(err <= allow), (rank, path, float(err.max()))
            else:        # AdamW's first step: saturated elements tightly
                u = (p0 - w) / lr - (0.1 * p0 if TO._wd_ok(path) else 0.0)
                sat = np.abs(u) >= 0.99
                assert np.all(err <= np.where(sat, 1e-3 * lr, lr)), \
                    (rank, path, float(err.max()))
        if conv and "stats" in got:
            assert len(got["stats"]) == len(ref["stats"])
            for (name, m, v), (jm, jv) in zip(got["stats"], ref["stats"]):
                # a mean against the spread of its channel's values
                std = float(np.sqrt(np.abs(jv).max()))
                assert float(np.abs(m - jm).max()) <= STATS_TOL * max(
                    float(np.abs(jm).max()), std), (rank, name, "mean")
                assert float(np.abs(v - jv).max()) <= STATS_TOL * float(
                    np.abs(jv).max()), (rank, name, "var")
    return split


@pytest.mark.parametrize("accum", TVM.ACCUMS)
@pytest.mark.parametrize("arch_id,filtered", TVM.CASES)
def test_vision_mesh_step_matches_reference(runs, arch_id, filtered, accum):
    """The 2 x 2 mesh step against the reference's ``_vis_cell`` step:
    loss, gradient norm, every rank's gradient and updated blocks, and
    (the conv nets) the batch statistics of every BN, which are the whole
    microbatch's."""
    split = _check_step(runs["ranks"], (arch_id, filtered, accum),
                        runs["ref"][(arch_id, accum)], arch_id, filtered)
    if arch_id == "dynamic-ofa-supernet":
        for leaf in ("attn/q/kernel", "attn/q/bias", "attn/o/kernel",
                     "mlp/wi/kernel", "mlp/wo/kernel"):
            assert f"layers/0/{leaf}" in split, leaf
        assert "patch_embed/kernel" not in split    # embed/: lm_rules
    elif arch_id == "resnet-152":
        assert {"stage0/0/conv3/kernel", "stage0/0/proj/kernel",
                "stage1/0/conv3/kernel", "fc/kernel"} <= split
        # stage 1's 264 mid channels: split only without the 16-way filter
        assert ("stage1/0/conv2/kernel" in split) == (not filtered)
    else:
        assert {"stage4/0/expand/kernel", "stage4/0/dw/kernel",
                "stage4/0/se_expand/kernel", "stage6/0/project/kernel",
                "head/kernel", "fc/kernel"} <= split


def test_conv_blocks_checkpoint_restores_whole(runs):
    """Four ranks save ResNet's updated blocks and SGD momentum (3x3,
    1x1 and classifier splits) under ``rank<k>/``; restored onto one
    process each leaf is whole and each rank's block ``==`` what it
    saved."""
    arch_id, filtered, _ = TVM.CKPT_CASE
    step, whole = restore_checkpoint(runs["ckpt"])
    assert step == 1
    whole = dict(TO.named_leaves(whole))
    spec_fn = _spec_fn(arch_id, filtered)
    split = 0
    for rank, r in enumerate(runs["ranks"]):
        saved = r[TVM.CKPT_CASE]["ckpt"]
        assert set(saved) == set(whole)
        for path, blk in saved.items():
            leaf = path.split("/", 1)[1]
            if path.startswith("opt/"):
                leaf = leaf[len("s/"):].rsplit("/", 1)[0]
            spec = spec_fn(leaf, whole[path].shape)
            split += any(spec)
            idx = TS.block_index(whole[path].shape, spec, SIZES,
                                 _coords(rank))
            assert np.array_equal(whole[path][idx].numpy(), blk), path
    assert split


def test_per_rank_batch_statistics_fail_the_check(runs):
    """BN over each rank's own rows (the statistics not summed over
    ``data``) is a silent divergence: the step's check fails on it."""
    ref = runs["ref"][("resnet-152", 1)]
    with pytest.raises(AssertionError):
        _check_step(runs["ranks"], "local_stats", ref, "resnet-152")
    err = max(abs(r["local_stats"]["loss"] - ref["loss"])
              for r in runs["ranks"]) / abs(ref["loss"])
    assert err > 1e3 * CONV_TOL, err


def _ref_leaves(arch_id: str, make: str) -> tuple:
    """({port path: (reference path, reference shape, stacked)}, the
    reference's abstract parameter tree) of an arch's config."""
    init = {"vit": JV.vit_init, "resnet": JRes.resnet_init,
            "effnet": JEff.effnet_init}[vision_family(arch_id)]
    shapes = jax.eval_shape(functools.partial(
        init, KEY, getattr(j_get_arch(arch_id), make)()))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        p = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)
        head, _, rest = p.partition("/")
        if head == "layers":
            for i in range(leaf.shape[0]):
                out[f"layers/{i}/{rest}"] = (p, leaf.shape, True)
        else:
            out[p] = (p, leaf.shape, False)
    return out, shapes


@pytest.mark.parametrize("arch_id", VISION)
def test_vision_spec_fn_matches_param_specs(arch_id):
    """``vision_train_spec_fn`` leaf by leaf against the reference's
    ``param_specs(..., "vision", fsdp_axes=())`` of the full config (a
    stacked ViT leaf without its leading L entry), and unfiltered against
    ``vision_rules`` at the smoke config.  The ViT's patch embed is
    replicated (``embed/`` takes ``lm_rules`` first)."""
    for make, filtered in (("make_config", True), ("make_smoke", False)):
        leaves, shapes = _ref_leaves(arch_id, make)
        if filtered:
            want = _flat_specs(JSH.param_specs(shapes, "vision",
                                               fsdp_axes=()))
        else:
            want = {rp: _rule(rp, s) for rp, s, _ in leaves.values()}
        cfg = getattr(get_arch(arch_id), make)()
        fn = TS.vision_train_spec_fn(arch_id, cfg, filtered=filtered)
        for port_path, (rp, shape, stacked) in leaves.items():
            spec = tuple(want[rp])
            got = fn(port_path, shape[1:] if stacked else shape)
            assert got == (spec[1:] if stacked else spec), \
                (port_path, got, spec)
        if vision_family(arch_id) == "vit":
            assert fn("patch_embed/kernel", leaves["patch_embed/kernel"][
                1]) == (None,) * 4


def _rule(path, shape):
    spec = tuple(JSH.vision_rules(path, tuple(shape), None))
    return spec if len(spec) == len(shape) else (None,) * len(shape)


def _flat_specs(specs) -> dict:
    out = {}
    for path, sp in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))[0]:
        out["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)] = sp
    return out


def test_tensor_parallel_attention_wants_whole_heads():
    """The dynamic-ofa-supernet's 6 heads over the production mesh's 16
    model ranks: 24-column blocks, not whole heads, raise (ROADMAP §3)."""
    cfg = get_arch("dynamic-ofa-supernet").make_config()
    fn = TS.vision_train_spec_fn("dynamic-ofa-supernet", cfg)
    assert fn("layers/0/attn/q/kernel", (384, 384)) == (None, "model")
    from repro_torch.core import layers as TL

    class Mesh16:
        mesh_dim_names = ("data", "model")

        def size(self, d=None):
            return 16
    p = {k: {"kernel": torch.zeros(384, 24), "bias": torch.zeros(24)}
         for k in ("q", "k", "v")}
    p["o"] = {"kernel": torch.zeros(24, 384), "bias": torch.zeros(384)}
    with pytest.raises(NotImplementedError, match="whole heads"):
        TL.attention_apply(p, torch.zeros(1, 197, 384), n_heads=6, n_kv=6,
                           d_head=64, causal=False, tp=Mesh16())


# --- the launcher ------------------------------------------------------------

def test_vision_mesh_launcher_restarts_to_the_same_loss(tmp_path):
    """``launch.train --arch resnet-152 --smoke --mesh 2x2 --device cpu``:
    a failure at step 2 and a restart from step 1's checkpoint blocks
    reach step 2's loss of a run without the failure, on every rank."""
    base = ["--arch", "resnet-152", "--smoke", "--device", "cpu", "--mesh",
            "2x2", "--steps", "3", "--log-every", "100"]
    failed = TT.main(base + ["--fail-at", "2", "--save-every", "1",
                             "--ckpt-dir", str(tmp_path / "a")])
    clean = TT.main(base + ["--save-every", "0", "--ckpt-dir",
                            str(tmp_path / "b")])
    assert [r["restarts"] for r in failed] == [1] * 4
    assert [r["restarts"] for r in clean] == [0] * 4
    for r, c in zip(failed, clean):
        assert r["losses"][-1] == c["losses"][2], (r["losses"], c["losses"])
        assert np.isfinite(r["losses"]).all()


def test_vision_mesh_launcher_refusals(tmp_path):
    """Under a mesh the diffusion family (ROADMAP item 11 (d)) and
    ``--sandwich`` raise before any rank starts; a batch the batch shards
    do not divide raises."""
    with pytest.raises(NotImplementedError, match=r"11 \(d\)"):
        TT.main(["--arch", "dit-l2", "--smoke", "--mesh", "2x2",
                 "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="sandwich"):
        TT.main(["--arch", "dynamic-ofa-supernet", "--sandwich", "--smoke",
                 "--mesh", "2x2", "--device", "cpu"])
    TT.check_batch_split("resnet-152", 8, 2, 2)
    with pytest.raises(ValueError, match="image height"):
        TT.check_batch_split("resnet-152", 6, 2, 2)


def test_shared_card_cut_keeps_the_vision_nets_whole():
    """The vision archs at cls_224 on ranks sharing a card: the global
    batch cut from 256 to 8 as 2 microbatches, no depth cut."""
    args = TT.parse_args(["--arch", "resnet-152", "--mesh", "2x2"])
    for arch_id in VISION:
        assert TT.step_cuts((arch_id, "cls_224"), 256, args, True) == \
            ({}, 8, 2)
