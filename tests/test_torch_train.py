"""The PyTorch port's training path against the JAX reference.

Masked-mode models, the sandwich step, the optimizers, the data stream,
checkpoints, the restart supervisor and the training launcher, at smoke
sizes on the CPU (fp32; inputs from numpy seeds; parameters from the
reference's init, converted).  Tolerances: 1e-5 on losses, 1e-4 relative
(to the leaf's largest value) on gradients and updated parameters (with
the floors stated where a true value is 0), 1e-4 on masked logits (a few
fp32 layers summed in another order).
"""
import dataclasses
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import deit_b as j_deit  # noqa: E402
from repro.configs import dynamic_ofa_supernet as j_ofa  # noqa: E402
from repro.core import elastic as JE  # noqa: E402
from repro.core import supernet as JS  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.models import vit as JV  # noqa: E402
from repro.optim import api as JO  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import vit_params  # noqa: E402
from repro_torch.core import elastic as TE  # noqa: E402
from repro_torch.core import supernet as TS  # noqa: E402
from repro_torch.core.distill import ce_loss, kd_loss  # noqa: E402
from repro_torch.data import pipeline as TD  # noqa: E402
from repro_torch.distributed import fault  # noqa: E402
from repro_torch.models import vit as TV  # noqa: E402
from repro_torch.optim import api as TO  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = j_ofa.make_smoke()
TSMOKE = get_arch("dynamic-ofa-supernet").make_smoke()
DIMS = {"d_model": SMOKE.d_model, "d_ff": SMOKE.d_ff,
        "n_heads": SMOKE.n_heads, "n_layers": SMOKE.n_layers}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaf_close(t: torch.Tensor, j, tol=1e-4, name="", atol=0.0):
    j = np.asarray(j, np.float32)
    t = t.detach().float().numpy()
    scale = max(float(np.abs(j).max()), 1e-6)
    err = float(np.abs(t - j).max()) if j.size else 0.0
    assert err <= tol * scale + atol, f"{name}: {err} > {tol} x {scale}"


def _flat_j(tree):
    """Reference leaves keyed by the port's paths (layer index inserted)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        leaf = np.asarray(leaf)
        if keys[0] == "layers":
            for i in range(leaf.shape[0]):
                out["/".join([keys[0], str(i)] + keys[1:])] = leaf[i]
        else:
            out["/".join(keys)] = leaf
    return out


def _flat_t(tree):
    return dict(TO.named_leaves(tree))


# --- sampling -----------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7])
def test_elastic_space_sample_and_sandwich_match_reference(seed):
    space = SMOKE.elastic
    tspace = TSMOKE.elastic
    js = JE.sandwich_specs(space, np.random.default_rng(seed), n_random=4)
    ts = TE.sandwich_specs(tspace, np.random.default_rng(seed), n_random=4)
    assert [dataclasses.asdict(s) for s in js] == \
        [dataclasses.asdict(s) for s in ts]
    big = j_ofa.make_config().elastic
    tbig = get_arch("dynamic-ofa-supernet").make_config().elastic
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(20):
        assert dataclasses.asdict(big.sample(rj)) == \
            dataclasses.asdict(tbig.sample(rt))


def test_masked_widths_are_cpu_int32_and_helpers():
    spec = TSMOKE.elastic.min_spec()
    E = TE.spec_to_dynamic(spec, DIMS)
    for v in E.values():
        assert v.device.type == "cpu" and v.dtype == torch.int32 \
            and v.ndim == 0
    assert TE.resolve(None, 8) == 8 and TE.resolve(3, 8) == 3
    assert TE.count_or_none(None, 8) is None
    assert TE.count_or_none(8, 8) is None and TE.count_or_none(3, 8) == 3
    t = torch.tensor(5, dtype=torch.int32)
    assert TE.count_or_none(t, 8) is t


# --- masked vit_apply ---------------------------------------------------------

SPECS = SMOKE.elastic.enumerate()[::5]


@pytest.fixture(scope="module")
def smoke_vit():
    jp = JV.vit_init(jax.random.PRNGKey(0), SMOKE)
    x = np.random.default_rng(0).normal(
        size=(2, SMOKE.img_res, SMOKE.img_res, 3)).astype(np.float32)
    return jp, vit_params(_np_tree(jp)), x


@pytest.mark.parametrize("spec", SPECS, ids=[s.name() for s in SPECS])
def test_masked_vit_matches_jax_masked(smoke_vit, spec):
    jp, tp, x = smoke_vit
    Ej = JE.spec_to_dynamic(spec, DIMS)
    Et = TE.spec_to_dynamic(spec, DIMS)
    yj, aj = JV.vit_apply(jp, x, SMOKE, E=Ej, return_exits=True)
    yt, at = TV.vit_apply(tp, torch.from_numpy(x), TSMOKE, E=Et,
                          return_exits=True)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-4,
                               atol=1e-4)
    for a, b in zip(at["exit_logits"], aj["exit_logits"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("arch_id,jcfg", [
    ("dynamic-ofa-supernet", SMOKE), ("deit-b", j_deit.make_smoke())])
def test_masked_vit_equals_sliced_in_the_port(arch_id, jcfg):
    """Mirrors tests/test_models.py:77: sliced == masked, in the port."""
    cfg = get_arch(arch_id).make_smoke()
    jp = JV.vit_init(jax.random.PRNGKey(3), jcfg)
    tp = vit_params(_np_tree(jp))
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, cfg.img_res, cfg.img_res, 3)).astype(np.float32))
    E_s = {"a_model": cfg.d_model // 2, "a_ff": cfg.d_ff // 2,
           "a_heads": cfg.n_heads // 2, "a_layers": cfg.n_layers // 2}
    E_m = {k: torch.tensor(v, dtype=torch.int32) for k, v in E_s.items()}
    a, _ = TV.vit_apply(tp, x, cfg, E=E_s)
    b, _ = TV.vit_apply(tp, x, cfg, E=E_m)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-5, atol=5e-5)


def test_masked_vit_gradients_match_jax(smoke_vit):
    """Gradients of a masked subnet's loss (depth gate included) against
    jax.grad: every leaf, the gated layers' zeros included."""
    jp, _, x = smoke_vit
    spec = SMOKE.elastic.min_spec()
    labels = np.array([1, 3], np.int32)
    from repro.core.distill import ce_loss as j_ce

    def loss_j(p):
        y, _ = JV.vit_apply(p, x, SMOKE, E=JE.spec_to_dynamic(spec, DIMS))
        return j_ce(y, labels)
    gj = _flat_j(jax.grad(loss_j)(jp))
    tp = vit_params(_np_tree(jp))
    for _, p in TO.named_leaves(tp):
        p.requires_grad_(True)
    y, _ = TV.vit_apply(tp, torch.from_numpy(x), TSMOKE,
                        E=TE.spec_to_dynamic(spec, DIMS))
    ce_loss(y, torch.from_numpy(labels)).backward()
    for path, p in TO.named_leaves(tp):
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        # atol: fp32 round-off of sums whose true value is 0 (the key
        # bias: softmax ignores a shift shared by a row's scores)
        _leaf_close(g, gj[path], name=path, atol=1e-7)


# --- losses -------------------------------------------------------------------

def test_losses_match_reference():
    from repro.core import distill as JDs
    rng = np.random.default_rng(0)
    s = rng.normal(size=(4, 10)).astype(np.float32)
    t = rng.normal(size=(4, 10)).astype(np.float32)
    lab = rng.integers(0, 10, 4).astype(np.int32)
    mask = np.array([1, 0, 1, 1], np.float32)
    for temp in (1.0, 2.0):
        np.testing.assert_allclose(
            float(kd_loss(torch.from_numpy(s), torch.from_numpy(t), temp)),
            float(JDs.kd_loss(s, t, temp)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        float(ce_loss(torch.from_numpy(s), torch.from_numpy(lab))),
        float(JDs.ce_loss(s, lab)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        float(ce_loss(torch.from_numpy(s), torch.from_numpy(lab),
                      torch.from_numpy(mask))),
        float(JDs.ce_loss(s, lab, mask)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kd_weight,temp", [(1.0, 1.0), (0.5, 2.0)])
def test_sandwich_loss_matches_reference(kd_weight, temp):
    """distill.sandwich_loss (teacher CE + students' KD, and their CE below
    kd_weight 1): loss, metrics and gradient against the reference's, on
    logits handed out per spec by a table."""
    from repro.core import distill as JDs
    from repro_torch.core.distill import sandwich_loss
    rng = np.random.default_rng(5)
    table = rng.normal(size=(3, 4, 10)).astype(np.float32)
    batch = {"labels": rng.integers(0, 10, 4).astype(np.int32)}
    kw = {"kd_weight": kd_weight, "temperature": temp}
    j_loss, j_m = JDs.sandwich_loss(lambda p, b, s: p[s], table, batch,
                                    [0, 1, 2], **kw)
    j_g = jax.grad(lambda p: JDs.sandwich_loss(
        lambda q, b, s: q[s], p, batch, [0, 1, 2], **kw)[0])(table)
    tt = torch.from_numpy(table).requires_grad_(True)
    t_loss, t_m = sandwich_loss(
        lambda p, b, s: p[s], tt,
        {"labels": torch.from_numpy(batch["labels"])}, [0, 1, 2], **kw)
    t_loss.backward()
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-5,
                               atol=1e-6)
    assert set(t_m) == set(j_m)
    for k in j_m:
        np.testing.assert_allclose(t_m[k].item(), float(j_m[k]), rtol=1e-5,
                                   atol=1e-6)
    _leaf_close(tt.grad, j_g, tol=1e-5, name="d logits")


# --- the sandwich step --------------------------------------------------------

def _batch(batch=4, step=0):
    return next(JD.synthetic_image_batches(
        global_batch=batch, img_res=SMOKE.img_res,
        n_classes=SMOKE.n_classes, start_step=step))


@pytest.fixture(scope="module")
def sandwich_pair():
    """One sandwich step of the smoke supernet in both packages from the
    same params, batch and sampled specs."""
    jp = JV.vit_init(jax.random.PRNGKey(0), SMOKE)
    batch = _batch()
    j_init, j_update = JO.make_optimizer("adamw")
    j_step, j_sample = JS.make_sandwich_step(
        lambda p, b, E: JV.vit_apply(p, b["images"], SMOKE, E=E)[0],
        j_update, DIMS)
    Ej = j_sample(SMOKE.elastic, np.random.default_rng(3))
    jp2, _, jm = jax.jit(j_step)(jp, j_init(jp),
                                 {k: jnp.asarray(v) for k, v in batch.items()},
                                 Ej, jnp.asarray(0))

    tp = vit_params(_np_tree(jp))
    for _, p in TO.named_leaves(tp):
        p.requires_grad_(True)
    t_init, t_update = TO.make_optimizer("adamw")
    t_step, t_sample = TS.make_sandwich_step(
        lambda p, b, E: TV.vit_apply(p, b["images"], TSMOKE, E=E)[0],
        t_update, DIMS)
    Et = t_sample(TSMOKE.elastic, np.random.default_rng(3))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tp2, _, tm = t_step(tp, t_init(tp), tb, Et, 0)
    return (jp2, jm, Ej), (tp2, tm, Et)


def test_sandwich_step_matches_reference(sandwich_pair):
    (jp2, jm, Ej), (tp2, tm, Et) = sandwich_pair
    for k in Ej:
        assert Et[k].tolist() == np.asarray(Ej[k]).tolist(), k
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tm["gnorm"]), float(jm["gnorm"]),
                               rtol=1e-4)
    fj, ft = _flat_j(jp2), _flat_t(tp2)
    assert set(fj) == set(ft)
    lr = 1e-4       # AdamW's default: its first step moves p by lr * u,
    # u = g / (|g| + eps) in [-1, 1]; where |g| nears eps, u feels the
    # gradients' round-off, so each value is also allowed 1e-3 of lr.  The
    # key bias's true gradient is 0 (softmax ignores a shift shared by a
    # row's scores): its u is round-off in either package, held to lr.
    for path, t in ft.items():
        _leaf_close(t, fj[path], name=path,
                    atol=lr if path.endswith("attn/k/bias") else 1e-3 * lr)


def test_sandwich_sample_stacks_specs_on_cpu():
    _, sample = TS.make_sandwich_step(None, None, DIMS, n_random=3)
    E = sample(TSMOKE.elastic, np.random.default_rng(0))
    assert set(E) == {"a_model", "a_ff", "a_heads", "a_layers"}
    for v in E.values():
        assert v.shape == (4,) and v.dtype == torch.int32
        assert v.device.type == "cpu"
    mn = TE.spec_to_dynamic(TSMOKE.elastic.min_spec(), DIMS)
    assert all(int(E[k][0]) == int(mn[k]) for k in E)


# --- optimizers ---------------------------------------------------------------

def _opt_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"dense": {"kernel": rng.normal(size=(160, 130)),
                      "bias": rng.normal(size=(130,))},
            "layers": [{"ln1": {"scale": rng.normal(size=(8,))},
                        "w": rng.normal(size=(4, 6))} for _ in range(2)],
            "pos": rng.normal(size=(5, 4))}


def _j_tree(t):
    """The reference's layout: the layer list stacked on a leading axis."""
    t = dict(t)
    t["layers"] = jax.tree_util.tree_map(lambda *a: np.stack(a),
                                         *t["layers"])
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), t)


def _t_tree(t):
    return jax.tree_util.tree_map(
        lambda a: torch.tensor(np.asarray(a, np.float32)), t)


@pytest.mark.parametrize("name,hp", [("adamw", {}), ("adamw", {"lr": 1e-2}),
                                     ("adafactor", {}), ("sgdm", {})])
def test_optimizer_updates_match_reference(name, hp):
    p0, g0 = _opt_tree(0), _opt_tree(1)
    j_init, j_update = JO.make_optimizer(name, **hp)
    t_init, t_update = TO.make_optimizer(name, **hp)
    jp, jg = _j_tree(p0), _j_tree(g0)
    tp, tg = _t_tree(p0), _t_tree(g0)
    js, ts = j_init(jp), t_init(tp)
    for step in range(3):
        jp, js = j_update(jp, jg, js, jnp.asarray(step))
        tp, ts = t_update(tp, tg, ts, step)
    fj, ft = _flat_j(jp), _flat_t(tp)
    assert set(fj) == set(ft)
    for path in ft:
        _leaf_close(ft[path], fj[path], name=path)


def test_weight_decay_mask_picks_the_reference_leaves():
    jp = JV.vit_init(jax.random.PRNGKey(0), SMOKE)
    j_paths = {JO._path_str(path): JO._wd_ok(JO._path_str(path))
               for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]}
    t_paths = {path: TO._wd_ok(path)
               for path, _ in TO.named_leaves(vit_params(_np_tree(jp)))}
    for path, ok in t_paths.items():
        parts = path.split("/")
        ref = "/".join(parts[:1] + parts[2:]) if parts[0] == "layers" \
            else path
        assert j_paths[ref] == ok, path
    assert sum(t_paths.values()) > 0 and not all(t_paths.values())


def test_missing_gradients_count_as_zeros():
    p = {"w": torch.ones(3), "bias": torch.ones(2)}
    init, upd = TO.make_optimizer("adamw", weight_decay=0.5)
    st = init(p)
    upd(p, {"w": None, "bias": None}, st, 0)
    assert torch.allclose(p["w"], torch.full((3,), 1 - 1e-4 * 0.5))
    assert torch.equal(p["bias"], torch.ones(2))  # no decay on biases
    g, gn = TO.clip_by_global_norm({"a": torch.full((4,), 3.0), "b": None},
                                   1.0)
    assert float(gn) == pytest.approx(6.0)
    assert g["b"] is None and float(g["a"].norm()) == pytest.approx(1.0)


# --- data ---------------------------------------------------------------------

@pytest.mark.parametrize("start", [0, 5])
def test_batches_byte_identical_to_reference(start):
    for jgen, tgen in (
            (JD.synthetic_image_batches(global_batch=6, img_res=16,
                                        n_classes=10, seed=2,
                                        start_step=start),
             TD.synthetic_image_batches(global_batch=6, img_res=16,
                                        n_classes=10, seed=2,
                                        start_step=start)),
            (JD.synthetic_lm_batches(global_batch=3, seq_len=20, vocab=97,
                                     seed=2, start_step=start),
             TD.synthetic_lm_batches(global_batch=3, seq_len=20, vocab=97,
                                     seed=2, start_step=start))):
        for _ in range(2):
            a, b = next(jgen), next(tgen)
            assert set(a) == set(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and \
                    a[k].tobytes() == b[k].tobytes(), k
    assert TD.host_shard(8) == slice(0, 8)


def test_prefetcher_order_errors_and_close():
    pf = TD.Prefetcher(iter(range(5)), depth=2)
    assert list(next(pf) for _ in range(5)) == list(range(5))

    def bad():
        yield 1
        raise ValueError("boom")
    pf = TD.Prefetcher(bad())
    assert next(pf) == 1
    with pytest.raises(ValueError):
        next(pf)
    pf = TD.Prefetcher(iter(range(100)), depth=1)
    pf.close()
    pf._t.join(timeout=5)
    assert not pf._t.is_alive()


def test_to_device_on_cpu_keeps_values():
    b = {"images": np.ones((2, 4, 4, 3), np.float32),
         "labels": np.arange(2, dtype=np.int32)}
    t = TD.to_device(b, torch.device("cpu"))
    assert t["labels"].dtype == torch.int32 and t["images"].sum() == 96


# --- checkpoints and restarts ---------------------------------------------------

def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 16, generator=g),
                       "layers": [{"b": torch.ones(4)},
                                  {"b": torch.zeros(4)}]},
            "opt": {"mu": torch.full((8, 16), 0.5)}, "x": seed}


def test_checkpoint_roundtrip(tmp_path):
    st = _state()
    save_checkpoint(tmp_path, 7, st)
    step, restored = restore_checkpoint(tmp_path)
    assert step == 7 and restored["x"] == 0
    assert torch.equal(restored["params"]["w"], st["params"]["w"])
    assert torch.equal(restored["params"]["layers"][1]["b"], torch.zeros(4))
    assert torch.equal(restored["opt"]["mu"], st["opt"]["mu"])


def test_checkpoint_keep_k_rotation_async_and_tmp_ignored(tmp_path):
    m = CheckpointManager(tmp_path, save_every=1, keep=2, async_save=True)
    for step in range(5):
        m.maybe_save(step, _state(step))
    m.wait()
    assert m.latest_step() == 4
    assert sorted(int(p.name.split("_")[1])
                  for p in m.dir.glob("step_*")) == [3, 4]
    (tmp_path / ".tmp_step_00000009").mkdir()   # a dead partial save
    step, st = m.restore_latest()
    assert step == 4 and st["x"] == 4
    gate = CheckpointManager(tmp_path / "g", save_every=10, async_save=False)
    assert not gate.maybe_save(3, _state()) and gate.maybe_save(10, _state())


def test_run_with_restarts_resumes(tmp_path):
    m = CheckpointManager(tmp_path, save_every=2, async_save=False)
    calls = {"n": 0}

    def train(start_step, state):
        calls["n"] += 1
        x = state["x"] if state else 0
        for step in range(start_step, 10):
            x = x + 1
            m.maybe_save(step, {"x": x})
            if calls["n"] == 1 and step == 5:
                raise fault.SimulatedFailure("boom")
        return {"x": x}

    final, restarts = fault.run_with_restarts(train, manager=m,
                                              logger=lambda *_: 0)
    assert restarts == 1 and final["x"] == 10


def test_kernel_runtime_error_is_not_swallowed(tmp_path):
    """A kernel wrapper's RuntimeError (a failed launch) propagates: the
    reference would retry it, hiding the fault behind a restart."""
    m = CheckpointManager(tmp_path, save_every=1, async_save=False)
    calls = {"n": 0}

    def train(start_step, state):
        calls["n"] += 1
        raise RuntimeError("elastic_matmul (tma) launch failed "
                           "(CUDA error 700)")
    with pytest.raises(RuntimeError, match="launch failed"):
        fault.run_with_restarts(train, manager=m, logger=lambda *_: 0)
    assert calls["n"] == 1

    def disk(start_step, state):
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("disk gone")
        return "ok"
    assert fault.run_with_restarts(disk, manager=m,
                                   logger=lambda *_: 0) == ("ok", 1)


def test_straggler_and_watchdog():
    import time
    mon = fault.StragglerMonitor(window=20, threshold=2.0)
    for i in range(15):
        assert not mon.record(i, 0.1)
    assert mon.record(15, 0.5) and mon.flags[0]["step"] == 15
    events = []
    w = fault.Watchdog(timeout_s=0.2, on_stall=lambda: events.append(1))
    w.start()
    time.sleep(0.5)
    assert w.stalled and events
    w.stop()


# --- the launcher ---------------------------------------------------------------

def test_train_cli_sandwich_with_failure_recovery(tmp_path):
    """Mirrors tests/test_system.py:8: smoke sandwich training on the CPU,
    an injected failure at step 9 and one restart from step 8's
    checkpoint."""
    from repro_torch.launch import train as T
    out = T.main(["--arch", "dynamic-ofa-supernet", "--smoke", "--sandwich",
                  "--steps", "12", "--save-every", "4", "--fail-at", "9",
                  "--ckpt-dir", str(tmp_path), "--log-every", "100",
                  "--device", "cpu"])
    assert out["restarts"] == 1 and len(out["losses"]) == 12
    assert all(np.isfinite(out["losses"]))
    for _, p in TO.named_leaves(out["params"]):
        assert torch.isfinite(p).all()


def test_train_cli_plain_vis_train(tmp_path):
    from repro_torch.launch import train as T
    out = T.main(["--arch", "deit-b", "--smoke", "--steps", "3",
                  "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert out["restarts"] == 0 and len(out["losses"]) == 3


def test_train_cli_refuses_what_is_not_ported(tmp_path):
    from repro_torch.launch import train as T
    base = ["--smoke", "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    # deepseek-moe-16b trains since LM training came (test_torch_lm_train),
    # and under a mesh, as the vision family does (test_torch_vision_mesh)
    for argv in (["--arch", "dit-l2", "--mesh", "pod"],
                 ["--arch", "dit-l2", "--coordinator", "h:1"]):
        with pytest.raises(NotImplementedError):
            T.main(argv + base)


@pytest.mark.cuda
@pytest.mark.parametrize("arch_id", ["dit-l2", "unet-sdxl"])
def test_cuda_train_cli_diffusion_smoke_through_k1_and_k2(tmp_path,
                                                          arch_id):
    """The diffusion nets' smoke configs train on the card in fp32: K1
    forward, dgrad and wgrad, K2's forward and its fp32 backward at the
    smoke head dims (DiT 8, UNet 16: fma_f32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    from repro_torch.kernels import ops
    from repro_torch.launch import train as T
    ops.reset_launch_counts()
    out = T.main(["--arch", arch_id, "--smoke", "--steps", "3",
                  "--ckpt-dir", str(tmp_path), "--device", "cuda"])
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    n, v = ops.launch_counts(), ops.variant_counts()
    for k in ("elastic_matmul", "elastic_matmul_dgrad",
              "elastic_matmul_wgrad", "flash_attention",
              "flash_attention_bwd"):
        assert n[k] > 0, n
    assert v["flash_attention_bwd"]["fma_f32"] == n["flash_attention_bwd"]


@pytest.mark.cuda
def test_cuda_train_cli_resnet_smoke_through_k1(tmp_path):
    """resnet-152's smoke config trains on the card: its 1x1 convs and
    classifier on K1 (fp32: f32_splitk / tile_f32 at M = 128, small_m at
    the classifier's M = 2) with K1's fp32 dgrad and wgrad."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    from repro_torch.kernels import ops
    from repro_torch.launch import train as T
    ops.reset_launch_counts()
    out = T.main(["--arch", "resnet-152", "--smoke", "--steps", "3",
                  "--ckpt-dir", str(tmp_path), "--device", "cuda"])
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    n, v = ops.launch_counts(), ops.variant_counts()
    for k in ("elastic_matmul", "elastic_matmul_dgrad",
              "elastic_matmul_wgrad"):
        assert n[k] > 0, n
    assert v["elastic_matmul"]["small_m"] > 0
    assert v["elastic_matmul"]["f32_splitk"] + \
        v["elastic_matmul"]["tile_f32"] > 0
    for k in ("elastic_matmul_dgrad", "elastic_matmul_wgrad"):
        assert v[k]["fma_f32"] == n[k] > 0, v


def test_train_cli_without_a_card_raises(tmp_path):
    """Without --device cpu the launcher wants the card (none here)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "dynamic-ofa-supernet", "--sandwich", "--smoke", "--steps", "1",
         "--ckpt-dir", str(tmp_path)], capture_output=True, text=True,
        timeout=120, env=env, cwd=REPO)
    assert res.returncode != 0 and "no CUDA device" in res.stderr


def test_sandwich_training_improves_all_subnets():
    """Mirrors tests/test_system.py:21 in the port: after 150 sandwich
    steps every sub-network beats chance and the full net is at least as
    good as the smallest."""
    from repro_torch.core.types import ElasticSpace
    cfg = TV.ViTConfig(name="t", img_res=16, patch=4, n_layers=3, d_model=32,
                       n_heads=4, d_ff=64, n_classes=4,
                       compute_dtype="float32",
                       elastic=ElasticSpace(width_mults=(0.5, 1.0),
                                            ffn_mults=(0.5, 1.0),
                                            depth_mults=(2 / 3, 1.0)))
    params = TV.vit_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    for _, p in TO.named_leaves(params):
        p.requires_grad_(True)
    init_fn, update_fn = TO.make_optimizer("adamw", lr=3e-3, weight_decay=0.0)
    opt = init_fn(params)
    dims = {"d_model": 32, "d_ff": 64, "n_heads": 4, "n_layers": 3}

    def apply_fn(p, b, E):
        return TV.vit_apply(p, b["images"], cfg, E=E)[0]
    step_fn, sample_fn = TS.make_sandwich_step(apply_fn, update_fn, dims,
                                               n_random=1)
    rng = np.random.default_rng(0)
    data = TD.synthetic_image_batches(global_batch=32, img_res=16,
                                      n_classes=4)
    for step in range(150):
        batch = TD.to_device(next(data), torch.device("cpu"))
        params, opt, metrics = step_fn(params, opt, batch,
                                       sample_fn(cfg.elastic, rng), step)
    assert float(metrics["loss"]) < 2.0

    test_batch = TD.to_device(next(data), torch.device("cpu"))
    accs = {}
    with torch.no_grad():
        for spec in cfg.elastic.enumerate():
            y = apply_fn(params, test_batch, TE.spec_to_static(spec, dims))
            accs[spec.name()] = float(
                (y.argmax(-1) == test_batch["labels"]).float().mean())
    full = accs[cfg.elastic.max_spec().name()]
    smallest = accs[cfg.elastic.min_spec().name()]
    assert full > 0.5, accs
    assert smallest > 0.3, accs
    assert full >= smallest - 0.05, accs
