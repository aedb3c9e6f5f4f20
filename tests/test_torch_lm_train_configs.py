"""Training qwen1.5-110b, granite-20b and kimi-k2-1t-a32b in the port
against the JAX reference.

- P5: at accum > 1 a bf16 leaf's gradients sum in fp32 and divide there,
  as the reference's ``_accum_grads`` does (held to 1e-6 relative).
- kimi-k2's bf16 parameters under Adafactor: two steps against the
  reference's ``adafactor`` on a factored leaf and a 1-D one (at least
  99.9% of the elements bit-equal, the rest within one bf16 ulp).
- One train step of each config's smoke model at accum 1 and 2 against
  the reference's ``build_cell(.., "train_4k", smoke=True, accum=)``
  (one reference init and one jitted cell a config and accum, compiled in
  parallel), with ``tests/test_torch_lm_train.py``'s tolerances: the loss
  1e-5 and the gradient norm 1e-4 relative; AdamW's updated parameters
  1e-3 of the learning rate where the reference's |u| >= 0.99, else the
  learning rate; Adafactor's (kimi) 1e-5, as
  ``tests/test_torch_mesh_train.py`` holds its update, at 99.9% of the
  elements or more, the rest within twice the learning rate (a first
  step's update of a gradient at round-off is its sign).
- The same three steps on a (2, 2) gloo mesh at the unfiltered rules
  (GQA and MQA attention under TP: the k and v projections gathered over
  "model"; granite's one kv head split inside its columns) against the
  reference's ``build_cell(.., mesh=(2, 2))``, held as the one-process
  steps are.
- The launcher's one-card cuts at train_4k: full width, the parameter
  counts the launcher reckons with, the state and two fp32 logits
  microbatches under 80 GB; the plan it prints before any allocation.

All on the CPU in fp32 (the P5 and Adafactor cases in bf16): the kernels
run on the card only (``chip_smoke.py`` phase 30).
"""
import dataclasses
import textwrap
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _torch_mesh as TMS  # noqa: E402
from conftest import run_subprocess  # noqa: E402
from repro.configs.registry import get_arch as j_get_arch  # noqa: E402
from repro.configs.registry import load_all as j_load_all  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import make_optimizer as j_make_optimizer  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_params  # noqa: E402
from repro_torch.distributed import ctx  # noqa: E402
from repro_torch.distributed import sharding as TSH  # noqa: E402
from repro_torch.launch import flops as TF  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch import train as TT  # noqa: E402
from repro_torch.optim import api as TO  # noqa: E402

j_load_all()   # every arch, whatever config module another test imported
torch.set_num_threads(2)
ARCHS = ("qwen1.5-110b", "granite-20b", "kimi-k2-1t-a32b")
STEP_ACCUMS = (1, 2)
LR = {"adamw": 1e-4, "adafactor": 1e-3}    # the optimizers' defaults
SIZES = {"data": 2, "model": 2}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _run_jitted(calls):
    """Each ``(fn, args)`` jitted: traced here, compiled on threads at once
    (XLA's compiler releases the GIL), then run in order; the outputs as
    numpy trees."""
    lowered = [jax.jit(fn).lower(*args) for fn, args in calls]
    with ThreadPoolExecutor(4) as pool:
        compiled = list(pool.map(lambda lo: lo.compile(), lowered))
    return [_np_tree(c(*args)) for c, (_, args) in zip(compiled, calls)]


# --- P5: fp32 gradient sums for bf16 parameters ----------------------------------

def _p5_inputs(accum: int):
    """bf16 parameters (a (256, 384) kernel, a (32,) bias) and a batch of
    4 x accum rows whose chunk means are the loss's gradients: each
    chunk's gradient rounds to bf16, and their sum does not fit bf16."""
    rng = np.random.default_rng(30 + accum)
    p = {"w": rng.standard_normal((256, 384)).astype(np.float32),
         "b": rng.standard_normal(32).astype(np.float32)}
    # multiples of 2^-24 below 2^-14: every chunk's mean is exact in fp32
    # (no summation order of either package rounds it)
    x = {k: (rng.integers(-1024, 1024, (4 * accum,) + v.shape)
             * 2.0 ** -24).astype(np.float32) for k, v in p.items()}
    return p, x


@pytest.mark.parametrize("accum", [2, 4])
def test_bf16_gradients_sum_in_fp32_like_the_reference(accum):
    """P5: the train step's gradients of bf16 leaves at accum 2 and 4 are
    fp32, the sum of the chunks' bf16 gradients in fp32 divided by accum,
    within 1e-6 relative of the reference's ``_accum_grads``.  (The port
    summed them on each leaf's bf16 ``.grad`` before: off by up to a bf16
    rounding, ~4e-3 relative.)"""
    p, x = _p5_inputs(accum)

    def j_loss(params, mb):
        return sum(jnp.sum(params[k].astype(jnp.float32)
                           * jnp.mean(mb[k], 0)) for k in params)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    _, jg = jax.jit(lambda a, b: JS._accum_grads(j_loss, a, b, accum))(
        jp, {k: jnp.asarray(v) for k, v in x.items()})

    def t_loss(params, mb):
        return sum(torch.sum(params[k].float() * mb[k].mean(0))
                   for k in params)
    kept = []

    def keep(params, grads, opt, step):
        kept.append(grads)
        return params, opt
    tp = {k: torch.from_numpy(v).to(torch.bfloat16).requires_grad_(True)
          for k, v in p.items()}
    step = TS.clipped_step(t_loss, keep, accum)
    _, _, m = step(tp, None, {k: torch.from_numpy(v) for k, v in x.items()},
                   0)
    assert float(m["gnorm"]) < 1.0           # the clip leaves them as they are
    for k, g in kept[0].items():
        want = np.asarray(jg[k])
        assert want.dtype == np.float32 and g.dtype == torch.float32, k
        scale = float(np.abs(want).max())
        assert float(np.abs(g.numpy() - want).max()) <= 1e-6 * scale, k
        assert all(tp[k].grad is None for k in tp)


# --- kimi-k2's bf16 parameters under Adafactor ---------------------------------

def test_adafactor_on_bf16_leaves_matches_reference():
    """Two Adafactor steps on bf16 parameters (a factored 256 x 384 leaf,
    its row and column moments, and a 1-D leaf) from fp32 gradients (P5's
    sums), the update written back into bf16 as ``p.float() - lr u``:
    against the reference's update, at least 99.9% of the elements
    bit-equal and the rest within one bf16 ulp."""
    rng = np.random.default_rng(31)
    p0 = {"w": rng.standard_normal((256, 384)).astype(np.float32),
          "b": rng.standard_normal(32).astype(np.float32)}
    gs = [{k: (rng.standard_normal(v.shape) * (s + 1)).astype(np.float32)
           for k, v in p0.items()} for s in range(2)]
    init, update = j_make_optimizer("adafactor")
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p0.items()}
    js = init(jp)
    upd = jax.jit(update)
    for s, g in enumerate(gs):
        jp, js = upd(jp, {k: jnp.asarray(v) for k, v in g.items()}, js,
                     jnp.asarray(s))
    t_init, t_update = TO.make_optimizer("adafactor")
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p0.items()}
    ts = t_init(tp)
    assert set(ts["s"]["w"]) == {"vr", "vc"} and set(ts["s"]["b"]) == {"v"}
    for s, g in enumerate(gs):
        tp, ts = t_update(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                          ts, s)
    for k, t in tp.items():
        assert t.dtype == torch.bfloat16
        want = torch.from_numpy(np.asarray(jp[k].astype(jnp.float32)))
        got = t.float()
        equal = got == want
        assert float(equal.float().mean()) >= 0.999, k
        ulp = torch.ldexp(torch.ones_like(want),
                          torch.frexp(want).exponent - 8)   # 8 bits
        assert bool(torch.all(equal | (torch.abs(got - want) <= ulp))), k


# --- one train step of each smoke config -----------------------------------------

def _batch(vocab: int, B: int = 2, S: int = 64, seed: int = 5) -> dict:
    toks = np.random.default_rng(seed).integers(
        0, vocab, size=(B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.fixture(scope="module")
def step_ref():
    """Per config: the reference's init (one jitted call) and its
    ``build_cell(.., "train_4k", smoke=True, accum=)`` step at accum 1 and
    2 on one seeded batch of 2 x 64, every step compiled at once."""
    inits, calls = {}, []
    for arch_id in ARCHS:
        jcfg = j_get_arch(arch_id).make_smoke()
        inits[arch_id] = jax.jit(lambda k, c=jcfg: JT.lm_init(k, c))(
            jax.random.PRNGKey(0))
    for arch_id in ARCHS:
        arch = j_get_arch(arch_id)
        jp = inits[arch_id]
        opt = j_make_optimizer(arch.optimizer)[0](jp)
        batch = {k: jnp.asarray(v) for k, v in _batch(
            arch.make_smoke().vocab_size).items()}
        for accum in STEP_ACCUMS:
            cell = JS.build_cell(arch, "train_4k", smoke=True, accum=accum)
            calls.append((cell.fn, (jp, opt, batch, jnp.asarray(0))))
    outs = iter(_run_jitted(calls))
    return {arch_id: {"init": _np_tree(inits[arch_id]),
                      **{accum: next(outs) for accum in STEP_ACCUMS}}
            for arch_id in ARCHS}


def _check_update(path, got, p0, want, lr, adafactor, tag):
    """One updated leaf (or block) against the reference's: AdamW as
    ``tests/test_torch_lm_train.py`` holds it, (saturated, elements)
    back; Adafactor within twice the learning rate everywhere (a first
    step's update of a gradient at round-off is its sign, and a flipped
    sign moves by 2 lr), (elements off by more than 1e-5, elements)
    back."""
    err = np.abs(got - want)
    if adafactor:
        assert np.all(err <= 2 * lr), (tag, path, float(err.max()))
        return int((err > 1e-5).sum()), err.size
    u = (p0 - want) / lr - (0.1 * p0 if TO._wd_ok(path) else 0.0)
    sat = np.abs(u) >= 0.99
    assert np.all(err <= np.where(sat, 1e-3 * lr, lr)), \
        (tag, path, float(err.max()))
    return int(sat.sum()), sat.size


def _check_share(ada: bool, n: int, total: int, tag) -> None:
    """AdamW: at least 80% of the elements saturated (held to 1e-3 of
    lr); Adafactor: at most 0.1% off by more than 1e-5."""
    if ada:
        assert n <= 1e-3 * total, (tag, n, total)
    else:
        assert n >= 0.8 * total, (tag, n, total)


@pytest.mark.parametrize("accum", STEP_ACCUMS)
@pytest.mark.parametrize("arch_id", ARCHS)
def test_train_step_matches_jax(step_ref, arch_id, accum):
    """One train step of the smoke config (fp32, AdamW; kimi Adafactor and
    its MoE layers) against the reference's jitted ``build_cell`` step."""
    ref = step_ref[arch_id]
    jnew, _, jm = ref[accum]
    arch = get_arch(arch_id)
    init_fn, update_fn = TO.make_optimizer(arch.optimizer)
    step = TS.make_lm_train_step(arch.make_smoke(), update_fn, accum)
    params = lm_params(ref["init"])
    for _, p in TO.named_leaves(params):
        p.requires_grad_(True)
    batch = _batch(arch.make_smoke().vocab_size)
    params, _, m = step(params, init_fn(params),
                        {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    jl, jg = float(jm["loss"]), float(jm["gnorm"])
    assert abs(float(m["loss"]) - jl) <= 1e-5 * abs(jl), (float(m["loss"]), jl)
    assert abs(float(m["gnorm"]) - jg) <= 1e-4 * abs(jg), (float(m["gnorm"]), jg)
    want = dict(TO.named_leaves(lm_params(jnew)))
    old = dict(TO.named_leaves(lm_params(ref["init"])))
    ada = arch.optimizer == "adafactor"
    got = dict(TO.named_leaves(params))
    assert set(got) == set(want)
    n = total = 0
    for path, t in got.items():
        k, m_ = _check_update(path, t.detach().numpy(), old[path].numpy(),
                              want[path].numpy(), LR[arch.optimizer], ada,
                              arch_id)
        n, total = n + k, total + m_
    _check_share(ada, n, total, arch_id)


# --- the same steps on a (2, 2) mesh -------------------------------------------

REF_MESH = """
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from repro.configs.registry import get_arch
from repro.launch import steps as JS
from repro.launch.mesh import make_mesh
from repro.optim import make_optimizer

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
with mesh:
    for arch_id in {archs!r}:
        arch = get_arch(arch_id)
        cfg = arch.make_smoke()
        over = ({{"moe": dataclasses.replace(cfg.moe, dispatch="a2a")}}
                if cfg.moe else None)
        jp = tree(arch_id)
        opt = make_optimizer(arch.optimizer)[0](jp)
        batch = {{k: jnp.asarray(inp[arch_id + "/" + k])
                 for k in ("tokens", "labels")}}
        cell = JS.build_cell(arch, "train_4k", smoke=True, mesh=mesh,
                             cfg_overrides=over, accum=1,
                             smoke_batch={batch_n})
        new, _, m = cell.jit(mesh)(jp, opt, batch, jnp.asarray(0, jnp.int32))
        put("new/" + arch_id, new)
        out["loss/" + arch_id] = np.asarray(m["loss"])
        out["gnorm/" + arch_id] = np.asarray(m["gnorm"])
np.savez({out_path!r}, **out)
print("OK")
"""


def _flat(prefix, t, out):
    for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[prefix + "/" + key] = np.asarray(leaf)


def _tree(flat: dict, prefix: str) -> dict:
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


def _mesh_cfg(arch_id):
    """The smoke config as the launcher trains it under a mesh (the a2a
    expert dispatch)."""
    cfg = get_arch(arch_id).make_smoke()
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch="a2a"))
    return cfg


@pytest.fixture(scope="module")
def mesh_runs(step_ref, tmp_path_factory):
    """The reference's three mesh steps in a subprocess with 8 fake
    devices, the port's four gloo ranks beside it, on the one-process
    steps' parameters and a seeded batch of 4 x 64 a config."""
    tmp = tmp_path_factory.mktemp("cfg_mesh")
    inputs, params = str(tmp / "inputs.npz"), str(tmp / "ref_params.npz")
    ref_out = str(tmp / "ref_out.npz")
    flat, inp = {}, {}
    for i, arch_id in enumerate(ARCHS):
        _flat(arch_id, step_ref[arch_id]["init"], flat)
        b = _batch(get_arch(arch_id).make_smoke().vocab_size,
                   B=TMS.CFG_BATCH, seed=40 + i)
        inp.update({f"{arch_id}/{k}": v for k, v in b.items()})
    np.savez(params, **flat)
    np.savez(inputs, **inp)
    code = textwrap.dedent(REF_MESH).format(
        inputs=inputs, params=params, archs=ARCHS, batch_n=TMS.CFG_BATCH,
        out_path=ref_out)
    cfgs = {a: (_mesh_cfg(a), get_arch(a).optimizer) for a in ARCHS}
    with ThreadPoolExecutor(1) as pool:
        job = pool.submit(run_subprocess, code, 8, 600)
        ranks = ctx.spawn_ranks(TMS.configs_rank, 4, (
            str(tmp), inputs, params, cfgs), timeout_s=300)
        job.result()
    return {"ref": dict(np.load(ref_out)), "ranks": ranks, "flat": flat,
            "inp": inp}


@pytest.mark.parametrize("arch_id", ARCHS)
def test_mesh_train_step_matches_reference(step_ref, mesh_runs, arch_id):
    """Loss, gradient norm and every rank's updated blocks against the
    reference's ``build_cell(.., mesh=(2, 2))`` step: GQA (qwen, kimi)
    and MQA (granite) attention under TP, every leaf split as the
    unfiltered rules split it (granite's k and v kernels (64, 8) into 4
    columns a rank)."""
    ref = mesh_runs["ref"]
    jl, jg = float(ref[f"loss/{arch_id}"]), float(ref[f"gnorm/{arch_id}"])
    cfg = _mesh_cfg(arch_id)
    opt = get_arch(arch_id).optimizer
    ada = opt == "adafactor"
    spec_fn = TSH.train_spec_fn(cfg, filtered=False)
    want = dict(TO.named_leaves(lm_params(_tree(ref, f"new/{arch_id}"))))
    old = dict(TO.named_leaves(lm_params(step_ref[arch_id]["init"])))
    split = set()
    n = total = 0
    for rank, r in enumerate(mesh_runs["ranks"]):
        r = r[arch_id]
        assert abs(r["loss"] - jl) <= 1e-5 * abs(jl), (rank, r["loss"], jl)
        assert abs(r["gnorm"] - jg) <= 1e-4 * abs(jg), (rank, r["gnorm"], jg)
        assert set(r["params"]) == set(want)
        for path, blk in r["params"].items():
            spec = spec_fn(path, want[path].shape)
            idx = TSH.block_index(want[path].shape, spec, SIZES,
                                  {"data": rank // 2, "model": rank % 2})
            if any("model" in TSH.entry_axes(e) for e in spec):
                split.add(path)
            k, m_ = _check_update(path, blk, old[path].numpy()[idx],
                                  want[path].numpy()[idx], LR[opt], ada,
                                  (arch_id, rank))
            n, total = n + k, total + m_
    _check_share(ada, n, total, arch_id)
    for kv in ("k", "v"):
        assert f"dense_layers/0/attn/{kv}/kernel" in split


# --- the launcher's one-card cuts -------------------------------------------------

@pytest.mark.parametrize("arch_id,layers,params", [
    ("qwen1.5-110b", 1, 3.85e9), ("granite-20b", 8, 3.64e9),
    ("kimi-k2-1t-a32b", 1, 2.86e9)])
def test_train_one_card_cut_keeps_full_width(arch_id, layers, params):
    """The training launcher's one-card cut at train_4k: the first layers
    at full width (kimi's dense first layer, no MoE layer), and the
    parameters it leaves."""
    full = get_arch(arch_id).make_config()
    step = TS.make_lm_train_step(full, lambda *a, **k: None,
                                 cfg_overrides=TS.ONE_CARD_CUT[
                                     (arch_id, "train_4k")])
    cut = step.cfg
    assert cut.n_layers == layers
    assert dataclasses.replace(cut, n_layers=full.n_layers) == full
    if full.moe is not None:
        assert (cut.n_dense_layers, cut.n_moe_layers) == (1, 0)
    n = TF.lm_param_counts(cut)
    total = n["body_total"] + 2 * n["unembed"]     # untied head
    assert abs(total - params) < 0.01e9, total


@pytest.mark.parametrize("arch_id", ARCHS)
def test_train_one_card_cut_fits_the_card(arch_id):
    """Each cut's state (fp32 parameters, gradients and AdamW moments: 16
    bytes a parameter; kimi's bf16 parameters, bf16 gradients and their
    fp32 sums under Adafactor: 8) plus two fp32 logits microbatches (the
    log-softmax and its gradient) at ``ONE_CARD_ACCUM``'s microbatch stay
    under the card's 80 GB; one more layer's state does not fit beside
    qwen's."""
    key = (arch_id, "train_4k")
    arch = get_arch(arch_id)
    cfg = dataclasses.replace(arch.make_config(), **TS.ONE_CARD_CUT[key])
    n = TF.lm_param_counts(cfg)
    total = n["body_total"] + 2 * n["unembed"]
    per = 8 if arch.optimizer == "adafactor" else 16
    mb = arch.shapes["train_4k"].global_batch // TT.ONE_CARD_ACCUM[key]
    logits = 2 * 4 * mb * arch.shapes["train_4k"].seq_len * cfg.vocab_size
    assert per * total + logits < 80e9, (per * total, logits)
    if arch_id == "qwen1.5-110b":
        n2 = TF.lm_param_counts(dataclasses.replace(cfg, n_layers=2))
        assert per * (n2["body_total"] + 2 * n2["unembed"]) > 80e9
