"""Path-pattern sharding rules -> a spec per parameter, and a rank's block
of a leaf.

Counterpart of the reference's ``distributed/sharding.py``, as pure spec
logic over path strings and shapes: a spec is a tuple with one entry per
dim, each an axis name, a tuple of axis names or None (the reference's
``PartitionSpec``).  Trees are nested dicts and lists; a leaf is anything
with a ``.shape`` or a tuple of ints; its path joins the dict keys and
list indices with ``/``, as the reference's ``_path_str`` does.  Specs may
name axes (``"pod"``) that a mesh lacks; :func:`clean_spec` drops them.

What this slice applies (:func:`serving_spec`): only the routed experts'
leading ``"model"`` axis, which the all-to-all dispatch needs (``wi``,
``wg`` and ``wo``: ``P("model", fsdp, None)`` in the rules); every other
leaf is replicated.  The rules' TP and FSDP placements of the other
leaves come with training under a mesh (ROADMAP §3).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

Spec = Tuple


def clean_spec(spec: Spec, mesh) -> Spec:
    """``spec`` without the axes ``mesh`` lacks."""
    names = set(mesh.mesh_dim_names)

    def keep(e):
        if e is None:
            return None
        if isinstance(e, (tuple, list)):
            kept = tuple(a for a in e if a in names)
            return kept if kept else None
        return e if e in names else None

    return tuple(keep(e) for e in spec)


def _stacked(path_s: str) -> bool:
    """Stacked-layer params (leading L dim from vmap init / scan)."""
    return "layers/" in path_s and "exit_heads" not in path_s


def _none(n: int) -> Spec:
    return (None,) * n


def lm_rules(path_s: str, shape: Tuple[int, ...], fsdp) -> Spec:
    base = None
    if path_s.endswith("embed/embedding"):
        return ("model", fsdp)
    if path_s.endswith("lm_head/kernel"):
        return (fsdp, "model")
    if "/attn/" in path_s or "/attn1/" in path_s:
        if path_s.endswith("o/kernel"):
            base = ("model", fsdp)
        elif path_s.endswith("kernel"):
            base = (fsdp, "model")
        elif path_s.endswith("o/bias"):
            base = (None,)
        elif path_s.endswith("bias"):
            base = ("model",)
    elif "/moe/" in path_s:
        if "router" in path_s:
            base = (None, None)
        elif "/shared/" in path_s:
            if path_s.endswith("wo/kernel"):
                base = ("model", fsdp)
            elif path_s.endswith("kernel"):
                base = (fsdp, "model")
            else:
                base = ("model",)
        elif path_s.endswith("wo"):
            base = ("model", None, fsdp)
        elif path_s.endswith("wi") or path_s.endswith("wg"):
            base = ("model", fsdp, None)
    elif "/mlp/" in path_s:
        if path_s.endswith("wo/kernel"):
            base = ("model", fsdp)
        elif path_s.endswith("kernel"):
            base = (fsdp, "model")
        elif path_s.endswith("wo/bias"):
            base = (None,)
        elif path_s.endswith("bias"):
            base = ("model",)
    if base is None:
        return _none(len(shape))
    if _stacked(path_s):
        return (None, *base)
    return base


def vision_rules(path_s: str, shape: Tuple[int, ...], fsdp) -> Spec:
    # transformer-style leaves reuse the LM rules
    if any(t in path_s for t in ("/attn/", "/attn1/", "/mlp/", "embed/")):
        return lm_rules(path_s, shape, fsdp)
    if any(path_s.endswith(s) for s in ("q2/kernel", "kv2/kernel")):
        spec = (None, "model")
    elif path_s.endswith("o2/kernel"):
        spec = ("model", None)
    elif path_s.endswith("ada/kernel"):
        spec = (None, "model")
    elif "conv" in path_s or "patch_embed" in path_s or "/dw/" in path_s \
            or any(t in path_s for t in ("expand/", "project/", "stem/",
                                         "head/", "down/", "up/", "skip/",
                                         "proj/", "se_")):
        if len(shape) == 4 and shape[-1] >= 256:
            spec = (None, None, None, "model")
        else:
            spec = _none(len(shape))
    elif path_s.endswith("fc/kernel") and shape[0] >= 1024:
        spec = ("model", None)
    else:
        spec = _none(len(shape))
    if _stacked(path_s) and len(spec) == len(shape) - 1:
        return (None, *spec)
    if len(spec) != len(shape):
        spec = _none(len(shape))
    return spec


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(n) for n in (leaf if isinstance(leaf, tuple)
                                  else leaf.shape))


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, path + (str(i),))
                for i, v in enumerate(tree)]
    return fn("/".join(path), tree)


def leaf_spec(path_s: str, shape: Tuple[int, ...], family: str, *,
              fsdp_axes=("pod", "data"), fsdp_min_size: int = 1 << 22
              ) -> Spec:
    """One leaf's spec: the family's rule, FSDP dropped below
    ``fsdp_min_size`` elements, and any axis a dim cannot split evenly
    (16 shards for one axis, 32 for a pair) dropped, as the reference's
    ``param_specs`` does for GSPMD."""
    fsdp = tuple(fsdp_axes) if fsdp_axes else None
    rules = lm_rules if family == "lm" else vision_rules
    spec = rules(path_s, shape, fsdp)
    if len(spec) != len(shape):
        spec = _none(len(shape))
    if fsdp and int(np.prod(shape)) < fsdp_min_size:
        spec = tuple(None if e == fsdp or e == tuple(fsdp) else e
                     for e in spec)

    def fits(dim, entry):
        if entry is None:
            return True
        req = 32 if isinstance(entry, (tuple, list)) else 16
        return dim % req == 0
    return tuple(e if fits(shape[i], e) else None for i, e in enumerate(spec))


def param_specs(shapes_tree, family: str, *, fsdp_axes=("pod", "data"),
                fsdp_min_size: int = 1 << 22):
    """The tree of specs matching ``shapes_tree`` (the reference layout:
    stacked layers carry their leading L dim)."""
    return _map_with_path(
        lambda p, leaf: leaf_spec(p, _shape(leaf), family,
                                  fsdp_axes=fsdp_axes,
                                  fsdp_min_size=fsdp_min_size), shapes_tree)


def opt_specs_like(param_specs_tree, opt_state_shapes, params_shapes):
    """Optimizer-state specs from the param specs: elementwise states
    inherit the param's spec; adafactor's factored moments drop the
    matching trailing dim (``vr``: the last; ``vc``: the one before).
    ``opt_state_shapes`` is {"s": tree of {state name: leaf}} beside
    ``params_shapes``."""
    def one(spec, st, p):
        out = {}
        for k, v in st.items():
            if _shape(v) == _shape(p):
                out[k] = spec
            elif k == "vr":
                out[k] = tuple(spec[:-1])
            elif k == "vc":
                out[k] = tuple(spec[:-2]) + (spec[-1],)
            else:
                out[k] = _none(len(_shape(v)))
        return out

    def walk(specs, states, params):
        if isinstance(params, dict):
            return {k: walk(specs[k], states[k], params[k]) for k in params}
        if isinstance(params, list):
            return [walk(a, b, c) for a, b, c in zip(specs, states, params,
                                                      strict=True)]
        return one(specs, states, params)
    return {"s": walk(param_specs_tree, opt_state_shapes["s"],
                      params_shapes)}


# ---------------------------------------------------------------------------
# what this slice applies, and a rank's block
# ---------------------------------------------------------------------------

def _routed_expert(path_s: str) -> bool:
    return "/moe/" in path_s and "/shared/" not in path_s \
        and path_s.rsplit("/", 1)[-1] in ("wi", "wg", "wo")


def serving_spec(path_s: str, shape: Tuple[int, ...]) -> Spec:
    """The placement this slice applies to an LM leaf (module note): the
    rule's ``"model"`` entries for the routed experts (their expert axis),
    None everywhere else.  The rule itself, not ``param_specs``'s
    divisibility filter: the all-to-all dispatch shards the experts over
    ``"model"`` whatever their count, as the reference's shard_map does."""
    if not _routed_expert(path_s):
        return _none(len(shape))
    spec = lm_rules(path_s, shape, None)
    return tuple(e if e == "model" else None for e in spec)


def layer_path(path_s: str) -> str:
    """A port leaf's path (``moe_layers/3/moe/wi``: a per-layer list) as
    the reference's stacked path (``moe_layers/moe/wi``)."""
    parts = path_s.split("/")
    if len(parts) > 1 and parts[0] in ("dense_layers", "moe_layers") \
            and parts[1].isdigit():
        parts = parts[:1] + parts[2:]
    return "/".join(parts)


def layer_serving_spec(path_s: str, shape: Tuple[int, ...]) -> Spec:
    """:func:`serving_spec` of one layer of a stack (the port's per-layer
    leaves): the stacked rule's spec without its leading L entry."""
    ref = layer_path(path_s)
    if ref == path_s and not _stacked(path_s):
        return serving_spec(path_s, shape)
    return serving_spec(ref, (1, *shape))[1:]


def shard_leaf(x, spec: Spec, mesh, coords=None):
    """The block of ``x`` the rank at mesh coordinate ``coords`` (default
    this rank) holds under ``spec``: each split dim cut into equal blocks,
    the block index row-major over a tuple entry's axes (a dim its shards
    do not divide raises).  A view (or numpy view) of ``x``."""
    names = tuple(mesh.mesh_dim_names)
    coords = mesh.get_coordinate() if coords is None else coords
    index = []
    for dim, e in enumerate(clean_spec(spec, mesh)):
        i, n = 0, 1
        for a in () if e is None else (e if isinstance(e, tuple) else (e,)):
            d = names.index(a)
            i, n = i * mesh.size(d) + coords[d], n * mesh.size(d)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"into {n} blocks (spec {spec})")
        b = x.shape[dim] // n
        index.append(slice(i * b, (i + 1) * b))
    return x[tuple(index)]


def shard_tree(tree, mesh, coords=None, spec_fn=serving_spec):
    """Every leaf of ``tree`` cut to the rank's block by
    ``spec_fn(path, shape)``."""
    return _map_with_path(
        lambda p, leaf: shard_leaf(leaf, spec_fn(p, _shape(leaf)), mesh,
                                   coords), tree)
