"""Path-pattern sharding rules -> a spec per parameter, and a rank's block
of a leaf.

Counterpart of the reference's ``distributed/sharding.py``, as pure spec
logic over path strings and shapes: a spec is a tuple with one entry per
dim, each an axis name, a tuple of axis names or None (the reference's
``PartitionSpec``).  Trees are nested dicts and lists; a leaf is anything
with a ``.shape`` or a tuple of ints; its path joins the dict keys and
list indices with ``/``, as the reference's ``_path_str`` does.  Specs may
name axes (``"pod"``) that a mesh lacks; :func:`clean_spec` drops them.

Two placements are applied.  Serving (:func:`serving_spec`) splits only
the routed experts' leading ``"model"`` axis, which the all-to-all
dispatch needs, and replicates every other leaf.  Training
(:func:`train_spec_fn` for the LMs, :func:`vision_train_spec_fn` for the
vision family) applies the rules whole, TP over ``"model"`` and (the
LMs) FSDP over the batch axes, as the reference's ``param_specs``
computes them (its 16/32 divisibility and 4M-element floor; or, for
tests at a small size, the rules unfiltered), to the port's per-layer
leaves; the optimizer state follows by :func:`opt_specs_like`.  A
training rank owns contiguous copies of its blocks (:func:`shard_tree`
with ``own=True``).
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


def entry_axes(e) -> Tuple[str, ...]:
    """The mesh axes one entry of a spec names."""
    return () if e is None else (tuple(e) if isinstance(e, (tuple, list))
                                 else (e,))


def block_index(shape, spec: Spec, sizes: dict, coords: dict) -> tuple:
    """The slices of a ``shape`` leaf that the rank at ``coords`` ({axis:
    index}) holds under ``spec`` on a mesh of ``sizes`` ({axis: ranks};
    axes it lacks are dropped): each split dim cut into equal blocks, the
    block index row-major over a tuple entry's axes (a dim its shards do
    not divide raises)."""
    index = []
    for dim, e in enumerate(spec):
        i, n = 0, 1
        for a in entry_axes(e):
            if a in sizes:
                i, n = i * sizes[a] + coords[a], n * sizes[a]
        if shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"into {n} blocks (spec {spec})")
        b = shape[dim] // n
        index.append(slice(i * b, (i + 1) * b))
    return tuple(index)


def mesh_layout(mesh, coords=None) -> tuple:
    """({axis: ranks}, {axis: this rank's index}) of a ``DeviceMesh``, or
    of the rank at mesh coordinate ``coords``."""
    names = tuple(mesh.mesh_dim_names)
    coords = mesh.get_coordinate() if coords is None else coords
    return ({a: mesh.size(d) for d, a in enumerate(names)},
            {a: int(coords[d]) for d, a in enumerate(names)})


def shard_leaf(x, spec: Spec, mesh, coords=None, own: bool = False):
    """The block of ``x`` the rank at mesh coordinate ``coords`` (default
    this rank) holds under ``spec`` (:func:`block_index`): a view (or
    numpy view) of ``x``, or with ``own`` a contiguous copy of its own
    (a training state must not keep the whole leaf alive behind a view)."""
    sizes, at = mesh_layout(mesh, coords)
    blk = x[block_index(x.shape, spec, sizes, at)]
    if not own:
        return blk
    if isinstance(blk, np.ndarray):
        return np.array(blk, copy=True, order="C")
    # a strided view's contiguous() is already a copy of its own
    return blk.clone() if blk.is_contiguous() else blk.contiguous()


def shard_tree(tree, mesh, coords=None, spec_fn=serving_spec,
               own: bool = False):
    """Every leaf of ``tree`` cut to the rank's block by
    ``spec_fn(path, shape)`` (:func:`shard_leaf`)."""
    return _map_with_path(
        lambda p, leaf: shard_leaf(leaf, spec_fn(p, _shape(leaf)), mesh,
                                   coords, own), tree)


def is_spec(t) -> bool:
    """A spec (a tuple of axis names, tuples of them and Nones), as a leaf
    of a spec tree (``optim.api.named_leaves(..., is_leaf=is_spec)``)."""
    return isinstance(t, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in t)


def spec_tree(tree, spec_fn):
    """The tree of ``spec_fn(path, shape)`` over ``tree``'s leaves."""
    return _map_with_path(lambda p, leaf: spec_fn(p, _shape(leaf)), tree)


# ---------------------------------------------------------------------------
# the training placement
# ---------------------------------------------------------------------------

def _stack_spec_fn(family: str, stacks: dict, fsdp, filtered: bool):
    """``spec_fn(path, shape)`` of a port tree whose layer stacks are
    per-layer lists (``stacks``: {stack name: its layer count}): the spec
    ``param_specs(..., family, fsdp_axes=fsdp)`` gives the reference's
    leaf (a stacked one of shape ``(L, *shape)``), without the stack's
    leading L entry; ``filtered=False``: the rules alone."""
    def fn(path_s: str, shape) -> Spec:
        parts = path_s.split("/")
        stacked = len(parts) > 1 and parts[0] in stacks \
            and parts[1].isdigit()
        ref = "/".join(parts[:1] + parts[2:]) if stacked else path_s
        full = (stacks[parts[0]], *shape) if stacked else tuple(shape)
        if filtered:
            spec = leaf_spec(ref, full, family, fsdp_axes=fsdp)
        else:
            rules = lm_rules if family == "lm" else vision_rules
            spec = rules(ref, full, tuple(fsdp) if fsdp else None)
            if len(spec) != len(full):
                spec = _none(len(full))
        return tuple(spec[1:]) if stacked else tuple(spec)
    return fn


def train_spec_fn(cfg, *, filtered: bool = True):
    """``spec_fn(path, shape)`` of the training placement for an LM config
    ``cfg``'s port tree (per-layer paths such as
    ``moe_layers/3/moe/wi``): the spec the reference's ``param_specs``
    gives the stacked leaf (shape ``(L, *shape)`` for a stack of L
    layers), without its leading L entry.  ``filtered=False`` applies the
    rules without ``param_specs``'s divisibility filter and 4M-element
    floor, so that at a small size every TP and FSDP split is made (a dim
    the mesh does not divide then raises in :func:`shard_leaf`).  FSDP is
    over ("pod", "data"), the production meshes' batch axes: a mesh
    without "pod" drops it (:func:`clean_spec`)."""
    return _stack_spec_fn("lm", {"dense_layers": cfg.n_dense_layers,
                                 "moe_layers": cfg.n_moe_layers},
                          ("pod", "data"), filtered)


def vision_train_spec_fn(arch_id: str, cfg, *, filtered: bool = True):
    """``spec_fn(path, shape)`` of the vision family's training placement:
    what the reference's ``_vis_cell`` gives each leaf,
    ``param_specs(..., "vision", fsdp_axes=())`` (no FSDP; ``"model"``
    splits that only a dim's 16 shards can make kept), for the port's
    paths.  The ViTs' per-layer leaves (``layers/3/attn/q/kernel``) take
    the spec of the reference's stacked leaf without its leading L entry;
    the conv nets' stages are lists in both trees.  ``filtered=False``
    applies ``vision_rules`` without the divisibility filter, so that at
    a small size every split the rules name is made."""
    from repro_torch.configs.registry import vision_family
    stacks = {"layers": cfg.n_layers} if vision_family(arch_id) == "vit" \
        else {}
    return _stack_spec_fn("vision", stacks, (), filtered)


def split_axes(spec: Spec, mesh) -> Tuple[str, ...]:
    """The mesh axes that split a leaf under ``spec``, in mesh order."""
    named = {a for e in clean_spec(spec, mesh) for a in entry_axes(e)}
    return tuple(a for a in mesh.mesh_dim_names if a in named)


def replicated_axes(spec: Spec, mesh) -> Tuple[str, ...]:
    """The mesh axes over which a leaf under ``spec`` is replicated."""
    split = split_axes(spec, mesh)
    return tuple(a for a in mesh.mesh_dim_names if a not in split)


def fsdp_entry(spec: Spec, mesh):
    """(dim, axes) of the entry of ``spec`` that splits a leaf over batch
    axes alone (its FSDP dim), or None."""
    for dim, e in enumerate(clean_spec(spec, mesh)):
        axes = entry_axes(e)
        if axes and "model" not in axes:
            return dim, axes
    return None


def model_split(spec: Spec, mesh) -> bool:
    """Whether ``spec`` splits a leaf over the ``"model"`` axis."""
    return "model" in split_axes(spec, mesh)
