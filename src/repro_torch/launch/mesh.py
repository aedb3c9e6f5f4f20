"""Device meshes over the ranks of a ``torch.distributed`` group.

Counterpart of the reference's ``launch/mesh.py``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose ``mesh_dim_names`` are
the axis names (``"data"``, ``"model"``, ``"pod"``), built by
``init_device_mesh`` on the ranks' device type, rank ``r`` at the row-major
coordinate of ``r`` (as the reference lays its devices out).  The default
process group must exist first (:func:`repro_torch.distributed.ctx.
init_ranks`); building a mesh never starts processes or picks a backend.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.distributed import ctx


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A ``shape`` mesh named ``axes`` over every rank of the default
    group (its size must be the product of ``shape``); ``device_type``
    defaults to the type of the device :func:`ctx.init_ranks` gave this
    rank."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    world = dist.get_world_size()
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"mesh {shape} needs {n} ranks; the group has "
                         f"{world}")
    return init_device_mesh(device_type or ctx.rank_device().type, shape,
                            mesh_dim_names=axes)


PRODUCTION = {"pod": ((16, 16), ("data", "model")),
              "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The reference's production meshes: 16 x 16 (``data``, ``model``),
    or 2 x 16 x 16 with ``pod``.  Built only over a group of exactly 256
    or 512 ranks; any other world size raises."""
    shape, axes = PRODUCTION["multipod" if multi_pod else "pod"]
    need = 512 if multi_pod else 256
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"the production mesh {shape} needs {need} ranks; "
                         f"this group has {world}")
    return make_mesh(shape, axes)


def mesh_spec(text: str) -> tuple:
    """A launcher's ``--mesh``: ``pod`` and ``multipod`` (the production
    meshes) or ``DATAxMODEL`` -> (shape, axes)."""
    if text in PRODUCTION:
        return PRODUCTION[text]
    return parse_mesh(text), ("data", "model")


def make_host_mesh(n_devices: Optional[int] = None) -> DeviceMesh:
    """(n, 1) over (``data``, ``model``): every rank of the group by
    default, as the reference's mesh over every local device."""
    n = n_devices or dist.get_world_size()
    return make_mesh((n, 1), ("data", "model"))


def parse_mesh(text: str) -> tuple:
    """``"DATAxMODEL"`` (e.g. ``"1x2"``) -> (data, model)."""
    try:
        d, m = (int(t) for t in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh wants DATAxMODEL, e.g. 1x2; got "
                         f"{text!r}") from None
    if d < 1 or m < 1:
        raise ValueError(f"mesh sizes must be positive, got {text!r}")
    return d, m
