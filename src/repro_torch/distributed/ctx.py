"""Ambient mesh, rank bring-up and the collectives of the mesh paths.

Counterpart of the reference's ``distributed/ctx.py``: ``use_mesh``,
``current_mesh`` and ``batch_axes`` as there.  ``wsc`` is the identity: in
eager PyTorch each rank holds its own block of every tensor explicitly
(the port's mesh paths slice, exchange and gather themselves), so there
is no sharding constraint to hint; it stays so that model code reads as
the reference's.

Ranks: :func:`spawn_ranks` starts one process per rank (the ``spawn``
start method: CUDA cannot fork), :func:`init_ranks` brings one up.  The
backend is picked once, from the ranks on THIS host (all of them for
ranks this host spawns; ``LOCAL_WORLD_SIZE``, else one, for a rank of a
multi-process job) against the cards the host has: NCCL when each rank
has a card of its own, gloo when ranks share one card or run on the CPU;
the choice is printed, and a failed init raises.
Rendezvous is by a file (``init_method="file://..."``) for ranks this
host spawns, or by the TCP address a multi-process job names
(``--coordinator host:port``: :func:`init_method`).

Collectives go through :func:`all_reduce`, :func:`all_gather`,
:func:`all_to_all` and :func:`reduce_scatter` over the group of one or
all mesh axes (:func:`axes_group`), on the tensors where they lie: gloo
takes CUDA tensors for all four, reduce_scatter in fp32 and bf16 too (it
stages them through host memory itself; probed on an H100 with ranks
sharing the card, torch 2.11: ``chip_smoke.py`` phase 28 checks it every
run), so no collective needs a second route.

Training differentiates through :func:`all_to_all_grad`,
:func:`all_gather_grad` and :func:`all_reduce_grad`.  Their backwards
follow one convention: every rank's loss is its SHARE of the global loss
(the shares sum to it), so the gradient a rank holds for a tensor it
shares with other ranks is a partial one, and the partials summed over
those ranks are the gradient.  Under it the adjoint of an all-to-all is
the reverse all-to-all, that of an all-gather a reduce-scatter, and that
of an all-reduce an all-reduce; a replicated tensor read by a rank's own
work needs no collective at all (its partials are summed where a leaf's
gradient is reduced: ``launch/steps.py``).
"""
from __future__ import annotations

import contextlib
import contextvars
import datetime
import multiprocessing
import os
import queue
import time
import traceback
from typing import Callable, Sequence, Tuple

import torch
import torch.distributed as dist

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=None)
_RANK = {"device": None, "backend": None, "shared": None}


def current_mesh():
    return _MESH.get()


@contextlib.contextmanager
def use_mesh(mesh):
    """Set the ambient mesh that model code reads."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def batch_axes() -> Tuple[str, ...]:
    """Mesh axes that shard the batch (every non-'model' axis)."""
    mesh = current_mesh()
    if mesh is None:
        return ()
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def wsc(x, *spec):
    """The identity (module note): each rank already holds its block."""
    return x


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------

def shares_card(local_world: int, device_type: str) -> bool:
    """Whether the ``local_world`` ranks on this host share a card (or run
    on the CPU)."""
    return device_type != "cuda" or local_world > torch.cuda.device_count()


def choose_backend(local_world: int, device_type: str) -> str:
    """NCCL when each of the ``local_world`` ranks on this host has a card
    of its own; gloo when they share a card (NCCL refuses two ranks on one
    device) or run on the CPU."""
    return "gloo" if shares_card(local_world, device_type) else "nccl"


def local_world_size(world: int, coordinator: bool) -> int:
    """The ranks on this host: all ``world`` of a job this host spawns;
    for a rank of a multi-process job (``coordinator``) the launcher's
    ``LOCAL_WORLD_SIZE``, else one (a card a process)."""
    if not coordinator:
        return world
    return int(os.environ.get("LOCAL_WORLD_SIZE", "1"))


def init_ranks(rank: int, world: int, init_file: str, device: str = "cuda",
               *, local_world: int | None = None,
               timeout_s: float = 600.0) -> torch.device:
    """Join rank ``rank`` of ``world`` to the default process group,
    rendezvous through ``init_file`` (a path no earlier group used, or a
    coordinator's ``host:port``).  ``local_world``: the ranks on this
    host (default all ``world``: :func:`local_world_size`), which decides
    the backend and whether they share a card.
    ``device`` ``"cuda"`` puts rank r on card r mod the host's cards;
    ``"cpu"`` keeps it on the CPU.  Returns the rank's device."""
    local_world = world if local_world is None else local_world
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_ranks: no CUDA device; pass device='cpu'"
                               " to run the ranks on the CPU")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    elif kind == "cpu":
        dev = torch.device("cpu")
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // local_world))
    else:
        raise ValueError(f"unsupported device {device!r}")
    backend = choose_backend(local_world, kind)
    dist.init_process_group(
        backend, init_method=init_method(init_file), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    _RANK.update(device=dev, backend=backend,
                 shared=shares_card(local_world, kind))
    if rank == 0:
        where = ("the CPU" if kind == "cpu" else
                 f"{min(local_world, torch.cuda.device_count())} card(s) "
                 f"a host")
        print(f"ranks: {world} on {where}, backend {backend}", flush=True)
    return dev


def init_method(where: str) -> str:
    """A rendezvous address: ``host:port`` (a TCP store on that host: the
    launcher's ``--coordinator``) or a file path (no fixed port)."""
    host, _, port = where.rpartition(":")
    if host and port.isdigit() and os.sep not in where:
        return f"tcp://{where}"
    return "file://" + os.path.abspath(where)


def rank_backend() -> str:
    return _RANK["backend"]


def ranks_share_card() -> bool:
    """Whether this host's ranks share a card, or run on the CPU."""
    if _RANK["shared"] is None:
        raise RuntimeError("init_ranks has not run in this process")
    return _RANK["shared"]


def rank_device() -> torch.device:
    if _RANK["device"] is None:
        raise RuntimeError("init_ranks has not run in this process")
    return _RANK["device"]


def close_ranks() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
    _RANK.update(device=None, backend=None, shared=None)


def _rank_main(fn, rank, world, args, results) -> None:
    try:
        out = fn(rank, world, *args)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        return
    finally:
        close_ranks()
    results.put((rank, True, out))


def spawn_ranks(fn: Callable, world: int, args: Sequence = (), *,
                timeout_s: float) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` fresh processes (the
    ``spawn`` start method) and return what each returned, in rank order
    (plain picklable values: numbers, strings, numpy arrays).  A rank that
    raises fails the call with its traceback, and the other ranks are
    killed; so are all of them when ``timeout_s`` passes first."""
    mpc = multiprocessing.get_context("spawn")
    results = mpc.Queue()
    procs = [mpc.Process(target=_rank_main, args=(fn, r, world, tuple(args),
                                                  results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    out, deadline = {}, time.perf_counter() + timeout_s
    try:
        while len(out) < world:
            left = deadline - time.perf_counter()
            if left <= 0:
                raise TimeoutError(f"spawn_ranks: ranks "
                                   f"{sorted(set(range(world)) - set(out))} "
                                   f"still running after {timeout_s} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(f"spawn_ranks: rank {dead[0]} died "
                                       f"(exit code "
                                       f"{procs[dead[0]].exitcode})")
                continue
            if not ok:
                raise RuntimeError(f"spawn_ranks: rank {rank} failed:\n"
                                   f"{payload}")
            out[rank] = payload
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.perf_counter()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
        results.close()
    return [out[r] for r in range(world)]


# ---------------------------------------------------------------------------
# mesh axes and collectives
# ---------------------------------------------------------------------------

def _axes(mesh, axes) -> Tuple[str, ...]:
    names = tuple(mesh.mesh_dim_names)
    return tuple(a for a in axes if a in names)


def axes_size(mesh, axes) -> int:
    """Ranks along the mesh axes ``axes`` (those the mesh lacks count 1)."""
    names = tuple(mesh.mesh_dim_names)
    n = 1
    for a in _axes(mesh, axes):
        n *= mesh.size(names.index(a))
    return n


def axes_index(mesh, axes) -> int:
    """This rank's flat index over ``axes``, row-major in their order (the
    reference's shard index over several axes)."""
    names = tuple(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    i = 0
    for a in _axes(mesh, axes):
        d = names.index(a)
        i = i * mesh.size(d) + coord[d]
    return i


def axes_group(mesh, axes):
    """The process group of this rank's peers along ``axes``: one mesh
    axis, or every axis of a mesh over the whole default group (the flat
    order then is the rank order, row-major as :func:`axes_index`).  Other
    subsets of several axes raise ``NotImplementedError``."""
    axes = _axes(mesh, axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if axes == tuple(mesh.mesh_dim_names) \
            and mesh.size() == dist.get_world_size():
        return dist.group.WORLD
    raise NotImplementedError(f"a group over mesh axes {axes} of "
                              f"{tuple(mesh.mesh_dim_names)}: one axis or "
                              f"all of them, in the mesh's order")


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
# all_gather_into_tensor and reduce_scatter_tensor under their newer
# names where torch has them (the older ones warn there)
_gather_single = getattr(dist, "all_gather_single",
                         dist.all_gather_into_tensor)
_scatter_single = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)


def all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """``t`` reduced (``"sum"`` or ``"max"``) over ``group``, in place."""
    dist.all_reduce(t, op=_OPS[op], group=group)
    return t


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """(group size, *t.shape): every rank's ``t`` (at least 1-D) in
    group-rank order."""
    n = dist.get_world_size(group)
    src = t.contiguous()
    out = torch.empty((n * src.shape[0], *src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    _gather_single(out, src, group=group)
    return out.reshape(n, *t.shape)


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Rank i's chunk j of ``t`` (dim 0 in group-size equal chunks) goes
    to rank j, as its chunk i of the result (``all_to_all_single``)."""
    src = t.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out


def all_reduce_axes(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``t`` summed over the mesh axes ``axes``, in place (none: as it
    is): over their joint group where they are the whole mesh, else one
    axis at a time."""
    axes = _axes(mesh, axes)
    if not axes:
        return t
    if set(axes) == set(mesh.mesh_dim_names):      # in any order
        return all_reduce(t, "sum", axes_group(mesh, mesh.mesh_dim_names))
    for a in axes:
        all_reduce(t, "sum", mesh.get_group(a))
    return t


def reduce_scatter(t: torch.Tensor, group) -> torch.Tensor:
    """Rank i's chunk i (dim 0 in group-size equal chunks) of the sum of
    every rank's ``t`` over ``group``."""
    n = dist.get_world_size(group)
    src = t.contiguous()
    out = torch.empty((src.shape[0] // n, *src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    _scatter_single(out, src, group=group)
    return out


def gather_axes(t: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """Concatenate every rank's ``t`` along ``dim`` over the mesh axes
    ``axes`` (each a block of the row-major flat index), one axis at a
    time from the innermost."""
    for a in reversed(_axes(mesh, axes)):
        parts = all_gather(t, mesh.get_group(a))
        t = torch.cat(list(parts.unbind(0)), dim=dim)
    return t


# ---------------------------------------------------------------------------
# collectives that carry gradients (the module note's convention)
# ---------------------------------------------------------------------------

class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(fctx, t, group):
        fctx.group = group
        return all_to_all(t, group)

    @staticmethod
    def backward(fctx, g):
        return all_to_all(g, fctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, t, groups, dim, dtype):
        fctx.groups, fctx.dim, fctx.in_dtype = groups, dim, t.dtype
        t = t.to(dtype)
        for group in groups:                 # innermost axis first
            t = torch.cat(list(all_gather(t, group).unbind(0)), dim=dim)
        return t

    @staticmethod
    def backward(fctx, g):
        g = g.to(fctx.in_dtype)
        for group in reversed(fctx.groups):
            n = dist.get_world_size(group)
            chunks = torch.stack(g.chunk(n, fctx.dim))
            g = reduce_scatter(chunks, group).reshape(chunks.shape[1:])
        return g, None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(fctx, t, group):
        fctx.group = group
        return all_reduce(t.clone(), "sum", group)

    @staticmethod
    def backward(fctx, g):
        return all_reduce(g.clone(), "sum", fctx.group), None


def all_to_all_grad(t: torch.Tensor, group) -> torch.Tensor:
    """:func:`all_to_all` whose backward is the reverse all-to-all."""
    return _AllToAll.apply(t, group)


def all_gather_grad(t: torch.Tensor, mesh, axes, dim: int,
                    dtype=None) -> torch.Tensor:
    """:func:`gather_axes` of ``t`` (cast to ``dtype`` first, where given:
    a block gathered in the compute dtype moves fewer bytes) whose
    backward reduce-scatters the gradient in ``t``'s own dtype (an fp32
    parameter block's: fp32) and hands each rank its block's part."""
    groups = tuple(mesh.get_group(a) for a in reversed(_axes(mesh, axes)))
    return _AllGather.apply(t, groups, dim, dtype or t.dtype)


def all_reduce_grad(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``t`` over ``group`` (a new tensor), whose
    backward sums the ranks' gradients the same way."""
    return _AllReduce.apply(t, group)

