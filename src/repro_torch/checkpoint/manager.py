"""Checkpointing: async save, keep-k rotation, restart discovery.

Counterpart of the reference ``checkpoint/manager.py`` in the port's own
format, for one process or for the ranks of a mesh:

  * a state is any tree of dicts and lists of tensors (parameters,
    optimizer state) and plain values; it is copied to host memory
    synchronously (cheap beside a training step) and written by
    ``torch.save`` into ``.tmp_step_<n>/state.pt`` beside a ``meta.json``;
  * saves are ATOMIC: the temporary directory is renamed into place, so a
    failure mid-save never corrupts the latest good checkpoint;
  * saves are ASYNC: the disk write runs on a daemon thread, and
    :meth:`CheckpointManager.wait` joins it;
  * restore loads with ``weights_only=True`` (no arbitrary unpickling) and
    places the tensors on the caller's device.

Under a mesh (``shard=``) each rank saves only its own blocks, under
``step_<n>/rank<k>/`` beside a ``meta.json`` with the mesh's shape and
axes, the rank's coordinate and each leaf's spec: the reference's
multi-host ``proc<k>/`` contract; nothing gathers the state to one rank.
Each rank publishes its directory atomically, and a step counts once
every rank's is there.  A restore onto another mesh, or onto one process
(whole leaves), reads from the saved blocks the parts that overlap the
blocks it needs (the files memory-mapped: only those parts are read).
The rotation runs once every rank has published (a barrier): each rank
then sees the same newest ``keep`` complete steps, and removes its own
directory from every older step, complete or not (its removals never
reach those ``keep``); the last rank out removes the step's directory.

Reading the reference's JAX checkpoints is not supported.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import torch

from repro_torch.distributed.sharding import block_index, mesh_layout


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_host(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def _complete(d: Path) -> bool:
    """A one-process step, or a mesh step every rank has published."""
    if (d / "state.pt").exists():
        return True
    ranks = list(d.glob("rank*/meta.json"))
    return bool(ranks) and len(ranks) == json.loads(
        ranks[0].read_text())["world"]


def _steps(ckpt_dir: Path) -> list:
    return sorted(int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
                  if _complete(p))


def _flat(tree, path: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}" if path else str(k)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{path}/{i}" if path else str(i)))
        return out
    return {path: tree}


def _rebuild(tree, flat: dict, path: str = ""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, flat, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, flat, f"{path}/{i}" if path else str(i))
                for i, v in enumerate(tree)]
    return flat[path]


def _spec_json(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _spec(entries) -> tuple:
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


def save_checkpoint(ckpt_dir: str, step: int, state: Any, *,
                    blocking: bool = True, shard: Optional[dict] = None
                    ) -> threading.Thread:
    """state: a tree of tensors (params/opt/...).  ``shard`` ({"mesh": a
    DeviceMesh, "specs": {path: spec} of the state's split leaves}): this
    rank's blocks, under ``rank<k>/`` (module note).  Returns the writer
    thread (already joined when ``blocking``)."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    meta = {"step": step, "format": "repro_torch"}
    if shard is not None:
        mesh = shard["mesh"]
        sizes, coords = mesh_layout(mesh)
        rank = torch.distributed.get_rank()
        final, tmp = final / f"rank{rank}", Path(f"{tmp}_rank{rank}")
        meta.update(rank=rank, world=mesh.size(),
                    axes=list(mesh.mesh_dim_names),
                    shape=[sizes[a] for a in mesh.mesh_dim_names],
                    coords=[coords[a] for a in mesh.mesh_dim_names],
                    specs={p: _spec_json(sp)
                           for p, sp in shard["specs"].items()})
    host_state = _to_host(state)   # synchronous D2H

    def write():
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        torch.save(host_state, tmp / "state.pt")
        (tmp / "meta.json").write_text(json.dumps(
            dict(meta, time=time.time())))  # repro: allow-wallclock(checkpoint metadata timestamp; never read back)
        if final.exists():
            shutil.rmtree(final)
        final.parent.mkdir(parents=True, exist_ok=True)
        os.replace(tmp, final)     # atomic publish

    t = threading.Thread(target=write, daemon=True)
    t.start()
    if blocking:
        t.join()
    return t


def _restore_blocks(d: Path, mesh) -> Any:
    """The state of a mesh step: each leaf's block under ``mesh`` (this
    rank's; ``None``: the whole leaf), by the saved specs, from the saved
    blocks that overlap it."""
    metas = sorted((json.loads(p.read_text()) for p in
                    d.glob("rank*/meta.json")), key=lambda m: m["rank"])
    trees = {}

    def load(rank):
        if rank not in trees:
            tree = torch.load(d / f"rank{rank}" / "state.pt",
                              map_location="cpu", weights_only=True,
                              mmap=True)
            trees[rank] = (tree, _flat(tree))
        return trees[rank][1]
    m0 = metas[0]
    sizes = dict(zip(m0["axes"], m0["shape"]))
    at = {m["rank"]: dict(zip(m["axes"], m["coords"])) for m in metas}
    tsizes, tcoords = mesh_layout(mesh) if mesh is not None else ({}, {})
    out = {}
    for path, blk in load(m0["rank"]).items():
        spec = _spec(m0["specs"].get(path, [None] * getattr(blk, "ndim",
                                                            0)))
        if not isinstance(blk, torch.Tensor) or not any(spec):
            out[path] = blk.clone() if isinstance(blk, torch.Tensor) \
                else blk
            continue
        shape = tuple(s_ * _ways(e, sizes) for s_, e in zip(blk.shape, spec))
        want = block_index(shape, spec, tsizes, tcoords)
        res = torch.empty([w.stop - w.start for w in want], dtype=blk.dtype)
        for rank, coords in at.items():
            have = block_index(shape, spec, sizes, coords)
            lo = [max(h.start, w.start) for h, w in zip(have, want)]
            hi = [min(h.stop, w.stop) for h, w in zip(have, want)]
            if any(a >= b for a, b in zip(lo, hi)):
                continue
            src = tuple(slice(a - h.start, b - h.start)
                        for a, b, h in zip(lo, hi, have))
            dst = tuple(slice(a - w.start, b - w.start)
                        for a, b, w in zip(lo, hi, want))
            res[dst] = load(rank)[path][src]
        out[path] = res
    return _rebuild(trees[m0["rank"]][0], out)


def _ways(entry, sizes: dict) -> int:
    n = 1
    for a in (() if entry is None else (entry if isinstance(entry, tuple)
                                        else (entry,))):
        n *= sizes.get(a, 1)
    return n


def restore_checkpoint(ckpt_dir: str, *, step: Optional[int] = None,
                       device: Optional[torch.device] = None,
                       mesh=None) -> tuple:
    """Returns (step, state), the latest complete step unless ``step`` is
    given, tensors on ``device`` (the CPU by default).  A mesh step
    restores onto ``mesh`` (this rank's blocks) or, with none, onto one
    process (whole leaves), whatever mesh saved it."""
    ckpt_dir = Path(ckpt_dir)
    steps = _steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    step = step if step is not None else steps[-1]
    d = ckpt_dir / f"step_{step:08d}"
    sharded = not (d / "state.pt").exists()
    meta_path = next(d.glob("rank*/meta.json")) if sharded \
        else d / "meta.json"
    meta = json.loads(meta_path.read_text())
    if meta.get("format") != "repro_torch":
        raise ValueError(f"{d} is not a repro_torch checkpoint")
    if sharded:
        state = _restore_blocks(d, mesh)
    else:
        state = torch.load(d / "state.pt", map_location="cpu",
                           weights_only=True)
    if device is not None:
        state = _to_device(state, device)
    return step, state


class CheckpointManager:
    """save_every/keep-k rotation + restart discovery + async writes.
    ``shard`` ({"mesh", "specs"}: :func:`save_checkpoint`, and optionally
    "group", the process group of the rotation's barrier: the default
    one if absent): a rank of a mesh, saving and restoring its own
    blocks; every rank then calls :meth:`maybe_save` and :meth:`wait`
    at the same steps."""

    def __init__(self, ckpt_dir: str, *, save_every: int = 100,
                 keep: int = 3, async_save: bool = True,
                 device: Optional[torch.device] = None,
                 shard: Optional[dict] = None):
        self.dir = Path(ckpt_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.save_every = save_every
        self.keep = keep
        self.async_save = async_save
        self.device = device
        self.shard = shard
        self._pending: Optional[threading.Thread] = None

    def maybe_save(self, step: int, state) -> bool:
        """Save at every ``save_every``-th step (step 0 included); never
        when ``save_every`` is 0."""
        if self.save_every <= 0 or step % self.save_every:
            return False
        self.wait()
        self._pending = save_checkpoint(self.dir, step, state,
                                        blocking=not self.async_save,
                                        shard=self.shard)
        if not self.async_save:
            self.wait()
        return True

    def wait(self):
        """Join the save in flight, then rotate (keep the newest k); under
        a mesh once every rank has joined its own."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
            if self.shard is not None:
                torch.distributed.barrier(group=self.shard.get("group"))
            self._gc()

    def latest_step(self) -> Optional[int]:
        steps = _steps(self.dir)
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None):
        """(step, state) of ``step`` (default the latest), this rank's
        blocks under a mesh."""
        return restore_checkpoint(
            self.dir, step=step, device=self.device,
            mesh=None if self.shard is None else self.shard["mesh"])

    def restore_latest(self):
        return self.restore()

    def _gc(self):
        steps = _steps(self.dir)
        if self.shard is None:
            for s in steps[:-self.keep]:
                shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)
            return
        if self.keep <= 0 or len(steps) < self.keep:
            return
        # this rank's view (module note): its blocks in every step older
        # than the newest keep complete ones; the last rank the directory
        oldest, rank = steps[-self.keep], torch.distributed.get_rank()
        for d in self.dir.glob("step_*"):
            if int(d.name.split("_")[1]) < oldest:
                shutil.rmtree(d / f"rank{rank}", ignore_errors=True)
                try:
                    d.rmdir()
                except OSError:
                    pass
