"""Checkpointing: async save, keep-k rotation, restart discovery.

Counterpart of the reference ``checkpoint/manager.py`` for one process and
the port's own format:

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


def _steps(ckpt_dir: Path) -> list:
    return sorted(int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*"))


def save_checkpoint(ckpt_dir: str, step: int, state: Any, *,
                    blocking: bool = True) -> threading.Thread:
    """state: a tree of tensors (params/opt/...).  Returns the writer
    thread (already joined when ``blocking``)."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    host_state = _to_host(state)   # synchronous D2H

    def write():
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        torch.save(host_state, tmp / "state.pt")
        (tmp / "meta.json").write_text(json.dumps(
            {"step": step, "format": "repro_torch",
             "time": time.time()}))  # repro: allow-wallclock(checkpoint metadata timestamp; never read back)
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)     # atomic publish

    t = threading.Thread(target=write, daemon=True)
    t.start()
    if blocking:
        t.join()
    return t


def restore_checkpoint(ckpt_dir: str, *, step: Optional[int] = None,
                       device: Optional[torch.device] = None) -> tuple:
    """Returns (step, state), the latest step unless ``step`` is given,
    tensors on ``device`` (the CPU by default)."""
    ckpt_dir = Path(ckpt_dir)
    steps = _steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    step = step if step is not None else steps[-1]
    d = ckpt_dir / f"step_{step:08d}"
    meta = json.loads((d / "meta.json").read_text())
    if meta.get("format") != "repro_torch":
        raise ValueError(f"{d} is not a repro_torch checkpoint")
    state = torch.load(d / "state.pt", map_location="cpu", weights_only=True)
    if device is not None:
        state = _to_device(state, device)
    return step, state


class CheckpointManager:
    """save_every/keep-k rotation + restart discovery + async writes."""

    def __init__(self, ckpt_dir: str, *, save_every: int = 100,
                 keep: int = 3, async_save: bool = True,
                 device: Optional[torch.device] = None):
        self.dir = Path(ckpt_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.save_every = save_every
        self.keep = keep
        self.async_save = async_save
        self.device = device
        self._pending: Optional[threading.Thread] = None

    def maybe_save(self, step: int, state) -> bool:
        """Save at every ``save_every``-th step (step 0 included); never
        when ``save_every`` is 0."""
        if self.save_every <= 0 or step % self.save_every:
            return False
        self.wait()
        self._pending = save_checkpoint(self.dir, step, state,
                                        blocking=not self.async_save)
        if not self.async_save:
            self.wait()
        return True

    def wait(self):
        """Join the save in flight, then rotate (keep the newest k)."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
            self._gc()

    def latest_step(self) -> Optional[int]:
        steps = _steps(self.dir)
        return steps[-1] if steps else None

    def restore_latest(self):
        return restore_checkpoint(self.dir, device=self.device)

    def _gc(self):
        for s in _steps(self.dir)[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)
