"""Fault tolerance: watchdog, straggler detection, restart driver.

Counterpart of the reference ``distributed/fault.py``.  Recovery is
checkpoint/restart: :func:`run_with_restarts` runs the train function,
catches a failure, restores the latest checkpoint and continues, up to
``max_restarts``.  Across the ranks of a job (``group=``) every rank
resumes from the same step: the latest that every rank sees complete.
An injected failure hits every rank at the same step (the launcher's
``--fail-at``); a fault on one rank alone fails the run (its peers' next
collective times out, or the spawner stops them).

Divergence from the reference: the reference retries on any
``RuntimeError``.  The port's kernel wrappers raise ``RuntimeError`` when a
launch fails (and PyTorch raises it for CUDA faults), so retrying on it
would hide a kernel fault behind a restart.  The port's supervisor catches
only :class:`SimulatedFailure` (a ``RuntimeError`` subclass: the injected
failure is still caught) and ``OSError`` (a lost file system or host);
everything else propagates.
"""
from __future__ import annotations

import statistics
import threading
import time
from collections import deque
from typing import Callable, Optional


class SimulatedFailure(RuntimeError):
    """Injected by tests/examples to exercise the restart path."""


# what the supervisor restarts from; anything else is a fault to surface
RETRIED = (SimulatedFailure, OSError)


class Watchdog:
    """Re-armable heartbeat: firing ``on_stall`` does NOT kill the
    watchdog thread -- a later :meth:`beat` clears ``stalled`` and arms
    the next stall, so one watchdog covers a whole run-with-restarts."""

    def __init__(self, timeout_s: float = 300.0,
                 on_stall: Optional[Callable[[], None]] = None):
        self.timeout_s = timeout_s
        self.on_stall = on_stall
        self._last_beat = time.monotonic()
        self._stop = threading.Event()
        self.stalled = False
        self.stall_count = 0
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def start(self):
        self._last_beat = time.monotonic()
        self._thread.start()
        return self

    def beat(self):
        self._last_beat = time.monotonic()
        self.stalled = False   # recovery re-arms the next stall

    def stop(self):
        self._stop.set()

    def _loop(self):
        fired_for: Optional[float] = None
        while not self._stop.wait(min(self.timeout_s / 4, 5.0)):
            if time.monotonic() - self._last_beat > self.timeout_s:
                if fired_for == self._last_beat:
                    continue   # already fired for this stall; wait for beat
                fired_for = self._last_beat
                self.stalled = True
                self.stall_count += 1
                if self.on_stall:
                    self.on_stall()


class StragglerMonitor:
    """Per-step wall-time tracker: flags steps slower than ``threshold`` x
    the rolling median, in a bounded log."""

    def __init__(self, window: int = 50, threshold: float = 2.0,
                 log_cap: int = 1024):
        self.times = deque(maxlen=window)
        self.threshold = threshold
        self.flags = deque(maxlen=log_cap)
        self.flags_dropped = 0

    def record(self, step: int, seconds: float) -> bool:
        """Returns True if this step is a straggler outlier."""
        is_straggler = False
        if len(self.times) >= 10:
            med = statistics.median(self.times)
            if seconds > self.threshold * med:
                is_straggler = True
                if len(self.flags) == self.flags.maxlen:
                    self.flags_dropped += 1   # deque evicts the oldest
                self.flags.append({"step": step, "seconds": seconds,
                                   "median": med})
        self.times.append(seconds)
        return is_straggler


def _agreed_step(manager, group) -> Optional[int]:
    """The least of every rank's latest complete step (None: some rank
    has none), the same on every rank of ``group``, read once every rank
    has published its saves."""
    import torch
    import torch.distributed as dist
    dist.barrier(group=group)
    step = manager.latest_step()
    t = torch.tensor([-1 if step is None else step], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return None if int(t) < 0 else int(t)


def run_with_restarts(train_fn, *, manager, max_restarts: int = 3,
                      logger=print, group=None):
    """Supervisor: ``train_fn(start_step, restored_state|None) -> state``.

    On a :data:`RETRIED` failure, restores the latest checkpoint and
    re-invokes train_fn.  Returns (final_state, n_restarts).  ``group``
    (a ``torch.distributed`` group over CPU tensors: gloo) makes the
    ranks agree on the step they resume from (the module note).
    """
    restarts = 0
    while True:
        start_step, state = 0, None
        latest = manager.latest_step() if group is None \
            else _agreed_step(manager, group)
        if latest is not None:
            start_step, state = manager.restore(latest)
            start_step += 1
            logger(f"[fault] resuming from checkpoint step {start_step - 1}")
        try:
            return train_fn(start_step, state), restarts
        except RETRIED as e:
            restarts += 1
            logger(f"[fault] failure at restart {restarts}: {e!r}")
            if hasattr(manager, "wait"):
                # drain in-flight async saves before restore
                manager.wait()  # repro: allow-wait(checkpoint drain joins a finite set of in-flight saves, not an Event)
            if restarts > max_restarts:
                raise
