"""Dynamic serving engine: the deployed half of the paper's system.

The port's counterpart of the reference ``runtime/engine.py``, running the
port's model eagerly on one device (the CUDA card, or the CPU in tests).
It serves a supernet through its Pareto sub-networks:

* an executable cache keyed by ``(SubnetSpec, batch bucket)`` — each
  sub-network is a sliced-mode closure over the SAME resident parameter
  tensors, so switching architectures costs one dictionary lookup (the
  Dynamic-OFA trick: weights stay resident, no re-deployment);
* **bucketed continuous batching**: a batch of ``k`` requests is padded
  only up to the nearest power-of-two bucket (1, 2, 4, ..., max_batch);
  per-bucket pad buffers (pinned host memory on the card) are pooled so
  the steady state does zero host allocation, and
  :meth:`DynamicServer.warm` runs the whole bucket ladder once so serving
  meets no cold ``(spec, bucket)`` (``cold_compiles`` counts misses);
* **pipelined dispatch**: a *collector* thread stacks batch N+1, copies it
  to the device and enqueues its forward while a *completer* thread waits
  on batch N's CUDA event and resolves its futures.  ``pipeline_depth``
  bounds how far the collector may run ahead; ``busy_s``/
  ``measured_energy_mj`` integrate non-overlapping dispatch→ready
  intervals so accounting stays correct under overlap;
* the runtime governor in the loop: every ``govern_every`` batches it
  re-reads the performance target + hardware state and may switch the
  active sub-network and the (modelled) DVFS point;
* wall-clock measurement (:meth:`measure`) that feeds the measured LUT.

Served logits are float32 numpy rows (numpy has no bfloat16; the
reference's bf16 ``y`` is an ml_dtypes array).  The request tracer,
metrics registry and calibration store hooks come with a later slice of
the port: passing them raises.

The worker blocks on the request queue and on pause/resume events (no
polling): an idle or paused server burns no CPU and wakes immediately.
"""
from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.analysis.guards import guarded_by
from repro_torch.core.elastic import spec_to_static
from repro_torch.core.types import SubnetSpec
from repro_torch.device import resolve_device, synchronize
from repro_torch.runtime import hwmodel as hm
from repro_torch.runtime.lut import bucket_ladder

# queue token that wakes a blocked collector without carrying a request
# (pause()/stop() enqueue it so the worker never needs a poll timeout)
_WAKE = object()


@dataclasses.dataclass
class Request:
    x: Any
    t_submit: float
    future: "queue.Queue"


@dataclasses.dataclass
class _InFlight:
    """One dispatched batch travelling from collector to completer."""
    out: Any                   # device tensor (enqueued, maybe not ready)
    ready: Any                 # CUDA event recorded after the forward|None
    reqs: List[Request]
    t_dispatch: float
    hw: Any                    # HwState active at dispatch
    subnet: str
    buf_key: tuple             # pad-buffer pool slot to recycle when ready
    buf: Optional[torch.Tensor]  # None once returned to the pool
    spec: SubnetSpec = SubnetSpec()   # the dispatched
    bucket: int = 0                   # (SubnetSpec, bucket) executable


@guarded_by("_wake_lock", "_wake_tokens")
@guarded_by("_acct_lock", "_outstanding")
class DynamicServer:
    def __init__(self, apply_fn: Callable, params, dims: Dict[str, int], *,
                 governor=None, max_batch: int = 8, timeout_ms: float = 5.0,
                 multiple_of: int = 1,
                 warm_specs: Optional[List[SubnetSpec]] = None,
                 batch_buckets: bool = True, pipeline: bool = True,
                 pipeline_depth: int = 2, example_input=None,
                 switch_log_cap: int = 1024,
                 calibration=None, tracer=None, metrics=None, device=None):
        """``apply_fn(params, x, E) -> output``: the model on device tensors
        (``params`` already on ``device``; ``x`` a device batch).

        ``device`` is the card unless the caller passes ``"cpu"``; with no
        card and no explicit request the constructor raises.

        ``dims`` maps knob names to full sizes (see spec_to_static).
        ``batch_buckets=False`` restores the pad-to-max data path and
        ``pipeline=False`` the synchronous dispatch-then-wait loop (the
        baselines the benchmarks compare against).  ``example_input`` is
        one request-shaped array; when given, ``warm_specs`` warms the
        whole bucket ladder (one execution per bucket) instead of only
        building the closures.

        ``calibration``, ``tracer`` and ``metrics`` come with a later slice
        of the port and raise ``NotImplementedError`` when given.  The
        reference's adaptive batching window, tenant label and arbiter,
        cluster and chaos methods come with the slice that calls them.
        """
        for name, hook in (("calibration", calibration), ("tracer", tracer),
                           ("metrics", metrics)):
            if hook is not None:
                raise NotImplementedError(
                    f"DynamicServer({name}=...) comes with a later slice of "
                    f"the port")
        self.device = resolve_device(device)
        self.apply_fn = apply_fn
        self.params = params
        self.dims = dims
        self.governor = governor
        self.max_batch = max_batch
        self.timeout_s = timeout_ms / 1e3
        self.multiple_of = multiple_of
        self.batch_buckets = batch_buckets
        self.buckets: Tuple[int, ...] = (bucket_ladder(max_batch)
                                         if batch_buckets else (max_batch,))
        self.pipeline = pipeline
        self.pipeline_depth = max(1, pipeline_depth)
        self.example_input = (None if example_input is None
                              else np.asarray(example_input))
        # cache key: (spec, bucket); bucket None is the shape-polymorphic
        # executable used by the synchronous infer()/measure() path
        self._cache: Dict[Tuple[SubnetSpec, Optional[int]], Any] = {}
        self._specs_cached: Set[SubnetSpec] = set()
        self._compiled: Set[Tuple[SubnetSpec, int]] = set()
        self._cache_lock = threading.Lock()
        # per-bucket pad-buffer free list (pinned host tensors on the card):
        # the completer recycles a buffer only after its batch left the
        # device, so the collector never rewrites memory an in-flight
        # non-blocking copy (or, on the CPU, the forward itself) still
        # reads.  Steady state: zero host allocation.
        self._pad_pool: Dict[Tuple[int, tuple, str], List[torch.Tensor]] = {}
        self._pad_lock = threading.Lock()
        self._queue: "queue.Queue" = queue.Queue()
        # _WAKE entries in _queue (not real backlog); lock-protected because
        # pause()/stop() (callers) and the worker all touch it and
        # queue_depth() reads it
        self._wake_tokens = 0     # guarded-by: _wake_lock
        self._wake_lock = threading.Lock()
        # unresolved futures; drain() waits on it
        self._outstanding = 0     # guarded-by: _acct_lock
        self._acct_lock = threading.Lock()
        self._draining = False
        self._fail_reason: Optional[str] = None
        self._completions: Optional["queue.Queue"] = None
        self._stop = threading.Event()
        self._paused = threading.Event()
        self._resume = threading.Event()
        self._resume.set()
        self._worker: Optional[threading.Thread] = None
        self._completer: Optional[threading.Thread] = None
        self.active_spec = SubnetSpec()
        self.active_point = None
        # bounded: governor churn must not grow memory without limit
        self.switch_log: Deque[dict] = collections.deque(maxlen=switch_log_cap)
        self.switch_log_cap = switch_log_cap
        self.switch_log_dropped = 0
        self.served = 0
        self.cancelled = 0
        # serve-path dispatches of a (spec, bucket) that warm() never ran
        self.cold_compiles = 0
        # measured accounting: non-overlapping dispatch->ready wall-clock
        # integrated against the active hw slice's modelled power (vs the
        # LUT's modelled energy_mj).  _last_ready de-overlaps pipelined
        # batches.
        self.busy_s = 0.0
        self.measured_energy_mj = 0.0
        self._last_ready = 0.0
        if warm_specs:
            self.warm(warm_specs)

    # --- executable cache ---------------------------------------------------

    def executable(self, spec: SubnetSpec, bucket: Optional[int] = None):
        # called from the worker thread AND synchronous infer()/measure()
        # callers
        with self._cache_lock:
            key = (spec, bucket)
            if key not in self._cache:
                E = spec_to_static(spec, self.dims, self.multiple_of)
                apply_fn = self.apply_fn

                def fn(p, x, E=E):
                    # inference mode is thread-local: enter it here, on
                    # whichever thread (collector or caller) runs the forward
                    with torch.inference_mode():
                        return apply_fn(p, x, E)

                self._cache[key] = fn
                self._specs_cached.add(spec)
            return self._cache[key]

    def warm(self, specs: List[SubnetSpec], example_input=None):
        """Warm the bucket ladder for each spec.

        Builds every (spec, bucket) executable; with an example input
        (here or at construction) each one is also executed once, so the
        kernels are built and every shape has run before serving — after
        this, steady-state serving meets zero cold (spec, bucket) pairs
        (``cold_compiles`` stays 0) and zero host allocations (pad
        buffers are pre-pinned per bucket).
        """
        x1 = example_input if example_input is not None else self.example_input
        if x1 is not None:
            x1 = np.asarray(x1)
            self.example_input = x1
        for spec in specs:
            for b in self.buckets:
                fn = self.executable(spec, b)
                if x1 is None:
                    continue
                key, buf = self._take_buffer(b, x1.shape, x1.dtype)
                buf.zero_()
                fn(self.params, self._to_device(buf))
                synchronize(self.device)
                self._give_buffer(key, buf)
                self._compiled.add((spec, b))

    def switch(self, spec: SubnetSpec, point=None):
        t0 = time.perf_counter()
        cold = spec not in self._specs_cached
        self.executable(spec)
        if len(self.switch_log) == self.switch_log_cap:
            self.switch_log_dropped += 1   # deque evicts the oldest entry
        self.switch_log.append({"spec": spec.name(), "cold": cold,
                                "ms": (time.perf_counter() - t0) * 1e3})
        self.active_spec = spec
        self.active_point = point

    # --- synchronous API ------------------------------------------------------

    def _to_device(self, x) -> torch.Tensor:
        """A host batch (numpy array or tensor) on the serving device; a
        pinned host tensor is copied without blocking the host."""
        t = torch.as_tensor(x)
        return t.to(self.device, non_blocking=t.is_pinned())

    def infer(self, x, spec: Optional[SubnetSpec] = None) -> torch.Tensor:
        """One synchronous forward of batch ``x``; returns the device output."""
        spec = spec or self.active_spec
        fn = self.executable(spec)
        out = fn(self.params, self._to_device(x))
        synchronize(self.device)
        return out

    def measure(self, spec: SubnetSpec, x, iters: int = 5) -> float:
        """Median wall-clock ms for one batch under ``spec`` (post-warmup),
        host-to-device copy of the batch included, as serving pays it."""
        fn = self.executable(spec)
        fn(self.params, self._to_device(x))
        synchronize(self.device)
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(self.params, self._to_device(x))
            synchronize(self.device)
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))

    # --- batched serving loop -------------------------------------------------

    def _cancel(self, r: Request, reason: str):
        # "failed" marks fail-stop (kill) resolutions apart from ordinary
        # cancels (stop/drain/shed) so live accounting can separate a node
        # failure from load shedding, as the cluster simulator does
        r.future.put({"y": None, "cancelled": True, "error": reason,
                      "failed": self._fail_reason is not None,
                      "latency_ms": (time.perf_counter() - r.t_submit) * 1e3,
                      "subnet": None})
        self.cancelled += 1
        with self._acct_lock:
            self._outstanding = max(0, self._outstanding - 1)

    def _stop_reason(self) -> str:
        return self._fail_reason or "server stopped"

    def submit(self, x) -> "queue.Queue":
        """Queue one request (one image, host array); the returned future
        resolves to ``{"y", "latency_ms", "subnet"}`` or a cancel payload."""
        fut: "queue.Queue" = queue.Queue(maxsize=1)
        r = Request(x=x, t_submit=time.perf_counter(), future=fut)
        with self._acct_lock:
            self._outstanding += 1
        if self._stop.is_set() or self._draining:
            # stopped/draining server: resolve immediately instead of
            # queueing a request no worker will ever pick up
            self._cancel(r, "server draining" if self._draining
                         and not self._stop.is_set() else self._stop_reason())
            return fut
        self._queue.put(r)
        if self._stop.is_set() and not self.is_running:
            # stop() raced the put above and its drain may have missed us;
            # drain again (queue.get is atomic, each request resolves once)
            self._drain_queue()
        return fut

    def outstanding(self) -> int:
        """Futures submitted but not yet resolved (drain watches this)."""
        with self._acct_lock:
            return self._outstanding

    def queue_depth(self) -> int:
        """Requests waiting for a batch."""
        with self._wake_lock:
            tokens = self._wake_tokens
        return max(0, self._queue.qsize() - tokens)

    def _put_wake(self):
        with self._wake_lock:
            self._wake_tokens += 1
        self._queue.put(_WAKE)

    def _took_wake(self):
        with self._wake_lock:
            self._wake_tokens -= 1

    def _drain_queue(self):
        while True:
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                break
            if r is _WAKE:
                self._took_wake()
                continue
            self._cancel(r, self._stop_reason())

    def _collect_batch(self) -> List[Request]:
        """Block (no poll) until a request arrives, then hold the batching
        window open.  A _WAKE token (pause/stop) ends collection early."""
        reqs: List[Request] = []
        deadline = 0.0
        while len(reqs) < self.max_batch:
            if not reqs:
                r = self._queue.get()    # idle: block until work or wake
            else:
                timeout = max(0.0, deadline - time.perf_counter())
                try:
                    r = self._queue.get(timeout=timeout)
                except queue.Empty:
                    break
            if r is _WAKE:
                self._took_wake()
                break
            if not reqs:
                deadline = time.perf_counter() + self.timeout_s
            reqs.append(r)
        return reqs

    def pause(self):
        """Park the worker: requests queue up but no compute is consumed."""
        if not self._paused.is_set():
            self._paused.set()
            self._resume.clear()
            self._put_wake()         # wake a collector blocked on get()

    def resume(self):
        if self._paused.is_set():
            self._paused.clear()
            self._resume.set()

    def _bucket_for(self, n: int) -> int:
        # scan the precomputed ladder: no per-dispatch allocation
        for b in self.buckets:
            if b >= n:
                return b
        return self.max_batch

    def _take_buffer(self, bucket: int, shape: tuple, dtype
                     ) -> Tuple[tuple, torch.Tensor]:
        """Pop a pre-allocated staging buffer for one bucket (allocate only
        on first use; the completer gives it back once the batch is ready).
        On the card it is pinned host memory, so the batch's copy to the
        device does not block the collector."""
        key = (bucket, tuple(shape), np.dtype(dtype).str)
        with self._pad_lock:
            pool = self._pad_pool.setdefault(key, [])
            if pool:
                return key, pool.pop()
        tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
        return key, torch.zeros((bucket,) + tuple(shape), dtype=tdtype,
                                pin_memory=self.device.type == "cuda")

    def _give_buffer(self, key: tuple, buf: torch.Tensor):
        with self._pad_lock:
            self._pad_pool[key].append(buf)

    def _dispatch(self, reqs: List[Request]) -> _InFlight:
        """Stack + pad to the nearest bucket and enqueue the forward."""
        xs = [np.asarray(r.x) for r in reqs]
        n = len(xs)
        bucket = self._bucket_for(n)
        buf_key, buf = self._take_buffer(bucket, xs[0].shape, xs[0].dtype)
        host = buf.numpy()       # shares the (pinned) buffer's memory
        for i, x in enumerate(xs):
            host[i] = x
        if n < bucket:
            host[n:] = 0
        spec = self.active_spec
        key = (spec, bucket)
        fn = self.executable(spec, bucket)
        if key not in self._compiled:
            self.cold_compiles += 1
            self._compiled.add(key)
        hw = getattr(self.active_point, "hw_state", None) \
            or hm.HwState(chips=1, freq=1.0)
        t_disp = time.perf_counter()
        out = fn(self.params, self._to_device(buf))   # enqueued, not waited
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        return _InFlight(out=out, ready=ready, reqs=reqs, t_dispatch=t_disp,
                         hw=hw, subnet=spec.name(), buf_key=buf_key, buf=buf,
                         spec=spec, bucket=bucket)

    def _complete(self, item: _InFlight):
        """Resolve one in-flight batch: wait for the device, account the
        non-overlapping dispatch->ready interval, answer the futures."""
        if item.ready is not None:
            item.ready.synchronize()
        # numpy has no bfloat16: served logits are float32 rows
        out = item.out.float().cpu().numpy()
        if item.buf is not None:
            self._give_buffer(item.buf_key, item.buf)
            item.buf = None          # _complete_safe must not re-pool it
        t_ready = time.perf_counter()
        # clamp: completions can land out of order across the pipeline
        # (completer vs synchronous paths), and a stale _last_ready past
        # t_ready would otherwise integrate NEGATIVE busy time/energy
        dt = max(0.0, t_ready - max(item.t_dispatch, self._last_ready))
        self._last_ready = max(self._last_ready, t_ready)
        if dt > 0:
            self.busy_s += dt
            self.measured_energy_mj += hm.slice_power_w(item.hw) * dt * 1e3
        for i, r in enumerate(item.reqs):
            r.future.put({"y": out[i],
                          "latency_ms": (t_ready - r.t_submit) * 1e3,
                          "subnet": item.subnet})
            with self._acct_lock:
                self._outstanding = max(0, self._outstanding - 1)
        self.served += len(item.reqs)

    def _complete_safe(self, item: _InFlight):
        """_complete, never letting an exception kill the thread: a failed
        batch (device error, bad input shape) resolves its futures with an
        error payload instead of wedging callers forever."""
        try:
            self._complete(item)
        except Exception as e:  # noqa: BLE001 - resolve, don't wedge
            if item.buf is not None:    # not yet returned by _complete
                self._give_buffer(item.buf_key, item.buf)
                item.buf = None
            for r in item.reqs:
                if r.future.empty():
                    self._cancel(r, f"batch failed: {e!r}")

    def _completion_loop(self):
        while True:
            item = self._completions.get()
            if item is None:
                break
            self._complete_safe(item)

    def _serve_loop(self, constraints_fn=None, govern_every: int = 4):
        n_batches = 0
        carry: List[Request] = []    # batch formed, then pause/stop landed
        while not self._stop.is_set():
            if self._paused.is_set():
                self._resume.wait()  # repro: allow-wait(no spin; audited: resume() AND stop() both set _resume)
                continue
            # serve a carried-over batch first: requests must not be
            # re-queued behind later submissions (FIFO across a pause)
            reqs = carry or self._collect_batch()
            carry = []
            if self._stop.is_set():
                carry = reqs             # requeued below; stop() cancels
                break
            if self._paused.is_set():
                carry = reqs
                continue
            if not reqs:
                continue
            if self.governor is not None and constraints_fn is not None \
                    and n_batches % govern_every == 0:
                c = constraints_fn()
                point = self.governor.select(c)
                if point.subnet != self.active_spec:
                    self.switch(point.subnet, point)
                else:
                    self.active_point = point
            try:
                item = self._dispatch(reqs)
            except Exception as e:  # noqa: BLE001 - resolve, don't wedge
                for r in reqs:
                    self._cancel(r, f"dispatch failed: {e!r}")
                continue
            if self.pipeline:
                # bounded handoff: batch N+1 stacks while N is on device
                self._completions.put(item)
            else:
                self._complete_safe(item)
            n_batches += 1
        for r in carry:                  # stop() drains and cancels these
            self._queue.put(r)

    @property
    def is_running(self) -> bool:
        return self._worker is not None and self._worker.is_alive()

    def start(self, constraints_fn=None, govern_every: int = 4):
        self._stop.clear()
        self._paused.clear()
        self._resume.set()
        self._draining = False
        self._fail_reason = None
        self._last_ready = 0.0
        if self.pipeline:
            self._completions = queue.Queue(maxsize=self.pipeline_depth)
            self._completer = threading.Thread(target=self._completion_loop,
                                               daemon=True)
            self._completer.start()
        self._worker = threading.Thread(
            target=self._serve_loop, args=(constraints_fn, govern_every),
            daemon=True)
        self._worker.start()

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Graceful node-drain handoff: refuse new work, let the backlog
        resolve, then stop.

        New submits resolve immediately with a ``"server draining"``
        payload (the cluster router stops sending them first); everything
        already accepted is served.  Returns True when the backlog fully
        resolved inside the timeout — False means leftovers were cancelled
        by :meth:`stop` (e.g. the server was paused/starved the whole
        time).
        """
        self._draining = True
        deadline = time.perf_counter() + timeout_s
        while self.outstanding() and time.perf_counter() < deadline:
            time.sleep(0.005)
        drained = self.outstanding() == 0
        self.stop()
        return drained

    def kill(self, reason: str = "node failed"):
        """Fail-stop: everything queued (and every racing submit) resolves
        with an error payload carrying ``reason`` — no caller ever hangs
        on a dead node.  Batches already on the device still complete and
        answer normally (fail-stop kills the node, not physics)."""
        self._fail_reason = reason
        self.stop()

    def stop(self):
        self._stop.set()
        self._resume.set()               # unpark a paused worker
        self._put_wake()                 # wake a collector blocked on get()
        worker_alive = False
        if self._worker:
            self._worker.join(timeout=60)
            worker_alive = self._worker.is_alive()
            if not worker_alive:
                self._worker = None
        if self._completer and not worker_alive:
            # the collector is joined: every dispatched batch is already in
            # the completion queue, so the sentinel lands after all of them.
            # If the worker is somehow still wedged in an in-flight dispatch
            # we leave the (daemon) pipeline running instead — its futures
            # still resolve when the device returns, and the worker exits on
            # its own once it observes _stop.
            self._completions.put(None)
            self._completer.join(timeout=5)
            self._completer = None
        # drain abandoned requests: their futures must resolve or callers
        # blocked on fut.get() hang forever (paused/never-started servers
        # accumulate queued work; the worker is joined, and a submit()
        # racing this drain re-drains after its own put)
        self._drain_queue()
