"""Dynamic serving engine: the deployed half of the paper's system.

The port's counterpart of the reference ``runtime/engine.py``, on one
device (the CUDA card, or the CPU in tests).  It serves a supernet
through its Pareto sub-networks:

* an executable cache keyed by ``(SubnetSpec, batch bucket)`` — on the
  card each entry is a CUDA graph of the sub-network's forward over a
  static ``(bucket, ...)`` input (:class:`repro_torch.graphs.Graph`, the
  counterpart of the reference's ``jax.jit`` executable), captured at
  :meth:`DynamicServer.warm` or, cold, at first use; on the CPU an eager
  sliced-mode closure.  Every sub-network reads the SAME resident
  parameter tensors, so switching architectures costs one dictionary
  lookup (the Dynamic-OFA trick: weights stay resident, no
  re-deployment);
* **bucketed continuous batching**: a batch of ``k`` requests is padded
  only up to the nearest power-of-two bucket (1, 2, 4, ..., max_batch);
  per-bucket pad buffers (pinned host memory on the card) are pooled so
  the steady state does zero host allocation, and
  :meth:`DynamicServer.warm` captures (on the CPU: runs) the whole bucket
  ladder so serving meets no cold ``(spec, bucket)`` (``cold_compiles``
  counts the serve-path dispatches that had to capture);
* **pipelined dispatch**: a *collector* thread stacks batch N+1, copies it
  to the device and enqueues its forward while a *completer* thread waits
  on batch N's CUDA event and resolves its futures.  ``pipeline_depth``
  bounds how far the collector may run ahead; ``busy_s``/
  ``measured_energy_mj`` integrate non-overlapping dispatch→ready
  intervals so accounting stays correct under overlap;
* the runtime governor in the loop: every ``govern_every`` batches it
  re-reads the performance target + hardware state and may switch the
  active sub-network and the (modelled) DVFS point;
* wall-clock measurement hooks that feed the measured LUT, and — with a
  :class:`repro_torch.runtime.telemetry.CalibrationStore` attached — the
  CLOSED measurement loop: every completed batch records its
  dispatch→ready latency under its ``(SubnetSpec, bucket)`` executable
  key and its measured energy/busy under the server's tenant label, the
  numbers the LUT columns and the arbiter's energy objective then plan
  off.

Served logits are float32 numpy rows (numpy has no bfloat16; the
reference's bf16 ``y`` is an ml_dtypes array).  On the card a dispatch
copies the pinned batch into the graph's static input, replays the graph
and copies its logits into the batch's own tensor, all on one stream and
before the batch's ``ready`` event, so a later replay of the same graph
cannot overwrite logits not yet read; the request tracer's ``dispatch``
span holds the host's time to enqueue them and ``device`` what the
device still had to do after it.  :meth:`DynamicServer.infer` and :meth:`measure` go through
the graph of the batch's bucket, so the measured LUT times what serving
runs, as the reference's ``measure`` times a compiled executable.  The chaos
hooks :meth:`DynamicServer.wedge`/``unwedge`` park the worker silently
(the failure only the cluster's stall health check can see).

The worker blocks on the request queue and on pause/resume events (no
polling): an idle or paused server burns no CPU and wakes immediately.
"""
from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from typing import (Any, Callable, Deque, Dict, List, Optional, Sequence,
                    Set, Tuple)

import numpy as np
import torch

from repro_torch.analysis.guards import guarded_by
from repro_torch.core.elastic import spec_to_static
from repro_torch.core.types import SubnetSpec
from repro_torch.device import resolve_device, synchronize
from repro_torch.graphs import Graph, new_pool, pool_bytes
from repro_torch.obs import trace as obs
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
    trace_id: Optional[int] = None   # obs: span tree begun upstream
    t_take: float = 0.0              # obs: collector pulled it off the queue


@dataclasses.dataclass
class _InFlight:
    """One dispatched batch travelling from collector to completer."""
    out: Any                   # the batch's own device tensor (enqueued)
    ready: Any                 # CUDA event recorded after the forward|None
    reqs: List[Request]
    t_dispatch: float
    hw: Any                    # HwState active at dispatch
    subnet: str
    buf_key: tuple             # pad-buffer pool slot to recycle when ready
    buf: Optional[torch.Tensor]  # None once returned to the pool
    spec: SubnetSpec = SubnetSpec()   # calibration key: the dispatched
    bucket: int = 0                   # (SubnetSpec, bucket) executable
    t_collect: float = 0.0     # obs: batch window closed (stacking starts)
    t_disp_ret: float = 0.0    # obs: the forward's issuing call returned


@guarded_by("_wake_lock", "_wake_tokens")
@guarded_by("_acct_lock", "_outstanding", "_arrivals")
class DynamicServer:
    def __init__(self, apply_fn: Callable, params, dims: Dict[str, int], *,
                 governor=None, max_batch: int = 8, timeout_ms: float = 5.0,
                 multiple_of: int = 1,
                 warm_specs: Optional[List[SubnetSpec]] = None,
                 batch_buckets: bool = True, pipeline: bool = True,
                 pipeline_depth: int = 2, example_input=None,
                 switch_log_cap: int = 1024,
                 adaptive_window: bool = False,
                 min_window_ms: float = 0.5,
                 calibration=None, tenant: Optional[str] = None,
                 tracer=None, metrics=None, device=None):
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

        ``adaptive_window=True`` sizes the batching window from the
        arrival-rate EWMA the arbiter tracks: under load the collector
        holds the window open only about one expected inter-arrival time
        (floored at ``min_window_ms``), when traffic is sparse it keeps
        the full ``timeout_ms``.

        ``calibration`` (a :class:`repro_torch.runtime.telemetry
        .CalibrationStore`) closes the measurement loop: every completed
        batch records its dispatch→ready latency under its
        ``(SubnetSpec, bucket)`` key, and — when ``tenant`` names this
        server's workload — its measured energy/busy integral.

        ``tracer`` (a :class:`repro_torch.obs.Tracer`) records each
        request's span tree — queue / collect / stack / dispatch / device
        / complete — into the shared buffer; upstream layers (the traffic
        driver) begin the trace with the SLO class and pass ``trace_id``
        to :meth:`submit`, or the engine begins its own under the tenant
        label.  ``metrics`` (a :class:`repro_torch.obs.MetricsRegistry`)
        gets served/cancelled counters and a request-latency histogram.
        Both default to None = zero work on the hot path; the traffic
        driver also sets them post-construction.
        """
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
        # eager closure (the synchronous path on the CPU)
        self._cache: Dict[Tuple[SubnetSpec, Optional[int]], Any] = {}
        self._specs_cached: Set[SubnetSpec] = set()
        # (spec, bucket) pairs that have run (CPU) or been captured (card)
        self._compiled: Set[Tuple[SubnetSpec, int]] = set()
        self._cache_lock = threading.Lock()
        # the card: one graph memory pool and one capture stream for this
        # server's graphs, which replay on the caller's (current) stream
        self.graphs = self.device.type == "cuda"
        self._pool = new_pool() if self.graphs else None
        self._capture_stream = (torch.cuda.Stream(self.device)
                                if self.graphs else None)
        self.captures = 0         # graphs captured (warm, measure, cold)
        self._graph_of: Dict[Tuple[SubnetSpec, int], Graph] = {}
        # per-bucket pad-buffer free list (pinned host tensors on the card):
        # the completer recycles a buffer only after its batch left the
        # device, so the collector never rewrites memory an in-flight
        # non-blocking copy (or, on the CPU, the forward itself) still
        # reads.  Steady state: zero host allocation.
        self._pad_pool: Dict[Tuple[int, tuple, str], List[torch.Tensor]] = {}
        self._pad_lock = threading.Lock()
        self.adaptive_window = adaptive_window
        self.min_window_s = min_window_ms / 1e3
        self.calibration = calibration
        self.tenant = tenant
        self.tracer = tracer
        self.metrics = metrics
        self.trace_node: Optional[str] = None   # cluster sets the node label
        self._arrival_rate_rps = 0.0
        self._queue: "queue.Queue" = queue.Queue()
        # _WAKE entries in _queue (not real backlog); lock-protected because
        # pause()/stop() (arbiter clock, callers) and the worker all touch
        # it and queue_depth() feeds the arbiter's water-filling
        self._wake_tokens = 0     # guarded-by: _wake_lock
        self._wake_lock = threading.Lock()
        # unresolved futures + arrivals since the last arbiter pull; drain()
        # waits on _outstanding and the arbiter's EWMA feeds off
        # take_arrival_count()
        self._outstanding = 0     # guarded-by: _acct_lock
        self._arrivals = 0        # guarded-by: _acct_lock
        self._acct_lock = threading.Lock()
        self._draining = False
        self._fail_reason: Optional[str] = None
        self._completions: Optional["queue.Queue"] = None
        self._stop = threading.Event()
        self._paused = threading.Event()
        self._resume = threading.Event()
        self._resume.set()
        self._wedged = False   # chaos: resume() defeated until unwedge()
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

    def executable(self, spec: SubnetSpec, bucket: Optional[int] = None,
                   like: Optional[torch.Tensor] = None):
        """``fn(params, batch) -> device output`` for ``spec`` at ``bucket``.

        On the card, with a bucket, the forward's CUDA graph over a static
        input shaped and typed as ``like`` (a ``(bucket, ...)`` host batch),
        captured here at first use: ``fn`` copies the batch in, replays
        and returns a copy of the logits, all enqueued.  Otherwise an
        eager closure (the batch moved to the device first)."""
        # called from the worker thread AND synchronous infer()/measure()
        # callers
        with self._cache_lock:
            key = (spec, bucket)
            fn = self._cache.get(key)
            if fn is not None:
                return fn
            E = spec_to_static(spec, self.dims, self.multiple_of)
            apply_fn = self.apply_fn

            def eager(p, x, E=E):
                # inference mode is thread-local: enter it here, on
                # whichever thread (collector or caller) runs the forward
                with torch.inference_mode():
                    return apply_fn(p, x, E)

            if self.graphs and bucket is not None:
                if like is None or like.shape[0] != bucket:
                    raise ValueError(f"capturing {spec.name()} at bucket "
                                     f"{bucket} needs a ({bucket}, ...) "
                                     f"batch to shape its input")
                static_in = torch.zeros(like.shape, dtype=like.dtype,
                                        device=self.device)
                graph = Graph(lambda x: eager(self.params, x), [static_in],
                              pool=self._pool, stream=self._capture_stream)
                self.captures += 1
                self._graph_of[key] = graph
                self._compiled.add(key)
                fn = lambda p, x, g=graph: g.run(x)
            else:
                fn = lambda p, x: eager(p, self._to_device(x))
            self._cache[key] = fn
            self._specs_cached.add(spec)
            return fn

    def graph(self, spec: SubnetSpec, bucket: int) -> Optional[Graph]:
        """The captured graph serving ``spec`` at ``bucket`` (None if none:
        on the CPU, or not captured yet)."""
        with self._cache_lock:
            return self._graph_of.get((spec, bucket))

    def graph_pool_bytes(self) -> Optional[int]:
        """Device memory held by this server's graph pool (None on the
        CPU, or where the allocator's snapshot does not say)."""
        return pool_bytes(self._pool) if self.graphs else None

    def warm(self, specs: List[SubnetSpec], example_input=None):
        """Warm the bucket ladder for each spec, in a fixed order.

        With an example input (here or at construction) every (spec,
        bucket) executable is captured on the card (run once on the CPU),
        so the kernels are built and every shape has run before serving —
        after this, steady-state serving meets zero cold (spec, bucket)
        pairs (``cold_compiles`` stays 0) and zero host allocations (pad
        buffers are pre-pinned per bucket).  Without one, the CPU's
        closures are built and the card captures nothing (a graph needs
        its input's shape).
        """
        x1 = example_input if example_input is not None else self.example_input
        if x1 is not None:
            x1 = np.asarray(x1)
            self.example_input = x1
        for spec in specs:
            for b in self.buckets:
                if x1 is None:
                    if not self.graphs:
                        self.executable(spec, b)
                    continue
                key, buf = self._take_buffer(b, x1.shape, x1.dtype)
                buf.zero_()
                fn = self.executable(spec, b, like=buf)
                fn(self.params, buf)
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

    def _padded(self, x) -> Tuple[tuple, torch.Tensor, int]:
        """(pool key, pinned (bucket, ...) buffer holding ``x`` then zeros,
        rows of ``x``): the batch as serving pads it."""
        x = np.asarray(x)
        n = len(x)
        if n > self.max_batch:
            raise ValueError(f"batch of {n} over max_batch {self.max_batch}")
        bucket = self._bucket_for(n)
        key, buf = self._take_buffer(bucket, x.shape[1:], x.dtype)
        host = buf.numpy()
        host[:n] = x
        host[n:] = 0
        return key, buf, n

    def infer(self, x, spec: Optional[SubnetSpec] = None) -> torch.Tensor:
        """One synchronous forward of batch ``x``; returns the device output
        (on the card: the graph of ``x``'s bucket, its rows of ``x``)."""
        spec = spec or self.active_spec
        if not self.graphs:
            out = self.executable(spec)(self.params, x)
            synchronize(self.device)
            return out
        key, buf, n = self._padded(x)
        try:
            out = self.executable(spec, buf.shape[0], like=buf)(self.params,
                                                                buf)
            synchronize(self.device)
        finally:
            self._give_buffer(key, buf)
        return out[:n]

    def measure(self, spec: SubnetSpec, x, iters: int = 5) -> float:
        """Median wall-clock ms for one batch under ``spec`` (post-warmup),
        host-to-device copy of the batch included, as serving pays it: on
        the card a replay of the graph serving runs for ``x``'s bucket."""
        if self.graphs:
            key, buf, _ = self._padded(x)
            fn, x = self.executable(spec, buf.shape[0], like=buf), buf
        else:
            key, buf, fn = None, None, self.executable(spec)
        try:
            fn(self.params, x)
            synchronize(self.device)
            ts = []
            for _ in range(iters):
                t0 = time.perf_counter()
                fn(self.params, x)
                synchronize(self.device)
                ts.append((time.perf_counter() - t0) * 1e3)
        finally:
            if buf is not None:
                self._give_buffer(key, buf)
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
        if self.tracer is not None and r.trace_id is not None:
            # retain the partial tree: a retried attempt links back to this
            # trace_id, and a link whose target was popped from the buffer
            # can never resolve in the exported trace
            self.tracer.abort_request(r.trace_id, retain=True)
        if self.metrics is not None:
            # node label: engine series from different nodes must not
            # collide in a shared cluster registry
            self.metrics.counter("engine_cancelled_total",
                                 tenant=self.tenant or "default",
                                 node=self.trace_node or "").inc()
        with self._acct_lock:
            self._outstanding = max(0, self._outstanding - 1)

    def _stop_reason(self) -> str:
        return self._fail_reason or "server stopped"

    def submit(self, x, trace_id: Optional[int] = None,
               links: Sequence[int] = (), *,
               t_submit: Optional[float] = None) -> "queue.Queue":
        """Queue one request (one image, host array); the returned future
        resolves to ``{"y", "latency_ms", "subnet"}`` or a cancel payload.

        ``t_submit`` (a ``time.perf_counter()`` reading) is where an
        upstream layer handed the request over — the cluster front-end
        passes the end of its route span, so the span tree's components
        partition the request's latency with no gap between route and
        queue; now when None."""
        fut: "queue.Queue" = queue.Queue(maxsize=1)
        if t_submit is None:
            t_submit = time.perf_counter()
        if self.tracer is not None and trace_id is None:
            # standalone server: begin the tree here under the tenant label
            # (the cluster front-end begins it earlier, with the SLO class
            # and a route span, and hands us its trace_id).  ``links``
            # names prior attempts' trace_ids (retry/hedge).
            trace_id = self.tracer.begin_request(
                self.tenant or "default", t=t_submit, node=self.trace_node,
                links=links)
        # retry layers read the id back off the future to link attempts
        fut.trace_id = trace_id
        r = Request(x=x, t_submit=t_submit, future=fut, trace_id=trace_id)
        with self._acct_lock:
            self._outstanding += 1
            self._arrivals += 1
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

    def take_arrival_count(self) -> int:
        """Arrivals since the last call — the arbiter's EWMA input."""
        with self._acct_lock:
            n = self._arrivals
            self._arrivals = 0
            return n

    def note_arrival_rate(self, rps: float):
        """The arbiter pushes its smoothed per-tenant arrival rate here;
        the adaptive batching window is sized from it."""
        self._arrival_rate_rps = max(0.0, float(rps))

    def effective_timeout_s(self) -> float:
        """Current batching window: the expected inter-arrival time under
        load (floored at ``min_window_s``), the full ``timeout_s`` when
        sparse, and always ``timeout_s`` unless ``adaptive_window``."""
        rate = self._arrival_rate_rps
        if not self.adaptive_window or rate <= 0.0:
            return self.timeout_s
        return min(self.timeout_s, max(self.min_window_s, 1.0 / rate))

    def queue_depth(self) -> int:
        """Requests waiting for a batch (the arbiter's backlog signal)."""
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
                deadline = time.perf_counter() + self.effective_timeout_s()
            if self.tracer is not None:
                r.t_take = time.perf_counter()
            reqs.append(r)
        return reqs

    def pause(self):
        """Park the worker: requests queue up but no compute is consumed
        (the arbiter starves a workload this way — its slice is gone)."""
        if not self._paused.is_set():
            self._paused.set()
            self._resume.clear()
            self._put_wake()         # wake a collector blocked on get()

    def resume(self):
        if self._wedged:
            return   # a wedged worker silently ignores the arbiter
        if self._paused.is_set():
            self._paused.clear()
            self._resume.set()

    def wedge(self):
        """Chaos: silently hang the worker.  Requests keep queueing and
        the server stays registered/routable, but nothing completes and
        ``resume()`` is defeated until :meth:`unwedge` — the failure
        mode only the stall health check can see."""
        self._wedged = True
        self.pause()

    def unwedge(self):
        self._wedged = False
        self.resume()

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
        t_collect = time.perf_counter() if self.tracer is not None else 0.0
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
        cold = key not in self._compiled
        fn = self.executable(spec, bucket, like=buf)   # captures if cold
        if cold:
            self.cold_compiles += 1
            self._compiled.add(key)
        hw = getattr(self.active_point, "hw_state", None) \
            or hm.HwState(chips=1, freq=1.0)
        t_disp = time.perf_counter()
        # enqueued, not waited; on the card the graph's logits are copied
        # into this batch's own tensor before `ready` below
        out = fn(self.params, buf)
        t_ret = time.perf_counter() if self.tracer is not None else 0.0
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        return _InFlight(out=out, ready=ready, reqs=reqs, t_dispatch=t_disp,
                         hw=hw, subnet=spec.name(), buf_key=buf_key, buf=buf,
                         spec=spec, bucket=bucket, t_collect=t_collect,
                         t_disp_ret=t_ret)

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
        if self.calibration is not None:
            # dispatch→ready is the batch's effective service latency
            # (under pipeline overlap, and behind another tenant's batch on
            # the shared stream, it includes device queueing, which is
            # exactly what the replay simulator should price)
            self.calibration.note_latency(
                item.spec, item.bucket,
                (t_ready - item.t_dispatch) * 1e3,
                max_batch=self.max_batch)
            if self.tenant is not None and dt > 0:
                self.calibration.note_energy(
                    self.tenant, hm.slice_power_w(item.hw) * dt * 1e3, dt)
        for i, r in enumerate(item.reqs):
            r.future.put({"y": out[i],
                          "latency_ms": (t_ready - r.t_submit) * 1e3,
                          "subnet": item.subnet})
            with self._acct_lock:
                self._outstanding = max(0, self._outstanding - 1)
        self.served += len(item.reqs)
        if self.tracer is not None:
            # futures are already answered — tracing never delays callers.
            # Components partition submit→ready exactly, so the tree sums
            # to the measured latency; `complete` (ready→futures resolved)
            # is post-measurement and excluded from the total.
            t_done = time.perf_counter()
            dev_attrs = {"bucket": item.bucket, "subnet": item.subnet,
                         "n": len(item.reqs)}
            for r in item.reqs:
                if r.trace_id is None:
                    continue
                self.tracer.finish_request(
                    r.trace_id, t=t_ready, node=self.trace_node, spans=[
                        (obs.QUEUE, r.t_submit, r.t_take, None),
                        (obs.COLLECT, r.t_take, item.t_collect, None),
                        (obs.STACK, item.t_collect, item.t_dispatch, None),
                        (obs.DISPATCH, item.t_dispatch, item.t_disp_ret,
                         None),
                        (obs.DEVICE, item.t_disp_ret, t_ready, dev_attrs),
                        (obs.COMPLETE, t_ready, t_done, None)])
        if self.metrics is not None:
            tn = self.tenant or "default"
            nd = self.trace_node or ""
            self.metrics.counter("engine_served_total", tenant=tn,
                                 node=nd).inc(len(item.reqs))
            hist = self.metrics.histogram("engine_request_ms", tenant=tn,
                                          node=nd)
            for r in item.reqs:
                # exemplar: a p99 bucket names a concrete retained trace
                hist.observe((t_ready - r.t_submit) * 1e3,
                             exemplar=r.trace_id)

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
