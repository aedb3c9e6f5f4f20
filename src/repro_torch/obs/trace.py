"""Per-request span trees with a fixed vocabulary + tail-biased retention.

One :class:`Tracer` serves every layer of the stack (engine → arbiter →
cluster) in BOTH time domains: the live path records wall-clock spans
through the injectable ``clock``, and the virtual-time simulators
(:func:`repro_torch.traffic.driver.simulate`,
:func:`repro_torch.cluster.sim.simulate_cluster`) pass explicit virtual
timestamps — the span *schema* is identical either way, which is what
makes a simulated tail request directly comparable to a live one (and
what the sim-vs-live parity tests assert).

The port's copy of the reference ``obs/trace.py``: :data:`SCHEMA` and every
kind string are identical to the reference's, so the project lint's
span-schema rule holds the port's call sites to the same vocabulary.

**Span vocabulary** (fixed — :data:`SCHEMA` maps each name to the attr
keys it must carry):

* request path (device layer, one tree per request)::

      request -> route -> queue -> collect -> stack -> dispatch
              -> device -> complete          (+ warming when a request
                                              waited out a replica warmup)

* decision spans (runtime / cluster layers): ``arbitrate``,
  ``rebalance``, ``migrate`` (with its real warmup duration),
  ``preempt``, ``scale``, ``health_fail``.

**Retention** is bounded and tail-biased: finished request trees land in
a fixed-capacity buffer that always keeps the globally slowest
``tail_frac`` share (a min-heap on total latency — the p99 outlier that
motivated the trace is never evicted) plus a seeded uniform reservoir
sample of the rest, so percentile *decomposition* stays honest while
memory stays O(capacity).  Decision spans go to a separate capped deque
with a ``decisions_dropped`` counter (the engine's ``switch_log`` idiom).

Overhead: recording is a handful of dataclass constructions and one
lock acquisition per finished request (the engine batches a request's
whole span list into a single call); with no tracer attached the
instrumented code paths do nothing.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import random
import threading
import time
from typing import Deque, Dict, Iterable, List, Optional, Sequence, Tuple

# --- span vocabulary (fixed) -------------------------------------------------

# request path, in causal order
REQUEST = "request"     # the root: submit -> future resolved
ROUTE = "route"         # cluster router pick (absent on single-node paths)
QUEUE = "queue"         # waiting for the collector / a slice / busy server
COLLECT = "collect"     # the batching window held open
STACK = "stack"         # host-side pad/stack into the bucket buffer
DISPATCH = "dispatch"   # async device enqueue call
DEVICE = "device"       # dispatch returned -> outputs ready
COMPLETE = "complete"   # outputs ready -> futures resolved
WARMING = "warming"     # stalled behind a migrating replica's warmup

# decision spans (runtime / cluster layers)
ARBITRATE = "arbitrate"
REBALANCE = "rebalance"
MIGRATE = "migrate"
PREEMPT = "preempt"
SCALE = "scale"
HEALTH_FAIL = "health_fail"
CHAOS = "chaos"         # one injected fault landing (repro_torch.chaos)
BROWNOUT = "brownout"   # a class entering/exiting degraded-target mode

REQUEST_SPANS = (ROUTE, QUEUE, COLLECT, STACK, DISPATCH, DEVICE, COMPLETE,
                 WARMING)
DECISION_SPANS = (ARBITRATE, REBALANCE, MIGRATE, PREEMPT, SCALE, HEALTH_FAIL,
                  CHAOS, BROWNOUT)

# the latency components a request's measured latency decomposes into
# (COMPLETE is post-measurement: latency_ms is stamped when outputs are
# ready, before futures resolve, so it is excluded from the sum)
COMPONENTS = (ROUTE, QUEUE, COLLECT, STACK, DISPATCH, DEVICE, WARMING)

# span name -> attr keys every emitter (live or virtual-time) must carry.
# The sim-vs-live parity tests validate both sides against this table.
SCHEMA: Dict[str, Tuple[str, ...]] = {
    ROUTE: (),
    QUEUE: (),
    COLLECT: (),
    STACK: (),
    DISPATCH: (),
    DEVICE: ("bucket", "subnet", "n"),
    COMPLETE: (),
    WARMING: (),
    ARBITRATE: ("tenants", "granted"),
    REBALANCE: ("moves", "preemptions"),
    MIGRATE: ("src", "cost_s"),
    PREEMPT: ("for_cls",),
    SCALE: ("direction",),
    HEALTH_FAIL: (),
    CHAOS: ("kind",),
    BROWNOUT: ("direction",),
}


@dataclasses.dataclass
class Span:
    """One timed interval.  ``t0``/``t1`` are seconds on the tracer's
    clock (wall or virtual); ``cls``/``node`` are the fixed dimensions
    every span carries, ``attrs`` the per-name extras of :data:`SCHEMA`."""
    name: str
    t0: float
    t1: float
    trace_id: int = -1           # -1: decision span (no request tree)
    cls: Optional[str] = None
    node: Optional[str] = None
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def dur_ms(self) -> float:
        return (self.t1 - self.t0) * 1e3


@dataclasses.dataclass
class RequestTrace:
    """One request's span tree (flat list; the root interval is
    ``t0 -> t1`` and the children partition it by component)."""
    trace_id: int
    cls: str
    t0: float
    t1: float = 0.0
    node: Optional[str] = None
    spans: List[Span] = dataclasses.field(default_factory=list)
    # span links: trace_ids of CAUSALLY-PRIOR attempts of the same
    # request (a retried/hedged/preempted request's second attempt links
    # to its first instead of starting an unrelated trace) — carried
    # through the Perfetto export as event args
    links: List[int] = dataclasses.field(default_factory=list)

    @property
    def total_ms(self) -> float:
        """The measured request latency (submit -> outputs ready)."""
        return (self.t1 - self.t0) * 1e3

    def component_ms(self) -> Dict[str, float]:
        """Summed child-span duration per component name."""
        out: Dict[str, float] = {}
        for s in self.spans:
            if s.name in COMPONENTS:
                out[s.name] = out.get(s.name, 0.0) + s.dur_ms
        return out


class Tracer:
    """Bounded, thread-safe span recorder shared by live stack and sims.

    ``clock`` is injectable: the live path uses ``time.perf_counter``
    (the default) and calls that never pass explicit timestamps use it;
    the virtual-time simulators pass explicit ``t`` everywhere, so one
    tracer class serves both domains with one schema.

    ``cap`` bounds retained request trees; ``tail_frac`` of the capacity
    is reserved for the globally slowest requests (kept exactly, via a
    min-heap on total latency) and the rest holds a seeded uniform
    reservoir sample of the remainder — ``dropped`` counts evictions.
    """

    def __init__(self, *, clock=time.perf_counter, cap: int = 4096,
                 tail_frac: float = 0.05, decision_cap: int = 8192,
                 seed: int = 0):
        if cap < 2:
            raise ValueError("tracer cap must be >= 2")
        self.clock = clock
        self.cap = cap
        self.tail_cap = max(1, int(round(cap * tail_frac)))
        self.uniform_cap = max(1, cap - self.tail_cap)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._next_id = 0
        self._open: Dict[int, RequestTrace] = {}
        # slowest-K retention: min-heap of (total_ms, seq, trace)
        self._tail: List[Tuple[float, int, RequestTrace]] = []
        self._uniform: List[RequestTrace] = []
        self._nontail_seen = 0     # reservoir denominator
        self.finished = 0          # request trees ever completed
        self.aborted = 0           # begun but cancelled (shed/failed)
        self.dropped = 0           # finished trees evicted by sampling
        self.decision_cap = decision_cap
        self.decisions: Deque[Span] = collections.deque(maxlen=decision_cap)
        self.decisions_dropped = 0
        # retirement hook: called with each FINALIZED RequestTrace (every
        # finished tree, whether or not sampling keeps it) — the streaming
        # exporter attaches here.  Always invoked OUTSIDE the tracer lock:
        # the callback may do file IO or call back into the tracer.
        self.on_retire = None

    # --- request span trees --------------------------------------------------

    def begin_request(self, cls: str, *, t: Optional[float] = None,
                      node: Optional[str] = None,
                      links: Sequence[int] = ()) -> int:
        with self._lock:
            rid = self._next_id
            self._next_id += 1
            self._open[rid] = RequestTrace(
                trace_id=rid, cls=cls, node=node,
                t0=self.clock() if t is None else t,
                links=list(links))
            return rid

    def add_span(self, trace_id: int, name: str, t0: float, t1: float, *,
                 node: Optional[str] = None, **attrs):
        with self._lock:
            tr = self._open.get(trace_id)
            if tr is None:
                return   # request already ended/aborted: drop, don't raise
            tr.spans.append(Span(name=name, t0=t0, t1=t1, trace_id=trace_id,
                                 cls=tr.cls, node=node or tr.node,
                                 attrs=attrs))

    def end_request(self, trace_id: int, *, t: Optional[float] = None,
                    node: Optional[str] = None):
        """Finalize one tree at its MEASURED-latency instant (outputs
        ready); post-measurement spans (``complete``) may extend past
        ``t`` and are recorded before this call."""
        with self._lock:
            tr = self._open.pop(trace_id, None)
            if tr is None:
                return
            tr.t1 = self.clock() if t is None else t
            if node is not None:
                tr.node = node
            self._retain(tr)
            cb = self.on_retire
        if cb is not None:
            cb(tr)

    def finish_request(self, trace_id: int, *, t: Optional[float] = None,
                       node: Optional[str] = None,
                       spans: Sequence[Tuple[str, float, float,
                                             Optional[dict]]] = ()):
        """Append a request's remaining spans AND finalize it under one
        lock acquisition — the engine's completer calls this once per
        request instead of ``add_span`` × N + ``end_request``."""
        with self._lock:
            tr = self._open.pop(trace_id, None)
            if tr is None:
                return
            if node is not None:
                tr.node = node
            for name, s0, s1, attrs in spans:
                tr.spans.append(Span(name=name, t0=s0, t1=s1,
                                     trace_id=trace_id, cls=tr.cls,
                                     node=tr.node, attrs=dict(attrs or {})))
            tr.t1 = self.clock() if t is None else t
            self._retain(tr)
            cb = self.on_retire
        if cb is not None:
            cb(tr)

    def abort_request(self, trace_id: int, *, t: Optional[float] = None,
                      retain: bool = False):
        """Forget a begun request that will never complete (shed, failed,
        cancelled) — aborted trees never enter the buffer.

        ``retain=True`` instead FINALIZES the partial tree at the cut
        instant (a closing ``queue`` span covers whatever the emitters
        had not stamped yet, so the decomposition still sums) and keeps
        it — a preempted request's first attempt must stay resolvable
        when its second attempt links back to it."""
        cb = tr = None
        with self._lock:
            tr = self._open.pop(trace_id, None)
            if tr is None:
                return
            self.aborted += 1
            if not retain:
                return
            cut = self.clock() if t is None else t
            last = max((s.t1 for s in tr.spans), default=tr.t0)
            tr.t1 = max(cut, last)
            tr.spans.append(Span(name=QUEUE, t0=last, t1=tr.t1,
                                 trace_id=trace_id, cls=tr.cls,
                                 node=tr.node, attrs={"aborted": True}))
            self._retain(tr)
            cb = self.on_retire
        if cb is not None:
            cb(tr)

    def request(self, cls: str, t0: float, t1: float, *,
                node: Optional[str] = None,
                spans: Sequence[Tuple[str, float, float, Optional[dict]]] = (),
                links: Sequence[int] = ()) -> int:
        """One-shot: record a whole finished request tree under a single
        lock acquisition (the engine and the simulators batch through
        here — per-request tracing cost is one call).  ``links`` names
        causally-prior trace_ids (the first attempt a retry follows)."""
        with self._lock:
            rid = self._next_id
            self._next_id += 1
            tr = RequestTrace(trace_id=rid, cls=cls, t0=t0, t1=t1, node=node,
                              links=list(links))
            for name, s0, s1, attrs in spans:
                tr.spans.append(Span(name=name, t0=s0, t1=s1, trace_id=rid,
                                     cls=cls, node=node,
                                     attrs=dict(attrs or {})))
            self._retain(tr)
            cb = self.on_retire
        if cb is not None:
            cb(tr)
        return rid

    def _retain(self, tr: RequestTrace):
        """Tail-biased sampling: keep the slowest ``tail_cap`` requests
        exactly, reservoir-sample the rest into ``uniform_cap`` slots."""
        self.finished += 1
        entry = (tr.total_ms, self.finished, tr)
        if len(self._tail) < self.tail_cap:
            heapq.heappush(self._tail, entry)
            return
        if entry[:2] > self._tail[0][:2]:
            # slower than the current tail floor: it joins the tail and
            # the displaced request falls through to the uniform sample
            _, _, bumped = heapq.heapreplace(self._tail, entry)
        else:
            bumped = tr
        self._nontail_seen += 1
        if len(self._uniform) < self.uniform_cap:
            self._uniform.append(bumped)
            return
        j = self._rng.randrange(self._nontail_seen)
        if j < self.uniform_cap:
            self._uniform[j] = bumped
        self.dropped += 1

    # --- decision spans ------------------------------------------------------

    def decision(self, name: str, t0: Optional[float] = None,
                 t1: Optional[float] = None, *, cls: Optional[str] = None,
                 node: Optional[str] = None, **attrs) -> Span:
        if t0 is None:
            t0 = self.clock()
        if t1 is None:
            t1 = t0
        span = Span(name=name, t0=t0, t1=t1, cls=cls, node=node, attrs=attrs)
        with self._lock:
            if len(self.decisions) == self.decision_cap:
                self.decisions_dropped += 1   # deque evicts the oldest
            self.decisions.append(span)
        return span

    # --- reads ---------------------------------------------------------------

    def requests(self) -> List[RequestTrace]:
        """Retained request trees (tail + uniform sample), by start time."""
        with self._lock:
            out = [e[2] for e in self._tail] + list(self._uniform)
        return sorted(out, key=lambda tr: (tr.t0, tr.trace_id))

    def tail_requests(self) -> List[RequestTrace]:
        """The always-kept slowest share, slowest first."""
        with self._lock:
            entries = sorted(self._tail, reverse=True)
        return [e[2] for e in entries]

    def spans(self) -> List[Span]:
        """Every retained span (request children + decisions), by t0."""
        out: List[Span] = []
        for tr in self.requests():
            out.extend(tr.spans)
        with self._lock:
            out.extend(self.decisions)
        return sorted(out, key=lambda s: (s.t0, s.t1, s.name))

    def summary(self) -> dict:
        with self._lock:
            return {"finished": self.finished, "aborted": self.aborted,
                    "retained": len(self._tail) + len(self._uniform),
                    "dropped": self.dropped,
                    "decisions": len(self.decisions),
                    "decisions_dropped": self.decisions_dropped}


def validate_schema(spans: Iterable[Span]) -> List[str]:
    """Schema violations (unknown name / missing required attrs) in a
    span stream — empty list means the emitter conforms.  The parity
    tests run both the live and the virtual-time emitters through this.
    """
    problems = []
    for s in spans:
        if s.name not in SCHEMA:
            problems.append(f"unknown span name {s.name!r}")
            continue
        missing = [k for k in SCHEMA[s.name] if k not in s.attrs]
        if missing:
            problems.append(f"span {s.name!r} missing attrs {missing}")
    return problems
