"""Chrome trace-event / Perfetto JSON export of a span buffer.

:func:`to_chrome_trace` turns a :class:`~repro_torch.obs.trace.Tracer` (or a
plain span list) into the Trace Event Format dict that
https://ui.perfetto.dev and ``chrome://tracing`` load directly: every
span becomes a complete ("ph": "X") event, request trees get one track
(tid) per request grouped under their node's process (pid), decision
spans share a per-node "decisions" track, and metadata events name the
tracks.  Timestamps are rebased to the earliest span so virtual-time
traces (which start near t=0 anyway) and wall-clock traces (which start
at an arbitrary perf_counter origin) render identically.

``json.loads(json.dumps(to_chrome_trace(tracer)))`` round-trips by
construction — the export tests assert it, and ``launch/serve.py
--trace-out`` writes exactly this object.

The span→event conversion lives in :class:`EventBuilder`, which keeps
its pid/tid naming state across calls — the streaming exporter
(:class:`repro_torch.obs.stream.TraceStreamer`) feeds it one retired
request at a time and appends the events incrementally in the **JSON Array
Format** (``[`` then one ``{event},`` per line): the trace-event spec
allows the closing ``]`` to be absent, so a truncated or still-growing
stream file loads in Perfetto as-is.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Union

from repro_torch.obs.trace import DECISION_SPANS, Span, Tracer

_DECISION_TID = 0          # per-process track for decision spans
_REQUEST_TID_BASE = 1      # request tracks start above it


def _spans_of(source: Union[Tracer, Iterable[Span]]) -> List[Span]:
    if isinstance(source, Tracer):
        return source.spans()
    return list(source)


class EventBuilder:
    """Incremental span → trace-event conversion.

    Sticky state (process ids per node, thread ids per trace, the time
    base) lives here so the one-shot exporter and the incremental
    streamer emit identical events: metadata events are interleaved
    exactly where a pid/tid is first seen.
    """

    def __init__(self, t_base: float = 0.0):
        self.t_base = t_base
        self.pids: Dict[str, int] = {}
        self.tids: Dict[int, int] = {}

    def _pid_of(self, node, out: List[dict]) -> int:
        name = node or "node"
        if name not in self.pids:
            self.pids[name] = len(self.pids) + 1
            out.append({"ph": "M", "name": "process_name",
                        "pid": self.pids[name], "tid": 0,
                        "args": {"name": name}})
            out.append({"ph": "M", "name": "thread_name",
                        "pid": self.pids[name], "tid": _DECISION_TID,
                        "args": {"name": "decisions"}})
        return self.pids[name]

    def _tid_of(self, span: Span, out: List[dict]) -> int:
        if span.name in DECISION_SPANS or span.trace_id < 0:
            return _DECISION_TID
        if span.trace_id not in self.tids:
            self.tids[span.trace_id] = _REQUEST_TID_BASE + len(self.tids)
            out.append({"ph": "M", "name": "thread_name",
                        "pid": self._pid_of(span.node, out),
                        "tid": self.tids[span.trace_id],
                        "args": {"name": f"req {span.trace_id}"
                                         f" [{span.cls}]"}})
        return self.tids[span.trace_id]

    def events_for(self, span: Span,
                   links: Sequence[int] = ()) -> List[dict]:
        """The events one span contributes: any first-seen pid/tid
        metadata, then the complete ("X") event itself."""
        out: List[dict] = []
        args = {"cls": span.cls, "trace_id": span.trace_id}
        if links:
            args["links"] = list(links)
        args.update(span.attrs)
        out.append({
            "ph": "X",
            "name": span.name,
            "cat": ("decision"
                    if span.name in DECISION_SPANS or span.trace_id < 0
                    else "request"),
            "pid": self._pid_of(span.node, out),
            "tid": self._tid_of(span, out),
            # trace-event timestamps are microseconds
            "ts": round((span.t0 - self.t_base) * 1e6, 3),
            "dur": round(max(span.t1 - span.t0, 0.0) * 1e6, 3),
            "args": {k: v for k, v in args.items() if v is not None},
        })
        return out


def to_chrome_trace(source: Union[Tracer, Iterable[Span]]) -> dict:
    """Trace-event dict (``{"traceEvents": [...], ...}``) for a span
    buffer.  Pure data in, pure data out — callers json.dump it."""
    spans = _spans_of(source)
    # span links (retry/hedge/preemption second attempts): carried on
    # every event of the linked trace so Perfetto shows which attempt
    # it follows
    links: Dict[int, List[int]] = {}
    if isinstance(source, Tracer):
        links = {tr.trace_id: list(tr.links)
                 for tr in source.requests() if tr.links}
    builder = EventBuilder(t_base=min((s.t0 for s in spans), default=0.0))
    events: List[dict] = []
    for s in spans:
        events.extend(builder.events_for(s, links=links.get(s.trace_id, ())))
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"source": "repro_torch.obs",
                          "span_count": len(spans)}}


def write_chrome_trace(source: Union[Tracer, Iterable[Span]],
                       path: str, *, ndjson: bool = False) -> int:
    """Write the Perfetto-loadable JSON to ``path``; returns the event
    count (``serve.py --trace-out`` logs it).

    ``ndjson=True`` writes the incremental JSON Array Format instead —
    ``[`` then one event per line with a trailing comma, no closing
    ``]`` — byte-identical to what a streaming exporter
    appends live, and equally loadable in Perfetto."""
    doc = to_chrome_trace(source)
    with open(path, "w") as f:
        if ndjson:
            f.write("[\n")
            for ev in doc["traceEvents"]:
                f.write(json.dumps(ev, indent=None,
                                   separators=(",", ":")) + ",\n")
        else:
            json.dump(doc, f, indent=None, separators=(",", ":"))
    return len(doc["traceEvents"])


def iter_trace_events(path: str) -> Iterator[dict]:
    """Parse either export format back into events: the one-shot JSON
    object or the incremental array format (possibly truncated) — the
    streaming tests and offline tools read through this."""
    with open(path) as f:
        head = f.read(1)
        rest = f.read()
    text = head + rest
    if head == "{":
        for ev in json.loads(text)["traceEvents"]:
            yield ev
        return
    for line in text.splitlines():
        line = line.strip().rstrip(",")
        if not line or line in "[]":
            continue
        yield json.loads(line)
