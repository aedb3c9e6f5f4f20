"""Live Perfetto streaming: append spans to disk as requests retire.

The one-shot exporter (:func:`repro_torch.obs.export.write_chrome_trace`)
dumps whatever the tracer RETAINED at exit — bounded, but a crash loses
the run and a long soak only keeps the sample.  :class:`TraceStreamer`
instead hooks :attr:`Tracer.on_retire` and appends every finished
request's events the moment it retires, in the incremental JSON Array
Format (``[`` then one ``{event},`` per line, no closing ``]`` — the
trace-event spec tolerates the missing bracket, so the file loads in
Perfetto mid-run or after a crash).

The shared :class:`~repro_torch.obs.export.EventBuilder` keeps pid/tid
naming state across appends, so the streamed file and a one-shot
export of the same spans name their tracks identically.  Decision
spans are not retired through the hook; :meth:`close` flushes them
from the tracer at shutdown.

``serve.py --stream-trace PATH`` wires this up; the callback runs on
whatever thread retires the request (the engine's completer), so
writes go through one lock and an OS-buffered file handle — a handful
of microseconds per request, off the device-dispatch path.
"""
from __future__ import annotations

import json
import threading
from typing import Optional, Sequence

from repro_torch.obs.export import EventBuilder
from repro_torch.obs.trace import RequestTrace, Span, Tracer


class TraceStreamer:
    """Append-as-they-retire Perfetto stream over one tracer."""

    def __init__(self, path: str, *, t_base: Optional[float] = None):
        self.path = path
        self._f = open(path, "w")
        self._f.write("[\n")
        self._lock = threading.Lock()
        self._builder: Optional[EventBuilder] = (
            None if t_base is None else EventBuilder(t_base=t_base))
        self._tracer: Optional[Tracer] = None
        self.events = 0
        self.closed = False

    # --- wiring ------------------------------------------------------------

    def attach(self, tracer: Tracer) -> "TraceStreamer":
        """Start streaming ``tracer``'s retired requests (one streamer
        per tracer — the hook is a single slot)."""
        tracer.on_retire = self.on_retire
        self._tracer = tracer
        return self

    def on_retire(self, tr: RequestTrace):
        self._emit(tr.spans, links=tr.links)

    # --- writing -----------------------------------------------------------

    def _emit(self, spans: Sequence[Span], links: Sequence[int] = ()):
        with self._lock:
            if self.closed:
                return
            for s in spans:
                if self._builder is None:
                    # rebase on the first span seen, like the one-shot
                    # exporter rebases on the earliest span
                    self._builder = EventBuilder(t_base=s.t0)
                for ev in self._builder.events_for(s, links=links):
                    self._f.write(json.dumps(ev, indent=None,
                                             separators=(",", ":"))
                                  + ",\n")
                    self.events += 1
            self._f.flush()

    def close(self, tracer: Optional[Tracer] = None) -> int:
        """Flush decision spans (they have no retire event), detach,
        and close the file; returns the total event count."""
        tracer = tracer if tracer is not None else self._tracer
        if tracer is not None:
            with tracer._lock:
                decisions = list(tracer.decisions)
            self._emit(decisions)
            if tracer.on_retire == self.on_retire:
                tracer.on_retire = None
        with self._lock:
            if not self.closed:
                self.closed = True
                self._f.close()
        return self.events
