"""Compile a :class:`Scenario` into timeline queries + primitive events.

One :class:`ChaosTimeline` serves both consumers:

* the virtual-time simulator polls the CONTINUOUS overlays each epoch —
  :meth:`latency_mult` (stragglers), :meth:`throttle` (thermal DVFS
  ladder) and :meth:`partitioned` (router→node edge down) — and merges
  the DISCRETE events (:meth:`lifecycle`) into its existing
  ``fail_at``/``drain_at``/``wedge_at`` scripting, so chaos rides the
  exact failover machinery operators script by hand;
* the live :class:`~repro_torch.chaos.live.ChaosController` walks
  :meth:`events` — every injection flattened to timestamped primitive
  state changes (including the *ends* of windows and each thermal
  ladder step) — and applies them to a real cluster on the wall clock.

Both views are derived from the same frozen scenario, which is what
makes a simulated chaos day and its live rehearsal the same experiment.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from repro_torch.chaos.scenario import (FAIL_STOP, PARTITION, RACK_FAIL,
                                  SPOT_PREEMPT, STRAGGLER, THERMAL, WEDGE,
                                  Injection, Scenario)

# primitive live/lifecycle actions a scenario compiles down to
FAIL = "fail"
DRAIN = "drain"            # spot-preemption notice: stop routing, serve out
WEDGE_ON = "wedge_on"
STRAGGLE_ON = "straggle_on"
STRAGGLE_OFF = "straggle_off"
THROTTLE = "throttle"      # one thermal ladder step (value carried)
PARTITION_ON = "partition_on"
PARTITION_OFF = "partition_off"


class ChaosTimeline:
    """Deterministic query/event view of one scenario."""

    def __init__(self, scenario: Scenario,
                 node_names: Sequence[str]):
        known = set(node_names)
        for inj in scenario.injections:
            unknown = [n for n in inj.targets() if n not in known]
            if unknown:
                raise ValueError(f"injection {inj.kind!r}@{inj.t}: "
                                 f"unknown nodes {unknown}")
        self.scenario = scenario
        # windows per node for the continuous overlays
        self._stragglers: Dict[str, List[Tuple[float, float, float]]] = {}
        self._thermals: Dict[str, List[Injection]] = {}
        self._partitions: Dict[str, List[Tuple[float, float]]] = {}
        for inj in scenario.injections:
            if inj.kind == STRAGGLER:
                self._stragglers.setdefault(inj.node, []).append(
                    (inj.t, inj.t + inj.duration_s, inj.factor))
            elif inj.kind == THERMAL:
                self._thermals.setdefault(inj.node, []).append(inj)
            elif inj.kind == PARTITION:
                self._partitions.setdefault(inj.node, []).append(
                    (inj.t, inj.t + inj.duration_s))

    # --- continuous overlays (sim polls these each epoch) -------------------

    def latency_mult(self, node: str, t: float) -> float:
        """Product of active straggler slowdowns on ``node`` at ``t``."""
        mult = 1.0
        for t0, t1, factor in self._stragglers.get(node, ()):
            if t0 <= t < t1:
                mult *= factor
        return mult

    def throttle(self, node: str, t: float) -> float:
        """Thermal DVFS throttle at ``t``: the ladder value of the
        deepest active thermal window (1.0 = full frequency; the node
        recovers the instant its window ends)."""
        val = 1.0
        for inj in self._thermals.get(node, ()):
            if inj.t <= t < inj.t + inj.duration_s and inj.ladder:
                frac = (t - inj.t) / max(inj.duration_s, 1e-9)
                idx = min(int(frac * len(inj.ladder)), len(inj.ladder) - 1)
                val = min(val, inj.ladder[idx])
        return val

    def partitioned(self, node: str, t: float) -> bool:
        """Is the router→``node`` edge down at ``t``?  The node keeps
        serving its queue — only NEW routes are blocked."""
        return any(t0 <= t < t1
                   for t0, t1 in self._partitions.get(node, ()))

    # --- discrete lifecycle events (sim merges into fail/drain/wedge) -------

    def lifecycle(self) -> List[Tuple[float, str, str]]:
        """``(t, FAIL|DRAIN|WEDGE_ON, node)`` — the fail-stop family,
        expanded: a rack failure is N simultaneous fails, a spot
        preemption is a drain notice followed by a fail."""
        out: List[Tuple[float, str, str]] = []
        for inj in self.scenario.injections:
            if inj.kind in (FAIL_STOP, RACK_FAIL):
                out.extend((inj.t, FAIL, nn) for nn in inj.targets())
            elif inj.kind == WEDGE:
                out.append((inj.t, WEDGE_ON, inj.node))
            elif inj.kind == SPOT_PREEMPT:
                out.append((inj.t, DRAIN, inj.node))
                out.append((inj.t + inj.notice_s, FAIL, inj.node))
        return sorted(out)

    # --- flattened primitive timeline (live controller walks this) ----------

    def events(self) -> List[Tuple[float, str, str, float]]:
        """Every state change as ``(t, action, node, value)`` — window
        ends and thermal ladder steps included, time-sorted."""
        out: List[Tuple[float, str, str, float]] = [
            (t, action, nn, 0.0) for t, action, nn in self.lifecycle()]
        for nn, wins in self._stragglers.items():
            for t0, t1, factor in wins:
                out.append((t0, STRAGGLE_ON, nn, factor))
                out.append((t1, STRAGGLE_OFF, nn, 1.0))
        for nn, injs in self._thermals.items():
            for inj in injs:
                step = inj.duration_s / max(len(inj.ladder), 1)
                for i, val in enumerate(inj.ladder):
                    out.append((inj.t + i * step, THROTTLE, nn, val))
                out.append((inj.t + inj.duration_s, THROTTLE, nn, 1.0))
        for nn, wins in self._partitions.items():
            for t0, t1 in wins:
                out.append((t0, PARTITION_ON, nn, 0.0))
                out.append((t1, PARTITION_OFF, nn, 1.0))
        return sorted(out)
