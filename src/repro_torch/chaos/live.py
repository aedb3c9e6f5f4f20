"""Live chaos: replay a :class:`Scenario` against a real Cluster.

:class:`ChaosController` walks the scenario's flattened primitive
timeline (:meth:`repro_torch.chaos.engine.ChaosTimeline.events`) on the wall
clock (scaled by ``speed``) and perturbs the cluster through the same
surfaces an operator or the paper's runtime would:

* ``fail`` / ``drain``   — :meth:`Cluster.fail` / :meth:`Cluster.drain`
  (spot preemption = drain for the notice window, then fail);
* ``wedge_on``           — every replica server on the node wedges
  (:meth:`DynamicServer.wedge`: silently parked, ``resume()`` defeated)
  so only the stall health check can catch it;
* ``straggle_on/off``    — capacity multiplier on the node's hw state
  (``ClusterNode.chaos_capacity = 1/factor``): fewer effective chips,
  the arbiter re-water-fills onto slower points;
* ``throttle``           — thermal DVFS ladder via
  ``ClusterNode.chaos_throttle`` (filters the LUT to low-frequency
  points, exactly the paper's governor throttling);
* ``partition_on/off``   — router weight 0 on every (class, node) edge
  of the target node: no new routes, in-flight work still completes.

Every applied event is logged (``applied``), counted
(``chaos_injections_total``) and — when the cluster has a tracer —
emitted as a ``chaos`` decision span, so a live chaos day is observable
with the same vocabulary as the simulated one.
"""
from __future__ import annotations

import threading
import time
from typing import List, Tuple

from repro_torch.chaos import engine as ce
from repro_torch.chaos.engine import ChaosTimeline
from repro_torch.chaos.scenario import Scenario
from repro_torch.obs import trace as obs


class ChaosController:
    """Daemon thread applying one scenario to one live cluster."""

    def __init__(self, cluster, scenario: Scenario, *,
                 speed: float = 1.0):
        self.cluster = cluster
        self.scenario = scenario
        self.speed = speed
        self.timeline = ChaosTimeline(scenario, list(cluster.nodes))
        self.applied: List[Tuple[float, str, str]] = []
        self._partitioned: dict = {}   # node -> [(cls, node)] weights set
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # --- lifecycle ----------------------------------------------------------

    def start(self) -> "ChaosController":
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()

    def join(self, timeout_s: float = 30.0):
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)

    @property
    def done(self) -> bool:
        return self._thread is not None and not self._thread.is_alive()

    # --- the injection loop -------------------------------------------------

    def _loop(self):
        t0 = time.perf_counter()
        for t, action, nn, value in self.timeline.events():
            wait = t / self.speed - (time.perf_counter() - t0)
            if wait > 0 and self._stop.wait(wait):
                return
            if self._stop.is_set():
                return
            try:
                self._apply(action, nn, value)
            except Exception:   # noqa: BLE001 — chaos must not kill chaos
                continue
            self.applied.append((t, action, nn))
            self.cluster.metrics.counter("chaos_injections_total",
                                         kind=action).inc()
            if self.cluster.tracer is not None:
                tw = time.perf_counter()
                self.cluster.tracer.decision(obs.CHAOS, tw, tw, node=nn,
                                             kind=action)

    def _apply(self, action: str, nn: str, value: float):
        cluster, node = self.cluster, self.cluster.nodes[nn]
        if action == ce.FAIL:
            cluster.fail(nn, reason=f"chaos: {self.scenario.name} "
                                    f"fail-stop on {nn}")
        elif action == ce.DRAIN:
            # spot-preemption notice: drain in the background for the
            # notice window; the scheduled FAIL lands regardless
            threading.Thread(target=cluster.drain, args=(nn,),
                             kwargs=dict(timeout_s=30.0),
                             daemon=True).start()
        elif action == ce.WEDGE_ON:
            for server in node.servers.values():
                server.wedge()
        elif action == ce.STRAGGLE_ON:
            node.chaos_capacity = 1.0 / max(value, 1.0)
        elif action == ce.STRAGGLE_OFF:
            node.chaos_capacity = 1.0
        elif action == ce.THROTTLE:
            node.chaos_throttle = value
        elif action == ce.PARTITION_ON:
            edges = []
            for cls_name, placed in cluster.placements_snapshot().items():
                if nn in placed:
                    cluster.router.set_weight(cls_name, nn, 0.0)
                    edges.append(cls_name)
            self._partitioned[nn] = edges
        elif action == ce.PARTITION_OFF:
            for cls_name in self._partitioned.pop(nn, ()):
                cluster.router.set_weight(cls_name, nn, None)
