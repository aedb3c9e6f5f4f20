"""Cluster request routing: round-robin, least-loaded, power-of-two.

The router spreads ONE SLO class's traffic across the nodes where that
class is placed.  Three policies, all deterministic under a fixed seed:

* ``round_robin``   — cycle the routable placements; ignores load.  The
  baseline: under skewed node capacity it keeps feeding the slow node
  its full share and the slow node's queue (and the class p95) explodes;
* ``least_loaded``  — always the minimum :meth:`ClusterNode.load`
  (backlog per chip).  Optimal signal use, but every front-end choosing
  the same minimum herds onto one node between signal refreshes;
* ``p2c``           — power-of-two-choices (Mitzenmacher 2001): sample
  two distinct candidates with a seeded rng, send to the less loaded.
  Near-least-loaded tail behaviour without the herding, and the default.

The placement engine steers traffic with **weight hints**
(:meth:`ClusterRouter.set_weight`): a per-(class, node) multiplier on
the load signal's attractiveness.  Weight 0 takes a replica out of
rotation entirely — how a WARMING replica (mid-migration or a freshly
spun-up node) avoids traffic until its weights have transferred and its
buckets are compiled — and weights scale the compared load otherwise
(weight 2 looks half as loaded).  Round-robin honours only the
in/out-of-rotation part.
"""
from __future__ import annotations

import collections
from typing import Callable, Deque, Optional, Sequence, Tuple

import numpy as np

from repro_torch.cluster.node import ClusterNode
from repro_torch.obs.metrics import MetricsRegistry

P2C = "p2c"
LEAST_LOADED = "least_loaded"
ROUND_ROBIN = "round_robin"
ROUTERS = (P2C, LEAST_LOADED, ROUND_ROBIN)


class ClusterRouter:
    """Per-class routing decisions over routable placements.

    ``decisions`` logs every pick as ``(t, class, node)`` — the cluster
    determinism tests compare it across runs, and :meth:`routed_counts`
    aggregates it for reports.  Like the engine's ``switch_log``,
    the log is a bounded deque: a long live run keeps the NEWEST
    ``decision_log_cap`` picks and counts the rest in
    ``decisions_dropped`` instead of growing without limit.
    """

    def __init__(self, policy: str = P2C, *, seed: int = 0,
                 decision_log_cap: int = 1 << 20,
                 metrics: Optional[MetricsRegistry] = None):
        if policy not in ROUTERS:
            raise ValueError(f"router {policy!r} not in {ROUTERS}")
        self.policy = policy
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self._rr: dict = {}            # per-class round-robin cursor
        self.decision_log_cap = decision_log_cap
        self.decisions: Deque[Tuple[float, str, str]] = collections.deque(
            maxlen=decision_log_cap)
        self.decisions_dropped = 0
        # per-(class, node) pick counts live in the metrics registry
        # (series ``router_routed_total``); the cluster injects its shared
        # registry so one scrape sees routing next to placement counters
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.weights: dict = {}        # (class, node) -> load multiplier

    def set_weight(self, cls_name: str, node_name: str,
                   weight: Optional[float]):
        """Placement hint: 0 removes the replica from rotation (warming),
        >1 attracts traffic, <1 repels it; ``None`` clears the hint."""
        if weight is None:
            self.weights.pop((cls_name, node_name), None)
        else:
            self.weights[(cls_name, node_name)] = float(weight)

    def _weight(self, cls_name: str, node: ClusterNode) -> float:
        return self.weights.get((cls_name, node.name), 1.0)

    def pick(self, cls_name: str, candidates: Sequence[ClusterNode], *,
             t: float = 0.0,
             load_fn: Optional[Callable[[ClusterNode], float]] = None
             ) -> Optional[ClusterNode]:
        """Choose a node for one request of ``cls_name`` (None: nowhere
        to go — every placement is draining, dead, or weighted out)."""
        cands = [n for n in candidates
                 if n.routable and self._weight(cls_name, n) > 0]
        if not cands:
            return None
        base = load_fn if load_fn is not None else (lambda n: n.load(t))

        def load(n: ClusterNode) -> float:
            return base(n) / self._weight(cls_name, n)

        if len(cands) == 1:
            node = cands[0]
        elif self.policy == ROUND_ROBIN:
            i = self._rr.get(cls_name, 0)
            node = cands[i % len(cands)]
            self._rr[cls_name] = i + 1
        elif self.policy == LEAST_LOADED:
            # stable: ties go to the earliest candidate
            node = min(cands, key=load)
        else:   # P2C
            i, j = self._rng.choice(len(cands), size=2, replace=False)
            a, b = cands[int(i)], cands[int(j)]
            node = a if load(a) <= load(b) else b
        if len(self.decisions) == self.decision_log_cap:
            self.decisions_dropped += 1   # deque evicts the oldest pick
        self.decisions.append((t, cls_name, node.name))
        self.metrics.counter("router_routed_total", cls=cls_name,
                             node=node.name).inc()
        return node

    def routed_counts(self) -> dict:
        """``{class: {node: requests_routed}}`` for reports —
        reconstructed from the registry's ``router_routed_total`` series."""
        out: dict = {}
        for lbl in self.metrics.labels_of("router_routed_total"):
            n = self.metrics.value("router_routed_total", **lbl)
            out.setdefault(lbl["cls"], {})[lbl["node"]] = int(n)
        return out
