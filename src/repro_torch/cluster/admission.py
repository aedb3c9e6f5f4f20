"""Cluster-level admission control.

A tenant's resource share cannot straddle hosts — chips on two machines
never serve one model slice — so cluster admission reduces to a
PLACEMENT question: does some node's headroom (capacity left after its
equal-or-higher-priority tenants' minimal feasible shares) fit the
prospective class's minimal share?  :func:`cluster_admission` asks every
routable node's :meth:`ResourceArbiter.admission_check` and returns the
set of nodes that can host the class — its *placement set* — raising
:class:`AdmissionError` when the set is empty.  Adding a node with
enough headroom turns the same rejected class admissible, which is the
whole point of scaling out.

:func:`cluster_headroom` sums the per-node headroom for observability
(capacity-planning dashboards want the aggregate even though admission
binds per node).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.cluster.node import ClusterNode
from repro_torch.runtime.arbiter import AdmissionError, Headroom
from repro_torch.runtime.lut import LUT


def cluster_admission(nodes: Sequence[ClusterNode], lut: LUT,
                      target_latency_ms: float, *, priority: int = 0,
                      min_accuracy: Optional[float] = None,
                      t: float = 0.0) -> List[str]:
    """Names of routable nodes whose headroom fits the class's minimal
    share; raises :class:`AdmissionError` when no placement exists."""
    placed = []
    for n in nodes:
        if not n.routable:
            continue
        if n.arbiter.admission_check(lut, target_latency_ms, n.g(t),
                                     priority=priority,
                                     min_accuracy=min_accuracy) is not None:
            placed.append(n.name)
    if not placed:
        hr = cluster_headroom(nodes, t=t)
        raise AdmissionError(
            f"no placement fits a minimal share under {target_latency_ms}ms "
            f"across {sum(1 for n in nodes if n.routable)} routable node(s) "
            f"(summed headroom: {hr.chips} chips)")
    return placed


def cluster_headroom(nodes: Sequence[ClusterNode], *, t: float = 0.0
                     ) -> Headroom:
    """Summed unreserved capacity across routable nodes (observability —
    admission itself binds per node, see module docstring).  ``power_w``
    is inf when any routable node runs without a power budget."""
    chips = 0
    power = 0.0
    for n in nodes:
        if not n.routable:
            continue
        hr = n.headroom(t)
        chips += max(0, hr.chips)
        power += max(0.0, hr.power_w)   # inf (no budget) propagates
    return Headroom(chips=chips, power_w=power)
