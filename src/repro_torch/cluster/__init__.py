"""Cluster layer: multi-node serving over the runtime arbiter stack.

The paper's runtime manager arbitrates ONE device's chips and power;
the follow-up work (Xun et al., DATE 2021) frames the manager as a
hierarchy — per-device decisions under a global coordinator.  This
package is that coordinator, and the ROADMAP's "multi-host traffic"
scaling axis: N independent nodes (each a :class:`ResourceArbiter` plus
its :class:`DynamicServer`s, exactly as PRs 1-3 built them) composed
under a cluster front-end that adds

* **routing** — :class:`ClusterRouter` spreads one SLO class across its
  placement nodes by power-of-two-choices / least-loaded over the
  backlog-per-chip signal the arbiters already track (round-robin is the
  baseline p2c is compared against);
* **cluster-level admission** — :func:`cluster_admission` admits a class
  iff SOME node's headroom (:meth:`ResourceArbiter.headroom`) fits its
  minimal share, raising :class:`AdmissionError` otherwise;
* **lifecycle** — :meth:`Cluster.drain` (stop routing, let queues empty,
  migrate tenant registrations to survivors) and :meth:`Cluster.fail`
  (fail-stop: queued requests resolve with error payloads and orphaned
  classes re-arbitrate elsewhere);
* **deterministic benchmarking** — :func:`simulate_cluster` mirrors
  ``traffic.driver.simulate`` in virtual time, so routing policies are
  compared bit-reproducibly on one seeded trace.
"""
from repro_torch.cluster.node import (DEAD, DRAINED, DRAINING, HEALTH_EPOCHS,
                                NODE_STATES, STANDBY, UP, ClusterNode,
                                StallDetector)
from repro_torch.cluster.router import (LEAST_LOADED, P2C, ROUND_ROBIN, ROUTERS,
                                  ClusterRouter)
from repro_torch.cluster.admission import cluster_admission, cluster_headroom
from repro_torch.cluster.placement import (ClassSpec, Eviction, MigrationCost,
                                     Move, PlacementPlan, RebalancePlan,
                                     ScalePlan, migration_cost,
                                     plan_preemptions, plan_rebalance,
                                     plan_scaling, solve_placement)
from repro_torch.cluster.frontend import Cluster
from repro_torch.cluster.sim import (FIRST_FIT, REPLICATE, ClusterReport,
                               simulate_cluster)
