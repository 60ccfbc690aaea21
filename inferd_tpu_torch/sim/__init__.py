"""Deterministic discrete-event fleet simulator (port of inferd_tpu/sim).

Rehearses the port's control plane (`control.dht.SwarmDHT` gossip,
`control.balance.Balancer`, `control.path_finder.PathFinder` with its
long-lived D*-Lite `SwarmChainPlanner`, `control.autoscale.AutoScaler`,
and `utils.retry`'s budgets) against thousands of virtual replicas on a
virtual clock: no sockets, no threads, no wall time, no device. Same seed
and same scenario give a byte-identical event trace and metrics, the same
as the reference's simulator gives, so the reference's committed fixtures
(tests/data/sim/) hold the port to it decision for decision.

    python -m inferd_tpu_torch.sim run hot_stage_skew --seed 7
    python -m inferd_tpu_torch.sim --check tests/data/sim
"""

from inferd_tpu_torch.sim.core import SimLoop, SimNet
from inferd_tpu_torch.sim.fleet import Fleet, SimReplica, SimRouter
from inferd_tpu_torch.sim.scenario import check_fixture, run_scenario
from inferd_tpu_torch.sim.scenarios import CATALOG

__all__ = [
    "SimLoop", "SimNet", "Fleet", "SimReplica", "SimRouter",
    "run_scenario", "check_fixture", "CATALOG",
]
