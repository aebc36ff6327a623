"""The port's own copy of ``rapid_tpu/search/``.

Coverage-guided nemesis search over the fault-plan space -- "Jepsen in
a box".

The pieces compose as a pipeline: :mod:`.generator` samples seeded
``FaultPlan`` specs within the builders' validity rules, :mod:`.runner`
executes one spec as a probe (serving fabric or device-plane simulator)
and extracts a coverage fingerprint (:mod:`.coverage`) plus invariant
verdicts (:mod:`.checkers`), :mod:`.hunt` drives a budgeted search that
biases generation toward unvisited coverage, and :mod:`.shrinker`
delta-debugs any violating plan down to a minimal corpus artifact.
"""

from .checkers import (
    InvariantViolation,
    check_config_parity,
    check_fingerprint_agreement,
    check_leader_agreement,
    check_linearizable_history,
    check_linearizable_single_client,
    check_view_agreement,
    ClientOp,
)

__all__ = [
    "ClientOp",
    "InvariantViolation",
    "check_config_parity",
    "check_fingerprint_agreement",
    "check_leader_agreement",
    "check_linearizable_history",
    "check_linearizable_single_client",
    "check_view_agreement",
]
