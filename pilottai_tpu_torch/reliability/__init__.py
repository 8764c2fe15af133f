"""Reliability layer: end-to-end deadlines, overload shedding, circuit
breaking and a fault-injection (chaos) harness.

The serving north star is heavy traffic against finite hardware; this
package holds the pieces that keep overload and failure *bounded*:

* ``deadline`` — one deadline/overload error vocabulary plus monotonic
  deadline helpers, threaded HTTP edge → handler → batcher.
* ``inject`` — named failure points (no-ops in production) that chaos
  tests script to provoke the failure paths the tree claims to handle.
* ``breaker`` — a circuit breaker wrapping engine calls so repeated
  device failures flip to fast-fail 503s with half-open probing.
* ``watchdog`` — a heartbeat-staleness monitor that turns a *hung*
  dispatch (which never raises anywhere) into an explicit stalled
  state: health endpoint 503s and subscribed breakers force-open.
* ``degrade`` — a capability ladder: repeated faults inside a rolling
  window step serving capability down (drafting → chunk size → slots →
  batch-class shed) instead of oscillating between full speed and
  total failure; a clean soak promotes back up.

The port's copy of ``pilottai_tpu/reliability``, with the same exports.
Import cost: utils-only dependencies, no torch — safe for control-plane
processes.
"""

from pilottai_tpu_torch.reliability.breaker import (
    CLOSED,
    HALF_OPEN,
    OPEN,
    CircuitBreaker,
    CircuitOpenError,
)
from pilottai_tpu_torch.reliability.deadline import (
    DeadlineExceeded,
    EngineOverloaded,
    PoisonedOutput,
    deadline_from_timeout,
    expired,
    remaining,
)
from pilottai_tpu_torch.reliability.degrade import DegradeLadder
from pilottai_tpu_torch.reliability.watchdog import (
    EngineHealth,
    Watchdog,
    global_engine_health,
)
from pilottai_tpu_torch.reliability.inject import (
    Fault,
    FaultInjector,
    global_injector,
    inject,
)

__all__ = [
    "CLOSED",
    "HALF_OPEN",
    "OPEN",
    "CircuitBreaker",
    "CircuitOpenError",
    "DeadlineExceeded",
    "DegradeLadder",
    "EngineHealth",
    "EngineOverloaded",
    "Fault",
    "FaultInjector",
    "PoisonedOutput",
    "Watchdog",
    "deadline_from_timeout",
    "expired",
    "global_engine_health",
    "global_injector",
    "inject",
    "remaining",
]
