"""Resilience layer of the serving path — the port's copy of
``opensim_tpu/resilience/``: request deadlines enforced at phase
boundaries (``deadline``), bounded retry with jittered backoff for the
snapshot fetch (``retry``) and deterministic fault injection at named
points (``faults``). The reference's circuit breakers guard its engine
fallbacks; the port has no fallback, so it has no breaker."""

from .deadline import Deadline, DeadlineExceeded, check_deadline, current_deadline, deadline_scope  # noqa: F401
from .faults import FaultError, clear_faults, fault_point, fault_stats, inject  # noqa: F401
from .retry import retry_call  # noqa: F401
