"""Fault tolerance of the rpc fabric (counterpart of glt_tpu/resilience):
retry with backoff, circuit breaking, health monitoring and the
degradation cache. Host-side control-plane code; none of it touches a
card. Not ported: ``chaos.py``, the fault injection (ROADMAP)."""
from .health import (DEGRADED, DOWN, UP, DegradedFeatureCache,  # noqa: F401
                     HealthMonitor)
from .retry import (CLOSED, HALF_OPEN, OPEN, CircuitBreaker,  # noqa: F401
                    CircuitOpenError, RetryPolicy)

__all__ = [
    'DegradedFeatureCache', 'HealthMonitor', 'UP', 'DEGRADED', 'DOWN',
    'CircuitBreaker', 'CircuitOpenError', 'RetryPolicy',
    'CLOSED', 'OPEN', 'HALF_OPEN',
]
