"""Fault tolerance of the rpc fabric (counterpart of glt_tpu/resilience):
retry with backoff, circuit breaking, health monitoring, the degradation
cache and the seeded fault injection of ``chaos.py``.
Host-side control-plane code; none of it touches a card."""
from .chaos import (ChaosChannel, ChaosTcpProxy, FaultPlan,  # noqa: F401
                    chaos_seed, flaky)
from .health import (DEGRADED, DOWN, UP, DegradedFeatureCache,  # noqa: F401
                     HealthMonitor)
from .retry import (CLOSED, HALF_OPEN, OPEN, CircuitBreaker,  # noqa: F401
                    CircuitOpenError, RetryPolicy)

__all__ = [
    'ChaosChannel', 'ChaosTcpProxy', 'FaultPlan', 'chaos_seed', 'flaky',
    'DegradedFeatureCache', 'HealthMonitor', 'UP', 'DEGRADED', 'DOWN',
    'CircuitBreaker', 'CircuitOpenError', 'RetryPolicy',
    'CLOSED', 'OPEN', 'HALF_OPEN',
]
