"""glt_tpu_torch.obs — the observability layer (counterpart of
glt_tpu/obs/).

One process-wide surface for the three observability primitives the
serving front ends, the rpc fabric and the resilience primitives publish
into:

  * :class:`MetricsRegistry` — thread-safe labeled counters / gauges /
    log-spaced histograms with JSON and Prometheus-text exposition, the
    same text as the JAX package's. :class:`~glt_tpu_torch.serving.
    ServingMetrics` is a view over one of these.
  * :class:`Tracer` — host-side spans (batcher flush, engine bucket and
    forward, fleet dispatch, rpc client and server) that open
    ``torch.profiler.record_function`` ranges of the same names and
    export as Chrome-trace-event JSON. Trace context propagates over the
    rpc fabric (``distributed.rpc``), across the two packages too.
  * :mod:`recorder` — the :class:`FlightRecorder` (bounded event ring;
    trips dump a postmortem JSON into ``GLT_OBS_POSTMORTEM_DIR``) and
    :class:`SloBurnEvaluator` (``slo_burn{slo=...}`` gauges over the
    registry histograms).
  * :mod:`perf` — the card's measured ceilings (:func:`device_ceilings`:
    the device memory's stream rate and the float32 GEMM rate, cached by
    device kind in ``GLT_ROOFLINE_CACHE``, published as the
    ``roofline_*`` gauges) and :func:`roofline_report`.

Disabled (the default), ``span()`` returns a cached null context manager;
plain registry counters keep counting.

Knobs: GLT_OBS_TRACE, GLT_OBS_TRACE_SAMPLE, GLT_OBS_ANNOTATE,
GLT_OBS_BUFFER, GLT_OBS_POSTMORTEM_DIR, GLT_OBS_POSTMORTEM_MIN_S,
GLT_OBS_SLO, GLT_ROOFLINE_CACHE (as in the JAX package). The JAX
package's compile accounting (XLA cost analysis, compile counters) has no
counterpart here: the port compiles no programs.
"""
from .registry import (
    Counter, Gauge, HistogramMetric, LatencyHistogram, MetricsRegistry,
    get_registry, set_registry,
)
from .trace import (
    Span, SpanContext, Tracer, collect_endpoint_obs, get_tracer,
    merge_chrome_traces, save_chrome_trace,
)
from .perf import (
    default_cache_path, device_ceilings, measure_hbm_bandwidth,
    measure_matmul_flops, roofline_report,
)
from .recorder import (
    FlightRecorder, SloBurnEvaluator, SloPolicy, get_recorder,
    parse_slo_env, set_recorder,
)

__all__ = [
    'Counter', 'Gauge', 'HistogramMetric', 'LatencyHistogram',
    'MetricsRegistry', 'get_registry', 'set_registry',
    'Span', 'SpanContext', 'Tracer', 'get_tracer',
    'collect_endpoint_obs', 'merge_chrome_traces', 'save_chrome_trace',
    'default_cache_path', 'device_ceilings', 'measure_hbm_bandwidth',
    'measure_matmul_flops', 'roofline_report',
    'FlightRecorder', 'SloBurnEvaluator', 'SloPolicy', 'get_recorder',
    'parse_slo_env', 'set_recorder',
]
