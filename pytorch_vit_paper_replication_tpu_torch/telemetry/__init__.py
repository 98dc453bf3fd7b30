"""Telemetry of the port: one registry behind every subsystem.

* :mod:`.registry` — counters / gauges / rolling histograms, the
  postmortem event ring and the Prometheus text renderer,
* :mod:`.spans` — :class:`StepTelemetry`, the engine loop's per-step span
  tracker (data-wait / step-exec / checkpoint / eval seconds, sampled
  honest-timing barriers, live images/sec and ``tel_mfu`` gauges,
  per-epoch goodput summaries) writing the JAX package's JSONL rows,
* :mod:`.watchdog` — :class:`Watchdog`, the stall heartbeat that dumps
  all-thread stacks, memory and the last events instead of freezing
  silently (and the same dump on SIGTERM),
* :mod:`.profiling` — :class:`ProfileController`, ``torch.profiler``
  capture windows (``--profile-steps``, SIGUSR2, or a step-time anomaly)
  and the device-memory watermark gauges,
* :mod:`.flops` — the analytic ViT FLOP math and the cards' peak rates,
* :mod:`.tracing` — request-scoped tracing for the serve path,
* :mod:`.shipper` — :class:`TelemetryShipper` (frames pushed to a fleet
  aggregator), :class:`FrameSink` (a minimal aggregator) and
  :func:`start_metrics_http` (``train --metrics-port``),
* :mod:`.chrome_trace` — step rows and request spans as Perfetto-loadable
  Chrome trace JSON, one lane group per process role.
"""

from .chrome_trace import (merged_chrome_trace, to_chrome_trace,
                           validate_chrome_trace, write_chrome_trace)
from .flops import (PEAKS, analytic_mfu, bf16_peak_tflops, peaks,
                    train_step_flops_per_image)
from .profiling import (ProfileController, parse_profile_steps,
                        sample_device_memory)
from .registry import (HELP_TEXT, INSTRUMENTS, TelemetryRegistry,
                       get_registry, render_prometheus)
from .shipper import FrameSink, TelemetryShipper, start_metrics_http
from .spans import ROW_KEYS, StepTelemetry
from .tracing import (TraceContext, Tracer, configure_tracer, get_tracer,
                      trace_sample)
from .watchdog import Watchdog, memory_report

__all__ = [
    "FrameSink", "HELP_TEXT", "INSTRUMENTS", "PEAKS", "ProfileController",
    "ROW_KEYS", "StepTelemetry", "TelemetryRegistry", "TelemetryShipper",
    "TraceContext", "Tracer", "Watchdog", "analytic_mfu",
    "bf16_peak_tflops", "configure_tracer", "get_registry", "get_tracer",
    "memory_report", "merged_chrome_trace", "parse_profile_steps", "peaks",
    "render_prometheus", "sample_device_memory", "start_metrics_http",
    "to_chrome_trace", "trace_sample", "train_step_flops_per_image",
    "validate_chrome_trace", "write_chrome_trace",
]
