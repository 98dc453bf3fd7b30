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
* :mod:`.tracing` — request-scoped tracing for the serve path.
"""

from .flops import (PEAKS, analytic_mfu, bf16_peak_tflops, peaks,
                    train_step_flops_per_image)
from .profiling import (ProfileController, parse_profile_steps,
                        sample_device_memory)
from .registry import (HELP_TEXT, INSTRUMENTS, TelemetryRegistry,
                       get_registry, render_prometheus)
from .spans import ROW_KEYS, StepTelemetry
from .watchdog import Watchdog, memory_report

__all__ = [
    "HELP_TEXT", "INSTRUMENTS", "PEAKS", "ProfileController", "ROW_KEYS",
    "StepTelemetry", "TelemetryRegistry", "Watchdog", "analytic_mfu",
    "bf16_peak_tflops", "get_registry", "memory_report",
    "parse_profile_steps", "peaks", "render_prometheus",
    "sample_device_memory", "train_step_flops_per_image",
]
