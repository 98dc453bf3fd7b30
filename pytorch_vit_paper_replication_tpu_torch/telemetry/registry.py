"""The telemetry registry: counters, gauges, rolling histograms.

A copy of the JAX package's ``telemetry/registry.py`` (numpy only), with
the serve-side instrument schema. It is the substrate the serving stats
publish through:

* **counters** — monotonic totals (``tel_steps_total``, cache hits),
* **gauges** — last-value instruments (``tel_images_per_sec``,
  ``tel_goodput_pct``),
* **histograms** — bounded rolling sample windows with p50/p95/p99
  snapshots (step seconds, data-wait seconds) — same reservoir design
  as ServeStats' latency legs, so percentiles mean the same thing in
  train and serve,
* an **event ring** — the last N emitted telemetry events, kept so a
  watchdog postmortem (:mod:`.watchdog`) can show what the run was
  doing right before it stalled,
* :meth:`TelemetryRegistry.to_prometheus` — the registry rendered as
  Prometheus text exposition format (the serve CLI's ``::metrics``
  command), so any scraper that speaks Prometheus can watch a run.

Instrument names are namespaced by publisher (``tel_`` for the train
hot-loop spans, ``serve_``/``data_``/``compile_cache_``/``watchdog_``
for theirs) and the train-side names are declared in
:data:`INSTRUMENTS` — tests assert they can NEVER collide with the
existing MetricsLogger JSONL vocabulary (``images_per_sec``,
``lat_total_p99``, ...), so dashboards reading a merged stream always
know which subsystem a key came from.
"""

from __future__ import annotations

import json
import math
import re
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

# Rolling-histogram window: big enough that p99 has tail samples over an
# epoch of steps, bounded so sustained runs can't grow memory.
DEFAULT_HIST_WINDOW = 4096
# Event ring depth — what a postmortem shows as "the last things done".
DEFAULT_EVENT_RING = 256

# The instruments this package publishes, name -> kind: the train-side
# (tel_/watchdog_/profiler_/mem_), serve-side (serve_/compile_cache_/
# trace_), batch-inference (bi_), search (search_) and distillation
# (distill_) subsets of the JAX package's declared schema. Dynamic names ride
# their prefixes (mem_devN_*, serve_lat_*, serve_latency_*).
INSTRUMENTS: Dict[str, str] = {
    'tel_step_s': 'histogram',
    'tel_data_wait_s': 'histogram',
    'tel_step_exec_s': 'histogram',
    'tel_ckpt_s': 'histogram',
    'tel_eval_s': 'histogram',
    'tel_images_per_sec': 'gauge',
    'tel_mfu': 'gauge',
    'tel_goodput_pct': 'gauge',
    'tel_data_wait_frac': 'gauge',
    'tel_steps_total': 'counter',
    'tel_images_total': 'counter',
    'watchdog_beats_total': 'counter',
    'watchdog_stalls_total': 'counter',
    'watchdog_postmortems_total': 'counter',
    'profiler_captures_total': 'counter',
    'profiler_capture_errors_total': 'counter',
    'profiler_arms_refused_total': 'counter',
    'profiler_capture_active': 'gauge',
    'profiler_last_capture_path': 'gauge',
    'mem_live_bytes': 'gauge',
    'mem_live_bytes_peak': 'gauge',
    'mem_live_arrays': 'gauge',
    'mem_sample_errors_total': 'counter',
    'compile_cache_requests_total': 'counter',
    'compile_cache_hits_total': 'counter',
    'compile_cache_saved_seconds_total': 'counter',
    'serve_queue_depth': 'gauge',
    'serve_warm_rungs': 'gauge',
    'serve_warmup_cumulative_s': 'gauge',
    'serve_time_to_first_batch_s': 'gauge',
    'serve_head_probs_total': 'counter',
    'serve_head_features_total': 'counter',
    'serve_head_tokens_total': 'counter',
    'serve_head_probs_p99_s': 'gauge',
    'serve_head_features_p99_s': 'gauge',
    'serve_head_tokens_p99_s': 'gauge',
    'serve_tier_interactive_total': 'counter',
    'serve_tier_batch_total': 'counter',
    'serve_tier_interactive_p99_s': 'gauge',
    'serve_tier_batch_p99_s': 'gauge',
    'trace_spans_total': 'counter',
    'bi_records_total': 'counter',
    'bi_batches_total': 'counter',
    'bi_checkpoints_total': 'counter',
    'bi_images_per_sec': 'gauge',
    'bi_progress_pct': 'gauge',
    'bi_devices': 'gauge',
    'bi_data_wait_s': 'histogram',
    'bi_drain_s': 'histogram',
    'search_queries_total': 'counter',
    'search_scans_total': 'counter',
    'search_qps': 'gauge',
    'search_index_rows': 'gauge',
    'search_devices': 'gauge',
    'search_scan_s': 'histogram',
    'search_merge_s': 'histogram',
    'distill_alpha': 'gauge',
    'distill_t': 'gauge',
    'distill_loss': 'gauge',
    'distill_teacher_agree_frac': 'gauge',
}

# Prometheus # HELP text for the declared instruments (the renderer
# emits a generic fallback for dynamically-named ones).
HELP_TEXT: Dict[str, str] = {
    'tel_step_s': 'Train step wall seconds (barrier-window amortized)',
    'tel_data_wait_s': 'Seconds blocked on the batch iterator',
    'tel_step_exec_s': 'Step dispatch+device seconds (amortized)',
    'tel_ckpt_s': 'Checkpoint-save span seconds (host blocked)',
    'tel_eval_s': 'Eval-pass span seconds',
    'tel_images_per_sec': 'Live window throughput, images/sec',
    'tel_mfu': 'Analytic model-FLOPs utilization per card (bf16 peak)',
    'tel_goodput_pct': 'Step-exec share of epoch wall time, percent',
    'tel_data_wait_frac': 'Data-wait share of epoch wall time',
    'tel_steps_total': 'Train steps recorded',
    'tel_images_total': 'Train images recorded',
    'watchdog_beats_total': 'Watchdog heartbeats received',
    'watchdog_stalls_total': 'Stall deadlines missed',
    'watchdog_postmortems_total': 'Postmortem dumps written',
    'profiler_captures_total': 'torch.profiler capture windows opened',
    'profiler_capture_errors_total': 'Profiler start/stop failures',
    'profiler_arms_refused_total': 'Capture requests refused (window active or budget spent)',
    'profiler_capture_active': '1 while a capture window is open',
    'profiler_last_capture_path': 'Most recent capture directory (string)',
    'mem_live_bytes': 'CUDA allocator bytes held by live tensors at last sample',
    'mem_live_bytes_peak': 'Peak of mem_live_bytes over the run',
    'mem_live_arrays': 'CUDA allocator allocations held at last sample',
    'mem_sample_errors_total': 'Device-memory probes that raised',
    'compile_cache_requests_total': 'XLA modules that consulted the persistent compile cache',
    'compile_cache_hits_total': 'XLA modules deserialized from the persistent compile cache',
    'compile_cache_saved_seconds_total': 'Compile seconds saved by persistent-cache hits',
    'serve_queue_depth': 'Serve micro-batcher queue depth at last publish',
    'serve_warm_rungs': 'Bucket rungs with AOT-compiled executables',
    'serve_warmup_cumulative_s': 'Cumulative AOT warmup compile seconds',
    'serve_time_to_first_batch_s': 'Process start to first completed device batch, seconds',
    'serve_head_probs_total': 'Classifier-head requests completed',
    'serve_head_features_total': 'Pooled-embedding-head requests completed',
    'serve_head_tokens_total': 'Token-sequence-head requests completed',
    'serve_head_probs_p99_s': 'Rolling p99 total latency, probs head',
    'serve_head_features_p99_s': 'Rolling p99 total latency, features head',
    'serve_head_tokens_p99_s': 'Rolling p99 total latency, tokens head',
    'serve_tier_interactive_total': 'Interactive-tier requests completed',
    'serve_tier_batch_total': 'Batch-tier requests completed',
    'serve_tier_interactive_p99_s': 'Rolling p99 total latency, interactive tier',
    'serve_tier_batch_p99_s': 'Rolling p99 total latency, batch tier',
    'trace_spans_total': 'Request-trace spans recorded by this process',
    'bi_records_total': 'Batch-inference records completed',
    'bi_batches_total': 'Batch-inference loader batches consumed',
    'bi_checkpoints_total': 'Batch-inference progress manifests written',
    'bi_images_per_sec': 'Batch-inference live sweep throughput',
    'bi_progress_pct': 'Batch-inference dataset progress, percent',
    'bi_devices': 'Devices the batch-inference replicas run on',
    'bi_data_wait_s': 'Seconds blocked on the batch-inference loader',
    'bi_drain_s': 'Seconds blocked fetching batch-inference outputs',
    'search_queries_total': 'Query rows answered by the top-k scanner',
    'search_scans_total': 'Query chunks dispatched across the scan '
                          'devices',
    'search_qps': 'Queries per second of the last scan call',
    'search_index_rows': 'Rows of the attached embedding index',
    'search_devices': 'Devices the index shards scan across',
    'search_scan_s': "Seconds blocked fetching one query chunk's merged "
                     'top-k',
    'search_merge_s': "Host dispatch seconds of one chunk's scans and "
                      'merge',
    'distill_alpha': 'KD soft-target weight in force (0 = plain CE)',
    'distill_t': 'KD softmax temperature in force',
    'distill_loss': 'Latest KD train loss (blended hard+soft)',
    'distill_teacher_agree_frac': 'Per-epoch student/teacher argmax '
                                  'agreement over train batches',
}

class _RollingHistogram:
    """Fixed-window sample reservoir with percentile snapshots (the
    ServeStats reservoir, generalized). NOT thread-safe on its own —
    the registry's lock serializes access."""

    def __init__(self, window: int = DEFAULT_HIST_WINDOW):
        self._samples: deque = deque(maxlen=window)
        self.count_total = 0          # lifetime observations, not window
        self.sum_total = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        self._samples.append(v)
        self.count_total += 1
        self.sum_total += v

    def snapshot(self) -> Dict[str, Optional[float]]:
        if not self._samples:
            return {"p50": None, "p95": None, "p99": None, "count": 0,
                    "count_total": self.count_total,
                    "sum_total": round(self.sum_total, 6)}
        arr = np.fromiter(self._samples, float)
        p50, p95, p99 = np.percentile(arr, [50.0, 95.0, 99.0])
        return {"p50": round(float(p50), 6), "p95": round(float(p95), 6),
                "p99": round(float(p99), 6), "count": int(arr.size),
                "count_total": self.count_total,
                "sum_total": round(self.sum_total, 6)}


class TelemetryRegistry:
    """Thread-safe shared metrics registry (see module docstring).

    One lock guards everything: every operation is a dict lookup plus a
    scalar update or deque append, so contention is nanoseconds even
    from the training hot loop — the overhead A/B
    (``tools/telemetry_overhead.py``) holds the whole instrumented path
    under the 2% budget.
    """

    def __init__(self, *, hist_window: int = DEFAULT_HIST_WINDOW,
                 event_ring: int = DEFAULT_EVENT_RING):
        # RLock, not Lock: the watchdog's SIGTERM handler snapshots the
        # registry from whatever the interrupted (main) thread was
        # doing — possibly mid-``count()`` with this lock held. A plain
        # Lock would deadlock the handler against its own thread.
        self._lock = threading.RLock()
        self._hist_window = hist_window
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, Any] = {}
        self._hists: Dict[str, _RollingHistogram] = {}
        self._events: deque = deque(maxlen=event_ring)

    # ------------------------------------------------------- instruments
    def count(self, name: str, n: float = 1) -> None:
        """Increment a monotonic counter."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def set_counter(self, name: str, value: float) -> None:
        """Set a counter to an absolute value — the bridge for
        subsystems that keep their own totals (ServeStats, CacheStats)
        and publish point-in-time syncs instead of deltas."""
        with self._lock:
            self._counters[name] = value

    def gauge(self, name: str, value: Any) -> None:
        with self._lock:
            self._gauges[name] = value

    def gauge_max(self, name: str, value: float) -> None:
        """Monotonic high-water gauge: keep the max of the existing
        value and this one — device-memory watermarks
        (:mod:`.profiling`) must survive the sample after a big free."""
        with self._lock:
            prev = self._gauges.get(name)
            if not isinstance(prev, (int, float)) or isinstance(
                    prev, bool) or value > prev:
                self._gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        """Add one sample to a rolling histogram."""
        with self._lock:
            hist = self._hists.get(name)
            if hist is None:
                hist = self._hists[name] = _RollingHistogram(
                    self._hist_window)
            hist.observe(value)

    def event(self, name: str, **fields: Any) -> Dict[str, Any]:
        """Append one event to the ring buffer (the postmortem's
        "what was happening" record); returns the stored dict."""
        record = {"time": time.time(), "event": name, **fields}
        with self._lock:
            self._events.append(record)
        return record

    # --------------------------------------------------------- read side
    def last_events(self, n: int = DEFAULT_EVENT_RING) -> List[Dict]:
        with self._lock:
            return list(self._events)[-n:]

    def snapshot(self) -> Dict[str, Any]:
        """Point-in-time plain-dict view (JSON-serializable)."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {name: h.snapshot()
                               for name, h in self._hists.items()},
            }

    def to_prometheus(self, prefix: str = "vit_") -> str:
        """Render the registry as Prometheus text exposition format —
        :func:`render_prometheus` over :meth:`snapshot` (ONE renderer
        behind serve's ``::metrics``, ``train.py --metrics-port``, and
        the fleet aggregator's endpoint)."""
        return render_prometheus(self.snapshot(), prefix=prefix)

    def reset(self) -> None:
        """Forget everything — tests only (the process-global registry
        would otherwise leak state between cases)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._events.clear()


def _fmt(v: float) -> str:
    """Prometheus sample values: integers stay integral, floats use
    repr (full precision, no scientific-notation surprises for the
    magnitudes metrics take)."""
    if isinstance(v, float) and not v.is_integer():
        return repr(v)
    return str(int(v))


def render_prometheus(snap: Dict[str, Any], prefix: str = "vit_",
                      help_text: Optional[Dict[str, str]] = None) -> str:
    """Registry-snapshot-shaped dict -> Prometheus text exposition.

    The ONE renderer (serve ``::metrics``, train ``--metrics-port``,
    ``tools/fleet_agg.py``'s fleet endpoint all call it). Per metric:
    a ``# HELP`` line (from :data:`HELP_TEXT` merged with
    ``help_text``, generic fallback otherwise), a ``# TYPE`` line, then
    samples. Counters/gauges map directly; histograms render as
    summaries — quantile-labeled samples over the rolling window plus
    the lifetime ``_count``/``_sum`` pair. Sample names are EXACTLY
    the pre-HELP-era ones (prefix + sanitized raw name) — dashboards
    keyed on r9 names keep working, asserted by the name-stability
    test. Non-numeric gauges are skipped (they stay visible in the
    JSON snapshot/postmortem)."""
    helps = dict(HELP_TEXT)
    if help_text:
        helps.update(help_text)

    def name_of(raw: str) -> str:
        return prefix + re.sub(r"[^a-zA-Z0-9_:]", "_", raw)

    def header(raw: str, n: str, kind: str) -> List[str]:
        text = helps.get(raw, f"{kind} {raw} (no help registered)")
        return [f"# HELP {n} {text}", f"# TYPE {n} {kind}"]

    lines: List[str] = []
    for raw, v in sorted(snap.get("counters", {}).items()):
        n = name_of(raw)
        lines += header(raw, n, "counter") + [f"{n} {_fmt(v)}"]
    for raw, v in sorted(snap.get("gauges", {}).items()):
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            continue
        n = name_of(raw)
        lines += header(raw, n, "gauge") + [f"{n} {_fmt(v)}"]
    for raw, h in sorted(snap.get("histograms", {}).items()):
        n = name_of(raw)
        lines += header(raw, n, "summary")
        for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
            if h.get(key) is not None:
                lines.append(f'{n}{{quantile="{q}"}} {_fmt(h[key])}')
        lines.append(f"{n}_count {h['count_total']}")
        lines.append(f"{n}_sum {_fmt(h['sum_total'])}")
    return "\n".join(lines) + "\n"


# The process-global registry every subsystem publishes through by
# default. Constructed eagerly: it is cheap (three dicts and a deque)
# and having exactly one removes every "did you pass the registry"
# wiring question between train/serve/data/compile_cache.
_REGISTRY = TelemetryRegistry()


def get_registry() -> TelemetryRegistry:
    """The process-global :class:`TelemetryRegistry`."""
    return _REGISTRY


def _json_safe(v: Any) -> Any:
    """Non-finite floats break the JSONL contract: NaN becomes null and
    infinities keep their sign as strings."""
    if isinstance(v, float) and not math.isfinite(v):
        if math.isnan(v):
            return None
        return "Infinity" if v > 0 else "-Infinity"
    return v


def dump_events_jsonl(events: Iterable[Dict], fh) -> int:
    """Write events as JSONL (postmortem tail section); returns count.
    Non-finite floats get the same treatment as MetricsLogger rows
    (NaN -> null, infinities -> signed strings) — a postmortem tail
    must never contain a line strict JSON consumers reject."""
    n = 0
    for ev in events:
        row = {k: _json_safe(v) for k, v in ev.items()}
        try:
            line = json.dumps(row, default=str, allow_nan=False)
        except ValueError:   # non-finite buried in a nested value: a
            # postmortem must never crash the dump — degrade to repr.
            line = json.dumps({"event": "unserializable", "repr": repr(ev)})
        fh.write(line + "\n")
        n += 1
    return n
