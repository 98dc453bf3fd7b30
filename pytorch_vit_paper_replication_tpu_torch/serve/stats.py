"""Serving observability: rolling latency percentiles + counters.

A copy of the JAX package's ``serve/stats.py``.

Training metrics answer "how fast is the run"; serving metrics answer
"are users inside the SLO *right now*". The registry keeps bounded
rolling windows (no unbounded growth under sustained traffic) of the
three latency legs —

* **queue**: submit() -> the request leaves the queue for a device batch,
* **device**: batch dispatch -> results ready on host,
* **total**: submit() -> future resolved (what the user feels),

— plus a batch-occupancy histogram per bucket (real rows / bucket rows:
low occupancy means the ladder or max-wait is mistuned and the device
is mostly multiplying pad), and monotonic counters for admissions,
rejections (queue full), expiries (deadline passed while queued), and
completions. ``snapshot()`` is a plain-dict point-in-time view;
``emit()`` appends snapshots to JSONL via :class:`..metrics.MetricsLogger`
so serve runs land in a machine-readable stream (a later slice ports
``MetricsLogger``).

Multi-head / multi-tier observability: the head-blind
aggregates above stay (one fused batch IS one device dispatch), and
per-``head`` (probs / features / tokens) and per-``tier``
(interactive / batch) submitted/completed/expired counters plus
per-head and per-tier rolling total-latency percentiles ride next to
them — published as the ``serve_head_*`` / ``serve_tier_*``
instruments (declared in ``telemetry.registry.INSTRUMENTS``) and the
``serve_lat_head_<head>_s`` / ``serve_lat_tier_<tier>_s`` registry
histograms, so a mixed fleet's dashboards can tell embedding-traffic
tails from classifier tails without a second stats object.

Cold-start observability: per-rung warmup seconds, cumulative warmup time, ``time_to_first_batch_s`` (process
start -> first device batch completed), and the persistent
compilation-cache hit/miss counters (:mod:`..compile_cache`) all ride
the same snapshot — a slow restart is diagnosable from the ``::stats``
line protocol alone.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional

import numpy as np

# Window size trades memory/snapshot cost against how far back a
# percentile looks: 2048 samples at 1k QPS is ~2 s of history — current
# enough for SLO alarms, big enough that p99 has ~20 tail samples.
DEFAULT_WINDOW = 2048


class _RollingQuantiles:
    """Fixed-window sample reservoir with p50/p95/p99 snapshots."""

    def __init__(self, window: int = DEFAULT_WINDOW):
        self._samples: deque = deque(maxlen=window)

    def add(self, value: float) -> None:
        self._samples.append(float(value))

    def snapshot(self) -> Dict[str, Optional[float]]:
        if not self._samples:
            return {"p50": None, "p95": None, "p99": None, "count": 0}
        arr = np.fromiter(self._samples, float)
        p50, p95, p99 = np.percentile(arr, [50.0, 95.0, 99.0])
        return {"p50": round(float(p50), 6), "p95": round(float(p95), 6),
                "p99": round(float(p99), 6), "count": int(arr.size)}


class ServeStats:
    """Thread-safe serving metrics registry (see module docstring)."""

    LATENCY_LEGS = ("queue", "device", "total")

    def __init__(self, window: int = DEFAULT_WINDOW, registry=None):
        from ..telemetry.registry import get_registry

        self._lock = threading.Lock()
        self._window = window
        # Latency samples are ALSO observed into the shared registry's
        # rolling histograms (``serve_lat_<leg>_s``): registry
        # histogram snapshots carry window counts, which is what the
        # fleet aggregator's count-weighted percentile merge needs —
        # the p99 of N replicas is only honest when each replica's
        # quantiles are weighted by how much traffic stands behind
        # them. The gauges ``serve_latency_*_p99_s`` keep their r9
        # names for existing dashboards.
        self._registry = registry if registry is not None else get_registry()
        self._lat = {leg: _RollingQuantiles(window)
                     for leg in self.LATENCY_LEGS}
        # bucket -> [sum_real_rows, sum_bucket_rows, n_batches]
        self._occupancy: Dict[int, list] = {}
        self.counters: Dict[str, int] = {
            "submitted": 0, "completed": 0, "rejected_queue_full": 0,
            "rejected_draining": 0, "expired": 0, "batches": 0,
            "padded_rows": 0, "degraded_batches": 0}
        # head/tier -> {submitted, completed, expired} + rolling
        # total-latency windows (lazily created: a probs-only engine
        # snapshots no phantom zero rows for heads it never served).
        self._by_head: Dict[str, Dict[str, int]] = {}
        self._by_tier: Dict[str, Dict[str, int]] = {}
        self._head_lat: Dict[str, _RollingQuantiles] = {}
        self._tier_lat: Dict[str, _RollingQuantiles] = {}
        # Cold-start legs: rung -> AOT compile seconds, ladder total,
        # and process-start -> first completed device batch.
        self._warmup_rungs: Dict[int, float] = {}
        self._warmup_total_s: Optional[float] = None
        self._time_to_first_batch_s: Optional[float] = None

    def observe_warmup_rung(self, bucket: int, seconds: float) -> None:
        with self._lock:
            self._warmup_rungs[int(bucket)] = float(seconds)

    def warmup_finished(self, total_seconds: float) -> None:
        with self._lock:
            self._warmup_total_s = float(total_seconds)

    def observe_first_batch(self, seconds_since_start: float) -> None:
        """First call wins: time_to_first_batch is a process-level leg."""
        with self._lock:
            if self._time_to_first_batch_s is None:
                self._time_to_first_batch_s = float(seconds_since_start)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    # ------------------------------------------------- head/tier legs
    def _bump(self, table: Dict[str, Dict[str, int]], key: str,
              event: str, n: int = 1) -> None:
        """Caller holds the lock."""
        row = table.setdefault(
            key, {"submitted": 0, "completed": 0, "expired": 0})
        row[event] = row.get(event, 0) + n

    def observe_submit(self, head: str, tier: str) -> None:
        with self._lock:
            self._bump(self._by_head, head, "submitted")
            self._bump(self._by_tier, tier, "submitted")

    def observe_expired(self, head: str, tier: str) -> None:
        with self._lock:
            self._bump(self._by_head, head, "expired")
            self._bump(self._by_tier, tier, "expired")

    def observe_completion(self, head: str, tier: str,
                           total_seconds: float) -> None:
        """One request finished: per-head/per-tier counters + rolling
        total-latency windows (the head-blind legs are observed
        separately by the batcher, as before)."""
        with self._lock:
            self._bump(self._by_head, head, "completed")
            self._bump(self._by_tier, tier, "completed")
            if head not in self._head_lat:
                self._head_lat[head] = _RollingQuantiles(self._window)
            self._head_lat[head].add(total_seconds)
            if tier not in self._tier_lat:
                self._tier_lat[tier] = _RollingQuantiles(self._window)
            self._tier_lat[tier].add(total_seconds)
        self._registry.observe(f"serve_lat_head_{head}_s", total_seconds)
        self._registry.observe(f"serve_lat_tier_{tier}_s", total_seconds)

    def observe_latency(self, leg: str, seconds: float) -> None:
        with self._lock:
            self._lat[leg].add(seconds)
        self._registry.observe(f"serve_lat_{leg}_s", seconds)

    def observe_batch(self, bucket: int, real_rows: int,
                      degraded: bool = False) -> None:
        with self._lock:
            agg = self._occupancy.setdefault(bucket, [0, 0, 0])
            agg[0] += real_rows
            agg[1] += bucket
            agg[2] += 1
            self.counters["batches"] += 1
            self.counters["padded_rows"] += bucket - real_rows
            if degraded:
                self.counters["degraded_batches"] += 1

    def dispatched_buckets(self) -> list:
        """Bucket rungs at least one device batch actually rode — the
        traffic-proven set the engine records into the warmup manifest."""
        with self._lock:
            return sorted(self._occupancy)

    def snapshot(self) -> Dict:
        """Point-in-time plain-dict view (JSON-serializable)."""
        from ..compile_cache import STATS as cache_stats

        with self._lock:
            occ = {
                str(b): {"batches": n, "mean_occupancy":
                         round(real / rows, 4) if rows else None}
                for b, (real, rows, n) in sorted(self._occupancy.items())}
            warm = {
                "rungs": {str(b): round(s, 3)
                          for b, s in sorted(self._warmup_rungs.items())},
                "cumulative_s": round(sum(self._warmup_rungs.values()), 3),
                "total_s": (round(self._warmup_total_s, 3)
                            if self._warmup_total_s is not None else None),
                "done": self._warmup_total_s is not None,
            }
            return {
                "latency_s": {leg: q.snapshot()
                              for leg, q in self._lat.items()},
                "batch_occupancy": occ,
                "counters": dict(self.counters),
                "heads": {
                    h: {**row, "latency_s":
                        self._head_lat[h].snapshot()
                        if h in self._head_lat else None}
                    for h, row in sorted(self._by_head.items())},
                "tiers": {
                    t: {**row, "latency_s":
                        self._tier_lat[t].snapshot()
                        if t in self._tier_lat else None}
                    for t, row in sorted(self._by_tier.items())},
                "warmup": warm,
                "time_to_first_batch_s":
                (round(self._time_to_first_batch_s, 3)
                 if self._time_to_first_batch_s is not None else None),
                "compile_cache": cache_stats.snapshot(),
            }

    @property
    def registry(self):
        """The registry latency samples stream into at observe time —
        where the ``serve_lat_*_s`` histograms live."""
        return self._registry

    def publish(self, registry=None) -> None:
        """Sync a point-in-time view into the telemetry registry
        (``serve_``-prefixed names) — the substrate behind the CLI's
        ``::metrics`` Prometheus command. Counters publish as absolute
        values (this object owns the totals; the registry mirrors).
        Defaults to the BOUND registry (the one ``observe_latency``
        streams the ``serve_lat_*_s`` histograms into), so the default
        view is complete; publishing into a DIFFERENT registry copies
        counters/gauges only — the histogram samples already live in
        the bound one."""
        reg = registry if registry is not None else self._registry
        snap = self.snapshot()
        for name, v in snap["counters"].items():
            reg.set_counter(f"serve_{name}_total", v)
        for leg, q in snap["latency_s"].items():
            for key in ("p50", "p95", "p99"):
                if q[key] is not None:
                    reg.gauge(f"serve_latency_{leg}_{key}_s", q[key])
        for bucket, o in snap["batch_occupancy"].items():
            if o["mean_occupancy"] is not None:
                reg.gauge(f"serve_occupancy_b{bucket}",
                          o["mean_occupancy"])
        # Per-head / per-tier instruments (serve_head_*/serve_tier_*,
        # declared in telemetry.registry.INSTRUMENTS): completed totals
        # plus rolling-p99 gauges per SLO tier and head.
        for head, row in snap["heads"].items():
            reg.set_counter(f"serve_head_{head}_total", row["completed"])
            q = row["latency_s"]
            if q and q["p99"] is not None:
                reg.gauge(f"serve_head_{head}_p99_s", q["p99"])
        for tier, row in snap["tiers"].items():
            reg.set_counter(f"serve_tier_{tier}_total", row["completed"])
            q = row["latency_s"]
            if q and q["p99"] is not None:
                reg.gauge(f"serve_tier_{tier}_p99_s", q["p99"])
        warm = snap["warmup"]
        reg.gauge("serve_warmup_cumulative_s", warm["cumulative_s"])
        if snap["time_to_first_batch_s"] is not None:
            reg.gauge("serve_time_to_first_batch_s",
                      snap["time_to_first_batch_s"])

    def emit(self, logger, **extra) -> None:
        """Append a flattened snapshot to a :class:`..metrics.MetricsLogger`
        JSONL stream (nested dicts flatten to ``lat_total_p99``-style keys
        so TensorBoard scalar export keeps working)."""
        snap = self.snapshot()
        flat = dict(extra)
        for leg, q in snap["latency_s"].items():
            for k, v in q.items():
                if v is not None:
                    flat[f"lat_{leg}_{k}"] = v
        for bucket, o in snap["batch_occupancy"].items():
            if o["mean_occupancy"] is not None:
                flat[f"occupancy_b{bucket}"] = o["mean_occupancy"]
            flat[f"batches_b{bucket}"] = o["batches"]
        for head, row in snap["heads"].items():
            flat[f"head_{head}_completed"] = row["completed"]
        for tier, row in snap["tiers"].items():
            flat[f"tier_{tier}_completed"] = row["completed"]
            q = row["latency_s"]
            if q and q["p99"] is not None:
                flat[f"tier_{tier}_p99"] = q["p99"]
        flat.update(snap["counters"])
        if snap["warmup"]["done"]:
            flat["warmup_total_s"] = snap["warmup"]["total_s"]
        if snap["time_to_first_batch_s"] is not None:
            flat["time_to_first_batch_s"] = snap["time_to_first_batch_s"]
        cache = snap["compile_cache"]
        if cache["requests"]:
            flat["compile_cache_hits"] = cache["hits"]
            flat["compile_cache_misses"] = cache["misses"]
        logger.log(**flat)
