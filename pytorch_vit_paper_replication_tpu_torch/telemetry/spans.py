"""Per-step span telemetry for the training hot loop (port of the JAX
package's ``telemetry/spans.py``).

:class:`StepTelemetry` splits every step into spans:

* **data-wait** — seconds blocked on the batch iterator (`next()`),
* **step-exec** — dispatch + device seconds. CUDA launches return before
  the card finishes, so the per-step host wall measures dispatch; every
  ``sample_every``-th step the engine waits on the card (the step's loss
  read back to the host) before stamping the clock, and the
  step-wall/step-exec **histograms are fed barrier-window amortized
  values** (window wall / steps in window) instead of the raw mix.
  Data-wait is host-side and always recorded raw,
* **checkpoint** / **eval** — the epoch's non-step spans.

Everything publishes through the shared
:class:`.registry.TelemetryRegistry` (histograms + counters + gauges + the
postmortem event ring) and — sampled, every ``sample_every`` steps — as
JSONL rows through :class:`..metrics.MetricsLogger`, with the JAX
package's row grammar (:data:`ROW_KEYS`); ``epoch_end`` emits the
per-epoch summary row (step p50/p95/p99, data-wait fraction, goodput %).

Live gauges: ``tel_images_per_sec`` over the sampling window and
``tel_mfu`` — analytic model FLOPs (:mod:`.flops`) against the card's
bf16 dense peak, given by the caller from :func:`.flops.bf16_peak_tflops`
(None = no peak for this card: the gauge is left out). On a mesh the
caller gives the peak of the distinct cards the ranks run on and the
global batch's images. On the honesty-barrier
cadence, where the card has just caught up with the host, the
device-memory watermark gauges are sampled too
(:func:`.profiling.sample_device_memory`).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np

from .flops import analytic_mfu
from .registry import TelemetryRegistry, get_registry

# Every key a telemetry JSONL row may carry beyond the declared
# INSTRUMENTS (the JAX package's list): kept disjoint from the
# MetricsLogger vocabulary of engine.train rows, minus the shared row
# spine (time/step/epoch).
ROW_KEYS = (
    "event", "tel_block_sampled", "tel_step_amortized_s", "tel_steps",
    "tel_images", "tel_epoch_wall_s", "tel_step_p50_s", "tel_step_p95_s",
    "tel_step_p99_s", "tel_data_wait_s_sum", "tel_step_exec_s_sum",
    "tel_ckpt_s_sum", "tel_eval_s_sum",
    # event="span" rows: checkpoint/eval spans
    "span", "seconds",
)


class StepTelemetry:
    """Publish per-step spans to the registry + sampled JSONL rows.

    Args:
      jsonl_path: telemetry event stream destination (None = registry
        and watchdog only — the watchdog-without-tracing configuration).
      registry: defaults to the process-global registry.
      sample_every: emit one ``event="step"`` JSONL row every N steps
        (the first step of each window), so long runs trace at bounded
        volume. 1 = every step. The engine barriers for honest timing
        on the same cadence; it asks via :meth:`should_block`.
      flops_per_image: analytic train-step FLOPs (``telemetry.flops``);
        with ``peak_tflops`` enables the ``tel_mfu`` gauge.
      peak_tflops: the card's bf16 dense peak in TFLOP/s
        (:func:`.flops.bf16_peak_tflops`); None = gauge omitted.
      watchdog: optional :class:`.watchdog.Watchdog`; every recorded
        step and span beats it (progress of ANY kind resets the stall
        deadline — a long eval pass is not a hang).
      profiler: optional :class:`.profiling.ProfileController`; the
        engine's pre-step hook (:meth:`step_begin`) opens capture
        windows through it, and each recorded step feeds its window
        close + anomaly baseline.
    """

    def __init__(self, jsonl_path=None, *,
                 registry: Optional[TelemetryRegistry] = None,
                 sample_every: int = 32,
                 flops_per_image: Optional[float] = None,
                 peak_tflops: Optional[float] = None,
                 watchdog=None,
                 profiler=None):
        self.registry = registry if registry is not None else get_registry()
        self.sample_every = max(1, int(sample_every))
        self.flops_per_image = flops_per_image
        self.peak_tflops = peak_tflops
        self.watchdog = watchdog
        self.profiler = profiler
        self._logger = None
        if jsonl_path is not None:
            from ..metrics import MetricsLogger
            self._logger = MetricsLogger(jsonl_path)
        self._total_steps = 0
        # Live-throughput window: images/time since the last sampled row.
        self._win_t0 = time.perf_counter()
        self._win_images = 0
        # Walls buffered since the last honesty barrier (flushed
        # window-amortized into the histograms — module docstring).
        self._blk_wall: list = []
        self._blk_exec: list = []
        self._last_amortized: Optional[float] = None
        self._epoch_reset()

    # ------------------------------------------------------------ engine
    def should_block(self) -> bool:
        """True when the UPCOMING step should barrier on its metrics
        before the engine stamps its clock (honest sampled timing).

        Aligned with the emit cadence: the upcoming step is number
        ``_total_steps + 1``, and a row is emitted for steps 1, N+1,
        2N+1, ... — so every SAMPLED row carries a barrier-honest
        timing."""
        return self._total_steps % self.sample_every == 0

    def step_begin(self, step: Optional[int] = None) -> None:
        """Pre-step hook (the engine calls it just before dispatching
        the step): opens a profiler capture window when one is armed
        for this step — the capture must start BEFORE dispatch or the
        window misses the step's kernels. A None-check when no
        profiler is wired."""
        if self.profiler is not None:
            self.profiler.maybe_start(
                step if step is not None else self._total_steps + 1)

    def step(self, *, data_wait_s: float, exec_s: float, images: int,
             step: Optional[int] = None, epoch: Optional[int] = None,
             blocked: bool = False) -> None:
        """Record one completed train step's spans."""
        reg = self.registry
        total = data_wait_s + exec_s
        self._total_steps += 1
        self._ep_steps += 1
        self._ep_images += images
        self._ep_wait += data_wait_s
        self._ep_exec += exec_s
        self._win_images += images
        # Step-wall/step-exec buffer until the next barrier: unbarriered
        # walls are dispatch times under async execution and the
        # barriered step absorbs the backlog, so the histograms get the
        # window-amortized per-step value (see module docstring).
        self._blk_wall.append(total)
        self._blk_exec.append(exec_s)
        if blocked:
            self._flush_block_window()
            # Device-memory watermarks ride the honesty-barrier cadence:
            # the barrier just settled the backlog, and the cost
            # amortizes over sample_every steps.
            from .profiling import sample_device_memory
            sample_device_memory(reg)
        if self.profiler is not None:
            # The anomaly baseline is fed ONLY barrier-amortized walls
            # (unbarriered walls are dispatch times under async — a
            # device slowdown would be invisible in them); unbarriered
            # steps still tick the window-close logic.
            self.profiler.on_step_end(
                step if step is not None else self._total_steps,
                self._last_amortized if blocked else None)
        reg.observe("tel_data_wait_s", data_wait_s)
        reg.count("tel_steps_total")
        reg.count("tel_images_total", images)
        if self.watchdog is not None:
            self.watchdog.beat()
        if (self._total_steps - 1) % self.sample_every == 0:
            now = time.perf_counter()
            dt = max(now - self._win_t0, 1e-9)
            ips = self._win_images / dt
            self._win_t0, self._win_images = now, 0
            reg.gauge("tel_images_per_sec", round(ips, 2))
            row = {"event": "step",
                   "tel_data_wait_s": round(data_wait_s, 6),
                   "tel_step_exec_s": round(exec_s, 6),
                   "tel_step_s": round(total, 6),
                   "tel_images_per_sec": round(ips, 2),
                   "tel_block_sampled": int(bool(blocked))}
            if blocked and self._last_amortized is not None:
                # The raw wall above absorbs the window's async backlog;
                # this is the honest per-step figure (window wall /
                # steps) dashboards should plot.
                row["tel_step_amortized_s"] = round(self._last_amortized, 6)
            if self.flops_per_image and self.peak_tflops:
                mfu = analytic_mfu(ips, self.flops_per_image,
                                   self.peak_tflops)
                reg.gauge("tel_mfu", round(mfu, 4))
                row["tel_mfu"] = round(mfu, 4)
            if step is not None:
                row["step"] = int(step)
            if epoch is not None:
                row["epoch"] = int(epoch)
            reg.event("step", **{k: v for k, v in row.items()
                                 if k != "event"})
            if self._logger is not None:
                self._logger.log(**row)

    def heartbeat(self) -> None:
        """Beat the watchdog without recording anything — for
        fine-grained progress inside long phases (per eval batch), so a
        big test set can't outlive the stall deadline on a healthy
        run."""
        if self.watchdog is not None:
            self.watchdog.beat()

    def span(self, name: str, seconds: float) -> None:
        """Record a non-step span (``"checkpoint"`` or ``"eval"``)."""
        key = {"checkpoint": "tel_ckpt_s", "eval": "tel_eval_s"}.get(name)
        if key is None:
            raise ValueError(f"unknown span {name!r} "
                             "(expected 'checkpoint' or 'eval')")
        if name == "checkpoint":
            self._ep_ckpt += seconds
        else:
            self._ep_eval += seconds
        self.registry.observe(key, seconds)
        self.registry.event("span", span=name,
                            seconds=round(seconds, 6))
        if self._logger is not None:
            # Spans ride the JSONL too, so they outlive the process.
            self._logger.log(event="span", span=name,
                             seconds=round(seconds, 6))
        if self.watchdog is not None:
            self.watchdog.beat()

    def epoch_end(self, *, epoch: Optional[int] = None,
                  step: Optional[int] = None) -> Dict[str, Any]:
        """Summarize the finished epoch, emit its JSONL row, reset.

        Goodput is step-exec's share of the epoch wall (what MegaScale
        calls effective-compute share); data-wait fraction is the input
        pipeline's share — together they tell you whether to buy
        loader workers or kernel time.
        """
        self._flush_block_window()
        wall = max(time.perf_counter() - self._ep_t0, 1e-9)
        if self._ep_step_wall:
            p50, p95, p99 = np.percentile(
                np.asarray(self._ep_step_wall), [50.0, 95.0, 99.0])
        else:
            p50 = p95 = p99 = None
        goodput = 100.0 * self._ep_exec / wall
        wait_frac = self._ep_wait / wall
        ips = self._ep_images / wall
        summary: Dict[str, Any] = {
            "event": "epoch_summary",
            "tel_steps": self._ep_steps,
            "tel_images": self._ep_images,
            "tel_epoch_wall_s": round(wall, 3),
            "tel_step_p50_s": _r6(p50),
            "tel_step_p95_s": _r6(p95),
            "tel_step_p99_s": _r6(p99),
            "tel_data_wait_frac": round(wait_frac, 4),
            "tel_goodput_pct": round(goodput, 2),
            "tel_images_per_sec": round(ips, 2),
            "tel_data_wait_s_sum": round(self._ep_wait, 3),
            "tel_step_exec_s_sum": round(self._ep_exec, 3),
            "tel_ckpt_s_sum": round(self._ep_ckpt, 3),
            "tel_eval_s_sum": round(self._ep_eval, 3),
        }
        if self.flops_per_image and self.peak_tflops:
            summary["tel_mfu"] = round(
                analytic_mfu(ips, self.flops_per_image,
                             self.peak_tflops), 4)
        if epoch is not None:
            summary["epoch"] = int(epoch)
        if step is not None:
            summary["step"] = int(step)
        self.registry.gauge("tel_goodput_pct", summary["tel_goodput_pct"])
        self.registry.gauge("tel_data_wait_frac",
                            summary["tel_data_wait_frac"])
        self.registry.event("epoch_summary",
                            **{k: v for k, v in summary.items()
                               if k != "event"})
        if self._logger is not None:
            self._logger.log(**summary)
        if self.watchdog is not None:
            self.watchdog.beat()
        self._epoch_reset()
        return summary

    # ------------------------------------------------------------- misc
    def _flush_block_window(self) -> None:
        """Fold the buffered walls since the last barrier into the
        histograms/percentile list as the window-amortized per-step
        value, one observation per step so weighting stays per-step
        (module docstring: the async-dispatch honesty rule)."""
        n = len(self._blk_wall)
        if not n:
            return
        aw = sum(self._blk_wall) / n
        ae = sum(self._blk_exec) / n
        for _ in range(n):
            self.registry.observe("tel_step_s", aw)
            self.registry.observe("tel_step_exec_s", ae)
            self._ep_step_wall.append(aw)
        self._last_amortized = aw
        self._blk_wall.clear()
        self._blk_exec.clear()

    def _epoch_reset(self) -> None:
        self._ep_t0 = time.perf_counter()
        self._ep_steps = 0
        self._ep_images = 0
        self._ep_wait = 0.0
        self._ep_exec = 0.0
        self._ep_ckpt = 0.0
        self._ep_eval = 0.0
        self._ep_step_wall = []

    def close(self) -> None:
        if self._logger is not None:
            self._logger.close()
            self._logger = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _r6(v):
    return None if v is None else round(float(v), 6)
