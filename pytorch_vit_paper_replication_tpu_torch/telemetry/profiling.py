"""On-demand ``torch.profiler`` capture windows + device-memory watermarks
(port of the JAX package's ``telemetry/profiling.py``).

Step spans say *which phase* a slow step spent its time in; they cannot
say *which kernel* or *how many device bytes*. This module drills below
the span level, without the cost of always-on tracing:

* :class:`ProfileController` — bounded ``torch.profiler`` capture
  windows (CPU and CUDA activity) over the training loop, armed three
  ways:

  - **explicitly**: ``train --profile-steps A:B`` captures global steps
    A..B (inclusive) into the run's trace dir,
  - **by signal**: ``SIGUSR2`` to a running trainer captures the next
    :data:`SIGNAL_STEPS` steps,
  - **automatically**: a rolling step-time baseline; when the current
    window's p50 regresses more than ``auto_pct`` % over the anchored
    baseline, the controller arms a capture of the next window.

  Each window writes one Chrome trace (``trace.json``, for Perfetto or
  ``chrome://tracing``) into its own ``capture_NNN_stepA_reason``
  directory. Every capture publishes through the registry
  (``profiler_captures_total``, ``profiler_capture_active``,
  ``profiler_last_capture_path``) and the event ring, so the watchdog
  postmortem names the most recent capture. All profiler calls are
  fenced: a profiling failure degrades to a counted error, never a dead
  run.

* :func:`sample_device_memory` — device-memory watermarks from the CUDA
  caching allocator (``torch.cuda.memory_allocated``,
  ``max_memory_allocated``, ``memory_stats``) and ``mem_get_info``,
  under the JAX package's gauge names. It reads CUDA only when
  ``torch.cuda.is_initialized()`` (false in a forked loader worker, and
  in a CPU-only run, where it records nothing).
  :class:`.spans.StepTelemetry` samples it on the honesty-barrier
  cadence.

The per-step hooks are a None-check when disarmed, the anomaly check runs
every :data:`CHECK_EVERY` samples, and watermark sampling rides the (already
amortized) barrier cadence.
"""

from __future__ import annotations

import signal
import statistics
from collections import deque
from pathlib import Path
from typing import Optional, Tuple

from .registry import TelemetryRegistry, get_registry

TRACE_NAME = "trace.json"
# Anomaly arming: the rolling window of fed samples (one barrier-amortized
# wall per honesty barrier, ``StepTelemetry.sample_every`` steps each);
# the samples skipped first (compile steps would poison the baseline);
# and how often, in samples, the window's median is compared with the
# anchored baseline (keeps the median off the per-step path).
AUTO_WINDOW = 64
WARMUP_SAMPLES = 3
CHECK_EVERY = 16
# Length of a SIGUSR2- or anomaly-armed window, in steps.
SIGNAL_STEPS = 16
# Windows per process: profiling disk stays bounded however flappy the
# anomaly signal gets.
MAX_CAPTURES = 8


def sample_device_memory(registry: Optional[TelemetryRegistry] = None
                         ) -> dict:
    """Publish device-memory watermark gauges; returns what it saw.

    For each initialized CUDA device ``i`` (one on one card):
    ``mem_live_bytes`` / ``mem_devN_bytes_in_use`` are the bytes the
    caching allocator holds for live tensors (``memory_allocated``),
    ``mem_live_arrays`` the allocations it holds for them
    (``memory_stats()["allocation.all.current"]``),
    ``mem_devN_bytes_peak`` the allocator's peak
    (``max_memory_allocated``) and ``mem_devN_bytes_limit`` the card's
    total memory (``mem_get_info``). Peaks (``*_peak``) are tracked
    monotonically via :meth:`..registry.TelemetryRegistry.gauge_max`.
    Nothing here waits on the card. Without an initialized CUDA context it
    records nothing. Every probe is fenced: telemetry must never take the
    step down.
    """
    reg = registry if registry is not None else get_registry()
    seen: dict = {}
    try:
        import torch
        if not torch.cuda.is_initialized():
            return seen
        live_total = arrays = 0
        for i in range(torch.cuda.device_count()):
            live = int(torch.cuda.memory_allocated(i))
            peak = int(torch.cuda.max_memory_allocated(i))
            _, total = torch.cuda.mem_get_info(i)
            stats = torch.cuda.memory_stats(i)
            live_total += live
            arrays += int(stats.get("allocation.all.current", 0))
            reg.gauge(f"mem_dev{i}_bytes_in_use", live)
            reg.gauge_max(f"mem_dev{i}_bytes_peak", peak)
            reg.gauge(f"mem_dev{i}_bytes_limit", int(total))
            seen[f"mem_dev{i}_bytes_in_use"] = live
            seen[f"mem_dev{i}_bytes_peak"] = peak
            seen[f"mem_dev{i}_bytes_limit"] = int(total)
        seen["mem_live_bytes"] = live_total
        seen["mem_live_arrays"] = arrays
        reg.gauge("mem_live_bytes", live_total)
        reg.gauge("mem_live_arrays", arrays)
        reg.gauge_max("mem_live_bytes_peak", live_total)
    except Exception as e:  # noqa: BLE001 — a failed probe is counted
        reg.count("mem_sample_errors_total")
        reg.event("mem_sample_error", error=f"{type(e).__name__}: {e}")
    return seen


def parse_profile_steps(spec: str) -> Tuple[int, int]:
    """``"A:B"`` -> (A, B), global train steps, inclusive window."""
    try:
        a_s, b_s = spec.split(":")
        a, b = int(a_s), int(b_s)
    except ValueError:
        raise ValueError(
            f"--profile-steps expects START:END (e.g. 100:110), got "
            f"{spec!r}") from None
    if a < 1 or b < a:
        raise ValueError(
            f"--profile-steps window {a}:{b} must satisfy 1 <= START <= END")
    return a, b


class ProfileController:
    """Arm/disarm ``torch.profiler`` capture windows over the step loop.

    The engine's pre-step hook calls :meth:`maybe_start` (capture must
    open BEFORE dispatch so the window holds the step's kernels) and
    :class:`..spans.StepTelemetry` calls :meth:`on_step_end` after each
    recorded step (closes the window, feeds the anomaly baseline).

    Args:
      trace_dir: capture destination; each window writes its own
        ``capture_NNN_stepA_reason/trace.json`` (Chrome trace format).
      steps: optional explicit (start, end) global-step window
        (``--profile-steps``).
      auto: arm a capture automatically when the rolling step-time p50
        regresses more than ``auto_pct`` % over the anchored baseline.
        The baseline anchors to the first full :data:`AUTO_WINDOW` after
        :data:`WARMUP_SAMPLES` samples and re-anchors after every fired
        capture so one long regression can't fire forever.
    """

    def __init__(self, trace_dir: str | Path, *,
                 registry: Optional[TelemetryRegistry] = None,
                 steps: Optional[Tuple[int, int]] = None,
                 auto: bool = False,
                 auto_pct: float = 25.0):
        self.trace_dir = Path(trace_dir)
        self.registry = registry if registry is not None else get_registry()
        self.auto = bool(auto)
        self.auto_pct = float(auto_pct)
        # One pending window at a time: (start_step, end_step, reason).
        self._window: Optional[Tuple[int, int, str]] = steps and (
            int(steps[0]), int(steps[1]), "flag")
        self._active: Optional[Tuple[int, Path]] = None  # (end, dir)
        self._prof = None
        self._captures = 0
        self._signal_request = False
        self._sigusr2_installed = False
        self._prev_sigusr2 = None
        self._recent: deque = deque(maxlen=AUTO_WINDOW)
        self._baseline_p50: Optional[float] = None
        self._steps_seen = 0
        self.last_capture_path: Optional[str] = None
        self.registry.gauge("profiler_capture_active", 0)

    # ------------------------------------------------------------ arming
    def arm(self, start_step: int, n_steps: Optional[int] = None,
            reason: str = "manual") -> bool:
        """Request a capture of ``n_steps`` starting at ``start_step``;
        False when refused (already active/armed, or budget spent).
        Refusals are counted and ring-evented — an operator whose
        SIGUSR2 lost to a pending ``--profile-steps`` window (or to a
        spent :data:`MAX_CAPTURES` budget) must see WHY no trace appears,
        not wait forever."""
        if self._active is not None or self._window is not None:
            self._refuse(reason, "capture already active or armed")
            return False
        if self._captures >= MAX_CAPTURES:
            self._refuse(reason, f"max_captures={MAX_CAPTURES} spent")
            return False
        n = SIGNAL_STEPS if n_steps is None else max(1, int(n_steps))
        self._window = (int(start_step), int(start_step) + n - 1, reason)
        self.registry.event("profiler_armed", start=self._window[0],
                            end=self._window[1], reason=reason)
        return True

    def _refuse(self, reason: str, why: str) -> None:
        self.registry.count("profiler_arms_refused_total")
        self.registry.event("profiler_arm_refused", reason=reason,
                            why=why)

    def install_sigusr2(self) -> None:
        """SIGUSR2 -> capture the next :data:`SIGNAL_STEPS` steps. Main
        thread only (CPython rule); the handler just sets a flag — the
        step loop does the actual arming, so a signal landing mid-step
        can't re-enter the profiler."""
        self._prev_sigusr2 = signal.getsignal(signal.SIGUSR2)
        self._sigusr2_handler = self._on_sigusr2
        signal.signal(signal.SIGUSR2, self._sigusr2_handler)
        self._sigusr2_installed = True

    def uninstall_sigusr2(self) -> None:
        if not self._sigusr2_installed:
            return
        try:
            if signal.getsignal(signal.SIGUSR2) == self._sigusr2_handler:
                signal.signal(signal.SIGUSR2, self._prev_sigusr2)
        except ValueError:  # not the main thread
            return
        self._sigusr2_installed = False

    def _on_sigusr2(self, signum, frame) -> None:
        self._signal_request = True

    # --------------------------------------------------------- step hooks
    def maybe_start(self, step: int) -> bool:
        """Pre-step hook: open the capture window when ``step`` enters
        an armed one. Returns True while a capture is active."""
        if self._signal_request:
            self._signal_request = False
            self.arm(step, reason="sigusr2")
        if self._active is not None:
            return True
        if self._window is None or step < self._window[0]:
            return False
        start, end, reason = self._window
        self._window = None
        if step > end:  # the window was missed entirely (resume skipped
            return False  # past it); drop it rather than capture garbage
        path = (self.trace_dir
                / f"capture_{self._captures:03d}_step{step}_{reason}")
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile
            if torch._C._autograd._profiler_enabled():
                # One torch.profiler session at a time (a nested one
                # corrupts the outer's trace): refused like a failed start.
                raise RuntimeError("another torch.profiler session is "
                                   "active (--profile-dir's epoch trace?)")
            path.mkdir(parents=True, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.start()
            self._prof = prof
        except Exception as e:  # noqa: BLE001 — profiling must never
            # take the training step down with it.
            self.registry.count("profiler_capture_errors_total")
            self.registry.event("profiler_error", error=f"{e}")
            return False
        self._active = (end, path)
        self._captures += 1
        self.registry.count("profiler_captures_total")
        self.registry.gauge("profiler_capture_active", 1)
        self.registry.event("profiler_capture_start", step=step,
                            end=end, reason=reason, path=str(path))
        return True

    def on_step_end(self, step: int,
                    step_s: Optional[float] = None) -> None:
        """Post-step hook: close an elapsed window; when ``step_s`` is
        given (the caller passes barrier-amortized walls only — raw
        walls under async dispatch are dispatch times and would hide a
        device slowdown), feed the anomaly baseline."""
        if self._active is not None and step >= self._active[0]:
            self._stop(step)
        # No anomaly work while a capture is active or a window is
        # already pending (re-arming would only rack up refusals).
        if (not self.auto or self._active is not None
                or self._window is not None or step_s is None):
            return
        self._steps_seen += 1
        if self._steps_seen <= WARMUP_SAMPLES:
            return  # compile steps would poison the baseline
        self._recent.append(float(step_s))
        if (len(self._recent) < AUTO_WINDOW
                or self._steps_seen % CHECK_EVERY):
            return
        p50 = statistics.median(self._recent)
        if self._baseline_p50 is None:
            self._baseline_p50 = p50
            return
        if p50 > self._baseline_p50 * (1.0 + self.auto_pct / 100.0):
            armed = self.arm(step + 1, reason="anomaly")
            if armed:
                self.registry.event(
                    "profiler_anomaly", step=step,
                    p50_s=round(p50, 6),
                    baseline_p50_s=round(self._baseline_p50, 6),
                    regression_pct=round(
                        100.0 * (p50 / self._baseline_p50 - 1.0), 2))
                # Re-anchor: the regressed regime is the new normal
                # until something changes again — one sustained
                # regression fires one capture, not MAX_CAPTURES.
                self._baseline_p50 = p50

    def _stop(self, step: int) -> None:
        end, path = self._active
        prof, self._prof = self._prof, None
        try:
            import torch
            if torch.cuda.is_initialized():
                # The window's kernels must have run before the trace
                # closes, or the tail of the last step is missing from it.
                torch.cuda.synchronize()
            prof.stop()
            prof.export_chrome_trace(str(path / TRACE_NAME))
        except Exception as e:  # noqa: BLE001
            self.registry.count("profiler_capture_errors_total")
            self.registry.event("profiler_error", error=f"{e}")
        self._active = None
        self.last_capture_path = str(path)
        self.registry.gauge("profiler_capture_active", 0)
        self.registry.gauge("profiler_last_capture_path", str(path))
        self.registry.event("profiler_capture_stop", step=step,
                            path=str(path))

    # ------------------------------------------------------------ cleanup
    def close(self) -> None:
        """Stop any active capture and release the signal handler —
        wired into train.py's observability ExitStack so a run that
        raises mid-capture still finalizes its trace files."""
        if self._active is not None:
            self._stop(-1)
        self.uninstall_sigusr2()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
