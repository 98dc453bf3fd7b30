"""Stall watchdog: postmortem dumps instead of silent freezes (port of the
JAX package's ``telemetry/watchdog.py``).

A stalled loader thread, a hung collective, a wedged checkpoint writer or
a kernel that never finishes freezes a training process with no
diagnostics. :class:`Watchdog` is a heartbeat thread: the engine loop
beats it on every step/span (and every eval batch), and when no beat
lands within the deadline it writes a **postmortem** —

* all-thread Python stacks (``faulthandler`` — where every thread is
  wedged, including the loader pool and the checkpoint writer),
* host memory (``/proc/self/status``) and the CUDA caching allocator's
  counters (``torch.cuda.memory_stats``, host-side bookkeeping),
* the registry snapshot plus the last-N telemetry events,

— to a file, then keeps watching (a recovered stall re-arms it). The same
dump fires on SIGTERM when :meth:`install_sigterm` is used.

The watchdog thread never waits on the card: no ``synchronize``, no
``.item()``, no copy — a stalled kernel (``csrc/hopper.cuh``'s mbarrier
trap is the case in point) must not hang the postmortem too.
"""

from __future__ import annotations

import datetime
import faulthandler
import json
import os
import signal
import sys
import threading
import time
from pathlib import Path
from typing import Callable, Optional

from .registry import TelemetryRegistry, dump_events_jsonl, get_registry

# Ring events a postmortem tails.
LAST_EVENTS = 64
# Until the FIRST beat lands the deadline is this many times longer: the
# first beat only arrives after step 1 completes, which includes the
# kernels' build and the CUDA context's start-up. That is startup, not a
# stall; without the grace a healthy run would open with a bogus
# postmortem.
FIRST_GRACE_FACTOR = 10.0

# The allocator counters a postmortem shows, by the name it shows them
# under (the JAX package's keys where they mean the same).
_CUDA_STATS = {"bytes_in_use": "allocated_bytes.all.current",
               "peak_bytes_in_use": "allocated_bytes.all.peak",
               "bytes_reserved": "reserved_bytes.all.current",
               "num_alloc_retries": "num_alloc_retries",
               "num_ooms": "num_ooms"}


def memory_report() -> dict:
    """Host VmRSS/VmHWM/VmSize + per-device allocator counters
    (best-effort: every probe is fenced — a postmortem must never crash
    the dump). Reads ``torch.cuda.memory_stats`` only when torch is
    already imported and a CUDA context exists (the dump imports nothing);
    it is host-side bookkeeping and does not wait on the card."""
    report: dict = {"host": {}, "devices": {}}
    try:
        for line in Path("/proc/self/status").read_text().splitlines():
            if line.startswith(("VmRSS", "VmHWM", "VmSize")):
                k, v = line.split(":", 1)
                report["host"][k] = v.strip()
    except OSError:
        pass
    try:
        torch = sys.modules.get("torch")
        if torch is not None and torch.cuda.is_initialized():
            for i in range(torch.cuda.device_count()):
                ms = torch.cuda.memory_stats(i)
                report["devices"][f"cuda:{i}"] = {
                    k: ms[src] for k, src in _CUDA_STATS.items()
                    if src in ms}
    except Exception as e:  # noqa: BLE001 — keep the rest of the dump
        report["devices_error"] = f"{type(e).__name__}: {e}"
    return report


class Watchdog:
    """Heartbeat-deadline watchdog with postmortem dumps.

    Args:
      deadline_s: seconds without a :meth:`beat` before a stall dump.
      postmortem_path: dump destination; dumps APPEND (a flapping stall
        accumulates its history in one file).
      registry: where stall counters/events publish and whose event
        ring the dump includes; default process-global.
      on_stall: called with the postmortem's path after a stall dump
        (a rank of a mesh ends its process there: a stall on any rank
        fails the run).

    The checker polls every ``deadline_s / 4`` (clamped to 0.05-5 s);
    until the first beat it judges against :data:`FIRST_GRACE_FACTOR`
    times the deadline.
    """

    def __init__(self, deadline_s: float, *,
                 postmortem_path: str | Path = "postmortem.txt",
                 registry: Optional[TelemetryRegistry] = None,
                 on_stall: Optional[Callable[[Path], None]] = None):
        if deadline_s <= 0:
            raise ValueError("deadline_s must be > 0")
        self.deadline_s = float(deadline_s)
        self.postmortem_path = Path(postmortem_path)
        self.registry = registry if registry is not None else get_registry()
        self.on_stall = on_stall
        self.poll_s = min(max(self.deadline_s / 4.0, 0.05), 5.0)
        self._last_beat = time.monotonic()
        self._beat_seen = False
        self._stalled = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # RLock: the SIGTERM handler runs dump() on whatever the main
        # thread was doing — possibly already inside dump() (stall dump
        # interrupted by preemption). A plain Lock would self-deadlock.
        self._dump_lock = threading.RLock()
        self._prev_sigterm = None
        self._sigterm_installed = False

    # ---------------------------------------------------------- heartbeat
    def beat(self) -> None:
        """Progress of any kind — called from the instrumented loop."""
        self._last_beat = time.monotonic()
        self._beat_seen = True
        self.registry.count("watchdog_beats_total")
        if self._stalled:
            # Recovery re-arms the stall dump; record that it happened.
            self._stalled = False
            self.registry.event("watchdog_recovered")

    def start(self) -> "Watchdog":
        if self._thread is None:
            self._last_beat = time.monotonic()
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="telemetry-watchdog", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self.uninstall_sigterm()
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(self.poll_s * 4 + 1.0)

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            silent = time.monotonic() - self._last_beat
            # Until the first beat, the run is still compiling step 1 —
            # judge it against the startup grace, not the steady-state
            # deadline.
            deadline = (self.deadline_s if self._beat_seen
                        else FIRST_GRACE_FACTOR * self.deadline_s)
            if silent > deadline and not self._stalled:
                self._stalled = True
                self.registry.count("watchdog_stalls_total")
                path = self.dump(reason="stall", silent_s=silent)
                if self.on_stall is not None:
                    self.on_stall(path)

    # --------------------------------------------------------------- dump
    def dump(self, *, reason: str, silent_s: Optional[float] = None
             ) -> Path:
        """Write one postmortem section (see module docstring).

        The dump lock is taken with a timeout: if ANOTHER thread is
        wedged mid-dump (storage hang — exactly a stall scenario), a
        SIGTERM dump proceeds unserialized rather than joining the
        hang; a torn dump beats no dump. Same-thread reentry (signal
        during a stall dump) is safe — it's an RLock.
        """
        path = self.postmortem_path
        locked = self._dump_lock.acquire(timeout=10.0)
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            with open(path, "a") as fh:
                now = datetime.datetime.now(datetime.timezone.utc)
                fh.write(f"==== watchdog postmortem reason={reason} "
                         f"pid={os.getpid()} time={now.isoformat()}")
                if silent_s is not None:
                    fh.write(f" silent_s={silent_s:.2f} "
                             f"deadline_s={self.deadline_s:g}")
                fh.write("\n---- all-thread stacks ----\n")
                # faulthandler writes straight to the fd: flush the
                # Python-side buffer first so sections stay ordered.
                fh.flush()
                try:
                    faulthandler.dump_traceback(file=fh, all_threads=True)
                except Exception as e:  # noqa: BLE001 — keep dumping
                    fh.write(f"<faulthandler failed: {e}>\n")
                fh.write("---- memory ----\n")
                fh.write(json.dumps(memory_report(), indent=2) + "\n")
                snap = self.registry.snapshot()
                # Explicit forensic sections: the device-memory
                # watermarks and the most recent profiler capture are
                # the two things a stall investigation opens first —
                # surface them by name instead of burying them in the
                # full snapshot below.
                gauges = snap.get("gauges", {})
                fh.write("---- device memory watermarks ----\n")
                mem = {k: v for k, v in sorted(gauges.items())
                       if k.startswith("mem_")}
                fh.write((json.dumps(mem, indent=2, default=str)
                          if mem else "<no watermark samples recorded>")
                         + "\n")
                fh.write("---- last profiler capture ----\n")
                fh.write(str(gauges.get("profiler_last_capture_path",
                                        "<no captures this run>"))
                         + "\n")
                fh.write("---- registry snapshot ----\n")
                fh.write(json.dumps(snap, default=str) + "\n")
                fh.write(f"---- last {LAST_EVENTS} telemetry "
                         f"events ----\n")
                dump_events_jsonl(self.registry.last_events(LAST_EVENTS),
                                  fh)
                fh.write("==== end postmortem ====\n")
        finally:
            if locked:
                self._dump_lock.release()
        self.registry.count("watchdog_postmortems_total")
        self.registry.event("watchdog_postmortem", reason=reason,
                            path=str(path))
        return path

    # ------------------------------------------------------------- signal
    def install_sigterm(self) -> None:
        """Dump on SIGTERM (preemption forensics), then chain to the
        previously-installed disposition so the process still dies the
        way the supervisor expects. Main thread only (CPython rule);
        :meth:`stop` uninstalls, so a retired watchdog in a long-lived
        process (second train.main call, notebook) can't keep dumping
        stale forensics into the chain."""
        self._prev_sigterm = signal.getsignal(signal.SIGTERM)
        # One stable bound-method object: uninstall must compare the
        # CURRENT disposition against what it installed (a fresh
        # `self._on_sigterm` access builds a new object every time).
        self._sigterm_handler = self._on_sigterm
        signal.signal(signal.SIGTERM, self._sigterm_handler)
        self._sigterm_installed = True

    def uninstall_sigterm(self) -> None:
        """Restore the pre-install disposition (no-op when not
        installed, best-effort off the main thread — CPython only
        allows signal() there)."""
        if not getattr(self, "_sigterm_installed", False):
            return
        try:
            # Only restore when WE are still the disposition — another
            # install since ours must not be clobbered.
            if signal.getsignal(signal.SIGTERM) == self._sigterm_handler:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
        except ValueError:   # not the main thread: leave it installed
            return
        self._sigterm_installed = False

    def _on_sigterm(self, signum, frame) -> None:
        self.dump(reason="sigterm")
        prev = self._prev_sigterm
        if callable(prev):
            prev(signum, frame)
        elif prev != signal.SIG_IGN:
            # Default disposition — or None, a handler installed from C
            # that Python can neither call nor restore (getsignal()
            # returns None for those; installing ours already displaced
            # it). Best we can do either way: restore SIG_DFL and
            # re-deliver so exit status still says "killed by SIGTERM".
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

    # ------------------------------------------------------------ context
    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
