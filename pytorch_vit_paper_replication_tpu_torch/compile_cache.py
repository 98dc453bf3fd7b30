"""Cold-start instrumentation shared with the JAX package's serving stack.

The subset of the JAX package's ``compile_cache.py`` that serving needs:

* :func:`seconds_since_process_start` — the denominator of
  ``time_to_first_batch_s`` (honest restart latency includes interpreter,
  import and device init, not just the warmup the caller times);
* :class:`CacheStats` / :data:`STATS` — the ``compile_cache`` block of the
  ``::stats`` snapshot. The port has no persistent compilation cache yet
  (eager PyTorch; CUDA graphs come later), so nothing feeds the counters
  and they read zero;
* :func:`config_fingerprint` — the stable digest behind the warmup
  manifest's model identity, byte-compatible with the JAX package's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional

_IMPORT_WALL_TIME = time.time()


def _process_start_unix() -> float:
    """Wall-clock time this PROCESS started (not this module's import).

    Linux: field 22 of /proc/self/stat is the start time in clock ticks
    since boot; boot time is `btime` in /proc/stat. Falls back to this
    module's import time elsewhere — a lower bound.
    """
    try:
        stat = Path("/proc/self/stat").read_text()
        ticks = float(stat.rsplit(")", 1)[1].split()[19])
        hz = os.sysconf("SC_CLK_TCK")
        btime = next(
            float(line.split()[1])
            for line in Path("/proc/stat").read_text().splitlines()
            if line.startswith("btime "))
        return btime + ticks / hz
    except Exception:  # noqa: BLE001 — non-Linux / hardened /proc
        return _IMPORT_WALL_TIME


_PROCESS_START_UNIX = _process_start_unix()


def seconds_since_process_start() -> float:
    """Seconds since the interpreter started — the time-to-first-X base."""
    return time.time() - _PROCESS_START_UNIX


class CacheStats:
    """Thread-safe compile-cache counters (the ``::stats`` block)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests = 0
        self.hits = 0
        self.saved_secs = 0.0
        self.cache_dir: Optional[str] = None
        self.salt: Optional[str] = None

    @property
    def misses(self) -> int:
        return self.requests - self.hits

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "cache_dir": self.cache_dir,
                "salt": self.salt,
                "requests": self.requests,
                "hits": self.hits,
                "misses": self.requests - self.hits,
                "compile_time_saved_s": round(self.saved_secs, 3),
            }


STATS = CacheStats()


def config_fingerprint(*objs: Any, **parts: Any) -> str:
    """Stable hex digest of arbitrary config state.

    Dataclasses (e.g. :class:`..configs.ViTConfig`) are serialized via
    ``asdict``; everything else must be JSON-serializable. Keyword parts
    are sorted, so call-site ordering cannot change the digest.
    """
    def canon(o):
        if dataclasses.is_dataclass(o) and not isinstance(o, type):
            return {"__dc__": type(o).__name__,
                    **dataclasses.asdict(o)}
        return o

    payload = {"args": [canon(o) for o in objs],
               "kwargs": {k: canon(v) for k, v in sorted(parts.items())}}
    blob = json.dumps(payload, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()
