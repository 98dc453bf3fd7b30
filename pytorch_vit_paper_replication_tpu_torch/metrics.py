"""Structured metrics (port of the JAX package's ``metrics.py``).

* :class:`MetricsLogger` — one JSON object per ``log`` call to a JSONL
  file and/or stdout, strict JSON (``allow_nan=False``), closed on every
  exit path when used as a context manager;
* :class:`Timer` — images/sec accounting that can exclude warm-up steps;
* :func:`profile_trace` — a ``torch.profiler`` capture of the enclosed
  steps, written as a Chrome trace;
* :func:`block_until_ready` — wait for the device work behind tensors, for
  honest step timing (CUDA launches return before the card finishes).

TensorBoard scalars (the JAX logger's ``tb_dir``) are not ported yet
(ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import contextlib
import json
import math
import time
from pathlib import Path
from typing import Any, Optional

import torch


def _json_safe(v: Any) -> Any:
    """Non-finite floats break the JSONL contract: ``json.dumps`` emits
    bare ``NaN``/``Infinity`` (valid Python, INVALID JSON). NaN — "no
    value" — becomes null; infinities keep their sign as strings."""
    if isinstance(v, float) and not math.isfinite(v):
        if math.isnan(v):
            return None
        return "Infinity" if v > 0 else "-Infinity"
    return v


class MetricsLogger:
    """Write metrics to a JSONL file and/or stdout.

    Also a context manager: ``with MetricsLogger(...) as logger`` closes
    the JSONL handle on ANY exit path — a run that raises mid-epoch keeps
    the rows it logged.
    """

    def __init__(self, jsonl_path: Optional[str | Path] = None,
                 stdout: bool = False):
        self.jsonl_path = Path(jsonl_path) if jsonl_path else None
        self.stdout = stdout
        self._fh = None
        if self.jsonl_path:
            self.jsonl_path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.jsonl_path, "a")

    def log(self, **metrics: Any) -> None:
        record = {"time": time.time()}
        for k, v in metrics.items():
            if hasattr(v, "item"):
                v = v.item()
            record[k] = _json_safe(v)
        line = json.dumps(record, allow_nan=False)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self.stdout:
            print(line)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class Timer:
    """Wall-clock throughput meter that can exclude warm-up steps."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = None
        self._images = 0

    def start(self):
        self._t0 = time.perf_counter()
        self._images = 0

    def tick(self, batch_size: int):
        self._images += batch_size

    @property
    def elapsed(self) -> float:
        return 0.0 if self._t0 is None else time.perf_counter() - self._t0

    @property
    def images_per_sec(self) -> float:
        dt = self.elapsed
        return self._images / dt if dt > 0 else 0.0

    def images_per_sec_per_chip(self,
                                n_chips: Optional[int] = None) -> float:
        n = n_chips or max(1, torch.cuda.device_count())
        return self.images_per_sec / max(1, n)


@contextlib.contextmanager
def profile_trace(log_dir: str | Path, enabled: bool = True):
    """Capture a ``torch.profiler`` trace (CPU, and CUDA when a card is
    present) around the enclosed steps; writes ``trace.json`` (Chrome
    trace format, for Perfetto or ``chrome://tracing``) into ``log_dir``.
    The flagged-off path does nothing."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


def block_until_ready(tree: Any) -> Any:
    """Barrier for honest step timing: synchronize the CUDA device of
    every tensor in ``tree`` (a tensor, or a dict/list/tuple of them);
    CPU tensors need none. Returns ``tree``."""
    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    for dev in devices:
        torch.cuda.synchronize(dev)
    return tree
