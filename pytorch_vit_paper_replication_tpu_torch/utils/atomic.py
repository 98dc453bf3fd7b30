"""Atomic small-file writes: temp in the same directory + ``os.replace``.

A copy of the JAX package's ``utils/atomic.py``: every file a restart or
replica reads back to make decisions (warmup manifests, ``transform.json``,
``model_meta.json``) must never be observable torn — a process killed
mid-write leaves the previous version intact, and a concurrent reader sees
either the old or the new file, never a prefix.

The temp name carries the PID so replicas sharing a checkpoint
directory can't collide on the temp file; ``os.replace`` is atomic on
POSIX within a filesystem, which the same-directory temp guarantees.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Optional


def atomic_write_text(path: str | Path, text: str) -> Path:
    """Write ``text`` to ``path`` atomically (temp + ``os.replace``)."""
    p = Path(path)
    tmp = p.with_name(p.name + f".tmp.{os.getpid()}")
    tmp.write_text(text)
    os.replace(tmp, p)
    return p


def atomic_write_json(path: str | Path, payload: Any, *,
                      indent: Optional[int] = None,
                      sort_keys: bool = False) -> Path:
    """``json.dumps`` + :func:`atomic_write_text` — the manifest shape
    every durable JSON artifact in this repo is written with."""
    return atomic_write_text(
        path, json.dumps(payload, indent=indent, sort_keys=sort_keys))
