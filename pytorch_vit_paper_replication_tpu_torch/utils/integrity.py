"""Shared access to a checkpoint stream's ``integrity.json`` (a copy of
the JAX package's ``utils/integrity.py``).

ONE copy of the manifest reader and of the cross-process writer lock.
Two writers share the file: the trainer's :class:`..checkpoint
.Checkpointer` owns the ``steps`` digest map, and the deploy
controller (a DIFFERENT process) owns the ``pins`` rotation-exemption
list. Each writer preserves the keys it doesn't own — but
read-modify-write without mutual exclusion still loses updates: the
trainer reads the manifest, spends seconds digesting payload bytes,
and writes back a ``pins`` list from BEFORE a pin landed, after which
the next rotation prunes the very step a canary rollback needs.
:func:`integrity_lock` (``flock`` on a sidecar lockfile; advisory,
POSIX) brackets every read-modify-write so both writers serialize.
Slow work (digesting) belongs OUTSIDE the lock; only the
re-read → merge → atomic-write critical section holds it.

Plain reads never need the lock: writes land via temp +
``os.replace``, so a reader always sees a complete manifest.
"""

from __future__ import annotations

import fcntl
import json
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Dict

INTEGRITY_NAME = "integrity.json"
LOCK_NAME = "integrity.lock"


def read_integrity_file(directory: str | Path) -> Dict[str, Any]:
    """The manifest as written, or ``{"steps": {}}`` before the first
    write (and on a torn/absent file — atomic writes make torn
    impossible, absent-yet is the only real case)."""
    try:
        return json.loads(
            (Path(directory) / INTEGRITY_NAME).read_text())
    except (OSError, ValueError):
        return {"steps": {}}


def read_integrity_file_strict(directory: str | Path) -> Dict[str, Any]:
    """Like :func:`read_integrity_file` but only an ABSENT file maps
    to the empty default — any other read/parse failure raises. For
    callers whose failure mode must be CLOSED: checkpoint rotation
    reading the pins list must skip a round on a transient read error
    (EMFILE, EIO), not treat it as "no pins" and prune the very step
    a canary rollback needs."""
    try:
        return json.loads(
            (Path(directory) / INTEGRITY_NAME).read_text())
    except FileNotFoundError:
        return {"steps": {}}


@contextmanager
def integrity_lock(directory: str | Path):
    """Advisory cross-process writer lock for ``integrity.json``
    read-modify-write sections. Blocks until held; released on exit
    (and by the OS on process death, so a SIGKILLed holder cannot
    wedge the other writer)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    with open(directory / LOCK_NAME, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)
