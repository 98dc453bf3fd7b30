"""Content digests of on-disk artifact directories.

A copy of the JAX package's ``utils/digest.py``: the walk-sorted
sha256-over-(relative-path, bytes) digest that fingerprints the servable
export a replica is answering from (the ``::stats``
``checkpoint_fingerprint`` field).
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Any, Dict, Iterable

FINGERPRINT_SIDECAR = "fingerprint.json"


def resolve_export_dir(directory: str | Path) -> Path:
    """ONE copy of the export-directory resolution: a training
    ``--checkpoint-dir`` and its ``final`` params export are the same
    servable model, whichever spelling the operator used. Every
    consumer of a checkpoint's on-disk identity (the serve engine's
    warmup manifest + ``::stats`` fingerprint, the deploy controller's
    incumbent bootstrap) must resolve through here — two resolvers
    that drift would make a replica's reported fingerprint stop
    matching the controller's export fingerprint, the identity the
    whole canary/promote machinery keys on."""
    d = Path(directory)
    if (d / "final").is_dir():
        d = d / "final"
    return d


def checkpoint_fingerprint(export_dir: str | Path) -> str:
    """Short content identity of a servable params export — the value
    a replica's ``::stats`` reports as ``checkpoint_fingerprint`` and
    the deploy controller compares candidate exports against. Excludes
    the operational side-band files written NEXT TO the params
    (``warmup.json`` by the serve engine on first traffic, the
    fingerprint sidecar itself): an identity that churned when they
    appear would be useless for proving which model answered."""
    return digest_dir(
        export_dir,
        exclude=("warmup.json", FINGERPRINT_SIDECAR))["sha256"][:16]


def cached_checkpoint_fingerprint(export_dir: str | Path) -> str:
    """:func:`checkpoint_fingerprint` behind a sidecar cache. The full
    digest streams every payload byte — seconds of serial I/O for a
    big export — and it lands on every replica boot (spawn, supervised
    restart, autoscale scale-up, canary swap), exactly the
    warm-restart band the autoscaler and canary pricing key on.
    Exports are immutable by contract, so the first computation writes
    ``fingerprint.json`` next to the params (atomic; best-effort — a
    read-only export just recomputes per boot) and every later boot
    reads it back."""
    export_dir = Path(export_dir)
    path = export_dir / FINGERPRINT_SIDECAR
    try:
        fp = json.loads(path.read_text()).get("fingerprint")
        if isinstance(fp, str) and len(fp) == 16:
            return fp
    except (OSError, ValueError):
        pass
    fp = checkpoint_fingerprint(export_dir)
    try:
        from .atomic import atomic_write_json
        atomic_write_json(path, {"fingerprint": fp})
    except OSError:
        pass
    return fp


def digest_dir(directory: str | Path,
               exclude: Iterable[str] = ()) -> Dict[str, Any]:
    """Content digest of one directory tree: sha256 over every payload
    file's (relative path, bytes), walked in sorted order so the digest
    is layout-stable. ``exclude`` names files (by exact relative posix
    path or basename) that are operational side-band — e.g. the serve
    ``warmup.json`` manifest, which mutates next to a checkpoint the
    fleet is serving and must not churn its content identity.
    """
    directory = Path(directory)
    excluded = set(exclude)
    h = hashlib.sha256()
    files = 0
    nbytes = 0
    for p in sorted(directory.rglob("*")):
        if not p.is_file():
            continue
        rel = p.relative_to(directory).as_posix()
        if rel in excluded or p.name in excluded:
            continue
        h.update(rel.encode() + b"\x00")
        with open(p, "rb") as f:
            while True:
                chunk = f.read(1 << 20)
                if not chunk:
                    break
                h.update(chunk)
                nbytes += len(chunk)
        files += 1
    return {"sha256": h.hexdigest(), "files": files, "bytes": nbytes}
