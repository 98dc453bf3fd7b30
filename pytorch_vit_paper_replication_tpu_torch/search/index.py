"""The on-disk index contract: one manifest over a memory-mapped matrix
(port of the JAX package's ``search/index.py``; the files are the same).

An index directory holds

* ``index.json`` — the manifest (written atomically): rows / dim / dtype
  of the embedding matrix, the path of the source ``outputs.npy`` (the
  batch job's sink; relative to the index directory where it can be, so
  the pair travels together), the source's sha256 (verified by
  ``tools.build_index`` before indexing), the model fingerprint and head
  the embeddings came from (so a serving engine can tell an index its
  own model did not embed), the metric, and the IVF block when one was
  built;
* ``norms.npy`` — per-row L2 norms (float32 ``[rows]``), memory-mapped at
  load; the cosine metric divides scores by them on the device instead
  of normalizing the matrix;
* ``centroids.npy`` / ``assignments.npy`` — the optional IVF coarse
  quantizer (:mod:`.ivf`): k-means centroids (small, loaded to RAM) and
  the int32 row -> list vector (memory-mapped; the inverted lists derive
  from it at first use).

The embedding matrix is not copied into the index: the manifest points
at the batch job's sink and :class:`EmbeddingIndex` memory-maps it
read-only. Rows reach the Python heap only as a scan shard's transfer to
the device or an IVF candidate gather. No index file carries wall-clock
state: a killed and resumed build gives a byte-identical index.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional

import numpy as np

from ..utils.atomic import atomic_write_json

INDEX_MANIFEST = "index.json"
NORMS_NAME = "norms.npy"
CENTROIDS_NAME = "centroids.npy"
ASSIGNMENTS_NAME = "assignments.npy"
INDEX_VERSION = 1
METRICS = ("ip", "cosine")


def write_index_manifest(index_dir: str | Path, payload: dict) -> Path:
    """Atomically persist ``index.json`` (temp + ``os.replace``)."""
    return atomic_write_json(
        Path(index_dir) / INDEX_MANIFEST,
        {"version": INDEX_VERSION, **payload}, indent=2, sort_keys=True)


def load_index_manifest(index_dir: str | Path) -> Optional[dict]:
    """None when no manifest exists; ValueError (with delete-it
    guidance) when one exists but cannot be parsed."""
    path = Path(index_dir) / INDEX_MANIFEST
    if not path.is_file():
        return None
    try:
        manifest = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise ValueError(
            f"corrupt index manifest {path}: {e}; delete the index "
            "directory and rebuild it with tools.build_index") from e
    if not isinstance(manifest, dict):
        raise ValueError(
            f"corrupt index manifest {path}: expected a JSON object, got "
            f"{type(manifest).__name__}; delete the index directory and "
            "rebuild")
    return manifest


def validate_index_manifest(manifest: dict) -> dict:
    """Shape-check a loaded manifest; returns it. Raises ValueError on
    a manifest this code cannot serve (missing pins, unknown metric) —
    a half-built index (kill before the final manifest write) has NO
    manifest and fails the ``load_index_manifest`` is-file check
    upstream, so anything reaching here claimed to be complete."""
    for key in ("rows", "dim", "dtype", "source", "source_sha256",
                "metric"):
        if key not in manifest:
            raise ValueError(
                f"index manifest is missing {key!r} — not a "
                "tools.build_index index; rebuild it")
    if manifest["metric"] not in METRICS:
        raise ValueError(
            f"index manifest metric {manifest['metric']!r} unknown "
            f"(valid: {list(METRICS)}); rebuild the index")
    if int(manifest["rows"]) < 1 or int(manifest["dim"]) < 1:
        raise ValueError(
            f"index manifest rows/dim {manifest['rows']}x"
            f"{manifest['dim']} invalid; rebuild the index")
    return manifest


class EmbeddingIndex:
    """A built index, opened for querying (see module docstring).

    ``embeddings`` / ``norms`` / ``assignments`` are read-only
    memmaps; ``centroids`` (IVF only) is a small in-RAM array.
    ``invlists()`` derives the inverted lists from the assignment
    vector on first use (one stable argsort, cached).
    """

    def __init__(self, index_dir: str | Path):
        self.path = Path(index_dir)
        manifest = load_index_manifest(self.path)
        if manifest is None:
            raise ValueError(
                f"no {INDEX_MANIFEST} in {self.path} — build one with "
                "tools.build_index")
        self.manifest = validate_index_manifest(manifest)
        self.rows = int(manifest["rows"])
        self.dim = int(manifest["dim"])
        self.metric = str(manifest["metric"])
        self.fingerprint = manifest.get("fingerprint")
        self.head = manifest.get("head")
        self.source_sha256 = str(manifest["source_sha256"])

        src = Path(manifest["source"])
        if not src.is_absolute():
            src = self.path / src
        self.source_path = src
        if not src.is_file():
            raise ValueError(
                f"index source matrix {src} is missing — the manifest "
                "points at the batch-infer sink, which must travel with "
                "the index (or rebuild against its new location)")
        self.embeddings = np.load(src, mmap_mode="r")
        if self.embeddings.ndim != 2 or \
                self.embeddings.shape != (self.rows, self.dim) or \
                str(self.embeddings.dtype) != str(manifest["dtype"]):
            raise ValueError(
                f"index source matrix {src} is "
                f"{self.embeddings.dtype}{self.embeddings.shape}, the "
                f"manifest pins {manifest['dtype']}({self.rows}, "
                f"{self.dim}) — the sink was replaced after the build; "
                "rebuild the index")

        norms_path = self.path / NORMS_NAME
        if not norms_path.is_file():
            raise ValueError(
                f"index {self.path} has no {NORMS_NAME} — half-built "
                "index; delete it and rebuild")
        self.norms = np.load(norms_path, mmap_mode="r")
        if self.norms.shape != (self.rows,):
            raise ValueError(
                f"{norms_path} has {self.norms.shape[0]} rows, manifest "
                f"pins {self.rows}; delete the index and rebuild")

        self.ivf = manifest.get("ivf")
        self.centroids: Optional[np.ndarray] = None
        self.assignments: Optional[np.ndarray] = None
        self._invlists = None
        if self.ivf:
            self.centroids = np.load(self.path / CENTROIDS_NAME)
            self.assignments = np.load(
                self.path / ASSIGNMENTS_NAME, mmap_mode="r")
            nlist = int(self.ivf["nlist"])
            if self.centroids.shape != (nlist, self.dim) or \
                    self.assignments.shape != (self.rows,):
                raise ValueError(
                    f"IVF arrays in {self.path} disagree with the "
                    f"manifest (nlist={nlist}, rows={self.rows}); "
                    "delete the index and rebuild")

    def invlists(self):
        """``(order, starts)``: row ids grouped by list — ``order`` is
        the assignment-sorted row-id vector, ``starts[i]:starts[i+1]``
        slices list ``i``'s member rows. Derived once, cached."""
        if self._invlists is None:
            if self.assignments is None:
                raise ValueError(
                    f"index {self.path} was built without IVF "
                    "(--ivf-lists); only the exact scan can serve it")
            nlist = int(self.ivf["nlist"])
            order = np.argsort(self.assignments, kind="stable").astype(
                np.int64)
            counts = np.bincount(self.assignments, minlength=nlist)
            starts = np.zeros(nlist + 1, np.int64)
            np.cumsum(counts, out=starts[1:])
            self._invlists = (order, starts)
        return self._invlists

    def nbytes(self) -> int:
        """Mapped bytes of the embedding matrix (what a scan moves to
        the devices)."""
        return int(self.embeddings.nbytes)

    def describe(self) -> dict:
        """JSON-serializable summary (the serve CLI logs it)."""
        return {
            "rows": self.rows, "dim": self.dim,
            "dtype": str(self.embeddings.dtype), "metric": self.metric,
            "fingerprint": self.fingerprint, "head": self.head,
            "mapped_mb": round(self.nbytes() / 2**20, 1),
            "ivf": dict(self.ivf) if self.ivf else None,
            "source": os.fspath(self.source_path),
        }
