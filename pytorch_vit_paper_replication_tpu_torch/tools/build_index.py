"""Build a search index over a batch job's embedding sink (the port's
counterpart of the repo's ``tools/build_index.py``; same flags, same
files, byte for byte).

Consumes a completed ``tools.batch_infer`` output directory (the
pre-sized ``outputs.npy`` and its ``progress.json``) and writes an index
directory: the ``index.json`` manifest, per-row norms and, with
``--ivf-lists``, the IVF coarse quantizer (see :mod:`..search.index` for
the on-disk contract). The embedding matrix is not copied: the index
memory-maps the sink where it lies. Usage::

    python -m pytorch_vit_paper_replication_tpu_torch.tools.build_index \
        runs/embed --out runs/embed_index --metric ip --ivf-lists 64

* **verified source**: the batch job must be complete (``records_done ==
  total_records``) and the sink's sha256 must equal the ``sink_sha256``
  its final manifest recorded; a torn copy or a sink overwritten after
  the job is refused with guidance. Jobs whose manifest carries no digest
  need ``--allow-unhashed``.
* **resumable**: ``build_progress.json`` (atomic) pins the job's identity
  (source path and digest, rows / dim, metric, chunking, IVF config) and
  records progress at chunk and k-means-iteration boundaries; norms and
  assignments land in pre-sized memmap sinks, k-means saves its centroids
  every iteration. A killed build rerun with the same command resumes at
  the last durable boundary and leaves an index byte-identical to an
  unkilled build's (no index file carries wall-clock state).
* the final ``index.json`` is written last: an index directory has a
  complete manifest or is visibly unfinished.

It runs on the host (NumPy): nothing here needs a device.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path
from typing import Optional

import numpy as np

BUILD_MANIFEST = "build_progress.json"
BUILD_VERSION = 1


class BuildInterrupted(RuntimeError):
    """Raised by the ``stop_after_steps`` test hook: the build stopped
    at a durable boundary, exactly as a SIGKILL there would have."""


def _atomic_save_npy(path: Path, arr: np.ndarray) -> None:
    """np.save via temp + ``os.replace`` — the manifest discipline for
    the small whole-file artifacts (centroids)."""
    tmp = path.with_name(path.name + f".tmp.{os.getpid()}")
    with open(tmp, "wb") as f:
        np.save(f, arr)
    os.replace(tmp, path)


def load_source(source: str | Path, *, allow_unhashed: bool = False):
    """Validate + memory-map a completed batch-infer output dir;
    returns ``(matrix, source_manifest, sink_path)``. Refuses an
    incomplete job, a missing digest (unless ``allow_unhashed``), and
    a digest mismatch — each with delete-or-refresh guidance."""
    from ..serve.offline import SINK_NAME, load_progress, sink_sha256

    src = Path(source)
    manifest = load_progress(src)
    if manifest is None:
        raise ValueError(
            f"{src} has no batch-infer progress.json — point "
            "build_index at a tools.batch_infer output directory")
    total = int(manifest.get("total_records", -1))
    done = int(manifest.get("records_done", -1))
    if done != total or total < 1:
        raise ValueError(
            f"batch-infer job in {src} is incomplete "
            f"({done}/{total} records) — finish it (re-run the same "
            "batch_infer command; it resumes) before indexing")
    sink = src / manifest.get("sink", SINK_NAME)
    if not sink.is_file():
        raise ValueError(f"batch-infer sink {sink} is missing")
    recorded = manifest.get("sink_sha256")
    if recorded is None:
        if not allow_unhashed:
            raise ValueError(
                f"progress.json in {src} records no sink_sha256 (job "
                "finished before manifests carried one, or the manifest "
                "was edited) — re-run the batch_infer command to "
                "refresh the manifest, or pass --allow-unhashed to "
                "index the sink unverified")
    else:
        actual = sink_sha256(sink)
        if actual != recorded:
            raise ValueError(
                f"sink digest mismatch for {sink}: manifest records "
                f"{recorded[:12]}…, the file hashes {actual[:12]}… — "
                "the matrix was torn or replaced after the job "
                "finished; delete the batch-infer output dir and "
                "re-run the job (or re-run it in place: it refreshes "
                "the sink AND the digest)")
    matrix = np.load(sink, mmap_mode="r")
    if matrix.ndim != 2 or matrix.shape[0] != total:
        raise ValueError(
            f"sink {sink} is {matrix.shape}, manifest pins "
            f"({total}, {manifest.get('out_dim')}) — delete the "
            "output dir and re-run the batch-infer job")
    return matrix, manifest, sink


def _open_sink(path: Path, *, rows: int, dtype, resume: bool):
    if resume and path.is_file():
        m = np.lib.format.open_memmap(path, mode="r+")
        if m.shape != (rows,) or m.dtype != np.dtype(dtype):
            raise ValueError(
                f"existing sink {path} is {m.dtype}{m.shape}, this "
                f"build needs {np.dtype(dtype)}({rows},); delete the "
                "index dir (or pass --fresh) to rebuild")
        return m
    return np.lib.format.open_memmap(path, mode="w+", dtype=dtype,
                                     shape=(rows,))


def run_build(source: str | Path, out: str | Path, *,
              metric: str = "ip",
              ivf_lists: Optional[int] = None,
              kmeans_iters: int = 10,
              sample_rows: int = 16384,
              seed: int = 0,
              chunk_rows: int = 8192,
              fresh: bool = False,
              allow_unhashed: bool = False,
              checkpoint_every_s: float = 10.0,
              stop_after_steps: Optional[int] = None) -> dict:
    """The build (see module docstring); returns the summary dict.

    ``stop_after_steps`` is the kill/resume test hook: raise
    :class:`BuildInterrupted` after N durable progress steps (chunk
    flushes / k-means iterations) — behaviorally a SIGKILL landing at
    that boundary."""
    from ..search.index import (ASSIGNMENTS_NAME, CENTROIDS_NAME, METRICS,
                                NORMS_NAME, write_index_manifest)
    from ..search.ivf import assign_chunk, kmeans, sample_matrix
    from ..utils.atomic import atomic_write_json

    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r} (valid: "
                         f"{list(METRICS)})")
    t0 = time.perf_counter()
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    matrix, src_manifest, sink = load_source(
        source, allow_unhashed=allow_unhashed)
    rows, dim = (int(x) for x in matrix.shape)
    chunk = max(1, int(chunk_rows))
    ivf_cfg = None
    if ivf_lists:
        ivf_cfg = {"nlist": int(ivf_lists),
                   "sample_rows": min(int(sample_rows), rows),
                   "iters": int(kmeans_iters), "seed": int(seed)}
        if ivf_cfg["nlist"] > rows:
            raise ValueError(
                f"--ivf-lists {ivf_lists} exceeds the {rows}-row "
                "matrix")
    identity = {
        "version": BUILD_VERSION,
        # The resolved sink path is part of the identity alongside its
        # digest: an --allow-unhashed source has source_sha256 None,
        # and without the path pin a resume against a DIFFERENT
        # unhashed sink of the same shape would pass (None == None)
        # and silently mix two matrices' data in one index.
        "source_path": os.fspath(sink.resolve()),
        "source_sha256": src_manifest.get("sink_sha256"),
        "rows": rows, "dim": dim, "metric": metric,
        "chunk_rows": chunk, "ivf": ivf_cfg,
    }

    manifest_path = out / BUILD_MANIFEST
    progress = {"norms_rows": 0, "kmeans_iters": 0, "assign_rows": 0}
    if fresh or not manifest_path.is_file():
        atomic_write_json(manifest_path, {**identity, **progress},
                          indent=2)
    else:
        try:
            existing = json.loads(manifest_path.read_text())
        except (OSError, json.JSONDecodeError) as e:
            raise ValueError(
                f"corrupt {manifest_path}: {e}; delete the index dir "
                "(or pass --fresh) to rebuild") from e
        for key, want in identity.items():
            if existing.get(key) != want:
                raise ValueError(
                    f"build manifest {key} mismatch: manifest has "
                    f"{existing.get(key)!r}, this build wants {want!r} "
                    "— the index dir belongs to a different build; "
                    "point --out elsewhere or pass --fresh")
        for key in progress:
            progress[key] = int(existing.get(key, 0))

    steps = {"n": 0}

    def durable_step(**updates) -> None:
        """One durable boundary: progress lands atomically; the test
        hook 'kills' the build exactly here."""
        progress.update(updates)
        atomic_write_json(manifest_path, {**identity, **progress},
                          indent=2)
        steps["n"] += 1
        if stop_after_steps is not None and \
                steps["n"] >= stop_after_steps:
            raise BuildInterrupted(
                f"stopped after {steps['n']} durable steps (test hook)")

    # ---- stage 1: per-row norms (used by the cosine metric; cheap
    # enough to always build so a later metric switch reuses the dir).
    norms = _open_sink(out / NORMS_NAME, rows=rows, dtype=np.float32,
                       resume=not fresh)
    lo = progress["norms_rows"]
    last_flush = time.perf_counter()
    while lo < rows:
        hi = min(lo + chunk, rows)
        norms[lo:hi] = np.linalg.norm(
            np.asarray(matrix[lo:hi], np.float32), axis=1)
        lo = hi
        if lo >= rows or \
                time.perf_counter() - last_flush >= checkpoint_every_s:
            norms.flush()
            durable_step(norms_rows=lo)
            last_flush = time.perf_counter()
    norms.flush()
    del norms

    # ---- stage 2 (optional): IVF coarse quantizer.
    if ivf_cfg is not None:
        cents_path = out / CENTROIDS_NAME
        it = progress["kmeans_iters"]
        sample = sample_matrix(matrix, ivf_cfg["sample_rows"])
        if it == 0 or not cents_path.is_file():
            cents = kmeans(sample, ivf_cfg["nlist"], iters=0,
                           seed=ivf_cfg["seed"])   # seeded init only
            _atomic_save_npy(cents_path, cents)
            durable_step(kmeans_iters=0)
            it = 0
        else:
            cents = np.load(cents_path)
        while it < ivf_cfg["iters"]:
            cents = kmeans(sample, ivf_cfg["nlist"],
                           iters=it + 1, seed=ivf_cfg["seed"],
                           centroids=cents, start_iter=it)
            it += 1
            _atomic_save_npy(cents_path, cents)
            durable_step(kmeans_iters=it)
        assign = _open_sink(out / ASSIGNMENTS_NAME, rows=rows,
                            dtype=np.int32, resume=not fresh)
        lo = progress["assign_rows"]
        last_flush = time.perf_counter()
        while lo < rows:
            hi = min(lo + chunk, rows)
            assign[lo:hi] = assign_chunk(matrix[lo:hi], cents)
            lo = hi
            if lo >= rows or (time.perf_counter() - last_flush
                              >= checkpoint_every_s):
                assign.flush()
                durable_step(assign_rows=lo)
                last_flush = time.perf_counter()
        assign.flush()
        del assign

    # ---- final: the index manifest, written LAST. The source path is
    # stored relative to the index dir when possible so the pair can
    # move together (runs/ artifacts); byte-identity holds because
    # relpath depends only on the two paths, never the clock.
    try:
        source_ref = os.path.relpath(sink, out)
    except ValueError:   # different drive (non-POSIX); absolute then
        source_ref = os.fspath(sink.resolve())
    payload = {
        "rows": rows, "dim": dim, "dtype": str(matrix.dtype),
        "source": source_ref,
        "source_sha256": src_manifest.get("sink_sha256") or "unverified",
        "fingerprint": src_manifest.get("fingerprint"),
        "head": src_manifest.get("head"),
        "metric": metric,
        "norms": NORMS_NAME,
        "ivf": ivf_cfg,
    }
    write_index_manifest(out, payload)
    return {
        "index": os.fspath(out), "rows": rows, "dim": dim,
        # "scan_metric", not "metric": the CLI labels its summary line
        # {"metric": "build_index", ...} like every other tool.
        "scan_metric": metric, "ivf": ivf_cfg,
        "source": source_ref,
        "verified_sha256": src_manifest.get("sink_sha256") is not None,
        "wall_s": round(time.perf_counter() - t0, 3),
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        description="Build a search index over a completed batch-infer "
                    "embedding sink (memory-mapped; resumable)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("source",
                   help="tools.batch_infer output directory "
                        "(outputs.npy + progress.json)")
    p.add_argument("--out", required=True,
                   help="index directory (index.json, norms, IVF land "
                        "here; re-running resumes from "
                        f"{BUILD_MANIFEST})")
    p.add_argument("--metric", choices=["ip", "cosine"], default="ip",
                   help="scan scoring: raw inner product, or inner "
                        "product over the stored row norms")
    p.add_argument("--ivf-lists", type=int, default=None,
                   help="build an IVF coarse quantizer with this many "
                        "k-means lists (default: exact-scan-only index)")
    p.add_argument("--kmeans-iters", type=int, default=10,
                   help="Lloyd iterations (each one is a resumable "
                        "checkpoint)")
    p.add_argument("--sample-rows", type=int, default=16384,
                   help="deterministic strided sample size k-means "
                        "trains on")
    p.add_argument("--seed", type=int, default=0,
                   help="k-means init seed (part of the build identity)")
    p.add_argument("--chunk-rows", type=int, default=8192,
                   help="rows per streaming chunk for norms/assignments")
    p.add_argument("--checkpoint-every-s", type=float, default=10.0,
                   help="progress-manifest cadence between chunk flushes")
    p.add_argument("--fresh", action="store_true",
                   help="ignore an existing build manifest and restart "
                        "from scratch")
    p.add_argument("--allow-unhashed", action="store_true",
                   help="index a sink whose progress.json records no "
                        "sha256 (jobs finished before manifests carried "
                        "one) — the matrix goes unverified")
    args = p.parse_args(argv)
    summary = run_build(
        args.source, args.out, metric=args.metric,
        ivf_lists=args.ivf_lists, kmeans_iters=args.kmeans_iters,
        sample_rows=args.sample_rows, seed=args.seed,
        chunk_rows=args.chunk_rows,
        checkpoint_every_s=args.checkpoint_every_s,
        fresh=args.fresh, allow_unhashed=args.allow_unhashed)
    print(json.dumps({"metric": "build_index", **summary}))
    return summary


if __name__ == "__main__":
    main()
