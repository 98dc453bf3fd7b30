"""IVF-style coarse quantization: k-means centroids + inverted lists
(port of the JAX package's ``search/ivf.py``, NumPy on the host as there,
so centroids and assignments equal the JAX package's byte for byte).

A brute-force scan touches every row; IVF (the FAISS ``IndexIVFFlat``
idea) trades a little recall for about ``nlist / nprobe`` fewer rows:

* **build** (``tools.build_index``): k-means over a deterministic strided
  sample of the matrix (:func:`kmeans`: seeded init, plain Lloyd
  iterations, empty clusters keep their previous centroid, so a killed
  and resumed build replays to byte-identical centroids), then every row
  goes to its nearest centroid in streaming chunks (:func:`assign_chunk`);
  the int32 assignment vector is the only per-row file;
* **probe** (:func:`ivf_search`): score the query against the centroids,
  take the best ``nprobe`` lists, gather only their rows from the
  memory-mapped matrix, score the candidates exactly, top-k. Recall
  against the exact scan is measured and gated (recall@10 >= 0.95).

Assignment and probing use L2 distance (k-means geometry); the candidate
scoring uses the index metric (``ip`` / ``cosine``), so IVF results
compare directly with the exact scan they approximate. The quantizer
never touches a device: the candidate gather is a few percent of the
matrix, and a build never competes with a training job for the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def kmeans(sample: np.ndarray, nlist: int, *, iters: int = 10,
           seed: int = 0,
           centroids: Optional[np.ndarray] = None,
           start_iter: int = 0) -> np.ndarray:
    """Plain Lloyd k-means, fully deterministic: seeded row-choice
    init, float32 accumulation in a fixed order, empty clusters keep
    their previous centroid. ``centroids``/``start_iter`` resume a
    killed build mid-ladder — running ``iters`` from scratch and
    running ``start_iter`` then the remainder produce byte-identical
    results (the build's resume contract, test-pinned)."""
    s = np.asarray(sample, np.float32)
    if s.ndim != 2 or s.shape[0] < nlist:
        raise ValueError(
            f"need a [n>=nlist, dim] sample, got {s.shape} for "
            f"nlist={nlist}")
    if centroids is None:
        rng = np.random.default_rng(seed)
        cents = s[rng.choice(s.shape[0], nlist, replace=False)].copy()
    else:
        cents = np.asarray(centroids, np.float32).copy()
        if cents.shape != (nlist, s.shape[1]):
            raise ValueError(
                f"resume centroids {cents.shape} != ({nlist}, "
                f"{s.shape[1]})")
    s_sq = (s * s).sum(axis=1)
    for _ in range(int(start_iter), int(iters)):
        d2 = (s_sq[:, None] - 2.0 * (s @ cents.T)
              + (cents * cents).sum(axis=1)[None, :])
        assign = np.argmin(d2, axis=1)
        for c in range(nlist):
            members = s[assign == c]
            if len(members):
                cents[c] = members.mean(axis=0, dtype=np.float32)
    return cents


def assign_chunk(rows: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """Nearest-centroid (L2) assignment for one chunk of matrix rows;
    int32. Streaming-friendly: the caller walks the memory-mapped
    matrix chunk by chunk and writes these into the assignment sink."""
    r = np.asarray(rows, np.float32)
    c = np.asarray(centroids, np.float32)
    d2 = ((r * r).sum(axis=1)[:, None] - 2.0 * (r @ c.T)
          + (c * c).sum(axis=1)[None, :])
    return np.argmin(d2, axis=1).astype(np.int32)


def build_ivf(db: np.ndarray, nlist: int, *, sample_rows: int = 16384,
              iters: int = 10, seed: int = 0
              ) -> Tuple[np.ndarray, np.ndarray]:
    """In-memory convenience for tests/small corpora: ``(centroids,
    assignments)``. The resumable production path lives in
    ``tools.build_index`` (chunked sinks + progress manifest)."""
    sample = sample_matrix(db, sample_rows)
    cents = kmeans(sample, nlist, iters=iters, seed=seed)
    out = np.empty(db.shape[0], np.int32)
    for lo in range(0, db.shape[0], 8192):
        out[lo:lo + 8192] = assign_chunk(db[lo:lo + 8192], cents)
    return cents, out


def sample_matrix(db: np.ndarray, sample_rows: int) -> np.ndarray:
    """A deterministic strided sample of the matrix (every k-th row) —
    no RNG over 10⁷ rows, no heap copy beyond the sample itself, and
    trivially replayable on resume."""
    n = db.shape[0]
    take = min(int(sample_rows), n)
    stride = max(1, n // take)
    return np.asarray(db[::stride][:take], np.float32)


def ivf_search(index, queries: np.ndarray, k: int, *, nprobe: int = 8
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Probe ``nprobe`` lists per query; returns ``(scores [Q, k],
    indices [Q, k])`` in the index's metric. Queries whose probed
    lists hold fewer than ``k`` rows pad the tail with ``-inf`` /
    ``-1`` (possible at tiny corpora or absurd nlist; raise nprobe).

    ``index`` is an :class:`..search.index.EmbeddingIndex` built with
    ``--ivf-lists``."""
    if index.centroids is None:
        raise ValueError(
            f"index {index.path} has no IVF quantizer; rebuild with "
            "--ivf-lists (or use the exact scan)")
    q = np.asarray(queries, np.float32)
    if q.ndim == 1:
        q = q[None, :]
    order, starts = index.invlists()
    cents = index.centroids
    # Coarse probe in k-means geometry (L2): the lists were carved by
    # nearest-centroid L2, so probing must use the same distance or
    # recall quietly degrades for unnormalized corpora.
    cd2 = ((q * q).sum(axis=1)[:, None] - 2.0 * (q @ cents.T)
           + (cents * cents).sum(axis=1)[None, :])
    nprobe = min(int(nprobe), cents.shape[0])
    probe = np.argsort(cd2, axis=1, kind="stable")[:, :nprobe]

    out_s = np.full((q.shape[0], k), -np.inf, np.float32)
    out_i = np.full((q.shape[0], k), -1, np.int64)
    for qi in range(q.shape[0]):
        cand = np.concatenate(
            [order[starts[c]:starts[c + 1]] for c in probe[qi]])
        if not len(cand):
            continue
        cand.sort()   # ascending row ids: the stable tie order AND a
        # forward-seeking gather off the memory-mapped matrix
        rows = np.asarray(index.embeddings[cand], np.float32)
        scores = rows @ q[qi]
        if index.metric == "cosine":
            scores = scores / np.asarray(index.norms[cand], np.float32)
        take = min(k, len(cand))
        sel = np.argsort(-scores, kind="stable")[:take]
        out_s[qi, :take] = scores[sel]
        out_i[qi, :take] = cand[sel]
    return out_s, out_i


def recall_at_k(approx_idx: np.ndarray, exact_idx: np.ndarray) -> float:
    """Mean per-query overlap fraction |approx ∩ exact| / k — the
    gate statistic (recall@10 in the bench)."""
    a = np.asarray(approx_idx)
    e = np.asarray(exact_idx)
    if a.shape != e.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {e.shape}")
    hits = sum(len(np.intersect1d(a[i], e[i])) for i in range(len(a)))
    return float(hits) / float(e.size) if e.size else 1.0
