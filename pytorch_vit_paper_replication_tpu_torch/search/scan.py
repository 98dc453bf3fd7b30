"""The hot path: a device-sharded, double-buffered brute-force top-k scan
(port of the JAX package's ``search/scan.py``).

Layout: the database rows are split contiguously into one shard per
device (:func:`shard_rows`), each copied straight from the memory-mapped
matrix to its device through two pinned staging buffers in turn, so the
host never holds the matrix. Per query chunk:

* **local** (per device, queued asynchronously on each): the scores of
  each row block, ``q @ blockᵀ`` by :func:`..ops.scan_scores.scan_scores`
  (a hand-written kernel on the card whose rows do not depend on how many
  queries ride with them), divided by the rows' norms for ``cosine``,
  then the block's top ``k_local`` — kept on the device; the host never
  sees a ``[Q, rows]`` score matrix;
* **merge** (first device): the blocks' and shards' candidates (global
  row ids) are concatenated, ``[Q, blocks·k_local]``, and one more top-k
  gives the final ``[Q, K]``. One host fetch per query chunk returns
  scores and ids together.

Every top-k orders by score, then by the lowest row id (the NumPy
reference's stable argsort and ``lax.top_k`` order): it selects on int64
keys that pack the score's order-preserving bits above the inverted row
id, so no two candidates tie and the answer does not depend on how the
device's top-k breaks ties. A block holds at most ``SCORE_BUDGET_BYTES``
of scores and keys at the top rung; the blocking is fixed per scanner, so
a row meets the same computation in every chunk.

Queries ride a bucket ladder (``plan_buckets``) and are double-buffered
as :class:`..serve.offline.OfflineEngine` does it: chunk N+1 is queued
while chunk N computes, the host waiting only on the oldest past
``prefetch``. Padded query tails are sliced off after the fetch; a row's
scores are the same bits at every rung, so a padded batch equals the
unpadded per-query loop (test-pinned), and pad rows never reach the
results. ``cosine`` divides by the precomputed row norms on the device
(the query's norm is one constant per query row and cannot change its
ranking).
"""

from __future__ import annotations

import time
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.scan_scores import scan_scores
from ..predictions import resolve_device
from ..serve.bucketing import _check_ladder, plan_buckets

# Query-batch ladder. Online traffic is Q = 1 (one ::search a request);
# offline sweeps ride the bigger rungs.
DEFAULT_QUERY_BUCKETS: Tuple[int, ...] = (1, 8, 32)
# Device bytes one row block of a top-rung chunk may take: its float32
# scores, their int64 ordering keys and the transients that build them.
SCORE_BUDGET_BYTES = 1 << 30
_BYTES_PER_SCORE = 28
# Rows of staging buffer per host-to-device copy of a shard.
_STAGE_ROWS = 1 << 16
_ID_SPAN = (1 << 32) - 1


def shard_rows(rows: int, ndev: int) -> List[Tuple[int, int]]:
    """Contiguous ``[lo, hi)`` per device of ``ceil(rows / ndev)`` rows
    each (the last may be short; trailing devices may get empty shards on
    a tiny corpus and contribute no candidates)."""
    if rows < 1:
        raise ValueError(f"cannot shard {rows} rows")
    nd = max(1, int(ndev))
    per = -(-rows // nd)
    return [(min(i * per, rows), min((i + 1) * per, rows))
            for i in range(nd)]


def reference_topk(db: np.ndarray, queries: np.ndarray, k: int, *,
                   metric: str = "ip",
                   norms: Optional[np.ndarray] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """The NumPy reference the exact scan is pinned against: full float32
    score matrix + stable argsort (ties -> lowest row id). Returns
    ``(scores [Q, k], indices [Q, k])``; the JAX package's expression."""
    q = np.asarray(queries, np.float32)
    scores = q @ np.asarray(db, np.float32).T
    if metric == "cosine":
        n = (np.asarray(norms, np.float32) if norms is not None
             else np.linalg.norm(np.asarray(db, np.float32), axis=1))
        scores = scores / n[None, :]
    idx = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(scores, idx, axis=1), idx


def topk_lowest_id(scores: torch.Tensor, k: int,
                   ids: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top ``k`` of each row of ``scores`` ``[Q, N]`` (float32), best
    first, equal scores in ascending id; returns ``(scores [Q, k], ids
    [Q, k] int64)``. ``ids`` (``[Q, N]``, in ``[0, 2^32)``) name the
    candidates; by default their positions.

    The selection runs on int64 keys ``order(score) * 2^32 + (2^32 - 1 -
    id)``: ``order`` maps a float's bits to an int32 with the float's
    order (negatives' magnitude bits flipped; ``-0.0`` first made ``+0.0``
    so the two tie as NumPy's comparison has them), so keys are unique and
    the device's top-k has no tie to break."""
    if ids is None:
        ids = torch.arange(scores.shape[1], device=scores.device).expand(
            scores.shape[0], -1)
    bits = (scores + 0.0).view(torch.int32)
    order = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    keys = order.mul_(1 << 32).add_(_ID_SPAN - ids)
    _, pos = keys.topk(k, dim=1)
    return scores.gather(1, pos), ids.gather(1, pos)


class _Shard:
    """One device's rows: ``db`` ``[rows, dim]`` float32 (and ``norms``
    ``[rows]`` for cosine), the global id of its first row."""

    __slots__ = ("device", "db", "norms", "offset")

    def __init__(self, device, db, norms, offset: int):
        self.device, self.db, self.norms, self.offset = (device, db, norms,
                                                         offset)


def _to_device(mat: np.ndarray, device: torch.device) -> torch.Tensor:
    """``mat`` (usually a memmap slice) as a float32 tensor on ``device``:
    on the card through two pinned staging buffers in turn (a buffer is
    refilled only after its last copy completed), so the host holds two
    buffers of ``_STAGE_ROWS`` rows, never the matrix."""
    if device.type != "cuda":
        return torch.from_numpy(np.array(mat, dtype=np.float32))
    out = torch.empty(mat.shape, dtype=torch.float32, device=device)
    rows = mat.shape[0]
    tail = mat.shape[1:]
    stages = [torch.empty((min(_STAGE_ROWS, rows),) + tail,
                          dtype=torch.float32, pin_memory=True)
              for _ in range(2)]
    done: List[Optional[torch.cuda.Event]] = [None, None]
    with torch.cuda.device(device):
        for i, lo in enumerate(range(0, rows, _STAGE_ROWS)):
            hi = min(lo + _STAGE_ROWS, rows)
            s = i % 2
            if done[s] is not None:
                done[s].synchronize()
            stages[s][:hi - lo].numpy()[...] = mat[lo:hi]
            out[lo:hi].copy_(stages[s][:hi - lo], non_blocking=True)
            done[s] = torch.cuda.Event()
            done[s].record()
        torch.cuda.current_stream(device).synchronize()
    return out


class ShardedScanner:
    """See the module docstring.

    ``k_max`` bounds the K any :meth:`scan` may ask for (the scan keeps
    ``k_max`` candidates; a smaller request slices the result).
    ``devices``: one shard each, every visible CUDA device by default
    (raises without one; CPU devices run the plain scores). ``prefetch``
    bounds the query chunks in flight (2 = double buffering).
    """

    def __init__(self, db: np.ndarray, *, k_max: int = 100,
                 metric: str = "ip",
                 norms: Optional[np.ndarray] = None,
                 devices: Optional[Sequence] = None,
                 query_buckets: Sequence[int] = DEFAULT_QUERY_BUCKETS,
                 prefetch: int = 2,
                 registry=None):
        from ..telemetry.registry import get_registry

        if metric not in ("ip", "cosine"):
            raise ValueError(f"unknown metric {metric!r} (ip|cosine)")
        if db.ndim != 2:
            raise ValueError(f"database must be [rows, dim], got "
                             f"{db.shape}")
        self.rows, self.dim = int(db.shape[0]), int(db.shape[1])
        if self.rows > _ID_SPAN:
            raise ValueError(f"{self.rows} rows: row ids must fit 32 bits")
        self.metric = metric
        self.query_buckets = _check_ladder(query_buckets)
        self.prefetch = max(1, int(prefetch))
        self._registry = registry if registry is not None else \
            get_registry()
        if devices is None:
            resolve_device("cuda")
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        self.devices = [torch.device(d) for d in devices]
        spans = shard_rows(self.rows, len(self.devices))
        per = spans[0][1] - spans[0][0]
        # A shard gives at most k_local candidates; the merge pool bounds K.
        self.k_local = min(int(k_max), per)
        self.k_max = min(int(k_max), len(self.devices) * self.k_local,
                         self.rows)
        # Rows a block of one top-rung chunk may score at once.
        self._block = max(1, SCORE_BUDGET_BYTES // (
            _BYTES_PER_SCORE * self.query_buckets[-1]))

        nrm = None
        if metric == "cosine":
            nrm = (np.asarray(norms, np.float32) if norms is not None
                   else np.linalg.norm(np.asarray(db, np.float32), axis=1))
            if nrm.shape != (self.rows,):
                raise ValueError(
                    f"norms must be [rows]={self.rows}, got {nrm.shape}")
        self._shards: List[_Shard] = []
        for dev, (lo, hi) in zip(self.devices, spans):
            if hi == lo:
                continue
            self._shards.append(_Shard(
                dev, _to_device(db[lo:hi], dev),
                _to_device(nrm[lo:hi], dev) if nrm is not None else None,
                lo))
        self._registry.gauge("search_index_rows", self.rows)
        self._registry.gauge("search_devices", len(self.devices))

    # ------------------------------------------------------------ device
    def _local(self, shard: _Shard, q: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One shard's top ``k_local`` for the chunk ``q`` (on its device):
        per row block, scores -> cosine norms -> the block's top-k; then the
        blocks' candidates merged. Ids are global."""
        n = shard.db.shape[0]
        cand_s, cand_i = [], []
        for lo in range(0, n, self._block):
            hi = min(lo + self._block, n)
            scores = scan_scores(q, shard.db[lo:hi])
            if shard.norms is not None:
                scores.div_(shard.norms[lo:hi])
            s, i = topk_lowest_id(scores, min(self.k_local, hi - lo))
            cand_s.append(s)
            cand_i.append(i + (shard.offset + lo))
        if len(cand_s) == 1:
            return cand_s[0], cand_i[0]
        return topk_lowest_id(torch.cat(cand_s, 1),
                              min(self.k_local, n), torch.cat(cand_i, 1))

    def _dispatch_chunk(self, padded: np.ndarray):
        """Queue one padded query chunk on every shard's device, the local
        top-k on each, the merge on the first device, and the copy of the
        merged pair to the host; returns ``(scores, ids, event)`` — the
        host tensors are valid once ``event`` (None on the CPU) completed."""
        t0 = time.perf_counter()
        host = torch.from_numpy(np.ascontiguousarray(padded, np.float32))
        parts = []
        for shard in self._shards:
            if shard.device.type == "cuda":
                q = host.pin_memory().to(shard.device, non_blocking=True)
            else:
                q = host
            parts.append(self._local(shard, q))
        dev0 = parts[0][0].device
        ms, mi = topk_lowest_id(
            torch.cat([p[0].to(dev0) for p in parts], 1), self.k_max,
            torch.cat([p[1].to(dev0) for p in parts], 1))
        self._registry.observe("search_merge_s", time.perf_counter() - t0)
        if dev0.type != "cuda":
            return ms, mi, None
        out_s = torch.empty(ms.shape, dtype=ms.dtype, pin_memory=True)
        out_i = torch.empty(mi.shape, dtype=mi.dtype, pin_memory=True)
        out_s.copy_(ms, non_blocking=True)
        out_i.copy_(mi, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev0))
        return out_s, out_i, event

    def scan(self, queries: np.ndarray, k: Optional[int] = None
             ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-``k`` over the whole database for every query row; returns
        ``(scores [Q, k] float32, indices [Q, k] int32)``.

        Queries are chunked up the bucket ladder (padded tails sliced off
        after the fetch) and double-buffered across the chunks."""
        k = self.k_max if k is None else int(k)
        if not 1 <= k <= self.k_max:
            raise ValueError(
                f"k={k} outside [1, {self.k_max}] (k_max is bounded by "
                f"construction: min(requested k_max, devices x "
                f"per-shard candidates, rows))")
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.shape[1] != self.dim:
            raise ValueError(
                f"query dim {q.shape[1]} != index dim {self.dim}")
        n = q.shape[0]
        reg = self._registry
        out_s = np.empty((n, k), np.float32)
        out_i = np.empty((n, k), np.int32)

        inflight: deque = deque()   # ((scores, ids, event), n_real, row)
        t_run0 = time.perf_counter()

        def drain_one() -> None:
            (ms, mi, event), n_real, row = inflight.popleft()
            t0 = time.perf_counter()
            # The one host fetch of the chunk: its scores and ids arrive
            # together; everything upstream stayed on the device.
            if event is not None:
                event.synchronize()
            reg.observe("search_scan_s", time.perf_counter() - t0)
            out_s[row:row + n_real] = ms[:n_real, :k].numpy()
            out_i[row:row + n_real] = mi[:n_real, :k].numpy()

        pos = 0
        with torch.inference_mode():
            for bucket in plan_buckets(n, self.query_buckets):
                take = min(bucket, n - pos)
                chunk = q[pos:pos + take]
                if take < bucket:
                    # Zero-pad the tail up the rung; the pad rows' results
                    # are discarded by drain_one's n_real slice.
                    padded = np.zeros((bucket, self.dim), np.float32)
                    padded[:take] = chunk
                else:
                    padded = chunk
                inflight.append((self._dispatch_chunk(padded), take, pos))
                pos += take
                reg.count("search_scans_total")
                while len(inflight) > self.prefetch:
                    drain_one()
            while inflight:
                drain_one()
        reg.count("search_queries_total", n)
        wall = time.perf_counter() - t_run0
        reg.gauge("search_qps", round(n / max(wall, 1e-9), 2))
        return out_s, out_i
