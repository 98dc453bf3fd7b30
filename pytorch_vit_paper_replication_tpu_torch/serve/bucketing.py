"""The bucket ladder: a fixed set of device batch sizes.

A copy of the JAX package's ``serve/bucketing.py``. Serving traffic
produces ragged batch sizes; every batch is padded UP to the nearest rung
of a small fixed ladder, so the set of device batch shapes is exactly
``len(ladder)`` (warmed at startup, and the shape set CUDA graphs will
capture in a later slice). Pad rows replicate row 0 (uniform dtype/shape, same
trick as ``data.image_folder.pad_batch``) and a mask of real rows rides
alongside so callers only ever read real-row outputs — a ViT forward has
no cross-example ops, so pad rows cannot perturb real rows.

Used by :mod:`.batching` (online serving).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

# 1 serves the idle-traffic case at minimum latency; each subsequent rung
# trades ~linear device time for amortized dispatch.
DEFAULT_BUCKETS: Tuple[int, ...] = (1, 8, 32, 128, 256)


def _check_ladder(buckets: Sequence[int]) -> Tuple[int, ...]:
    ladder = tuple(sorted({int(b) for b in buckets}))
    if not ladder or ladder[0] < 1:
        raise ValueError(f"bucket ladder must be positive ints: {buckets}")
    return ladder


def pick_bucket(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest rung >= n (n must not exceed the top rung)."""
    ladder = _check_ladder(buckets)
    for b in ladder:
        if b >= n:
            return b
    raise ValueError(
        f"batch of {n} exceeds the top bucket {ladder[-1]}; split it "
        f"first (plan_buckets) or extend the ladder")


def plan_buckets(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS
                 ) -> List[int]:
    """Split ``n`` requests into a sequence of bucket-sized chunks.

    Full top-rung chunks while they fit; the sub-top remainder is split
    by a tiny DP minimizing ``dispatched_rows + n_chunks`` — padded rows
    are wasted MXU work, and each extra chunk costs one dispatch (so a
    remainder of 7 on a (1, 8) ladder pads to one 8, not seven 1s,
    while 104 on the default ladder runs 32x3 + 8 instead of one
    128-with-24-pad). Distinct shapes over ANY workload stays <=
    len(ladder) — a 1000-image directory at the default ladder runs
    256x3 + 128 + 32x3 + 8 (4 shapes, 0 pad rows), never one shape per
    residual batch size.
    """
    ladder = _check_ladder(buckets)
    if n < 0:
        raise ValueError(f"negative batch {n}")
    top = ladder[-1]
    plan = [top] * (n // top)
    rem = n % top
    if rem:
        best: List[Tuple[int, List[int]]] = [(0, [])]
        for r in range(1, rem + 1):
            cands = []
            for b in ladder:
                if b >= r:
                    cands.append((b + 1, [b]))  # one padded chunk, done
                else:
                    cost, tail = best[r - b]
                    cands.append((b + 1 + cost, [b] + tail))
            best.append(min(cands, key=lambda t: t[0]))
        plan.extend(sorted(best[rem][1], reverse=True))
    return plan


def pad_rows_to_bucket(rows: np.ndarray, bucket: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(padded, mask): pad `rows` up to `bucket` rows, mask marks real.

    Pad rows replicate row 0 — uniform dtype/shape with zero surprises
    (an all-zeros pad would be equally correct for ViT, but replicating
    a real row keeps the padded batch inside the model's input
    distribution, which matters if anyone adds batch-coupled ops like
    BatchNorm later; the mask contract stays the honest guard either
    way).
    """
    n = rows.shape[0]
    if n == 0 or n > bucket:
        raise ValueError(f"cannot pad {n} rows to bucket {bucket}")
    mask = np.zeros(bucket, np.float32)
    mask[:n] = 1.0
    if n == bucket:
        return rows, mask
    filler = np.repeat(rows[:1], bucket - n, axis=0)
    return np.concatenate([rows, filler], axis=0), mask
