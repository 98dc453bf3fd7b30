"""Streaming windowed-shuffle sampling + block readahead (a copy of the
JAX package's ``data/sampler.py``).

The packed-shard path's global per-epoch permutation reads records in
random order — ~150 KB random reads that a disk-cold pack serves at a
fraction of the sequential rate, and the only mitigation (`madvise(WILLNEED)` over the whole
pack) is disabled exactly when it matters, once the pack outgrows half of
MemAvailable. Production input pipelines (Grain over ArrayRecord,
FFCV) solve this with the design implemented here:

* the dataset is split into contiguous *blocks* of records; the epoch
  visits blocks in a seeded globally-shuffled order (sequential I/O
  within each block, one linear scan of the pack per epoch overall);
* records flow from that block stream through a bounded in-memory
  **shuffle window** (tf.data ``shuffle(buffer_size)`` semantics): the
  window holds ``window`` upcoming indices, each emission picks a
  uniform slot and refills it from the stream. Every index is emitted
  exactly once; the reorder distance *forward* is bounded by the window,
  so reads stay inside a bounded byte-range that readahead has already
  paged in.
* a :class:`BlockReadahead` controller runs in a parent-side thread
  during iteration, hinting upcoming blocks into the page cache
  (``posix_fadvise(WILLNEED)``) a bounded number of blocks ahead of the
  consumer and optionally evicting consumed blocks behind it
  (``madvise/fadvise(DONTNEED)``) so the resident working set stays
  O(window + lookahead) regardless of pack size.

Only *indices* are buffered (8 bytes each — the full epoch's order is a
tiny O(n) array; ImageNet-1k is ~10 MB); the O(window) claim is about
the record-data working set, which is what actually scales with pack
size. The window/block shuffle is computed once per epoch in the parent
from ``(seed, epoch)``, so it is bit-reproducible, identical across
hosts (each host then takes its ``indices[process::count]`` shard of the
same global order), and identical under thread and process workers.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import numpy as np

# Records per block. At the pack default of 256px uint8 records this is
# one default shard (4096 records ~= 800 MB / shard file): big enough
# that intra-block sequential reads amortize any seek, small enough that
# a few blocks of readahead stay far below host RAM.
DEFAULT_SHUFFLE_BLOCK = 4096


def epoch_block_order(n: int, block_size: int,
                      rng: np.random.Generator) -> np.ndarray:
    """The epoch's block visit order: a seeded permutation of the
    ``ceil(n / block_size)`` contiguous record blocks."""
    nblocks = -(-n // block_size)
    return rng.permutation(nblocks)


def windowed_shuffle_order(n: int, window: int, block_size: int,
                           rng: np.random.Generator,
                           block_order: Optional[np.ndarray] = None,
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """(order, block_order): a full-epoch index order with sequential-I/O
    structure and bounded-window shuffling.

    ``order`` is a permutation of ``arange(n)``: blocks in ``block_order``
    concatenated into a stream, passed through a ``window``-slot shuffle
    buffer (fill the buffer, then emit a uniform slot and refill it from
    the stream; drain with a final permutation). ``window <= 1``
    degenerates to the raw block-sequential stream; ``window >= n`` is a
    full uniform shuffle. Deterministic given ``rng`` state — the caller
    seeds from ``(seed, epoch)``.

    The element emitted at output position ``i`` entered the stream at a
    position ``<= i + window`` (never later), which is the property
    readahead relies on; residence *in* the window is geometric, so a few
    stragglers per epoch may trail their block by more than ``window``
    positions (harmless: at most ``window`` total).
    """
    if block_order is None:
        block_order = epoch_block_order(n, block_size, rng)
    stream = np.concatenate([
        np.arange(b * block_size, min((b + 1) * block_size, n),
                  dtype=np.int64)
        for b in block_order]) if n else np.empty(0, np.int64)
    w = min(max(int(window), 1), n) if n else 0
    if w <= 1:
        return stream, block_order
    out = np.empty(n, np.int64)
    if w < n:
        # Python-list hot loop: ~0.15 us/record, once per epoch (1.28M
        # records ~= 0.2 s) — the sequential slot dependency defeats
        # numpy vectorization.
        buf = stream[:w].tolist()
        slots = rng.integers(0, w, size=n - w).tolist()
        emitted = []
        for x, j in zip(stream[w:].tolist(), slots):
            emitted.append(buf[j])
            buf[j] = x
        out[:n - w] = emitted
    else:
        buf = stream.tolist()
    out[n - w:] = np.asarray(buf, np.int64)[rng.permutation(w)]
    return out, block_order


class BlockReadahead:
    """Parent-side background readahead over an epoch's block stream.

    Walks ``block_order``, asking the dataset to page in each upcoming
    block (``dataset.willneed_records``) while staying at most ``depth``
    blocks ahead of what the consumer could need (consumed position +
    window), and — with ``evict_behind`` — dropping blocks the window has
    fully drained (``dataset.evict_records``), which bounds the resident
    set to O(window + depth * block) bytes and makes a working set many
    times RAM behave like a working set of a few blocks. Double-buffered
    in the original sense: at ``depth=2`` one block is being consumed
    while the next streams in.

    The controller lives in the PARENT process even under process
    workers: the page cache is shared, so parent-side WILLNEED hints
    feed the forked decoders. Eviction is parent-side too, which makes
    it best-effort under process workers — pages still mapped by a
    worker's inherited memmap survive the parent's DONTNEED pair and
    are only reclaimed by normal kernel pressure (clean page-cache
    pages, so correctness and the >>RAM regime are unaffected; only the
    *proactive* bounding weakens). ``advance(local_records)`` is called
    by the loader after each batch; with multi-host sharding each host
    consumes every ``process_count``-th record of the same global
    stream, so the global stream position is ``local * process_count``.
    """

    def __init__(self, dataset, block_order: np.ndarray, block_size: int,
                 n: int, *, depth: int = 2, window: int = 0,
                 process_count: int = 1, evict_behind: bool = False):
        self._dataset = dataset
        self._order = np.asarray(block_order, np.int64)
        self._block = int(block_size)
        self._n = int(n)
        self._depth = max(1, int(depth))
        self._window = max(0, int(window))
        self._pc = max(1, int(process_count))
        self._evict = bool(evict_behind)
        self._consumed = 0          # local records, set by advance()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="block-readahead")
        self._thread.start()

    def _range(self, b: int) -> Tuple[int, int]:
        return b * self._block, min((b + 1) * self._block, self._n)

    def _run(self) -> None:
        nb = len(self._order)
        hinted = evicted = 0
        margin = self._window // self._block + 1  # straggler safety
        while not self._stop.is_set():
            pos = min(self._consumed * self._pc, self._n)  # global stream
            # Blocks wholly behind the consumer were skipped (mid-epoch
            # resume jumps pos past the sliced-off prefix) or outpaced —
            # never page them in retroactively. (Stream offsets are
            # block-uniform to within one short final block; the
            # approximation only shifts hints by < 1 block.)
            while hinted < nb and (hinted + 1) * self._block <= pos:
                if evicted == hinted:
                    evicted += 1  # nothing of a never-hinted block is
                    # resident; don't walk the skipped prefix evicting
                hinted += 1
            needed = (pos + self._window) // self._block + 1
            target = min(nb, needed + self._depth)
            progressed = False
            if hinted < target:
                self._dataset.willneed_records(
                    *self._range(int(self._order[hinted])))
                hinted += 1
                progressed = True
            if self._evict and evicted < min(hinted,
                                             pos // self._block - margin):
                self._dataset.evict_records(
                    *self._range(int(self._order[evicted])))
                evicted += 1
                progressed = True
            if not progressed:
                if hinted >= nb and not self._evict:
                    return
                self._wake.wait(0.05)
                self._wake.clear()

    def advance(self, local_records_consumed: int) -> None:
        self._consumed = int(local_records_consumed)
        self._wake.set()

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=5.0)
