"""Dynamic micro-batcher: coalesce concurrent requests into device batches.

A copy of the JAX package's ``serve/batching.py``. Single-image inference
underutilizes an accelerator badly; the serving fix is to let concurrent callers' requests pile
up for at most ``max_wait_us`` and dispatch them as ONE padded device
batch on a bucket-ladder shape (:mod:`.bucketing`). Each ``submit()``
returns a ``concurrent.futures.Future`` that resolves to that request's
own output row.

**Multi-head coalescing**: every request carries a ``head``
tag. The batcher coalesces *across* heads into one device batch — the
backbone is >99% of a ViT forward's FLOPs (telemetry/flops.py), so a
mixed classifier+embedding batch through ONE fused forward costs the
same as a single-head batch of the same size, and the compiled shape
set does not depend on the head mix. The device callback receives the
per-row head tags and may return either one array (head-blind
callbacks) or a ``{head: outputs}`` dict; the batcher hands request
``i`` row ``i`` of *its own head's* output. ``segregate_heads=True``
flips the batcher into the thing the fused path replaces — per-head
batches, as if each head ran its own fleet — and exists only as the
measured baseline for the ``multihead_ok`` A/B gate.

**SLO tiers**: every request also carries a ``tier``:

* ``interactive`` — the batch-fill window is ``max_wait_us`` (the
  latency knob, as before), and interactive requests win batch slots
  at formation time;
* ``batch`` — rides the queue until the bucket fills or
  ``batch_max_wait_us`` passes (amortization over latency). That
  window doubles as the anti-starvation bound: a batch-tier request
  older than it escalates to interactive priority, so sustained
  interactive pressure can delay batch work only up to the bound,
  never past it.

Robustness policy (all deterministic, all unit-tested):

* **Admission control**: the queue is bounded. A full queue REJECTS new
  work with :class:`QueueFullError` carrying a ``retry_after_s`` hint
  (queue depth x recent per-request service time) instead of growing
  without bound — callers see explicit backpressure, not silent
  multi-second latency.
* **Deadlines**: ``submit(..., timeout=t)`` marks the request; expired
  requests are dropped at batch-formation time, *before* they occupy a
  device batch — a queue that fell behind sheds exactly the work nobody
  is waiting for anymore.
* **Degradation**: when dispatches start shedding expired work (the
  queue is draining slower than callers' deadlines), the batcher steps
  its bucket cap DOWN one rung — smaller batches finish sooner, cutting
  time-in-queue at some throughput cost — and steps back up after
  ``recover_after`` consecutive clean dispatches.
* **Quiesce**: :meth:`MicroBatcher.drain` is the first-class stop-the-
  intake contract (new submits fail with :class:`DrainingError`
  carrying ``retry_after_s``, in-flight work flushes, the unfinished
  count comes back) — a fleet rollout quiesces a replica this way
  before restarting it onto a new checkpoint.

The device callback runs on the single worker thread, so there is at
most one batch in flight — the right regime for one chip (a second
in-flight batch would just queue inside the runtime).
"""

from __future__ import annotations

import concurrent.futures as cf
import heapq
import threading
import time
from collections import deque
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from ..telemetry import tracing as _tracing
from .bucketing import (DEFAULT_BUCKETS, _check_ladder, pad_rows_to_bucket,
                        pick_bucket)
from .stats import ServeStats

# SLO tiers, in priority order at batch formation. DEFAULT_HEAD is what
# head-oblivious callers (and the classic line protocol) get.
TIERS: Tuple[str, ...] = ("interactive", "batch")
DEFAULT_HEAD = "probs"
DEFAULT_TIER = "interactive"


def parse_req_line(line: str) -> Tuple[Optional[str], Optional[str],
                                       Optional[int], Optional[str], str]:
    """``::req [head=H] [tier=T] [k=K] [model=M] <path>`` ->
    (head|None, tier|None, k|None, model|None, path) — the ONE parser
    of the inline request grammar, shared by the serve CLI (both
    modes) and the fleet router (which relays non-default traffic in
    exactly this form so pooled replica connections stay stateless).
    ``k=K`` marks an embedding-SEARCH request: the replica
    embeds the image through the features head and answers the K
    nearest index rows — the ``::search K <path>`` client command
    relays as this form. ``model=M`` declares a model tier
    ("student"/"teacher"/any replica-declared name) so the router can
    steer a mixed student+teacher fleet; replicas themselves ignore
    it. The path is everything after the last recognized ``key=value``
    pair (paths may contain spaces, but not start with ``head=``/
    ``tier=``/``k=``/``model=``); an empty path, or a non-positive-
    integer ``k``, raises ValueError."""
    rest = line[len("::req"):].strip()
    head = tier = k = model = None
    while True:
        part, _, tail = rest.partition(" ")
        if part.startswith("head="):
            head = part[len("head="):]
            rest = tail.strip()
        elif part.startswith("tier="):
            tier = part[len("tier="):]
            rest = tail.strip()
        elif part.startswith("model="):
            model = part[len("model="):]
            rest = tail.strip()
        elif part.startswith("k="):
            raw = part[len("k="):]
            if not raw.isdigit() or int(raw) < 1:
                raise ValueError(
                    f"bad k={raw!r}: expected a positive integer")
            k = int(raw)
            rest = tail.strip()
        else:
            break
    if not rest:
        raise ValueError(
            "expected '::req [head=H] [tier=T] [k=K] [model=M] <path>'")
    return head, tier, k, model, rest


def parse_search_line(line: str) -> Tuple[int, str]:
    """``::search K <path>`` -> (k, path) — the ONE parser of the
    client-facing search command, shared by the serve CLI and the
    fleet router (which re-emits it as the ``::req k=`` relay form).
    Raises ValueError on a missing path or a non-positive-integer K."""
    parts = line.split(maxsplit=2)
    if len(parts) != 3 or not parts[1].isdigit() or int(parts[1]) < 1:
        raise ValueError(
            "expected '::search K <path>' with a positive integer K")
    return int(parts[1]), parts[2].strip()


class QueueFullError(RuntimeError):
    """Admission refused: the request queue is at capacity.

    ``retry_after_s`` estimates when capacity frees up (queue depth x
    recent per-request service time) — the serving equivalent of an HTTP
    429 with Retry-After.
    """

    def __init__(self, depth: int, retry_after_s: float):
        super().__init__(
            f"serve queue full ({depth} waiting); retry after "
            f"~{retry_after_s:.3f}s")
        self.retry_after_s = retry_after_s


class DrainingError(QueueFullError):
    """Admission refused: the batcher is quiescing (:meth:`MicroBatcher.
    drain`) ahead of a restart or checkpoint swap.

    Subclasses :class:`QueueFullError` so every existing backpressure
    handler (retry elsewhere / retry after ``retry_after_s``) treats a
    draining replica exactly like a momentarily-full one — which is
    what it is, from the caller's side.
    """

    def __init__(self, retry_after_s: float):
        RuntimeError.__init__(
            self, f"batcher draining (quiesce); retry after "
                  f"~{retry_after_s:.3f}s")
        self.retry_after_s = retry_after_s


class RequestExpired(TimeoutError):
    """The request's deadline passed while it waited in the queue."""


class ShutdownError(RuntimeError):
    """The batcher was closed before this request could run."""


class _Request:
    __slots__ = ("row", "future", "deadline", "t_submit", "head", "tier",
                 "fill_deadline", "ctx")

    def __init__(self, row: np.ndarray, deadline: Optional[float],
                 t_submit: float, head: str = DEFAULT_HEAD,
                 tier: str = DEFAULT_TIER,
                 fill_deadline: float = 0.0, ctx=None):
        self.row = row
        self.future: cf.Future = cf.Future()
        self.deadline = deadline
        self.t_submit = t_submit
        self.head = head
        self.tier = tier
        # The tier's batch-fill deadline: when it passes, the batcher
        # stops hoping for company (and a batch-tier request escalates
        # to interactive priority — the anti-starvation bound).
        self.fill_deadline = fill_deadline
        # The request's TraceContext, None for the (common)
        # untraced case — dispatch then pays one attribute check.
        self.ctx = ctx


class MicroBatcher:
    """See module docstring.

    ``forward(padded_rows, mask, heads) -> outputs``: the device
    callback; ``padded_rows`` is a bucket-shaped float32 array, ``mask``
    flags real rows (eval-style pad+mask semantics — ViT rows are
    independent, so the mask exists for the output contract, not the
    compute), ``heads`` is the per-REAL-row head tag tuple. The
    callback returns either per-row outputs (one array — head-blind)
    or a ``{head: per_row_outputs}`` dict (the fused multi-head
    forward); the batcher hands row ``i`` of request ``i``'s own head
    to future ``i``.

    ``start_thread=False`` skips the worker thread; callers (tests, the
    bench's sequential baseline) then drive dispatches with
    :meth:`run_once` for fully deterministic semantics.
    """

    def __init__(self, forward: Callable[[np.ndarray, np.ndarray,
                                          Tuple[str, ...]], object], *,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_wait_us: int = 2000,
                 batch_max_wait_us: int = 50_000,
                 max_queue: int = 1024,
                 recover_after: int = 8,
                 stats: Optional[ServeStats] = None,
                 segregate_heads: bool = False,
                 start_thread: bool = True):
        self._forward = forward
        self._ladder = _check_ladder(buckets)
        self.max_wait_s = max_wait_us / 1e6
        # Per-tier batch-fill windows: interactive rides the classic
        # latency knob; batch waits (much) longer for a full bucket —
        # and that window is ALSO the tier's starvation bound.
        self.tier_wait_s = {"interactive": max_wait_us / 1e6,
                            "batch": max(batch_max_wait_us, max_wait_us)
                            / 1e6}
        self.segregate_heads = bool(segregate_heads)
        self.max_queue = int(max_queue)
        self.recover_after = int(recover_after)
        self.stats = stats if stats is not None else ServeStats()
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._queue: deque = deque()
        self._closed = False
        self._draining = False
        # Rows inside the batch currently being formed/dispatched —
        # drain() is only done when the queue is empty AND this is 0.
        self._inflight_rows = 0
        # Degradation state: _cap indexes the ladder (top rung = full
        # throughput mode); _clean_dispatches counts toward recovery.
        self._cap = len(self._ladder) - 1
        self._clean_dispatches = 0
        # EMA of per-request device+dispatch seconds, for retry-after.
        self._ema_s_per_req: Optional[float] = None
        self._worker: Optional[threading.Thread] = None
        if start_thread:
            self._worker = threading.Thread(
                target=self._run, name="serve-microbatcher", daemon=True)
            self._worker.start()

    # ------------------------------------------------------------- API
    def submit(self, row: np.ndarray,
               timeout: Optional[float] = None,
               head: str = DEFAULT_HEAD,
               tier: str = DEFAULT_TIER, ctx=None) -> cf.Future:
        """Enqueue one example; returns a Future of its output row.

        ``timeout`` (seconds) sets the request deadline: if the queue
        cannot get it into a device batch in time, the future fails with
        :class:`RequestExpired` instead of occupying a batch. ``head``
        tags which of the forward's outputs this request reads;
        ``tier`` picks the SLO class (see module docstring). ``ctx``
        is the request's sampled TraceContext or None;
        dispatch records ``batch.queue_wait`` / ``batch.device`` spans
        under it.
        """
        if tier not in TIERS:
            raise ValueError(f"unknown tier {tier!r}; valid: {TIERS}")
        row = np.asarray(row, np.float32)
        now = time.monotonic()
        deadline = None if timeout is None else now + float(timeout)
        req = _Request(row, deadline, now, head=head, tier=tier,
                       fill_deadline=now + self.tier_wait_s[tier],
                       ctx=ctx)
        with self._nonempty:
            if self._closed:
                raise ShutdownError("batcher is closed")
            if self._draining:
                self.stats.count("rejected_draining")
                # Floor the hint: a drain typically ends with a restart
                # measured in seconds, and a 0-second retry-after (tiny
                # max_wait, empty queue) would tell callers to hammer a
                # quiescing replica.
                raise DrainingError(
                    max(self._retry_after_locked(), 0.05))
            if len(self._queue) >= self.max_queue:
                self.stats.count("rejected_queue_full")
                raise QueueFullError(len(self._queue),
                                     self._retry_after_locked())
            self._queue.append(req)
            self.stats.count("submitted")
            self.stats.observe_submit(head, tier)
            self._nonempty.notify()
        return req.future

    def close(self, timeout: float = 10.0) -> None:
        """Stop the worker; pending futures fail with ShutdownError."""
        with self._nonempty:
            if self._closed:
                return
            self._closed = True
            pending = list(self._queue)
            self._queue.clear()
            self._nonempty.notify_all()
        for req in pending:
            if not req.future.cancelled():
                req.future.set_exception(ShutdownError("batcher closed"))
        if self._worker is not None:
            self._worker.join(timeout)

    def drain(self, timeout_s: float = 10.0) -> int:
        """Quiesce: refuse new submits, flush in-flight work, report.

        The explicit quiesce contract the fleet rollout path rides
        (``close()`` FAILS pending futures; drain *finishes* them):

        * new ``submit()`` calls fail immediately with
          :class:`DrainingError` (carrying ``retry_after_s`` — callers
          route the work elsewhere or retry later),
        * queued and in-flight batches keep dispatching until the queue
          is empty and no batch is in flight, or ``timeout_s`` passes,
        * returns the number of requests still unfinished (0 = fully
          drained; >0 = the caller decides whether to wait longer,
          :meth:`resume`, or :meth:`close` and fail the stragglers).

        The batcher stays alive — a drained batcher can :meth:`resume`
        (the abort path of a quiesce whose restart never happened).
        Manual-drive batchers (``start_thread=False``) flush via the
        caller's own :meth:`run_once` loop; drain still gates
        admission and reports the unfinished count.
        """
        deadline = time.monotonic() + max(0.0, float(timeout_s))
        with self._nonempty:
            self._draining = True
            # Wake the worker: it may be parked in its coalescing wait
            # hoping for company that admission will now never let in.
            self._nonempty.notify_all()
            while self._queue or self._inflight_rows:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                # Bounded poll: run_once's completion notify usually
                # ends the wait early; the cap keeps a lost wakeup from
                # turning a bounded drain into an unbounded one.
                self._nonempty.wait(min(remaining, 0.05))
            return len(self._queue) + self._inflight_rows

    def resume(self) -> None:
        """Lift a :meth:`drain`: admissions open again."""
        with self._nonempty:
            self._draining = False

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def effective_bucket_cap(self) -> int:
        """Current max dispatch bucket (degradation steps this down)."""
        return self._ladder[self._cap]

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    # ------------------------------------------------------- internals
    def _retry_after_locked(self) -> float:
        per_req = self._ema_s_per_req
        if per_req is None:
            per_req = self.max_wait_s
        return max(self.max_wait_s, len(self._queue) * per_req)

    @staticmethod
    def _priority(req: _Request, now: float) -> Tuple[int, float]:
        """Batch-formation order: interactive first, FIFO within a
        rank — except a batch-tier request past its fill window
        ESCALATES to interactive rank (the anti-starvation bound:
        interactive pressure can push batch work back only as far as
        ``batch_max_wait_us``, never indefinitely)."""
        overdue = now >= req.fill_deadline
        return (0 if req.tier == "interactive" or overdue else 1,
                req.t_submit)

    def _collect(self, now: float) -> list:
        """Select up to one capped bucket of live requests in priority
        order; expire the dead everywhere in the queue.

        Caller holds the lock. Returns [] when everything queued had
        already expired (the caller should loop, not dispatch).
        """
        cap = self._ladder[self._cap]
        live: list = []
        expired: list = []
        for req in self._queue:
            if req.deadline is not None and now > req.deadline:
                expired.append(req)
            else:
                live.append(req)
        # Top-cap selection, not a full sort: O(Q log cap) under the
        # lock (submitters block on it), and Q can be max_queue deep
        # while a degraded cap is 1.
        batch = heapq.nsmallest(cap, live,
                                key=lambda r: self._priority(r, now))
        taken = {id(r) for r in batch} | {id(r) for r in expired}
        # What stays queued keeps its FIFO arrival order.
        remaining = [r for r in self._queue if id(r) not in taken]
        self._queue.clear()
        self._queue.extend(remaining)
        for req in expired:
            self.stats.count("expired")
            self.stats.observe_expired(req.head, req.tier)
            if not req.future.cancelled():
                req.future.set_exception(RequestExpired(
                    f"deadline exceeded after "
                    f"{now - req.t_submit:.3f}s in queue"))
        if expired:
            self._clean_dispatches = 0
            if self._cap > 0:
                self._cap -= 1  # degrade: drain faster, smaller batches
        return batch

    def _note_clean_dispatch(self) -> None:
        if self._cap == len(self._ladder) - 1:
            return
        self._clean_dispatches += 1
        if self._clean_dispatches >= self.recover_after:
            self._cap += 1
            self._clean_dispatches = 0

    def run_once(self, block: bool = False) -> int:
        """Form and dispatch ONE batch; returns the number of requests
        served (0 if the queue was empty / all expired). The worker
        thread calls this in a loop; tests and the sequential baseline
        call it directly."""
        with self._nonempty:
            if block:
                while not self._queue and not self._closed:
                    self._nonempty.wait()
            if not self._queue:
                return 0
            # Coalescing window: wait for more arrivals until the
            # EARLIEST queued fill deadline passes (an interactive
            # request caps the wait at max_wait from its submit; a
            # batch-tier-only queue rides until batch_max_wait), unless
            # a full capped bucket is already waiting. A request
            # carrying an EXPIRY deadline shorter than its fill window
            # pulls the dispatch forward to ~margin before it would
            # expire — a lone batch-tier request with a 20 ms timeout
            # must be served off an idle device, not held for the 50 ms
            # fill window and then expired. A drain skips the wait —
            # admission is closed, no company is coming.
            margin = max(self.max_wait_s, 1e-3)
            while (self._queue
                   and len(self._queue) < self._ladder[self._cap]
                   and not self._closed and not self._draining):
                fill = min(
                    (r.fill_deadline if r.deadline is None
                     else min(r.fill_deadline, r.deadline - margin))
                    for r in self._queue)
                remaining = fill - time.monotonic()
                if remaining <= 0:
                    break
                self._nonempty.wait(remaining)
            if not self._queue:
                return 0
            now = time.monotonic()
            batch = self._collect(now)
            self._inflight_rows = len(batch)
        if not batch:
            return 0
        try:
            return self._dispatch(batch)
        finally:
            # Whatever happened to the batch, it is no longer in
            # flight — a concurrent drain() can stop waiting on it.
            with self._nonempty:
                self._inflight_rows = 0
                self._nonempty.notify_all()

    def _dispatch(self, batch: list) -> int:
        """Run one collected batch through the device callback and
        resolve its futures (split from :meth:`run_once` so in-flight
        accounting wraps it in one try/finally)."""
        degraded = self._cap < len(self._ladder) - 1
        t_dispatch = time.monotonic()
        for req in batch:
            self.stats.observe_latency("queue", t_dispatch - req.t_submit)
        heads = tuple(req.head for req in batch)
        try:
            # Batch formation is inside the guard: a malformed row (e.g.
            # mismatched shapes feeding np.stack) must fail ITS batch,
            # not kill the worker thread.
            if self.segregate_heads:
                out, buckets_used = self._forward_segregated(batch)
            else:
                rows = np.stack([req.row for req in batch])
                bucket = pick_bucket(len(batch), self._ladder)
                padded, mask = pad_rows_to_bucket(rows, bucket)
                out = self._forward(padded, mask, heads)
                if not isinstance(out, dict):
                    out = np.asarray(out)
                buckets_used = [(bucket, len(batch))]
        except Exception as e:  # noqa: BLE001 — a failed device batch
            # fails ITS requests; the batcher survives for the next one.
            for req in batch:
                if not req.future.cancelled():
                    req.future.set_exception(e)
            return len(batch)
        t_done = time.monotonic()
        self.stats.observe_latency("device", t_done - t_dispatch)
        for bucket, real in buckets_used:
            self.stats.observe_batch(bucket, real, degraded=degraded)
        with self._lock:
            dt = (t_done - t_dispatch) / len(batch)
            self._ema_s_per_req = dt if self._ema_s_per_req is None \
                else 0.8 * self._ema_s_per_req + 0.2 * dt
            self._note_clean_dispatch()
        if any(req.ctx is not None for req in batch):
            # Per-traced-request coalesce-wait + device spans
            # (the hop split SLO attribution needs); untraced batches
            # pay only the any() scan above.
            tracer = _tracing.get_tracer()
            for req in batch:
                if req.ctx is None:
                    continue
                tracer.span(req.ctx, "batch.queue_wait",
                            _tracing.wall_from_monotonic(req.t_submit),
                            _tracing.wall_from_monotonic(t_dispatch),
                            tier=req.tier)
                tracer.span(req.ctx, "batch.device",
                            _tracing.wall_from_monotonic(t_dispatch),
                            _tracing.wall_from_monotonic(t_done),
                            head=req.head, batch=len(batch))
        multi = isinstance(out, dict)
        for i, req in enumerate(batch):
            if multi and req.head not in out:
                # A head the forward cannot produce FAILS its request —
                # and must not masquerade as a completion in the
                # counters/latency windows a dashboard reads.
                self.stats.count("head_errors")
                if not req.future.cancelled():
                    req.future.set_exception(ValueError(
                        f"forward produced no {req.head!r} head "
                        f"(got {sorted(out)})"))
                continue
            self.stats.observe_latency("total", t_done - req.t_submit)
            self.stats.count("completed")
            self.stats.observe_completion(req.head, req.tier,
                                          t_done - req.t_submit)
            if not req.future.cancelled():
                req.future.set_result(
                    out[req.head][i] if multi else out[i])
        return len(batch)

    def _forward_segregated(self, batch: list):
        """The A/B baseline the fused dispatch replaces
        (``segregate_heads=True``): the SAME admitted batch, split at
        the head boundary — one padded device forward per head
        present, at the same dispatch cadence. This is two fleets
        running the backbone twice, measured on one host; per-head
        queue DELAY is deliberately not modeled, because holding a
        head's traffic to refill its batches buys throughput only by
        doubling time-in-queue — exactly what the SLO tiers exist to
        forbid. Returns (per-request output rows, [(bucket,
        real_rows), ...])."""
        groups: dict = {}
        for i, req in enumerate(batch):
            groups.setdefault(req.head, []).append(i)
        rows_out: list = [None] * len(batch)
        buckets_used = []
        for head, idxs in groups.items():
            rows = np.stack([batch[i].row for i in idxs])
            bucket = pick_bucket(len(idxs), self._ladder)
            padded, mask = pad_rows_to_bucket(rows, bucket)
            out = self._forward(padded, mask, (head,) * len(idxs))
            sub = out[head] if isinstance(out, dict) else np.asarray(out)
            for j, i in enumerate(idxs):
                rows_out[i] = sub[j]
            buckets_used.append((bucket, len(idxs)))
        return rows_out, buckets_used

    def _run(self) -> None:
        import sys
        import traceback

        while True:
            with self._lock:
                if self._closed:
                    return
            try:
                self.run_once(block=True)
            except Exception:  # noqa: BLE001 — run_once fails request
                # futures itself; anything that still escapes must not
                # kill the worker (a dead worker hangs every future
                # submit). Each iteration consumes queued requests, so
                # this cannot hot-loop on one poisoned batch.
                traceback.print_exc(file=sys.stderr)
