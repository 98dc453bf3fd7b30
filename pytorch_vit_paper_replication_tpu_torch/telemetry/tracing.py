"""Request-scoped distributed tracing for the serving stack.

A copy of the JAX package's ``telemetry/tracing.py`` (stdlib only); the
port's micro-batcher records its spans through it.

One user request now crosses processes — loadgen -> fleet router ->
admission -> MicroBatcher -> replica exec, plus the optional cascade
teacher hop — and this module carries ONE identity across all of them:

* :class:`TraceContext` — W3C-traceparent-style ``(trace_id, span_id,
  parent_id)``; serialized on the wire as a ``trace=00-<32hex>-<16hex>-01``
  token riding inside the existing line protocol (``::req`` / ``::probs``
  / ``::search`` tags), so an un-traced request's bytes are COMPLETELY
  unchanged — tracing off the wire is tracing off the cost.
* :class:`Tracer` — per-process span recorder appending one JSON line
  per span to a crash-tolerant JSONL sink (single ``write()+flush()``
  under a lock; readers tolerate a torn final line). A process-global
  tracer (:func:`configure_tracer` / :func:`get_tracer`) defaults to a
  NULL tracer: serving code calls it unconditionally and pays one
  attribute check when tracing is off.
* Deterministic head sampling — :func:`trace_sample` is a seeded
  blake2b hash of the trace_id mapped to [0, 1): the SAME trace is
  sampled by every process that sees it, and the decision involves no
  wall clock and no PRNG (replayable; bench-gated at <=2% overhead for
  1% sampling by tools/serve_bench.py).
* Wire helpers — :func:`inject_wire_context` /
  :func:`extract_wire_context` insert/strip the ``trace=`` token from a
  protocol line without disturbing the rest of the tags (the 5-tuple
  shape of ``batching.parse_req_line`` is untouched; extraction happens
  BEFORE parsing at every hop's ingress).

This file is deliberately stdlib-only with no package-relative imports.

Span row schema (one JSON object per line, sorted keys)::

    {"args": {...}, "name": "batch.device", "parent_id": "…16hex",
     "pid": 1234, "role": "replica", "span_id": "…16hex",
     "t0": <epoch s>, "t1": <epoch s>, "trace_id": "…32hex"}

``t0``/``t1`` are WALL-clock epoch seconds so sinks from different
processes merge on one axis; spans timed with ``time.monotonic()`` /
``time.perf_counter()`` convert via :func:`wall_from_monotonic` /
:func:`wall_from_perf_counter` (process-constant offsets captured at
import — drift over a request's lifetime is nanoseconds).

See ``tools/trace_merge.py`` for the cross-process join (causal tree +
Perfetto render + SLO attribution) and the package README for the
end-to-end walkthrough.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "TraceContext", "Tracer", "trace_sample", "configure_tracer",
    "get_tracer", "inject_wire_context", "extract_wire_context",
    "read_trace_sink", "wall_from_monotonic", "wall_from_perf_counter",
    "WIRE_TOKEN",
]

# traceparent version/flags per W3C; we always mark sampled=01 because
# an unsampled request never carries the token at all.
_VERSION = "00"
_FLAGS = "01"
WIRE_TOKEN = "trace="

# Process-constant clock offsets: epoch = mono + _EPOCH_MINUS_MONO.
# Captured once so every span in one process rebases identically.
_EPOCH_MINUS_MONO = time.time() - time.monotonic()
_EPOCH_MINUS_PERF = time.time() - time.perf_counter()

_HEX = set("0123456789abcdef")


def wall_from_monotonic(t: float) -> float:
    """Map a ``time.monotonic()`` stamp to wall-clock epoch seconds."""
    return t + _EPOCH_MINUS_MONO


def wall_from_perf_counter(t: float) -> float:
    """Map a ``time.perf_counter()`` stamp to wall-clock epoch seconds."""
    return t + _EPOCH_MINUS_PERF


def _is_hex(s: str) -> bool:
    return bool(s) and all(c in _HEX for c in s)


class TraceContext:
    """One request identity at one point in the causal chain.

    ``span_id`` is THIS hop's span; serializing the context
    (:meth:`to_header`) hands it downstream as the parent for the next
    hop's spans. ``parent_id`` is None only for the ingress root."""

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id

    def to_header(self) -> str:
        """``00-<trace_id>-<span_id>-01`` (W3C traceparent shape)."""
        return f"{_VERSION}-{self.trace_id}-{self.span_id}-{_FLAGS}"

    def __repr__(self) -> str:  # debugging only; never on the wire
        return (f"TraceContext({self.trace_id[:8]}…, {self.span_id}, "
                f"parent={self.parent_id})")


def parse_header(header: str) -> Optional[Tuple[str, str]]:
    """``(trace_id, parent_span_id)`` from a traceparent header, or
    None when the string is not a well-formed header (a path that
    merely CONTAINS ``trace=`` must never be eaten — see
    :func:`extract_wire_context`)."""
    parts = header.split("-")
    if len(parts) != 4:
        return None
    ver, trace_id, span_id, _flags = parts
    if ver != _VERSION or len(trace_id) != 32 or len(span_id) != 16:
        return None
    if not (_is_hex(trace_id) and _is_hex(span_id)):
        return None
    return trace_id, span_id


def trace_sample(trace_id: str, rate: float, seed: int = 0) -> bool:
    """Deterministic head-sampling decision: a seeded blake2b hash of
    the trace_id mapped to [0, 1) compared against ``rate``. No wall
    clock, no PRNG — every process (and every replay) that sees the
    same trace_id makes the SAME decision."""
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    h = hashlib.blake2b(f"{seed}:{trace_id}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "big") / 2.0 ** 64 < rate


class Tracer:
    """Per-process span recorder with a crash-tolerant JSONL sink.

    ``sample_rate`` gates only :meth:`ingress` (where a trace is BORN);
    :meth:`accept` honors an upstream decision — a header on the wire
    means the ingress already sampled it. With ``sample_rate == 0`` and
    no inbound headers the hot path allocates NOTHING: ``allocations``
    stays 0, and tools/telemetry_overhead.py fails loudly if it ever
    doesn't."""

    def __init__(self, sink_path: Optional[str] = None, *,
                 role: str = "proc", sample_rate: float = 0.0,
                 seed: int = 0, registry: Any = None):
        self.role = role
        self.sample_rate = float(sample_rate)
        self.seed = int(seed)
        self.registry = registry
        self._path = sink_path
        self._fh = None
        self._lock = threading.Lock()
        # Lock-free id sequence: itertools.count.__next__ is atomic
        # under the GIL, and ingress runs once per request on EVERY
        # serving thread — a lock here serializes the whole client
        # pool each batch wave.
        self._seq = itertools.count(1)
        #: TraceContext + span-row objects built so far — the
        #: zero-alloc-when-off gate reads this.
        self.allocations = 0

    # -------------------------------------------------------- identity
    @property
    def enabled(self) -> bool:
        """Whether this process records spans at all (sink configured)."""
        return self._path is not None

    def _next_id(self, trace_id: str, width: int) -> str:
        seq = next(self._seq)
        h = hashlib.blake2b(
            f"{self.role}:{os.getpid()}:{seq}:{trace_id}".encode(),
            digest_size=width // 2)
        return h.hexdigest()

    def ingress(self, key: str = "") -> Optional[TraceContext]:
        """Start a new trace at request ingress, or None when tracing
        is off / this trace_id loses the sampling draw. ``key`` salts
        the trace_id (e.g. the request path) so concurrent ingresses
        never collide."""
        if self.sample_rate <= 0.0 or not self.enabled:
            return None
        trace_id = self._next_id(key, 32)
        if not trace_sample(trace_id, self.sample_rate, self.seed):
            return None
        self.allocations += 1
        return TraceContext(trace_id, self._next_id(trace_id, 16), None)

    def accept(self, header: Optional[str]) -> Optional[TraceContext]:
        """Adopt an upstream hop's header: returns a context whose
        spans chain under the upstream span. The upstream made the
        sampling decision; ``sample_rate`` is NOT re-applied."""
        if header is None or not self.enabled:
            return None
        parsed = parse_header(header)
        if parsed is None:
            return None
        trace_id, parent = parsed
        self.allocations += 1
        return TraceContext(trace_id, self._next_id(trace_id, 16), parent)

    def child(self, ctx: Optional[TraceContext]
              ) -> Optional[TraceContext]:
        """A sub-span context under ``ctx`` (same trace, new span_id,
        parent = ctx.span_id)."""
        if ctx is None:
            return None
        self.allocations += 1
        return TraceContext(ctx.trace_id,
                            self._next_id(ctx.trace_id, 16),
                            ctx.span_id)

    # ------------------------------------------------------- recording
    def record(self, ctx: Optional[TraceContext], name: str,
               t0: float, t1: float, **args: Any) -> None:
        """Append one finished span (wall-clock epoch bounds) for
        ``ctx`` to the sink. No-op on a None context — call sites stay
        unconditional."""
        if ctx is None or not self.enabled:
            return
        self.allocations += 1
        row = {"trace_id": ctx.trace_id, "span_id": ctx.span_id,
               "parent_id": ctx.parent_id, "name": name,
               "role": self.role, "pid": os.getpid(),
               "t0": t0, "t1": t1, "args": args}
        line = json.dumps(row, sort_keys=True)
        with self._lock:
            if self._fh is None:
                self._fh = open(self._path, "a", encoding="utf-8")
            # ONE write + flush per span: a crash mid-write tears at
            # most the final line, which readers skip.
            self._fh.write(line + "\n")
            self._fh.flush()
        if self.registry is not None:
            self.registry.count("trace_spans_total")

    def span(self, ctx: Optional[TraceContext], name: str,
             t0: float, t1: float, **args: Any
             ) -> Optional[TraceContext]:
        """Record a sub-span under ``ctx`` and return ITS context (so a
        downstream relay can chain under the sub-span, e.g. replica
        exec under ``cascade.student``)."""
        sub = self.child(ctx)
        self.record(sub, name, t0, t1, **args)
        return sub

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


# Null by default: serving code calls get_tracer() unconditionally and
# the off path is one attribute check, zero allocations.
_GLOBAL = Tracer(None)
_GLOBAL_LOCK = threading.Lock()


def configure_tracer(sink_path: Optional[str], *, role: str = "proc",
                     sample_rate: float = 0.0, seed: int = 0,
                     registry: Any = None) -> Tracer:
    """Install (and return) the process-global tracer. Passing
    ``sink_path=None`` restores the null tracer."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        _GLOBAL = Tracer(sink_path, role=role, sample_rate=sample_rate,
                         seed=seed, registry=registry)
        return _GLOBAL


def get_tracer() -> Tracer:
    return _GLOBAL


# ------------------------------------------------------------- the wire
def inject_wire_context(line: str, header: Optional[str]) -> str:
    """Insert a ``trace=<header>`` token into a ``::``-command protocol
    line, directly after the command word (``::req trace=… head=… p``).
    Lines without a header — or non-command lines, whose ingress is the
    serve CLI itself — pass through BYTE-IDENTICAL, so an untraced
    fleet's wire traffic is indistinguishable from pre-tracing builds."""
    if not header or not line.startswith("::"):
        return line
    cmd, sep, rest = line.partition(" ")
    if not sep:
        return f"{cmd} {WIRE_TOKEN}{header}"
    return f"{cmd} {WIRE_TOKEN}{header} {rest}"


def extract_wire_context(line: str) -> Tuple[Optional[str], str]:
    """``(header | None, line_without_token)``: strip the first
    well-formed ``trace=`` token from a protocol line. A token that
    does not parse as a traceparent header (e.g. a request path that
    happens to contain ``trace=``) is left in place — the wire is never
    corrupted by a lookalike."""
    if WIRE_TOKEN not in line:
        return None, line
    parts = line.split(" ")
    for i, part in enumerate(parts):
        if part.startswith(WIRE_TOKEN):
            header = part[len(WIRE_TOKEN):]
            if parse_header(header) is not None:
                del parts[i]
                return header, " ".join(parts)
    return None, line


# ------------------------------------------------------------ the sinks
def read_trace_sink(path: str) -> List[Dict[str, Any]]:
    """Load one process's span rows, tolerating a crash-truncated (or
    otherwise torn) final line: every line that parses to a dict with
    the required keys is kept, anything else is skipped — a COMPLETE
    span is never dropped (tier-1 asserts this on interleaved/truncated
    sinks)."""
    rows: List[Dict[str, Any]] = []
    try:
        with open(path, "r", encoding="utf-8") as fh:
            raw = fh.read()
    except FileNotFoundError:
        return rows
    for line in raw.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            row = json.loads(line)
        except ValueError:
            continue
        if isinstance(row, dict) and "trace_id" in row and \
                "span_id" in row and "t0" in row and "t1" in row:
            rows.append(row)
    return rows
