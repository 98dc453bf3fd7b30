"""Trace-driven load generation: replayable production-shaped traffic.

Port of the JAX package's ``serve/loadgen.py``: the same profile file
gives the same schedule — every arrival time and every head/tier/rung
tag — bit for bit in both packages (one seeded numpy generator).

Production traffic is not flat: it is diurnal (a sinusoidal day/night
swing), bursty (a launch or a retry storm is a step multiplier, not a
gentle ramp), and skewed across request shapes (head/tier/rung mixes —
a fleet that only ever sees one shape never exercises its affinity or
tier machinery). This module is the ONE load model both sinks drive
(:func:`run_trace_engine` against a single in-process engine;
:class:`TraceClients` against a serve socket or a live fleet router),
so a single-engine capacity number and a fleet SLO claim are earned
under the *same* traffic shape.

**Profiles are data, not code.** A :class:`LoadProfile` is a JSON file
(committed under ``profiles/`` and next to each run artifact) pinning:

* ``baseline_rps`` — the flat carrier rate,
* ``segments`` — ``[{"t0": s, "t1": s, "label": str, "rate_mult": x}]``
  step multipliers (a 4x burst is one segment); segment labels double
  as the phase-report windows, so "p99 during the burst" is a first-
  class number, not a post-hoc timeline slice,
* ``diurnal`` — optional ``{"period_s": p, "amplitude": a}`` sinusoid
  multiplier ``1 + a*sin(2*pi*t/p)`` (a compressed day),
* ``head_mix`` / ``tier_mix`` / ``rung_mix`` — per-request draw
  weights over the serve protocol's request-shape vocabulary,
* ``seed`` — and this is the point: :func:`build_schedule` derives the
  ENTIRE arrival sequence (times and per-arrival head/tier/rung tags)
  from one seeded generator via Lewis-Shedler thinning, so the same
  profile file replays the same trace bit-for-bit on any host. A run
  artifact plus its profile is a reproducible experiment, not a story.

**Two sinks, one schedule.** :func:`run_trace_engine` submits the
schedule straight into an :class:`..engine.InferenceEngine` (the
single-engine bench — no sockets, measures batching economics under
the shape). :class:`TraceClients` drives a serve socket or the fleet
router over the line protocol: workers are partitioned by rung (each
connection declares ``::rung N`` once — a real client has one shape),
and every non-default request rides the inline ``::req [head=H]
[tier=T] <path>`` grammar, so mixed traffic exercises exactly the
relay machinery production clients do. Latency is measured from the
SCHEDULED arrival time, not the send time — client-side queueing
under a burst is part of the number (the open-system discipline).
"""

from __future__ import annotations

import dataclasses
import json
import math
import socket
import threading
import time
from collections import deque
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..telemetry import tracing as _tracing


# ------------------------------------------------------ phase windows
# The phase-tagged latency machinery lives HERE, at the package layer:
# every harness and both loadgen sinks share ONE sample shape.
class PhaseSamples:
    """Thread-safe (t_done_rel_s, latency_s, ok) sample collector.

    Collection is mark-free on purpose: a run that learns its swap
    boundaries mid-run can still cut phases, because they are assigned at
    :func:`phase_report` time, not at record time.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._samples = []

    def add(self, t_rel_s: float, latency_s: float,
            ok: bool = True) -> None:
        with self._lock:
            self._samples.append(
                (float(t_rel_s), float(latency_s), bool(ok)))

    @property
    def samples(self):
        with self._lock:
            return list(self._samples)


def parse_marks(specs) -> list:
    """``["3=pre", "8.5=during"]`` -> sorted ``[(3.0, "pre"), ...]``."""
    marks = []
    for spec in specs or ():
        t_s, sep, label = str(spec).partition("=")
        if not sep or not label.strip():
            raise ValueError(
                f"expected --mark <seconds>=<label>, got {spec!r}")
        marks.append((float(t_s), label.strip()))
    return sorted(marks)


def phase_report(samples, marks, first_label: str = "start") -> dict:
    """Split samples into phase windows at the marks (by COMPLETION
    time — a request straddling a boundary lands in the phase that
    felt its latency) and report per-phase percentiles, in timeline
    order. ``ok=False`` samples count (``errors``) but never pollute
    the latency percentiles."""
    marks = sorted(marks)
    labels = [first_label] + [label for _, label in marks]
    bounds = [t for t, _ in marks]
    buckets = {label: [] for label in labels}
    errors = {label: 0 for label in labels}
    for t_rel, lat, ok in samples:
        idx = 0
        for i, b in enumerate(bounds):
            if t_rel >= b:
                idx = i + 1
        label = labels[idx]
        if ok:
            buckets[label].append(lat)
        else:
            errors[label] += 1
    out = {}
    for label in labels:
        lat = np.asarray(buckets[label], float) * 1e3
        row = {"count": int(lat.size), "errors": errors[label]}
        if lat.size:
            p50, p95, p99 = np.percentile(lat, [50.0, 95.0, 99.0])
            row.update(p50_ms=round(float(p50), 3),
                       p95_ms=round(float(p95), 3),
                       p99_ms=round(float(p99), 3))
        else:
            row.update(p50_ms=None, p95_ms=None, p99_ms=None)
        out[label] = row
    return out

# The request-shape vocabularies a profile may mix over. Kept as a
# local import target (not from .engine) so loadgen stays importable
# without the model stack — the fleet tests ride fakes.
VALID_HEADS: Tuple[str, ...] = ("probs", "features", "tokens")
VALID_TIERS: Tuple[str, ...] = ("interactive", "batch")
DEFAULT_HEAD = "probs"
DEFAULT_TIER = "interactive"


@dataclasses.dataclass(frozen=True)
class Segment:
    """One step-multiplier window: ``rate_mult`` applies on
    ``[t0, t1)``. Labels name phase-report windows (``burst``)."""

    t0: float
    t1: float
    rate_mult: float
    label: str


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One scheduled request: when, and what shape."""

    t: float          # seconds from trace start
    head: str
    tier: str
    rung: Optional[int]


def _norm_mix(mix: Optional[dict], valid: Optional[Sequence[str]],
              what: str, default_key: str) -> Dict[str, float]:
    if not mix:
        return {default_key: 1.0}
    out: Dict[str, float] = {}
    for key, w in mix.items():
        if valid is not None and str(key) not in valid:
            raise ValueError(f"unknown {what} {key!r} in profile mix; "
                             f"valid: {sorted(valid)}")
        weight = float(w)
        if weight <= 0 or not math.isfinite(weight):
            raise ValueError(f"{what} mix weight must be finite and "
                             f"> 0, got {key}={w!r}")
        out[str(key)] = weight
    total = sum(out.values())
    return {k: v / total for k, v in out.items()}


@dataclasses.dataclass(frozen=True)
class LoadProfile:
    """A parsed, validated load profile (see module docstring).

    Construct via :meth:`from_dict` / :meth:`load` — the constructors
    are where the validation lives, and a profile that parses is a
    profile that replays.
    """

    name: str
    seed: int
    duration_s: float
    baseline_rps: float
    segments: Tuple[Segment, ...]
    diurnal_period_s: Optional[float]
    diurnal_amplitude: float
    head_mix: Dict[str, float]
    tier_mix: Dict[str, float]
    rung_mix: Dict[int, float]
    slo_p99_ms: Optional[float]

    # ------------------------------------------------------ constructors
    @classmethod
    def from_dict(cls, raw: dict, name: str = "profile") -> "LoadProfile":
        duration_s = float(raw.get("duration_s", 0.0))
        baseline = float(raw.get("baseline_rps", 0.0))
        if duration_s <= 0:
            raise ValueError("profile needs duration_s > 0")
        if baseline <= 0:
            raise ValueError("profile needs baseline_rps > 0")
        segments: List[Segment] = []
        for i, seg in enumerate(raw.get("segments", ())):
            t0 = float(seg.get("t0", 0.0))
            t1 = float(seg.get("t1", duration_s))
            mult = float(seg.get("rate_mult", 1.0))
            if not (0.0 <= t0 < t1):
                raise ValueError(
                    f"segment {i}: need 0 <= t0 < t1, got "
                    f"[{t0}, {t1})")
            if mult < 0 or not math.isfinite(mult):
                raise ValueError(
                    f"segment {i}: rate_mult must be finite and >= 0")
            segments.append(Segment(
                t0=t0, t1=t1, rate_mult=mult,
                label=str(seg.get("label", f"seg{i}"))))
        segments.sort(key=lambda s: s.t0)
        for a, b in zip(segments, segments[1:]):
            if b.t0 < a.t1:
                raise ValueError(
                    f"segments {a.label!r} and {b.label!r} overlap "
                    f"([{a.t0},{a.t1}) vs [{b.t0},{b.t1})) — the rate "
                    "function must be single-valued")
        # Labels become the phase-report window keys ("carrier" +
        # label + after_<label>): a collision would silently merge two
        # distinct windows into one blended p99 the profile author
        # never declared.
        windows = ["carrier"]
        for seg in segments:
            windows.append(seg.label)
            if seg.t1 < duration_s:
                windows.append(f"after_{seg.label}")
        dupes = {w for w in windows if windows.count(w) > 1}
        if dupes:
            raise ValueError(
                f"segment labels collide on phase window(s) "
                f"{sorted(dupes)!r} — every segment needs a unique "
                "label, none may be 'carrier' or shadow another's "
                "'after_' window")
        diurnal = raw.get("diurnal") or {}
        period = diurnal.get("period_s")
        amplitude = float(diurnal.get("amplitude", 0.0))
        if period is not None:
            period = float(period)
            if period <= 0:
                raise ValueError("diurnal.period_s must be > 0")
            if not (0.0 <= amplitude < 1.0):
                raise ValueError(
                    "diurnal.amplitude must be in [0, 1) — an "
                    "amplitude >= 1 would ask for a negative rate")
        rung_mix_raw = _norm_mix(raw.get("rung_mix"), None, "rung", "1")
        rung_mix: Dict[int, float] = {}
        for k, v in rung_mix_raw.items():
            try:
                rung = int(k)
            except ValueError:
                raise ValueError(
                    f"rung mix key {k!r} is not an integer") from None
            if rung < 1:
                raise ValueError(f"rung mix key must be >= 1, got {rung}")
            rung_mix[rung] = v
        slo = raw.get("slo_p99_ms")
        return cls(
            name=str(raw.get("name", name)),
            seed=int(raw.get("seed", 0)),
            duration_s=duration_s,
            baseline_rps=baseline,
            segments=tuple(segments),
            diurnal_period_s=period,
            diurnal_amplitude=amplitude if period is not None else 0.0,
            head_mix=_norm_mix(raw.get("head_mix"), VALID_HEADS,
                               "head", DEFAULT_HEAD),
            tier_mix=_norm_mix(raw.get("tier_mix"), VALID_TIERS,
                               "tier", DEFAULT_TIER),
            rung_mix=rung_mix,
            slo_p99_ms=float(slo) if slo is not None else None)

    @classmethod
    def load(cls, path) -> "LoadProfile":
        path = Path(path)
        try:
            raw = json.loads(path.read_text())
        except json.JSONDecodeError as e:
            raise ValueError(f"profile {path}: not valid JSON: {e}") \
                from None
        return cls.from_dict(raw, name=path.stem)

    # ------------------------------------------------------------- shape
    def rate_at(self, t: float) -> float:
        """Offered rate (rps) at ``t`` seconds: baseline x segment
        step x diurnal sinusoid."""
        rate = self.baseline_rps
        for seg in self.segments:
            if seg.t0 <= t < seg.t1:
                rate *= seg.rate_mult
                break
        if self.diurnal_period_s:
            rate *= 1.0 + self.diurnal_amplitude * math.sin(
                2.0 * math.pi * t / self.diurnal_period_s)
        return rate

    def peak_rps(self) -> float:
        """Upper bound of :meth:`rate_at` over the trace (the thinning
        envelope — exact for step segments x bounded sinusoid)."""
        mult = max([s.rate_mult for s in self.segments] + [1.0])
        return self.baseline_rps * mult * (1.0 + self.diurnal_amplitude)

    def marks(self) -> List[Tuple[float, str]]:
        """Phase boundaries for :func:`phase_report`:
        each segment opens its labeled window; the window after a
        segment closes reopens the carrier (``after_<label>``)."""
        marks: List[Tuple[float, str]] = []
        for seg in self.segments:
            marks.append((seg.t0, seg.label))
            if seg.t1 < self.duration_s:
                marks.append((seg.t1, f"after_{seg.label}"))
        return sorted(marks)

    def describe(self) -> dict:
        """JSON-serializable summary (what run artifacts embed)."""
        return {
            "name": self.name, "seed": self.seed,
            "duration_s": self.duration_s,
            "baseline_rps": self.baseline_rps,
            "peak_rps": round(self.peak_rps(), 3),
            "segments": [dataclasses.asdict(s) for s in self.segments],
            "diurnal": ({"period_s": self.diurnal_period_s,
                         "amplitude": self.diurnal_amplitude}
                        if self.diurnal_period_s else None),
            "head_mix": dict(self.head_mix),
            "tier_mix": dict(self.tier_mix),
            "rung_mix": {str(k): v for k, v in self.rung_mix.items()},
            "slo_p99_ms": self.slo_p99_ms,
        }


def build_schedule(profile: LoadProfile) -> List[Arrival]:
    """The full arrival trace, derived deterministically from the
    profile's seed.

    Non-homogeneous Poisson via Lewis-Shedler thinning: candidate
    arrivals at the peak rate, each kept with probability
    ``rate_at(t)/peak``. Every random draw — candidate gaps, the
    accept coin, and the per-arrival head/tier/rung tags — comes from
    ONE seeded generator in a fixed order, so ``build_schedule(p)`` is
    a pure function of the profile file: the replay-bit-for-bit
    contract run artifacts rest on.
    """
    rng = np.random.default_rng(profile.seed)
    lam = profile.peak_rps()
    heads = sorted(profile.head_mix)
    head_p = [profile.head_mix[h] for h in heads]
    tiers = sorted(profile.tier_mix)
    tier_p = [profile.tier_mix[t] for t in tiers]
    rungs = sorted(profile.rung_mix)
    rung_p = [profile.rung_mix[r] for r in rungs]
    out: List[Arrival] = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / lam))
        if t >= profile.duration_s:
            break
        if float(rng.random()) * lam > profile.rate_at(t):
            continue   # thinned: a candidate the true rate rejects
        head = heads[int(rng.choice(len(heads), p=head_p))]
        tier = tiers[int(rng.choice(len(tiers), p=tier_p))]
        rung = rungs[int(rng.choice(len(rungs), p=rung_p))]
        out.append(Arrival(t=t, head=head, tier=tier, rung=rung))
    return out


# --------------------------------------------------------- engine sink
def run_trace_engine(engine, profile: LoadProfile,
                     timeout_s: float = 30.0) -> dict:
    """Replay a profile straight into an in-process
    :class:`..engine.InferenceEngine`: open-loop submits on the schedule's clock, per-segment
    phase windows, per-(head, tier) groups. Rung tags are recorded but
    not acted on — rung affinity is a ROUTER concept; a single engine
    buckets by batch size on its own."""
    schedule = build_schedule(profile)
    row = np.zeros((engine.image_size, engine.image_size, 3), np.float32)
    phases = PhaseSamples()
    groups: Dict[Tuple[str, str], PhaseSamples] = {}
    futures = []
    rejected = 0
    t0 = time.perf_counter()
    for arr in schedule:
        now = time.perf_counter()
        t_sched = t0 + arr.t
        if now < t_sched:
            time.sleep(t_sched - now)
        key = (arr.head, arr.tier)
        ps = groups.get(key)
        if ps is None:
            ps = groups[key] = PhaseSamples()

        def record(fut, t_sched=t_sched, ps=ps):
            t_done = time.perf_counter()
            ok = fut.exception() is None
            # Latency from the SCHEDULED arrival: a submit that slipped
            # because the trace fell behind still charges the slip.
            phases.add(t_done - t0, t_done - t_sched, ok=ok)
            ps.add(t_done - t0, t_done - t_sched, ok=ok)

        try:
            fut = engine.submit(row, timeout=timeout_s, head=arr.head,
                                tier=arr.tier)
            fut.add_done_callback(record)
            futures.append(fut)
        except Exception:  # noqa: BLE001 — QueueFull backpressure
            rejected += 1
    ok = err = 0
    for f in futures:
        try:
            f.result(timeout=60)
            ok += 1
        except Exception:  # noqa: BLE001 — expiries land here
            err += 1
    dt = time.perf_counter() - t0
    report = {}
    for (head, tier), ps in sorted(groups.items()):
        report[f"{head}/{tier}"] = phase_report(
            ps.samples, [], first_label="window")["window"]
    return {
        "mode": "trace_engine", "profile": profile.describe(),
        "scheduled": len(schedule), "completed": ok, "failed": err,
        "rejected_at_admission": rejected,
        "achieved_rps": round(ok / dt, 2),
        "wall_s": round(dt, 2),
        "phases": phase_report(phases.samples, profile.marks(),
                               first_label="carrier"),
        "groups": report,
    }


# --------------------------------------------------------- socket sink
class TraceClients:
    """Replay a profile against a serve socket or the fleet router.

    Workers are partitioned by rung — each holds ONE persistent
    connection that declares ``::rung N`` once, then serves arrivals
    of that rung from a per-rung queue (a real client has one shape;
    the router's affinity machinery sees exactly the connection-state
    protocol production clients speak). Non-default head/tier rides
    the inline ``::req`` form per request. One request outstanding per
    connection keeps request/reply matching positional, so the
    exactly-once accounting is airtight: ``dropped`` =
    sends that never got a reply, ``double_answered`` = bytes arriving
    with nothing outstanding.

    Latency is charged from the scheduled arrival time (client-side
    burst queueing included); ``error_replies`` keeps the first few
    raw error lines for the artifact.
    """

    def __init__(self, address, request_line: str | Sequence[str],
                 profile: LoadProfile, *,
                 clients_per_rung: int = 8,
                 reply_timeout_s: float = 90.0,
                 record_answers: bool = False):
        self.address = address
        # One line, or a SET cycled deterministically by arrival index
        # (a shadow-compared canary judged on a single image
        # would reduce "quality" to one coin flip — a probe set makes
        # the disagreement fraction a real distribution statistic).
        if isinstance(request_line, str):
            self.request_lines = [request_line]
        else:
            self.request_lines = [str(r) for r in request_line]
            if not self.request_lines:
                raise ValueError("request_line sequence is empty")
        self.request_line = self.request_lines[0]
        self.profile = profile
        self.schedule = build_schedule(profile)
        self.clients_per_rung = int(clients_per_rung)
        self.reply_timeout_s = float(reply_timeout_s)
        self.phases = PhaseSamples()
        self._lock = threading.Lock()
        self.sent = 0
        self.answered = 0
        self.errors = 0
        self.dropped = 0
        self.double_answered = 0
        self.connect_failures = 0
        self.error_replies: list = []
        # (request_lines index, served label) per ok reply, when asked
        # for — the cascade A/B's fidelity yardstick needs the SERVED
        # answers, not a separate offline prediction pass.
        self.record_answers = bool(record_answers)
        self.answers: List[Tuple[int, str]] = []
        self._stop = threading.Event()
        self._queues: Dict[int, deque] = {
            r: deque() for r in profile.rung_mix}
        self._work: Dict[int, threading.Semaphore] = {
            r: threading.Semaphore(0) for r in profile.rung_mix}
        # Live workers per rung: when the count hits 0 the rung's
        # queue is drained into ``dropped`` — a rung nobody serves
        # must report its loss, not hang join() on it.
        self._live: Dict[int, int] = {r: 0 for r in profile.rung_mix}
        self._threads: list = []
        self._t0: Optional[float] = None

    # -- lifecycle
    def start(self) -> "TraceClients":
        self._t0 = time.perf_counter()
        pacer = threading.Thread(target=self._pace, name="trace-pacer",
                                 daemon=True)
        self._threads.append(pacer)
        for rung in sorted(self._queues):
            with self._lock:
                self._live[rung] = self.clients_per_rung
            for i in range(self.clients_per_rung):
                t = threading.Thread(
                    target=self._worker, args=(rung,),
                    name=f"trace-client-r{rung}-{i}", daemon=True)
                self._threads.append(t)
        for t in self._threads:
            t.start()
        return self

    def join(self, timeout_s: Optional[float] = None) -> None:
        """Block until the whole schedule has been dispatched and
        answered (or ``timeout_s`` passes)."""
        budget = timeout_s if timeout_s is not None else (
            self.profile.duration_s + self.reply_timeout_s + 30.0)
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            # A rung whose every worker has exited can never answer:
            # sweep its queue into ``dropped`` here too (covers the
            # append-vs-last-exit race) so the loop terminates on
            # loss instead of spinning out the whole budget.
            for rung, live in list(self._live.items()):
                if live == 0:
                    self._drain_rung(rung)
            with self._lock:
                done = (self.answered + self.dropped) >= self.sent \
                    and self.sent >= len(self.schedule)
            if done:
                break
            time.sleep(0.05)
        self.stop()

    def stop(self) -> None:
        self._stop.set()
        for rung, sem in self._work.items():
            for _ in range(self.clients_per_rung):
                sem.release()
        for t in self._threads:
            t.join(self.reply_timeout_s + 10.0)

    # -- internals
    def _pace(self) -> None:
        for i, arr in enumerate(self.schedule):
            if self._stop.is_set():
                return
            now = time.perf_counter()
            t_sched = self._t0 + arr.t
            while now < t_sched:
                if self._stop.wait(min(t_sched - now, 0.05)):
                    return
                now = time.perf_counter()
            with self._lock:
                self.sent += 1
            self._queues[arr.rung].append((t_sched, arr, i))
            self._work[arr.rung].release()

    def _request_for(self, arr: Arrival, index: int) -> str:
        line = self.request_lines[index % len(self.request_lines)]
        tags = []
        if arr.head != DEFAULT_HEAD:
            tags.append(f"head={arr.head}")
        if arr.tier != DEFAULT_TIER:
            tags.append(f"tier={arr.tier}")
        if not tags:
            return line
        return f"::req {' '.join(tags)} {line}"

    def _worker(self, rung: int) -> None:
        try:
            self._serve_rung(rung)
        finally:
            with self._lock:
                self._live[rung] -= 1
                last = self._live[rung] == 0
            if last:
                self._drain_rung(rung)

    def _drain_rung(self, rung: int) -> None:
        """Nobody serves this rung any more (every worker failed to
        connect or died): each queued arrival is a DROP, counted so
        join() terminates and the artifact reports the loss as loss."""
        while True:
            try:
                self._queues[rung].popleft()
            except IndexError:
                return
            with self._lock:
                self.dropped += 1

    def _serve_rung(self, rung: int) -> None:
        try:
            sock = socket.create_connection(self.address, timeout=30.0)
        except OSError:
            sock = None
        if sock is None:
            with self._lock:
                self.connect_failures += 1
            return
        sock.settimeout(self.reply_timeout_s)
        rfile = sock.makefile("r", encoding="utf-8")
        tracer = _tracing.get_tracer()
        try:
            sock.sendall(f"::rung {rung}\n".encode())
            if not rfile.readline():
                with self._lock:
                    self.connect_failures += 1
                return
            while True:
                self._work[rung].acquire()
                if self._stop.is_set():
                    break
                try:
                    t_sched, arr, idx = self._queues[rung].popleft()
                except IndexError:
                    continue
                # Client ingress: a sampled request is BORN here — the
                # root span of the causal tree. A bare path upgrades to
                # the tagless ``::req <path>`` form so the token has a
                # command to ride; unsampled requests (the overwhelming
                # default) go out byte-identical to pre-tracing builds.
                wire = self._request_for(arr, idx)
                ctx = tracer.ingress(wire)
                if ctx is not None:
                    if not wire.startswith("::"):
                        wire = f"::req {wire}"
                    wire = _tracing.inject_wire_context(
                        wire, ctx.to_header())
                try:
                    sock.sendall((wire + "\n").encode())
                    reply = rfile.readline()
                except OSError:
                    reply = ""
                t_done = time.perf_counter()
                if not reply:
                    with self._lock:
                        self.dropped += 1
                    return   # server gone: this worker is done
                ok = "\tERROR\t" not in reply
                with self._lock:
                    self.answered += 1
                    if ok and self.record_answers:
                        parts = reply.rstrip("\n").split("\t")
                        if len(parts) >= 2:
                            self.answers.append(
                                (idx % len(self.request_lines),
                                 parts[1]))
                    if not ok:
                        self.errors += 1
                        if len(self.error_replies) < 20:
                            self.error_replies.append(
                                reply.strip()[:200])
                self.phases.add(t_done - self._t0, t_done - t_sched,
                                ok=ok)
                if ctx is not None:
                    # Charged from the SCHEDULED arrival, same as the
                    # latency sample — client-side burst queueing is
                    # part of the request's critical path.
                    tracer.record(
                        ctx, "client.request",
                        _tracing.wall_from_perf_counter(t_sched),
                        _tracing.wall_from_perf_counter(t_done),
                        rung=rung, head=arr.head, tier=arr.tier, ok=ok)
            # Exactly-once audit: nothing outstanding => silence.
            sock.settimeout(0.3)
            try:
                stray = rfile.readline()
            except OSError:
                stray = ""
            if stray:
                with self._lock:
                    self.double_answered += 1
        finally:
            for obj in (rfile, sock):
                try:
                    obj.close()
                except OSError:
                    pass

    def counts(self) -> dict:
        with self._lock:
            return {"sent": self.sent, "answered": self.answered,
                    "errors": self.errors, "dropped": self.dropped,
                    "double_answered": self.double_answered,
                    "connect_failures": self.connect_failures,
                    "error_replies": list(self.error_replies)}

    def report(self) -> dict:
        """Counts + per-segment phase windows, artifact-shaped."""
        return {
            "mode": "trace_socket",
            "profile": self.profile.describe(),
            "scheduled": len(self.schedule),
            "requests": self.counts(),
            "phases": phase_report(self.phases.samples,
                                   self.profile.marks(),
                                   first_label="carrier"),
        }
