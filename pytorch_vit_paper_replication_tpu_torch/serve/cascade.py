"""Speculative two-tier cascade at the fleet front door.

Port of the JAX package's ``serve/cascade.py`` (the same margins, config
refusals, drift-alarm sequences and routing for the same inputs).

A distilled Ti/16 student (``train --distill-from``) is ~16x
cheaper per image than its B/16 teacher but disagrees with it on a
small, *identifiable* slice of traffic: rows where the student's
softmax **margin** (top-1 minus top-2 probability) is small.
:class:`CascadeRouter` turns that into fleet throughput. It is a
:class:`.fleet.router.FleetRouter` over ONE mixed fleet — replicas whose
:class:`.fleet.replica.ReplicaSpec` declares ``model="student"`` next to
replicas declaring ``model="teacher"`` — whose classifier path
speculates:

1. every classifier request relays as the full-row ``::probs`` form
   to the STUDENT tier (the ``model=`` hard filter introduced for
   exactly this — a student answering teacher-tagged traffic would
   silently break the bit-identity contract below);
2. the router computes the top-1/top-2 margin from the probs row it
   already has — no extra inference, the row IS the reply;
3. a row whose margin is at or below ``threshold`` escalates: the SAME
   request re-dispatches to the teacher tier and the teacher's reply
   — its exact bytes — is what the client gets. Everything else ships
   the student's answer.

Three contracts, all test-pinned:

* **Exactly-once.** The client is answered once per request line, by
  whichever tier won; the student's speculative row on an escalated
  request is consumed by the router, never forwarded. The fleet's
  never-double-answered dispatch loop is reused verbatim for both
  legs.
* **Escalated rows are bit-identical to direct teacher ``::probs``.**
  The escalation relays the unmodified ``::probs <path>`` line and
  returns the teacher replica's reply bytes untouched — the cascade
  changes *which* model answers, never *what* a model answers.
* **Threshold endpoints degenerate exactly.** The gate is the
  INCLUSIVE ``margin <= threshold`` — a row exactly at the threshold
  escalates (the boundary is pinned by test, not implementation-
  defined). ``threshold=0`` escalates only exact top-1/top-2 ties
  (margin 0.0, vanishing under float softmax): the cascade IS the
  student fleet. ``threshold=inf`` always escalates: every answer is
  a teacher reply, bit-for-bit.

The threshold is LOADED, not guessed: a calibration (the repo's
``tools/calibrate_cascade.py``) sweeps paired student/teacher rows into
a ``cascade.json`` (threshold ↦ predicted escalation-rate + agreement
curve) and :meth:`CascadeRouter.from_config` boots from it, publishing
the calibration's predicted agreement floor as a gauge so live
agreement regressions have a declared baseline (effective cost ~=
student + e·teacher per request).

Scope: the cascade gates the default classifier slice only —
``head=probs``, ``tier=interactive``, no ``k=``, no explicit
``model=`` pin. Embedding heads have no "confident enough" test,
batch-tier traffic has its own SLO economics, and an explicit
``model=`` tag is an operator asking for direct tier access; all of
those ride the plain :class:`.fleet.router.FleetRouter` path unchanged.

Failure economics: an unanswerable student tier fails over to the
teacher (``cascade_student_failover_total`` — availability beats
economy); a failed escalation falls back to the student's valid
low-margin row (``cascade_teacher_fallback_total`` — a degraded
answer beats an error). Both are visible, neither is silent.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from pathlib import Path
from typing import Optional

import numpy as np

from ..telemetry import tracing as _tracing
from ..telemetry.registry import get_registry
from .batching import DEFAULT_HEAD, DEFAULT_TIER
from .fleet.replica import ReplicaManager
from .fleet.router import FleetRouter


def softmax_margin(row) -> float:
    """Top-1 minus top-2 probability of one softmax row — the
    student's self-reported confidence the escalation gate keys on.
    A single-class row has no runner-up: margin 1.0 (never escalate;
    the teacher could not answer differently)."""
    row = np.asarray(row, dtype=np.float64)
    if row.shape[-1] < 2:
        return 1.0
    top2 = np.partition(row, -2)[-2:]
    return float(top2[1] - top2[0])


def load_cascade_config(path) -> dict:
    """Read a ``cascade.json`` written by ``tools/calibrate_cascade.py``
    and validate the slice the router consumes. Returns ``{threshold,
    predicted_agreement, predicted_escalation_rate, source}`` —
    ``applied_threshold`` (the calibrator's floor-adjusted pick) wins
    over the raw ``threshold`` when both are present."""
    path = Path(path)
    try:
        raw = json.loads(path.read_text())
    except OSError as e:
        raise SystemExit(f"cascade config {path}: {e}")
    except ValueError as e:
        raise SystemExit(f"cascade config {path}: not valid JSON ({e}) "
                         "— point at tools/calibrate_cascade.py's "
                         "--json-out")
    threshold = raw.get("applied_threshold", raw.get("threshold"))
    if threshold is None:
        raise SystemExit(
            f"cascade config {path}: no 'threshold' (or "
            "'applied_threshold') key — this is not a "
            "tools/calibrate_cascade.py output")
    threshold = float(threshold)
    if not threshold >= 0.0:  # also catches NaN
        raise SystemExit(
            f"cascade config {path}: threshold must be >= 0 "
            f"(0 = student-only, inf = teacher-only), got {threshold!r}")
    out = {"threshold": threshold, "source": str(path)}
    for key in ("predicted_agreement", "predicted_escalation_rate"):
        if raw.get(key) is not None:
            out[key] = float(raw[key])
    return out


def _json_row(reply: str) -> Optional[dict]:
    """Parse a replica ``::probs`` reply; None for anything that is
    not a JSON object (e.g. the fleet's TSV backpressure shape)."""
    if not reply.startswith("{"):
        return None
    try:
        obj = json.loads(reply)
    except ValueError:
        return None
    return obj if isinstance(obj, dict) else None


class EscalationDriftAlarm:
    """Watch the live escalation rate against the
    calibration's prediction and ALARM when the input distribution has
    drifted out from under the threshold.

    The calibrated ``applied_threshold`` in a ``cascade.json`` predicts
    an escalation rate for the distribution it was fit on; a rolling
    window of per-request escalation decisions whose rate leaves
    ``expected_rate ± band`` (after ``min_samples`` observations) means
    the margins the student is producing no longer look like the
    calibration set — the threshold's agreement floor is no longer
    evidence. Firing emits a ``cascade_escalation_drift`` registry ring
    event (the stream :class:`..telemetry.watchdog.Watchdog`
    postmortems dump) carrying a ``refit_cmd`` hint — the
    ``tools/calibrate_cascade.py`` invocation that would re-fit —
    plus the ``cascade_drift_*`` gauges/counter, with hysteresis: one
    firing per band exit, re-armed only after the window returns in
    band."""

    def __init__(self, expected_rate: float, *, band: float = 0.15,
                 window: int = 256, min_samples: int = 64,
                 registry=None, refit_cmd: Optional[str] = None):
        if not 0.0 <= float(expected_rate) <= 1.0:
            raise ValueError(
                f"expected_rate must be a rate in [0, 1], got "
                f"{expected_rate!r}")
        if not float(band) > 0.0:
            raise ValueError(f"band must be > 0, got {band!r}")
        self.expected_rate = float(expected_rate)
        self.band = float(band)
        self.min_samples = max(1, int(min_samples))
        self.refit_cmd = refit_cmd
        self._win: deque = deque(maxlen=max(self.min_samples,
                                            int(window)))
        self._lock = threading.Lock()
        self._active = False
        self.fired = 0
        self._registry = registry if registry is not None \
            else get_registry()
        self._registry.gauge("cascade_drift_expected_rate",
                             self.expected_rate)
        self._registry.gauge("cascade_drift_alarm_active", 0.0)

    @property
    def active(self) -> bool:
        with self._lock:
            return self._active

    def window_rate(self) -> Optional[float]:
        with self._lock:
            if not self._win:
                return None
            return sum(self._win) / len(self._win)

    def observe(self, escalated: bool) -> bool:
        """Record one escalation decision; returns True iff THIS
        observation fired the alarm (band exit with hysteresis)."""
        reg = self._registry
        with self._lock:
            self._win.append(1 if escalated else 0)
            n = len(self._win)
            rate = sum(self._win) / n
            if n < self.min_samples:
                reg.gauge("cascade_drift_window_rate", rate)
                return False
            drifted = abs(rate - self.expected_rate) > self.band
            fired = drifted and not self._active
            if fired:
                self._active = True
                self.fired += 1
            elif not drifted:
                self._active = False
            active = self._active
        reg.gauge("cascade_drift_window_rate", rate)
        reg.gauge("cascade_drift_alarm_active", 1.0 if active else 0.0)
        if fired:
            reg.count("cascade_drift_alarms_total")
            reg.event("cascade_escalation_drift",
                      window_rate=round(rate, 6),
                      expected_rate=self.expected_rate,
                      band=self.band, window=n,
                      refit_cmd=self.refit_cmd or "")
        return fired

    def snapshot(self) -> dict:
        with self._lock:
            n = len(self._win)
            rate = (sum(self._win) / n) if n else None
            return {"expected_rate": self.expected_rate,
                    "band": self.band, "window": n,
                    "min_samples": self.min_samples,
                    "window_rate": rate, "active": self._active,
                    "fired": self.fired,
                    "refit_cmd": self.refit_cmd}


class CascadeRouter(FleetRouter):
    """See module docstring. ``student_model``/``teacher_model`` name
    the ``ReplicaSpec.model`` tags the two tiers declare; ``threshold``
    is the inclusive ``margin <= threshold`` escalation gate (a margin
    exactly at the threshold escalates)."""

    def __init__(self, manager: ReplicaManager, *,
                 threshold: float,
                 student_model: str = "student",
                 teacher_model: str = "teacher",
                 predicted_agreement: Optional[float] = None,
                 predicted_escalation_rate: Optional[float] = None,
                 drift_band: float = 0.15,
                 drift_window: int = 256,
                 drift_min_samples: int = 64,
                 refit_cmd: Optional[str] = None,
                 **kwargs):
        threshold = float(threshold)
        if not threshold >= 0.0:  # also catches NaN
            raise ValueError(
                f"threshold must be >= 0 (0 = student-only, inf = "
                f"teacher-only), got {threshold!r}")
        if student_model == teacher_model:
            raise ValueError(
                f"student and teacher tiers share the model tag "
                f"{student_model!r} — the hard filter could not tell "
                "them apart")
        # Validate BEFORE the base class binds its listener socket —
        # a rejected config must not leak a bound server.
        super().__init__(manager, **kwargs)
        self.threshold = threshold
        self.student_model = str(student_model)
        self.teacher_model = str(teacher_model)
        self.predicted_agreement = predicted_agreement
        self.predicted_escalation_rate = predicted_escalation_rate
        self._cascade_lock = threading.Lock()
        self._n_requests = 0
        self._n_escalated = 0
        self._n_student = 0
        self._n_teacher = 0
        self._n_failover = 0
        self._n_fallback = 0
        self._registry.gauge("cascade_threshold", self.threshold)
        if predicted_agreement is not None:
            self._registry.gauge("cascade_predicted_agreement",
                                 float(predicted_agreement))
        # The drift alarm exists exactly when the config
        # carried a calibrated expectation to judge the window against.
        self.refit_cmd = refit_cmd
        self.drift_alarm: Optional[EscalationDriftAlarm] = None
        if predicted_escalation_rate is not None:
            self.drift_alarm = EscalationDriftAlarm(
                float(predicted_escalation_rate), band=drift_band,
                window=drift_window, min_samples=drift_min_samples,
                registry=self._registry, refit_cmd=refit_cmd)

    @classmethod
    def from_config(cls, manager: ReplicaManager, config_path,
                    **kwargs) -> "CascadeRouter":
        """Boot from a ``tools/calibrate_cascade.py`` ``cascade.json``
        — the threshold is calibrated evidence, never argv folklore.
        The drift alarm's default ``refit_cmd`` hint points back at the
        calibrator with THIS config as the output slot."""
        cfg = load_cascade_config(config_path)
        kwargs.setdefault(
            "refit_cmd",
            f"python tools/calibrate_cascade.py --json-out "
            f"{cfg['source']}")
        return cls(manager, threshold=cfg["threshold"],
                   predicted_agreement=cfg.get("predicted_agreement"),
                   predicted_escalation_rate=cfg.get(
                       "predicted_escalation_rate"),
                   **kwargs)

    # ------------------------------------------------------------ routing
    def route(self, line: str, rung: Optional[int] = None,
              head: str = DEFAULT_HEAD, tier: str = DEFAULT_TIER,
              k: Optional[int] = None,
              model: Optional[str] = None, ctx=None) -> str:
        """The TSV classifier path: default-slice requests speculate
        through :meth:`_cascade` and the winning tier's probs row is
        formatted into the serve CLI's exact ``path\\tlabel\\tprob``
        shape; everything else (non-probs heads, batch tier, search
        ``k``, explicit ``model=`` pins) rides the base router."""
        if (head != DEFAULT_HEAD or tier != DEFAULT_TIER
                or k is not None or model is not None):
            return super().route(line, rung=rung, head=head, tier=tier,
                                 k=k, model=model, ctx=ctx)
        reply = self._cascade(line, line, rung, ctx=ctx)
        obj = _json_row(reply)
        if obj is None:
            return reply           # already the TSV backpressure shape
        if "error" in obj:
            return f"{line}\tERROR\t{obj['error']}"
        # serve/__main__._finish's exact formatting — cascade clients
        # read byte-shape-identical classifier replies.
        return f"{line}\t{obj['label']}\t{float(obj['prob']):.4f}"

    def _route_probs(self, line: str, rung: Optional[int] = None,
                     model: Optional[str] = None, ctx=None) -> str:
        """``::probs`` through the cascade: same gate, full-row JSON
        out. An explicit ``model=`` pin (``::model M`` connection
        state) is direct tier access — the operator's bit-sweep
        spelling — and bypasses speculation."""
        if model is not None:
            return super()._route_probs(line, rung=rung, model=model,
                                        ctx=ctx)
        path = line[len("::probs"):].strip()
        if not path:
            return f"{line}\tERROR\tValueError: expected '::probs <path>'"
        return self._cascade(line, path, rung, ctx=ctx)

    def _cascade(self, echo: str, path: str,
                 rung: Optional[int], ctx=None) -> str:
        """One speculative request → exactly one reply string (the
        teacher's verbatim bytes when escalation won — the
        bit-identity contract is BUILT here, not checked here). With a
        sampled ``ctx`` the hop records ``cascade.request`` plus the
        per-leg ``cascade.student`` / ``cascade.decide`` /
        ``cascade.teacher`` spans, each leg's sub-dispatch chaining
        under its leg span."""
        tracer = _tracing.get_tracer() if ctx is not None else None
        if tracer is None:
            return self._cascade_run(echo, path, rung, None, None)
        wall = _tracing.wall_from_monotonic
        t0 = time.monotonic()
        reply = self._cascade_run(echo, path, rung, ctx, tracer)
        tracer.record(ctx, "cascade.request", wall(t0),
                      wall(time.monotonic()), path=path)
        return reply

    def _leg(self, echo: str, relay: str, rung: Optional[int],
             model: str, name: str, ctx, tracer, **span_args) -> str:
        """One tier dispatch, wrapped in its leg span when traced."""
        if tracer is None:
            return self._dispatch(echo, relay, rung=rung, model=model)
        leg = tracer.child(ctx)
        t0 = time.monotonic()
        reply = self._dispatch(echo, relay, rung=rung, model=model,
                               ctx=tracer.child(leg))
        tracer.record(leg, name, _tracing.wall_from_monotonic(t0),
                      _tracing.wall_from_monotonic(time.monotonic()),
                      model=model, **span_args)
        return reply

    def _cascade_run(self, echo: str, path: str, rung: Optional[int],
                     ctx, tracer) -> str:
        reg = self._registry
        reg.count("cascade_requests_total")
        with self._cascade_lock:
            self._n_requests += 1
        relay = f"::probs {path}"
        sreply = self._leg(echo, relay, rung, self.student_model,
                           "cascade.student", ctx, tracer)
        sobj = _json_row(sreply)
        if sobj is None or "error" in sobj or "probs" not in sobj:
            # Student tier unanswerable (no routable student, replica
            # error row): unconditional failover — availability beats
            # economy, and the counter keeps it visible.
            reg.count("cascade_student_failover_total")
            with self._cascade_lock:
                self._n_failover += 1
            treply = self._leg(echo, relay, rung, self.teacher_model,
                               "cascade.teacher", ctx, tracer,
                               reason="failover")
            tobj = _json_row(treply)
            if tobj is not None and "error" not in tobj:
                self._served("teacher")
                return treply
            return treply   # both tiers refused: the freshest refusal
        t_d0 = time.monotonic()
        margin = softmax_margin(sobj["probs"])
        reg.observe("cascade_margin", margin)
        escalate = margin <= self.threshold
        if self.drift_alarm is not None:
            # Every margin-gated decision feeds the
            # rolling window (failovers are availability events, not
            # distribution evidence — they stay out).
            self.drift_alarm.observe(escalate)
        if tracer is not None:
            tracer.span(ctx, "cascade.decide",
                        _tracing.wall_from_monotonic(t_d0),
                        _tracing.wall_from_monotonic(time.monotonic()),
                        margin=round(margin, 6),
                        threshold=self.threshold, escalate=escalate)
        if escalate:
            reg.count("cascade_escalated_total")
            with self._cascade_lock:
                self._n_escalated += 1
            treply = self._leg(echo, relay, rung, self.teacher_model,
                               "cascade.teacher", ctx, tracer,
                               reason="escalation")
            tobj = _json_row(treply)
            if tobj is None or "error" in tobj:
                # Failed escalation: the student's row is a VALID
                # answer, just a low-confidence one — degrade, loudly.
                reg.count("cascade_teacher_fallback_total")
                with self._cascade_lock:
                    self._n_fallback += 1
                self._served("student")
                return sreply
            self._served("teacher")
            return treply
        self._served("student")
        return sreply

    def _served(self, tier: str) -> None:
        reg = self._registry
        with self._cascade_lock:
            if tier == "teacher":
                self._n_teacher += 1
            else:
                self._n_student += 1
            rate = (self._n_escalated / self._n_requests
                    if self._n_requests else 0.0)
        reg.count(f"cascade_served_{tier}_total")
        reg.gauge("cascade_escalation_rate", rate)

    # ---------------------------------------------------------------- obs
    def counters(self) -> dict:
        with self._cascade_lock:
            return {
                "requests": self._n_requests,
                "escalated": self._n_escalated,
                "served_student": self._n_student,
                "served_teacher": self._n_teacher,
                "student_failover": self._n_failover,
                "teacher_fallback": self._n_fallback,
                "escalation_rate": (self._n_escalated / self._n_requests
                                    if self._n_requests else 0.0),
            }

    def snapshot(self) -> dict:
        snap = super().snapshot()
        snap["cascade"] = dict(
            self.counters(), threshold=self.threshold,
            student_model=self.student_model,
            teacher_model=self.teacher_model,
            predicted_agreement=self.predicted_agreement,
            predicted_escalation_rate=self.predicted_escalation_rate,
            drift=(self.drift_alarm.snapshot()
                   if self.drift_alarm is not None else None))
        return snap

    def publish_telemetry(self, registry=None):
        reg = super().publish_telemetry(registry)
        c = self.counters()
        reg.gauge("cascade_threshold", self.threshold)
        reg.gauge("cascade_escalation_rate", c["escalation_rate"])
        if self.predicted_agreement is not None:
            reg.gauge("cascade_predicted_agreement",
                      float(self.predicted_agreement))
        return reg
