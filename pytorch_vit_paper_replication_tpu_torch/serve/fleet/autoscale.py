"""Telemetry-driven autoscaling: a fleet that sizes itself.

Port of the JAX package's ``serve/fleet/autoscale.py`` (the same
decisions for the same signal sequence). The control loop rides signals that ALREADY exist — nothing new is
instrumented on the hot path:

* **queue pressure** — the router's live in-flight counts plus each
  replica's last-polled ``queue_depth`` (the ``::stats`` field the
  health loop has always collected), normalized per up-replica;
* **latency** — the router's client-observed EMA
  (``fleet_route_lat_ema_s``, published by
  :meth:`..router.FleetRouter.publish_telemetry`) — responsive in both
  directions, unlike a rolling-window p99 that remembers a burst long
  after it ended;
* **warm-rung coverage** — the fraction of up replicas whose
  ``warm_rungs`` report covers the expected ladder: scale-DOWN is
  refused while coverage < 1 (shedding a warm replica while another is
  still warming trades a warm replica for a cold one).

Reads go through :func:`read_gauge` / :func:`read_counter` /
:func:`read_p99`, whose literal names are instruments the registry
declares (held by the tests), so signal-name drift fails a test, not
the control loop.

**Decider vs actuator.** :class:`AutoscaleDecider` is a pure state
machine — (signals, now) in, ``+N``/``-N``/``0`` out — with the three
guards that keep a burst from thrashing the fleet:

* **hysteresis** — the scale-up threshold is strictly above the
  scale-down threshold, so there is a dead band where the fleet holds;
* **consecutive-tick debounce** — a breach (or an all-clear) must hold
  for ``breach_ticks`` (``clear_ticks``) consecutive observations
  before it acts; one weird poll is not a trend;
* **cooldown** — after any action the decider holds for
  ``cooldown_s``: a scale-up must be given time to land (spawn + warm)
  before the still-degraded signals can demand another.

:class:`Autoscaler` is the actuator thread on a live
:class:`..replica.ReplicaManager` + :class:`..router.FleetRouter`:

* **scale-up** rides the warmup-manifest path: the new replica boots
  through the checkpoint's ``warmup.json``, is held DRAINING until its
  warm-rung report covers the expected ladder, and only then admitted
  — it never takes traffic it would answer with a cold rung;
* **scale-down** drains through the health-gated membership path:
  quiesce (the router stops selecting it), wait out the router's
  in-flight count, ``::drain`` the micro-batcher (stragglers get
  retryable ``DrainingError`` backpressure the router re-dispatches),
  THEN stop and remove — in-flight requests are never reset.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional, Tuple

from ...telemetry.registry import TelemetryRegistry, get_registry
from .replica import ReplicaManager, ReplicaSpec
from .router import FleetRouter


# ------------------------------------------------------ signal readers
# The ONE way autoscaling code reads a registry snapshot: literal names
# passed here are instruments telemetry.registry.INSTRUMENTS declares, so
# a gauge the fleet stopped publishing fails a test, not the control
# loop.
def read_gauge(snap: dict, name: str, default: float = 0.0) -> float:
    v = snap.get("gauges", {}).get(name)
    return float(v) if isinstance(v, (int, float)) \
        and not isinstance(v, bool) else default


def read_counter(snap: dict, name: str, default: float = 0.0) -> float:
    v = snap.get("counters", {}).get(name)
    return float(v) if isinstance(v, (int, float)) else default


def read_p99(snap: dict, name: str) -> Optional[float]:
    h = snap.get("histograms", {}).get(name)
    return h.get("p99") if isinstance(h, dict) else None


@dataclasses.dataclass(frozen=True)
class AutoscaleSignals:
    """One observation of the fleet (plain data — the decider must
    stay trivially testable on synthetic streams)."""

    replicas_up: int
    queue_depth_total: int       # router in-flight + replica queues
    lat_ema_s: Optional[float]   # client-observed EMA at the router
    warm_coverage: float         # up replicas warm for the ladder, 0..1
    # Fleet MEMBERSHIP (up + down + draining). Bound checks key on
    # this, not replicas_up: a dead-but-member replica is the
    # manager's supervised restart in flight — refilling it here too
    # would leave the fleet one over the floor once the restart lands.
    # None (synthetic streams) = assume membership == up.
    replicas_total: Optional[int] = None

    @property
    def membership(self) -> int:
        return (self.replicas_total if self.replicas_total is not None
                else self.replicas_up)

    @property
    def load_per_replica(self) -> float:
        return self.queue_depth_total / max(1, self.replicas_up)


@dataclasses.dataclass
class AutoscaleConfig:
    """Decider thresholds + actuator budgets. The defaults encode the
    hysteresis contract: ``up_load_per_replica`` must stay strictly
    above ``down_load_per_replica`` (validated) so there is always a
    hold band between the two actions."""

    min_replicas: int = 2
    max_replicas: int = 4
    # Queue pressure thresholds, per up-replica (router in-flight +
    # polled queue depths). Up fires on EITHER queue or latency.
    up_load_per_replica: float = 4.0
    down_load_per_replica: float = 1.0
    # Latency thresholds (seconds, client-observed EMA). None = queue
    # pressure alone decides on that side.
    up_lat_s: Optional[float] = None
    down_lat_s: Optional[float] = None
    # Debounce: consecutive ticks a breach / an all-clear must hold.
    breach_ticks: int = 2
    clear_ticks: int = 4
    # Hold after ANY action (seconds): a scale-up must land (spawn +
    # warm) before the still-degraded signals may demand another.
    cooldown_s: float = 8.0
    # Replicas added / removed per action.
    up_step: int = 1
    down_step: int = 1
    # Actuator budgets.
    interval_s: float = 1.0
    warm_timeout_s: float = 240.0
    drain_timeout_s: float = 15.0

    def validate(self) -> "AutoscaleConfig":
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if self.down_load_per_replica >= self.up_load_per_replica:
            raise ValueError(
                "hysteresis requires down_load_per_replica < "
                f"up_load_per_replica (got {self.down_load_per_replica}"
                f" >= {self.up_load_per_replica})")
        if self.up_lat_s is not None and self.down_lat_s is not None \
                and self.down_lat_s >= self.up_lat_s:
            raise ValueError("hysteresis requires down_lat_s < up_lat_s")
        if self.breach_ticks < 1 or self.clear_ticks < 1:
            raise ValueError("breach_ticks/clear_ticks must be >= 1")
        if self.up_step < 1 or self.down_step < 1:
            raise ValueError("up_step/down_step must be >= 1")
        return self


@dataclasses.dataclass(frozen=True)
class Decision:
    """One decider verdict: ``delta`` replicas (0 = hold), why."""

    delta: int
    reason: str


class AutoscaleDecider:
    """The pure hysteresis + debounce + cooldown state machine (see
    module docstring). Feed it one :class:`AutoscaleSignals` per tick
    via :meth:`observe`; it returns a :class:`Decision`. No threads,
    no clocks of its own (``now`` is an argument) — unit-testable on
    synthetic gauge streams in microseconds."""

    def __init__(self, config: AutoscaleConfig):
        self.config = config.validate()
        self._breach_run = 0
        self._clear_run = 0
        self._cooldown_until = 0.0

    def _breaching(self, s: AutoscaleSignals) -> bool:
        cfg = self.config
        if s.load_per_replica > cfg.up_load_per_replica:
            return True
        return (cfg.up_lat_s is not None and s.lat_ema_s is not None
                and s.lat_ema_s > cfg.up_lat_s)

    def _clear(self, s: AutoscaleSignals) -> bool:
        cfg = self.config
        if s.load_per_replica >= cfg.down_load_per_replica:
            return False
        return (cfg.down_lat_s is None or s.lat_ema_s is None
                or s.lat_ema_s < cfg.down_lat_s)

    def observe(self, s: AutoscaleSignals, now: float) -> Decision:
        cfg = self.config
        # Bound enforcement outranks debounce/cooldown: a fleet below
        # its floor must be refilled on the next tick, not after a
        # cooldown that exists to damp OSCILLATION, which this is not.
        # Keyed on MEMBERSHIP: a dead member the manager is still
        # supervising is a restart in flight, not a missing replica.
        if s.membership < cfg.min_replicas:
            self._breach_run = self._clear_run = 0
            return Decision(cfg.min_replicas - s.membership,
                            "below min_replicas floor")
        breach, clear = self._breaching(s), self._clear(s)
        self._breach_run = self._breach_run + 1 if breach else 0
        self._clear_run = self._clear_run + 1 if clear else 0
        if now < self._cooldown_until:
            return Decision(0, "cooldown")
        if breach and self._breach_run >= cfg.breach_ticks:
            # Membership-bounded: replicas still warming toward
            # admission count against the ceiling.
            room = cfg.max_replicas - s.membership
            if room <= 0:
                return Decision(0, "breach at max_replicas ceiling")
            delta = min(cfg.up_step, room)
            self._cooldown_until = now + cfg.cooldown_s
            self._breach_run = 0
            return Decision(delta,
                            f"load {s.load_per_replica:.2f}/replica or "
                            f"lat {s.lat_ema_s} over the up threshold "
                            f"for {cfg.breach_ticks} ticks")
        if clear and self._clear_run >= cfg.clear_ticks:
            room = s.replicas_up - cfg.min_replicas
            if room <= 0:
                return Decision(0, "clear at min_replicas floor")
            if s.warm_coverage < 1.0:
                # Never shed warm capacity while some replica is still
                # compiling its ladder — coverage recovers first.
                return Decision(0, "hold: warm coverage "
                                   f"{s.warm_coverage:.2f} < 1")
            delta = min(cfg.down_step, room)
            self._cooldown_until = now + cfg.cooldown_s
            self._clear_run = 0
            return Decision(-delta,
                            f"load {s.load_per_replica:.2f}/replica "
                            f"under the down threshold for "
                            f"{cfg.clear_ticks} ticks")
        return Decision(0, "hold")


class Autoscaler:
    """The actuator loop (see module docstring).

    ``spec_factory(index) -> ReplicaSpec`` builds the spec for a
    scaled-up replica (rid uniqueness is the factory's job; the
    default clones an existing replica's checkpoint — so a fleet that
    rolled onto a new checkpoint scales up on the NEW one — and wraps
    device ordinals round-robin). ``signals_fn`` overrides signal
    gathering (tests drive synthetic streams through the REAL
    actuation path).
    """

    def __init__(self, manager: ReplicaManager, router: FleetRouter,
                 config: Optional[AutoscaleConfig] = None, *,
                 spec_factory: Optional[
                     Callable[[int], ReplicaSpec]] = None,
                 signals_fn: Optional[
                     Callable[[], AutoscaleSignals]] = None,
                 registry: Optional[TelemetryRegistry] = None):
        self.manager = manager
        self.router = router
        self.config = (config if config is not None
                       else AutoscaleConfig()).validate()
        self.decider = AutoscaleDecider(self.config)
        self._spec_factory = spec_factory or self._default_spec
        self._signals_fn = signals_fn
        self._registry = registry if registry is not None \
            else get_registry()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._next_index = len(manager.replica_ids())
        self._events: List[dict] = []
        self._t0 = time.monotonic()

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "Autoscaler":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="fleet-autoscaler", daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            # A tick can legitimately block for a drain (the warm
            # wait checks _stop, a drain does not) — join for the
            # real worst case, and never drop the reference on a
            # thread that is still actuating against closing objects
            # (a later start() would run two control loops).
            t.join(self.config.interval_s
                   + self.config.drain_timeout_s + 10.0)
            if not t.is_alive():
                self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------ signals
    def signals(self) -> AutoscaleSignals:
        if self._signals_fn is not None:
            return self._signals_fn()
        views = self.manager.views()
        up = [v for v in views if v.up]
        queue_total = self.router.inflight() + sum(
            v.queue_depth for v in up)
        # Sync the router's live gauges (the latency EMA especially)
        # into the registry before reading — the shipper does the same
        # pre-frame; without it the gauge is last-scrape-old.
        self.router.publish_telemetry()
        snap = self._registry.snapshot()
        lat = read_gauge(snap, "fleet_route_lat_ema_s", 0.0) or None
        expected = self.manager.expected_rungs
        if expected is None or not up:
            coverage = 1.0
        else:
            need = set(expected)
            coverage = sum(1 for v in up
                           if need <= set(v.warm_rungs)) / len(up)
        return AutoscaleSignals(
            replicas_up=len(up), queue_depth_total=int(queue_total),
            lat_ema_s=lat, warm_coverage=coverage,
            replicas_total=len(views))

    # ----------------------------------------------------------- the loop
    def _run(self) -> None:
        while not self._stop.wait(self.config.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — one sick tick must not
                pass           # kill the control loop

    def tick(self) -> Decision:
        """One observe→decide→act round (public: tests drive it
        deterministically; the loop thread calls it on the interval)."""
        s = self.signals()
        reg = self._registry
        reg.gauge("autoscale_signal_load", round(s.load_per_replica, 4))
        reg.gauge("autoscale_signal_lat_s",
                  round(s.lat_ema_s, 6) if s.lat_ema_s else 0.0)
        reg.gauge("autoscale_warm_coverage", round(s.warm_coverage, 4))
        decision = self.decider.observe(s, time.monotonic())
        reg.count("autoscale_decisions_total")
        reg.gauge("autoscale_replicas_target",
                  s.replicas_up + decision.delta)
        if decision.delta > 0:
            self._scale_up(decision)
        elif decision.delta < 0:
            self._scale_down(decision)
        return decision

    # ------------------------------------------------------------ actions
    def _default_spec(self, index: int) -> ReplicaSpec:
        """Clone an existing replica's spec shape: its CURRENT
        checkpoint (a rolled fleet scales up on the new model) and its
        extra args, with device ordinals wrapped round-robin over the
        ordinals the fleet already covers."""
        rids = self.manager.replica_ids()
        if not rids:
            raise RuntimeError("cannot derive a replica spec from an "
                               "empty fleet")
        template_rid = rids[0]
        ordinals = sorted({d for r in rids
                           for d in self.manager.devices_of(r)})
        devices = [ordinals[index % len(ordinals)]] if ordinals else [0]
        return ReplicaSpec(
            rid=f"r{index}",
            checkpoint=self.manager.checkpoint_of(template_rid),
            devices=devices,
            extra_args=list(self.manager.extra_args_of(template_rid)))

    def _scale_up(self, decision: Decision) -> None:
        """Spawn every new replica CONCURRENTLY (a burst is short;
        serial spinups would pay the warm time N times over), then
        gate each behind its warm-ladder report before admission."""
        reg = self._registry
        specs: List[ReplicaSpec] = []
        t0 = time.monotonic()
        for _ in range(decision.delta):
            with self._lock:
                index = self._next_index
                self._next_index += 1
            spec = self._spec_factory(index)
            self.manager.add_replica(spec, draining=True)
            specs.append(spec)
        # The warm gate: each replica is admitted the moment ITS
        # ladder is warm (through the warmup manifest). Gates are
        # polled together: a ready replica must not
        # be held un-routable behind a slower (or wedged) sibling.
        pending = list(specs)
        deadline = t0 + self.config.warm_timeout_s
        while pending and not self._stop.is_set():
            for spec in list(pending):
                if self.manager.wait_healthy(
                        spec.rid, 0.0,
                        require_rungs=self.manager.expected_rungs):
                    pending.remove(spec)
                    spinup_s = time.monotonic() - t0
                    self.manager.readmit(spec.rid)
                    reg.count("autoscale_up_total")
                    reg.observe("autoscale_spinup_s", spinup_s)
                    self._note("up", spec.rid, decision.reason,
                               spinup_s=round(spinup_s, 3))
            if not pending or time.monotonic() >= deadline:
                break
            time.sleep(0.1)
        for spec in pending:
            # A replica that can't warm inside the budget (or was
            # caught by shutdown) must not linger half-born: remove
            # it and record the abort — the next breach tick will
            # try again.
            spinup_s = time.monotonic() - t0
            self.manager.stop_replica(spec.rid)
            self.manager.remove_replica(spec.rid)
            self.router.forget_replica(spec.rid)
            reg.count("autoscale_aborts_total")
            self._note("up_aborted", spec.rid, decision.reason,
                       spinup_s=round(spinup_s, 3))

    @staticmethod
    def _rid_key(rid: str) -> Tuple[int, str]:
        """Numeric-aware rid order: r10 sheds after r9, not after r1."""
        digits = "".join(c for c in rid if c.isdigit())
        return (int(digits) if digits else -1, rid)

    def _pick_victims(self, n: int) -> List[str]:
        """Shed the most recently added replicas first (LIFO): the
        original floor fleet keeps its identity, and timelines read
        as a clean 2→4→2."""
        up = sorted((v.rid for v in self.manager.views()
                     if v.up and not v.draining), key=self._rid_key)
        return up[-n:] if n < len(up) else up[1:]

    def _scale_down(self, decision: Decision) -> None:
        reg = self._registry
        for rid in self._pick_victims(-decision.delta):
            t0 = time.monotonic()
            self.decommission(rid)
            drain_s = time.monotonic() - t0
            reg.count("autoscale_down_total")
            reg.observe("autoscale_drain_s", drain_s)
            self._note("down", rid, decision.reason,
                       drain_s=round(drain_s, 3))

    def decommission(self, rid: str) -> None:
        """Drain a replica out of the fleet without resetting anyone:
        quiesce (router stops selecting it) → wait out the router's
        in-flight count → ``::drain`` the micro-batcher (stragglers
        get retryable backpressure the router re-dispatches to peers)
        → stop → remove from membership → drop pooled connections."""
        cfg = self.config
        self.manager.quiesce(rid)
        deadline = time.monotonic() + cfg.drain_timeout_s
        while time.monotonic() < deadline \
                and self.router.inflight(rid) > 0:
            time.sleep(0.02)
        self.manager.drain_replica(rid, cfg.drain_timeout_s)
        self.manager.stop_replica(rid)
        self.manager.remove_replica(rid)
        self.router.forget_replica(rid)

    # ------------------------------------------------------------- record
    def _note(self, action: str, rid: str, reason: str,
              **fields) -> None:
        event = {"t": round(time.monotonic() - self._t0, 3),
                 "action": action, "rid": rid, "reason": reason,
                 **fields}
        with self._lock:
            self._events.append(event)
        self._registry.event(f"autoscale_{action}", rid=rid,
                             reason=reason, **fields)

    def events(self) -> List[dict]:
        """The action log (what run artifacts commit as the scaling
        timeline's causes)."""
        with self._lock:
            return list(self._events)
