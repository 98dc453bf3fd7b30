"""The fleet front door: one address, N replicas, the same protocol.

Port of the JAX package's ``serve/fleet/router.py`` (the same replies
for the same line stream). :class:`FleetRouter` speaks exactly the serve CLI's line protocol —
one image path per line, ``path<TAB>label<TAB>prob`` back — so every
existing client points at the router instead of a replica and nothing
else changes. Per request it:

1. **admits** — fleet-level admission control: past ``max_inflight``
   (or with nothing routable) the reply is the same
   ``ERROR\\tQueueFullError: …retry after ~Ns`` shape a single
   replica's :class:`...batching.QueueFullError` produces, so client
   backpressure handling is one code path fleet-wide;
2. **routes** — the pluggable :mod:`.policy` picks a replica
   (least-loaded + bucket affinity by default; a connection declares
   its rung with ``::rung N``);
3. **relays** — over a pooled persistent connection, one line out, one
   line back;
4. **retries on replica death** — a connection error (the replica
   died or was killed mid-request) re-dispatches to a survivor, up to
   ``max_retries`` times, never to a replica already tried for this
   request. Requests are idempotent (pure inference), so a request
   whose reply was lost may EXECUTE twice on the fleet — but the
   client is ANSWERED exactly once, by construction: the handler
   writes one reply per request line, and a reply received ends the
   retry loop. Replica-side backpressure replies (``QueueFullError`` /
   ``DrainingError``) are retried the same way — a draining replica's
   refusals route to its survivors, which is what makes the rolling
   swap invisible to clients.

Router-side commands: ``::stats`` (fleet snapshot JSON — membership,
in-flight, policy), ``::metrics`` (the shared registry as Prometheus
text, blank-line framed like serve's), ``::rung N`` (this connection's
bucket-affinity hint), ``::model M`` (this connection's declared
model filter — the cascade steers student traffic to replicas whose
spec declares ``model=student`` and escalations to the teacher tier
through the same policy seam; HARD, unlike rung affinity — an
unmatched model answers explicit backpressure, never a silent
fallback to the wrong tier — and relayed as an inline ``model=`` tag
so the replica can prove which tier actually answered), and
``::head H`` / ``::tier T`` (this connection's default head and SLO
tier) plus the one-shot
``::req [head=H] [tier=T] [k=K] [model=M] <path>`` inline form.
``::search K <path>`` rides the same machinery: the router parses it,
then relays ``::req k=K …`` so the replica's shared index answers the
K nearest embedding rows — search traffic routes, retries, and
backpressures exactly like any other request. The router holds
head/tier as CLIENT-connection state and relays every non-default
request as the explicit ``::req`` form, so the pooled router→replica
connections (shared across client connections and across requests)
carry zero per-connection protocol state — multi-head, tiered, and
search traffic steer through the existing ``::rung`` affinity
machinery unchanged. Instruments: ``fleet_route_*`` counters/gauges plus the
``fleet_route_lat_s`` latency histogram — the fleet p99 a load run
reads.
"""

from __future__ import annotations

import json
import socket
import socketserver
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, Optional, Sequence, Tuple

from ..batching import (DEFAULT_HEAD, DEFAULT_TIER, TIERS,
                        parse_req_line, parse_search_line)
from ..engine import HEADS
from ...telemetry import tracing as _tracing
from ...telemetry.registry import TelemetryRegistry, get_registry
from .policy import LeastLoadedAffinity, RoutingPolicy
from .replica import ReplicaManager

# A pooled replica connection: the address it was dialed to rides
# along so a pool entry from before a replica restart (same rid, new
# port) is recognized as stale and redialed instead of reused.
_PooledConn = Tuple[Tuple[str, int], socket.socket, object]


def backpressure_reply(line: str, kind: str, detail: str,
                       retry_after_s: float) -> str:
    """The fleet-level refusal, in exactly the per-replica ERROR shape
    (serve/__main__._answer): clients keep ONE backpressure parser."""
    return (f"{line}\tERROR\t{kind}: {detail}; retry after "
            f"~{retry_after_s:.3f}s")


def is_backpressure(reply: str) -> bool:
    """A replica reply that means "not me, not now" — retryable on
    another replica without double-answer risk (the refused request
    never entered a device batch)."""
    if reply.startswith("{"):
        # The replica's ``::probs`` path answers errors as
        # ``{"error": ...}`` JSON (a full-row reply has no TSV echo
        # column to hang ERROR on); a refusal there is exactly as
        # retryable as the TSV shape.
        try:
            err = json.loads(reply).get("error", "")
        except ValueError:
            return False
        return str(err).startswith(("QueueFullError", "DrainingError",
                                    "ShutdownError"))
    if "\tERROR\t" not in reply:
        return False
    err = reply.split("\tERROR\t", 1)[1]
    return err.startswith(("QueueFullError", "DrainingError",
                           "ShutdownError"))


class FleetRouter:
    """See module docstring. ``manager`` supplies membership views;
    the router overlays its own live in-flight counts (health polls
    lag by an interval — in-flight must not)."""

    def __init__(self, manager: ReplicaManager, *,
                 host: str = "127.0.0.1", port: int = 0,
                 policy: Optional[RoutingPolicy] = None,
                 max_retries: int = 2,
                 max_inflight: int = 1024,
                 request_timeout_s: float = 60.0,
                 connect_timeout_s: float = 5.0,
                 registry: Optional[TelemetryRegistry] = None,
                 on_swap: Optional[Callable[[str], dict]] = None):
        self._manager = manager
        self._policy = policy if policy is not None \
            else LeastLoadedAffinity()
        self.max_retries = int(max_retries)
        self.max_inflight = int(max_inflight)
        self.request_timeout_s = float(request_timeout_s)
        self.connect_timeout_s = float(connect_timeout_s)
        self._registry = registry if registry is not None \
            else get_registry()
        # ``::swap <ckpt>`` hook: the fleet CLI wires the rollout here;
        # None (library default) answers the command with an error.
        self.on_swap = on_swap
        # Shadow tap: when set, every successfully answered
        # request is offered to ``tap(rid, relay_line, reply)`` AFTER
        # the client already has its reply — the deploy canary's
        # shadow mirror re-plays a sampled fraction against the canary
        # replica and compares, never touching the client path. The
        # tap MUST be cheap and non-raising (the mirror enqueues and
        # returns); a raising tap is swallowed, not propagated.
        self.tap: Optional[Callable[[str, str, str], None]] = None
        self._lock = threading.Lock()
        self._inflight: Dict[str, int] = {}
        self._inflight_total = 0
        self._pool: Dict[str, Deque[_PooledConn]] = {}
        self._ema_s: Optional[float] = None

        router = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                rung: Optional[int] = None
                head: str = DEFAULT_HEAD
                tier: str = DEFAULT_TIER
                model: Optional[str] = None
                for raw in self.rfile:
                    line = raw.decode("utf-8", "replace").strip()
                    if not line:
                        continue
                    # Tracing ingress: strip the upstream trace token
                    # (if any) BEFORE command parsing, so the grammar
                    # below never sees it; spans this hop records chain
                    # under the client's span.
                    hdr, line = _tracing.extract_wire_context(line)
                    ctx = _tracing.get_tracer().accept(hdr)
                    if line.startswith("::rung"):
                        rung, reply = router._set_rung(line)
                    elif line.startswith("::head"):
                        head, reply = router._set_tag(
                            line, "head", HEADS, head)
                    elif line.startswith("::tier"):
                        tier, reply = router._set_tag(
                            line, "tier", TIERS, tier)
                    elif line.startswith("::model"):
                        model, reply = router._set_model(line, model)
                    elif line.startswith("::req"):
                        # One-shot inline head/tier/k/model: parsed at
                        # the router so the echo key (and backpressure
                        # replies) use the bare path, then routed with
                        # the overrides.
                        reply = router._route_req(line, rung=rung,
                                                  head=head, tier=tier,
                                                  model=model, ctx=ctx)
                    elif line.startswith("::search"):
                        reply = router._route_search(line, rung=rung,
                                                     head=head,
                                                     tier=tier,
                                                     model=model,
                                                     ctx=ctx)
                    elif line.startswith("::probs"):
                        # The full-row JSON form is a REQUEST, not a
                        # router control command: it relays (and the
                        # cascade router speculates on it).
                        reply = router._route_probs(line, rung=rung,
                                                    model=model,
                                                    ctx=ctx)
                    elif line == "::stats":
                        reply = json.dumps(router.snapshot())
                    elif line == "::metrics":
                        reply = router.prometheus_metrics().rstrip(
                            "\n") + "\n"
                    elif line.startswith("::swap-status"):
                        reply = json.dumps(router.swap_status())
                    elif line.startswith("::swap"):
                        reply = router._handle_swap(line)
                    elif line.startswith("::"):
                        # Control commands are ROUTER-owned: relaying
                        # an unknown one to a replica would let any
                        # client ::drain a replica through the front
                        # door (quiesce is the rollout's privilege,
                        # exercised on the replica's own port).
                        reply = (f"{line}\tERROR\tValueError: unknown "
                                 f"router control command")
                    else:
                        reply = router.route(line, rung=rung,
                                             head=head, tier=tier,
                                             model=model, ctx=ctx)
                    self.wfile.write((reply + "\n").encode())
                    self.wfile.flush()

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.address: Tuple[str, int] = self._server.server_address[:2]
        self._thread: Optional[threading.Thread] = None
        self._last_swap: Optional[dict] = None

    # ---------------------------------------------------------- lifecycle
    @property
    def port(self) -> int:
        return self.address[1]

    def start(self) -> "FleetRouter":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._server.serve_forever, name="fleet-router",
                daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread = None
        with self._lock:
            pools = list(self._pool.values())
            self._pool.clear()
        for pool in pools:
            for _addr, sock, rfile in pool:
                _close_quietly(sock, rfile)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- routing
    def inflight(self, rid: Optional[str] = None) -> int:
        with self._lock:
            if rid is None:
                return self._inflight_total
            return self._inflight.get(rid, 0)

    def _retry_after_s(self) -> float:
        with self._lock:
            return self._retry_after_locked()

    def route(self, line: str, rung: Optional[int] = None,
              head: str = DEFAULT_HEAD, tier: str = DEFAULT_TIER,
              k: Optional[int] = None,
              model: Optional[str] = None, ctx=None) -> str:
        """Route one classifier/search request line (the TSV echo
        protocol); the admission/retry machinery itself lives in
        :meth:`_dispatch`.

        Non-default ``head``/``tier`` (and a search ``k``, and a
        declared ``model``) relay as the explicit
        ``::req head=H tier=T k=K model=M <path>`` form: the pooled
        replica connections are shared across clients and requests, so
        per-connection replica-side state can never be trusted — every
        relayed line must carry its own tags. Default traffic relays
        the bare line (byte-identical to the pre-multi-head protocol).
        ``line`` itself stays the client-facing echo key either way.

        ``model`` is the declared model filter (``::model M`` /
        inline ``model=M`` — the cascade's teacher/student steering):
        it HARD-narrows the policy's candidate set to replicas whose
        deployment spec declares that model (no advisory fallback —
        a student answering teacher-tagged traffic would silently
        break the cascade's bit-identity contract), and it IS relayed,
        so the replica's tag echo can prove which tier answered.
        """
        relay = line
        if head != DEFAULT_HEAD or tier != DEFAULT_TIER or \
                k is not None or model is not None:
            tags = []
            if head != DEFAULT_HEAD:
                tags.append(f"head={head}")
            if tier != DEFAULT_TIER:
                tags.append(f"tier={tier}")
            if k is not None:
                tags.append(f"k={int(k)}")
            if model is not None:
                tags.append(f"model={model}")
            relay = f"::req {' '.join(tags)} {line}"
        return self._dispatch(line, relay, rung=rung, model=model,
                              ctx=ctx)

    def _route_probs(self, line: str, rung: Optional[int] = None,
                     model: Optional[str] = None, ctx=None) -> str:
        """``::probs <path>`` through the front door: the full-row
        JSON form relays VERBATIM (the replica grammar is
        self-contained — there is no inline tag spelling), with a
        declared ``model`` narrowing the policy's candidate set only.
        Through the base router this is a plain full-row relay; the
        cascade router's speculation path rides the same machinery."""
        path = line[len("::probs"):].strip()
        if not path:
            return f"{line}\tERROR\tValueError: expected '::probs <path>'"
        return self._dispatch(line, line, rung=rung, model=model,
                              ctx=ctx)

    def _dispatch(self, line: str, relay: str, *,
                  rung: Optional[int] = None,
                  model: Optional[str] = None, ctx=None) -> str:
        """The admission + choose + relay + bounded-retry loop shared
        by every request form (``line`` is the client-facing echo key,
        ``relay`` the bytes the chosen replica sees). Always returns
        exactly one reply string — the never-double-answered contract
        lives here. With a sampled ``ctx`` this hop records
        ``router.request`` / ``router.admission`` / ``router.relay``
        spans and forwards the relay span's context on the wire, so
        replica-side spans chain under the relay."""
        reg = self._registry
        reg.count("fleet_route_requests_total")
        t0 = time.monotonic()
        tracer = _tracing.get_tracer() if ctx is not None else None
        with self._lock:
            if self._inflight_total >= self.max_inflight:
                reg.count("fleet_route_rejected_total")
                return backpressure_reply(
                    line, "QueueFullError",
                    f"fleet at capacity ({self._inflight_total} in "
                    f"flight)", self._retry_after_locked())
        tried: set = set()
        backpressured: Optional[str] = None
        for attempt in range(self.max_retries + 1):
            with self._lock:
                inflight = dict(self._inflight)
            views = self._manager.views(inflight)
            rid = self._policy.choose(views, rung=rung, model=model,
                                      exclude=frozenset(tried))
            if rid is None:
                break
            self._track(rid, +1)
            wire = relay
            rctx = None
            t_relay0 = time.monotonic()
            if tracer is not None:
                rctx = tracer.child(ctx)
                # Default traffic relays the bare line; a traced
                # request upgrades it to the tagless ``::req <path>``
                # form so the token has a command to ride on (the
                # replica's ingress strips it before parsing).
                if not wire.startswith("::"):
                    wire = f"::req {wire}"
                wire = _tracing.inject_wire_context(
                    wire, rctx.to_header())
            try:
                reply = self._roundtrip(rid, wire)
            except OSError:
                # The replica died under this request (or its address
                # went stale across a restart): bounded re-dispatch to
                # a survivor. The health loop notices the death on its
                # own clock; `tried` keeps THIS request off the corpse
                # immediately.
                tried.add(rid)
                reg.count("fleet_route_retries_total")
                continue
            finally:
                self._track(rid, -1)
            if is_backpressure(reply):
                # A full/draining replica refused before batching the
                # request — safe to offer it to a sibling.
                tried.add(rid)
                backpressured = reply
                reg.count("fleet_route_retries_total")
                continue
            t_end = time.monotonic()
            dt = t_end - t0
            reg.observe("fleet_route_lat_s", dt)
            with self._lock:
                self._ema_s = dt if self._ema_s is None \
                    else 0.8 * self._ema_s + 0.2 * dt
                reg.gauge("fleet_route_inflight", self._inflight_total)
            if tracer is not None:
                wall = _tracing.wall_from_monotonic
                tracer.span(ctx, "router.admission", wall(t0),
                            wall(t_relay0), attempts=attempt + 1,
                            rid=rid, model=model or "")
                tracer.record(rctx, "router.relay", wall(t_relay0),
                              wall(t_end), rid=rid)
                tracer.record(ctx, "router.request", wall(t0),
                              wall(t_end), path=line)
            tap = self.tap
            if tap is not None:
                try:
                    tap(rid, relay, reply)
                except Exception:  # noqa: BLE001 — a sick shadow
                    pass           # mirror must never cost a client
            return reply
        if backpressured is not None:
            # Every routable replica pushed back: propagate the last
            # replica's refusal (it carries an honest retry_after).
            reg.count("fleet_route_rejected_total")
            return backpressured
        reg.count("fleet_route_errors_total")
        if model is not None and not any(
                v.model == model for v in self._manager.views()):
            # The hard filter matched nothing: say WHICH contract
            # failed (a missing tier is a deployment bug, not load).
            return backpressure_reply(
                line, "NoReplicaAvailable",
                f"no replica declares model={model!r} (models are "
                f"deployment config — tag the spec, don't rely on "
                f"fallback)", self._retry_after_s())
        return backpressure_reply(
            line, "NoReplicaAvailable",
            f"no routable replica after {len(tried)} attempt(s)",
            self._retry_after_s())

    def _retry_after_locked(self) -> float:
        per_req = self._ema_s if self._ema_s is not None else 0.05
        return max(0.05, self._inflight_total * per_req)

    def _track(self, rid: str, delta: int) -> None:
        with self._lock:
            self._inflight[rid] = max(
                0, self._inflight.get(rid, 0) + delta)
            self._inflight_total = max(0, self._inflight_total + delta)

    # ------------------------------------------------------- replica conns
    def _roundtrip(self, rid: str, line: str) -> str:
        """One line to ``rid``, one line back, over a pooled
        connection. Raises OSError on any transport failure (the retry
        path's signal)."""
        addr = self._manager.address_of(rid)
        if addr is None:
            raise OSError(f"replica {rid} has no address")
        leased = self._lease(rid, addr)
        if leased is None:
            sock = socket.create_connection(
                addr, timeout=self.connect_timeout_s)
            sock.settimeout(self.request_timeout_s)
            rfile = sock.makefile("r", encoding="utf-8")
            leased = (addr, sock, rfile)
        addr, sock, rfile = leased
        try:
            sock.sendall((line + "\n").encode())
            reply = rfile.readline()
        except (OSError, ValueError) as e:
            _close_quietly(sock, rfile)
            raise OSError(str(e)) from e
        if not reply:
            _close_quietly(sock, rfile)
            raise OSError(f"replica {rid} closed mid-request")
        self._return(rid, leased)
        return reply.rstrip("\n")

    def _lease(self, rid: str, addr: Tuple[str, int]
               ) -> Optional[_PooledConn]:
        with self._lock:
            pool = self._pool.get(rid)
            while pool:
                entry = pool.popleft()
                if entry[0] == addr:
                    return entry
                # Pooled conn predates a restart: different port now.
                stale = entry
                _close_quietly(stale[1], stale[2])
            return None

    def _return(self, rid: str, entry: _PooledConn) -> None:
        with self._lock:
            self._pool.setdefault(rid, deque()).append(entry)

    def forget_replica(self, rid: str) -> None:
        """Drop a decommissioned replica's pooled connections and
        in-flight bookkeeping (autoscaler scale-down: the rid will never
        be chosen again — membership already lost it — but its pooled
        sockets would otherwise linger until router close)."""
        with self._lock:
            pool = self._pool.pop(rid, None)
            self._inflight.pop(rid, None)
        for entry in pool or ():
            _close_quietly(entry[1], entry[2])

    # ------------------------------------------------------------ commands
    def _set_rung(self, line: str) -> Tuple[Optional[int], str]:
        parts = line.split()
        if len(parts) == 2 and parts[1].isdigit():
            rung = int(parts[1])
            return rung, f"::rung\tok\t{rung}"
        return None, f"{line}\tERROR\tValueError: expected '::rung N'"

    def _set_model(self, line: str, current: Optional[str]
                   ) -> Tuple[Optional[str], str]:
        """``::model M`` — this connection's declared model filter
        (``::model -`` clears it). Model names are open vocabulary
        (deployment config invents them: "student"/"teacher" in a
        cascade fleet), so any non-empty token is accepted; a name no
        replica declares answers per-request backpressure — the filter
        is HARD, never a silent fallback."""
        parts = line.split()
        if len(parts) == 2 and parts[1]:
            value = None if parts[1] == "-" else parts[1]
            return value, f"::model\tok\t{value or '-'}"
        return current, (f"{line}\tERROR\tValueError: expected "
                         "'::model M' (M = a declared model name "
                         "like student/teacher, or '-' to clear)")

    @staticmethod
    def _set_tag(line: str, name: str, valid: Sequence[str],
                 current: str) -> Tuple[str, str]:
        """``::head H`` / ``::tier T`` connection-state commands: on a
        valid value returns (new_value, ack); on garbage keeps the
        current value and answers the serve CLI's ERROR shape."""
        parts = line.split()
        if len(parts) == 2 and parts[1] in valid:
            return parts[1], f"::{name}\tok\t{parts[1]}"
        return current, (f"{line}\tERROR\tValueError: expected "
                         f"'::{name} V' with V in {list(valid)}")

    def _route_req(self, line: str, rung: Optional[int],
                   head: str, tier: str,
                   model: Optional[str] = None, ctx=None) -> str:
        """A client-sent ``::req ...`` line: parse the inline tags so
        the echo key is the bare path, then route with the overrides
        (absent tags fall back to the connection's defaults). ``ctx``
        is the trace context the caller's ingress extracted — every
        wire-protocol reader accepts and forwards it."""
        try:
            req_head, req_tier, req_k, req_model, path = \
                parse_req_line(line)
        except ValueError as e:
            return f"{line}\tERROR\tValueError: {e}"
        return self.route(
            path, rung=rung,
            head=req_head if req_head is not None else head,
            tier=req_tier if req_tier is not None else tier,
            k=req_k,
            model=req_model if req_model is not None else model,
            ctx=ctx)

    def _route_search(self, line: str, rung: Optional[int],
                      head: str, tier: str,
                      model: Optional[str] = None, ctx=None) -> str:
        """``::search K <path>`` from a client: parse K (the shared
        :func:`...batching.parse_search_line` grammar), relay as the
        ``::req k=K`` form (the ONE grammar the pooled replica
        connections speak) with the connection's tier riding along —
        search routes/retries/backpressures like any other request."""
        try:
            k, path = parse_search_line(line)
        except ValueError as e:
            return f"{line}\tERROR\tValueError: {e}"
        return self.route(path, rung=rung, head=head, tier=tier, k=k,
                          model=model, ctx=ctx)

    def _handle_swap(self, line: str) -> str:
        parts = line.split(maxsplit=1)
        if len(parts) != 2 or not parts[1].strip():
            return json.dumps(
                {"error": "expected '::swap <checkpoint-path>'"})
        if self.on_swap is None:
            return json.dumps(
                {"error": "no swap hook configured on this router "
                          "(library embedders drive rollout.py "
                          "directly)"})
        try:
            started = self.on_swap(parts[1].strip())
        except Exception as e:  # noqa: BLE001 — an operator typo'd
            # checkpoint path answers THAT command, not the server.
            return json.dumps({"error": f"{type(e).__name__}: {e}"})
        return json.dumps(started)

    def swap_status(self) -> dict:
        with self._lock:
            return dict(self._last_swap) if self._last_swap \
                else {"swap": None}

    def note_swap(self, report: dict) -> None:
        """The rollout (or its CLI wrapper) records its latest report
        here so ``::swap-status`` can answer it."""
        with self._lock:
            self._last_swap = dict(report)

    # ---------------------------------------------------------------- obs
    def publish_telemetry(self, registry=None) -> TelemetryRegistry:
        """Sync live router+membership state into the registry — ONE
        publish path shared by ``::metrics`` and the fleet shipper's
        ``pre_ship``, mirroring ``InferenceEngine.publish_telemetry``."""
        reg = registry if registry is not None else self._registry
        with self._lock:
            total = self._inflight_total
            ema = self._ema_s
        reg.gauge("fleet_route_inflight", total)
        # The client-observed latency EMA: responsive in BOTH
        # directions (a rolling-window p99 remembers a burst long
        # after it ends) — the autoscaler's latency signal.
        reg.gauge("fleet_route_lat_ema_s",
                  round(ema, 6) if ema is not None else 0.0)
        self._manager.publish_telemetry()
        return reg

    def prometheus_metrics(self) -> str:
        return self.publish_telemetry().to_prometheus()

    def snapshot(self) -> dict:
        """Fleet-membership + routing state, JSON-serializable (the
        router's ``::stats``)."""
        with self._lock:
            inflight = dict(self._inflight)
            total = self._inflight_total
        views = self._manager.views(inflight)
        counters = {
            k: v for k, v in
            self._registry.snapshot()["counters"].items()
            if k.startswith(("fleet_", "replica_"))}
        return {
            "policy": self._policy.name,
            "inflight_total": total,
            "max_inflight": self.max_inflight,
            "replicas": {
                v.rid: {
                    "address": (f"{v.address[0]}:{v.address[1]}"
                                if v.address else None),
                    "up": v.up, "draining": v.draining,
                    "inflight": v.inflight,
                    "queue_depth": v.queue_depth,
                    "warm_rungs": list(v.warm_rungs),
                    "restarts": v.restarts,
                    "checkpoint_fingerprint": v.fingerprint,
                    "model": v.model,
                } for v in views},
            "counters": counters,
        }


def _close_quietly(sock, rfile) -> None:
    for obj in (rfile, sock):
        try:
            obj.close()
        except OSError:
            pass
