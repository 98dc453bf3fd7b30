"""Push telemetry off-host: the fleet shipper + /metrics HTTP pull.

A copy of the JAX package's ``telemetry/shipper.py`` (stdlib only): the
frame bytes are the same for the same dict, so either package's
aggregator reads the other's workers.

N workers (train runs, serve replicas, the fleet router, batch jobs)
each own a process-local :class:`..registry.TelemetryRegistry`; a fleet
is N disconnected JSONL files until something moves the snapshots. Two
transports, both built on the registry's one snapshot shape:

* :class:`TelemetryShipper` — **push**: a daemon thread that every
  ``interval_s`` sends a length-prefixed JSON frame (snapshot + recent
  ring events + identity) over TCP to an aggregator (the repo's
  ``tools/fleet_agg.py``, or :class:`FrameSink`). The hot loop never
  touches the socket: frames are built and sent entirely on the
  shipper thread, sends carry a timeout, a dead aggregator costs a
  **dropped frame and a backoff**, never a blocked step
  (``shipper_frames_total`` / ``shipper_dropped_total`` /
  ``shipper_reconnects_total`` count it).

* :func:`start_metrics_http` — **pull**: the stdlib-HTTP ``/metrics``
  endpoint (``train --metrics-port``) rendering the registry through
  the ONE Prometheus renderer (:func:`..registry.render_prometheus`) —
  a train run is scrapeable exactly like serve's ``::metrics``.

The frame protocol (4-byte big-endian length + UTF-8 JSON) is owned
here — :func:`send_frame` / :func:`read_frame`, so the two sides can
never disagree about framing. :class:`FrameSink` is the minimal
in-process receiver the tests and ``chip_smoke.py`` use as a stand-in
aggregator.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from .registry import TelemetryRegistry, get_registry

PROTOCOL_VERSION = 1
# One frame is a snapshot + a ring tail — far under this; the bound
# exists so a corrupt/hostile length prefix can't balloon the receiver.
MAX_FRAME_BYTES = 8 * 1024 * 1024
_LEN = struct.Struct(">I")


def default_worker_id(role: str) -> str:
    return f"{role}-{socket.gethostname()}-{os.getpid()}"


def parse_address(spec: str) -> Tuple[str, int]:
    """``"host:port"`` -> (host, port) with a usable error message."""
    host, sep, port_s = spec.rpartition(":")
    try:
        port = int(port_s)
    except ValueError:
        port = -1
    if not sep or not host or not (0 < port < 65536):
        raise ValueError(
            f"expected HOST:PORT (e.g. 127.0.0.1:9000), got {spec!r}")
    return host, port


def send_frame(sock: socket.socket, obj: Dict[str, Any]) -> None:
    payload = json.dumps(obj, default=str).encode()
    if len(payload) > MAX_FRAME_BYTES:
        raise ValueError(f"frame of {len(payload)} bytes exceeds "
                         f"MAX_FRAME_BYTES={MAX_FRAME_BYTES}")
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _read_exact(rfile, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = rfile.read(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def read_frame(rfile) -> Optional[Dict[str, Any]]:
    """One frame from a file-like (``socket.makefile('rb')``); None on
    clean EOF; ValueError on a torn/oversized/non-JSON frame."""
    header = _read_exact(rfile, _LEN.size)
    if header is None:
        return None
    (length,) = _LEN.unpack(header)
    if length > MAX_FRAME_BYTES:
        raise ValueError(f"frame length {length} exceeds "
                         f"MAX_FRAME_BYTES={MAX_FRAME_BYTES}")
    payload = _read_exact(rfile, length)
    if payload is None:
        raise ValueError("connection closed mid-frame")
    return json.loads(payload.decode("utf-8", "replace"))


class TelemetryShipper:
    """Ship registry snapshots to an aggregator (see module docstring).

    Args:
      address: ``(host, port)`` or ``"host:port"``.
      worker_id: stable identity in the fleet view; default
        ``{role}-{hostname}-{pid}``.
      role: ``"train"`` / ``"serve"`` / ... — the aggregator groups on
        it.
      interval_s: ship cadence.
      pre_ship: optional callback run (fenced) before each frame —
        serve uses it to sync :class:`..serve.stats.ServeStats` into
        the registry so frames carry live serving state.
      events_per_frame: how many ring events ride each frame (the
        aggregator dedups on the events' own timestamps).
      connect_timeout_s / send_timeout_s: socket budgets — the
        worst-case cost of a sick network is one timeout on the
        shipper thread, never on the step.
      backoff_s: (initial, max) reconnect backoff after a failure.
    """

    def __init__(self, address: str | Tuple[str, int], *,
                 worker_id: Optional[str] = None,
                 role: str = "worker",
                 registry: Optional[TelemetryRegistry] = None,
                 interval_s: float = 2.0,
                 pre_ship: Optional[Callable[[], None]] = None,
                 events_per_frame: int = 64,
                 connect_timeout_s: float = 2.0,
                 send_timeout_s: float = 2.0,
                 backoff_s: Tuple[float, float] = (0.5, 8.0)):
        self.address = (parse_address(address)
                        if isinstance(address, str) else
                        (address[0], int(address[1])))
        self.role = role
        self.worker_id = worker_id or default_worker_id(role)
        self.registry = registry if registry is not None else get_registry()
        self.interval_s = max(0.05, float(interval_s))
        self.pre_ship = pre_ship
        self.events_per_frame = int(events_per_frame)
        self.connect_timeout_s = float(connect_timeout_s)
        self.send_timeout_s = float(send_timeout_s)
        self.backoff_s = (float(backoff_s[0]), float(backoff_s[1]))
        self._sock: Optional[socket.socket] = None
        self._seq = 0
        self._next_attempt = 0.0           # monotonic deadline
        self._cur_backoff = self.backoff_s[0]
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "TelemetryShipper":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="telemetry-shipper", daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        """Stop the thread; one final best-effort frame so a clean
        shutdown's last state reaches the fleet view."""
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(self.send_timeout_s + self.interval_s + 2.0)
        self.ship_now()
        self._close_sock()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------ shipping
    def _run(self) -> None:
        # First frame immediately: a worker appears in the fleet view
        # at startup, not one interval later.
        self.ship_now()
        while not self._stop.wait(self.interval_s):
            self.ship_now()

    def ship_now(self) -> bool:
        """Build and send one frame; False when dropped. Public so
        tests and shutdown paths can force a frame synchronously (on
        the CALLING thread — the hot loop should never call this)."""
        if self.pre_ship is not None:
            try:
                self.pre_ship()
            except Exception:  # noqa: BLE001 — a sick publisher must
                pass           # not kill the shipping cadence
        frame = {
            "v": PROTOCOL_VERSION,
            "worker_id": self.worker_id,
            "role": self.role,
            "pid": os.getpid(),
            "seq": self._seq,
            "time": time.time(),
            "snapshot": self.registry.snapshot(),
            "events": self.registry.last_events(self.events_per_frame),
        }
        sock = self._ensure_connection()
        if sock is None:
            self.registry.count("shipper_dropped_total")
            return False
        try:
            send_frame(sock, frame)
        except (OSError, ValueError):
            self._on_failure()
            self.registry.count("shipper_dropped_total")
            return False
        self._seq += 1
        self.registry.count("shipper_frames_total")
        return True

    def _ensure_connection(self) -> Optional[socket.socket]:
        if self._sock is not None:
            return self._sock
        if time.monotonic() < self._next_attempt:
            return None                      # inside the backoff window
        try:
            sock = socket.create_connection(
                self.address, timeout=self.connect_timeout_s)
            sock.settimeout(self.send_timeout_s)
        except OSError:
            self._on_failure()
            return None
        self._sock = sock
        self._cur_backoff = self.backoff_s[0]
        self.registry.count("shipper_reconnects_total")
        return sock

    def _on_failure(self) -> None:
        self._close_sock()
        self._next_attempt = time.monotonic() + self._cur_backoff
        self._cur_backoff = min(self._cur_backoff * 2.0,
                                self.backoff_s[1])

    def _close_sock(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None


class FrameSink:
    """Minimal in-process frame receiver — the stand-in aggregator of
    the tests and ``chip_smoke.py``. Collects decoded frames; :meth:`stop`
    simulates aggregator death (port released), a fresh FrameSink on
    the same port simulates its restart."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        import socketserver

        sink = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                with sink._lock:
                    sink._conns.add(self.connection)
                try:
                    while True:
                        try:
                            frame = read_frame(self.rfile)
                        except (ValueError, OSError):
                            return
                        if frame is None:
                            return
                        with sink._lock:
                            sink.frames.append(frame)
                finally:
                    with sink._lock:
                        sink._conns.discard(self.connection)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self.frames: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._conns: set = set()
        self._server = Server((host, port), Handler)
        self.address = self._server.server_address[:2]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="frame-sink",
            daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self.address[1]

    def frame_count(self) -> int:
        with self._lock:
            return len(self.frames)

    def stop(self) -> None:
        """Die like a killed aggregator: stop accepting AND sever the
        established connections (shutdown() alone leaves live handler
        threads draining shippers — not what death means)."""
        self._server.shutdown()
        self._server.server_close()
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


def start_metrics_http(registry: Optional[TelemetryRegistry] = None,
                       port: int = 0, host: str = "127.0.0.1", *,
                       render_text: Optional[Callable[[], str]] = None,
                       render_json: Optional[Callable[[], Any]] = None,
                       json_path: str = "/snapshot",
                       thread_name: str = "metrics-http"):
    """Serve Prometheus text on ``/metrics`` (and JSON on
    ``json_path``) via a daemon-threaded stdlib HTTP server; returns
    the server (``server.server_address`` carries the bound port; call
    ``server.shutdown(); server.server_close()`` to stop — the train
    CLI's ExitStack does). Defaults render the given/global registry (ONE
    renderer — the same ``to_prometheus`` behind serve's
    ``::metrics``); the fleet aggregator passes its own render
    callbacks instead of re-implementing the server."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    if render_text is None or render_json is None:
        reg = registry if registry is not None else get_registry()
        if render_text is None:
            render_text = reg.to_prometheus
        if render_json is None:
            render_json = reg.snapshot

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path in ("/metrics", "/"):
                body = render_text().encode()
                ctype = "text/plain; version=0.0.4"
            elif self.path == json_path:
                body = (json.dumps(render_json(), default=str)
                        + "\n").encode()
                ctype = "application/json"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # scrapers hit this every few
            pass                       # seconds; stderr stays clean

    server = ThreadingHTTPServer((host, port), Handler)
    server.daemon_threads = True
    thread = threading.Thread(target=server.serve_forever,
                              name=thread_name, daemon=True)
    thread.start()
    return server
