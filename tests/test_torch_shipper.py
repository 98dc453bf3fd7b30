"""The port's telemetry sinks held to the JAX package on the same inputs.

Frames (``telemetry/shipper.py``): the bytes ``send_frame`` writes for a
dict equal JAX's, and each side's ``read_frame`` reads the other's; a
shipper pointed at a closed port drops and counts its frame; a
``FrameSink`` collects the frames a shipper sends. The ``/metrics`` HTTP
endpoint answers the registry's one Prometheus rendering. Chrome traces
(``telemetry/chrome_trace.py``): the committed telemetry fixture and a
set of request spans give byte-equal JSON in both packages, and the
validator refuses the same bad traces with the same message.
"""

import io
import json
import socket
import time
import urllib.request
from pathlib import Path

import pytest

from pytorch_vit_paper_replication_tpu.telemetry import (
    chrome_trace as jct)
from pytorch_vit_paper_replication_tpu.telemetry import registry as jreg
from pytorch_vit_paper_replication_tpu.telemetry import shipper as jship
from pytorch_vit_paper_replication_tpu_torch.telemetry import (
    chrome_trace as tct)
from pytorch_vit_paper_replication_tpu_torch.telemetry import (
    registry as treg)
from pytorch_vit_paper_replication_tpu_torch.telemetry import (
    shipper as tship)
from pytorch_vit_paper_replication_tpu_torch.telemetry.registry import (
    TelemetryRegistry)

MINI_JSONL = Path(__file__).parent / "data" / "telemetry_mini.jsonl"

FRAMES = [
    {"v": 1, "worker_id": "serve-h-1", "role": "serve", "pid": 1, "seq": 0,
     "time": 1754200000.25, "snapshot": {"counters": {"a_total": 3},
                                         "gauges": {"g": 0.5, "s": "x"},
                                         "histograms": {}},
     "events": [{"event": "e", "time": 1.0, "n": [1, 2]}]},
    {"unicode": "pizza é中", "nested": {"deep": [None, True, 1.5e-9]}},
    {},
]


def _frame_bytes(send_frame, obj) -> bytes:
    a, b = socket.socketpair()
    try:
        send_frame(a, obj)
        a.shutdown(socket.SHUT_WR)
        out = b""
        while True:
            chunk = b.recv(65536)
            if not chunk:
                return out
            out += chunk
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("index", range(len(FRAMES)))
def test_frame_bytes_equal_and_cross_read(index):
    obj = FRAMES[index]
    port_bytes = _frame_bytes(tship.send_frame, obj)
    assert port_bytes == _frame_bytes(jship.send_frame, obj)
    assert jship.read_frame(io.BytesIO(port_bytes)) == obj
    assert tship.read_frame(io.BytesIO(port_bytes)) == obj
    assert tship.read_frame(io.BytesIO(b"")) is None
    assert tship.PROTOCOL_VERSION == jship.PROTOCOL_VERSION
    assert tship.MAX_FRAME_BYTES == jship.MAX_FRAME_BYTES


def test_read_frame_refusals_equal_jax():
    torn = _frame_bytes(tship.send_frame, FRAMES[0])[:-3]
    huge = (tship.MAX_FRAME_BYTES + 1).to_bytes(4, "big")
    for raw in (torn, huge, b"\x00\x00\x00\x02{x"):
        errs = []
        for mod in (tship, jship):
            with pytest.raises(ValueError) as e:
                mod.read_frame(io.BytesIO(raw))
            errs.append(str(e.value))
        assert errs[0] == errs[1]


@pytest.mark.parametrize("spec", ["127.0.0.1:9300", "host:1", "[::1]:80",
                                  "nohost", ":9", "h:0", "h:65536", "h:x"])
def test_parse_address_equal_jax(spec):
    def run(mod):
        try:
            return mod.parse_address(spec)
        except ValueError as e:
            return str(e)
    assert run(tship) == run(jship)
    assert tship.default_worker_id("serve").rsplit("-", 1)[0] == \
        jship.default_worker_id("serve").rsplit("-", 1)[0]


def _closed_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_shipper_to_dead_aggregator_drops_and_counts():
    reg = TelemetryRegistry()
    shipper = tship.TelemetryShipper(
        ("127.0.0.1", _closed_port()), role="train", registry=reg,
        connect_timeout_s=0.5, send_timeout_s=0.5, backoff_s=(60.0, 60.0))
    t0 = time.monotonic()
    assert shipper.ship_now() is False
    assert time.monotonic() - t0 < shipper.connect_timeout_s + 5.0
    # Inside the backoff window the next frame drops without a dial.
    assert shipper.ship_now() is False
    counters = reg.snapshot()["counters"]
    assert counters["shipper_dropped_total"] == 2
    assert "shipper_frames_total" not in counters
    assert "shipper_reconnects_total" not in counters
    shipper.close()
    assert reg.snapshot()["counters"]["shipper_dropped_total"] == 3


def test_shipper_frames_reach_sink_with_jax_frame_keys():
    reg = TelemetryRegistry()
    reg.count("tel_steps_total", 4)
    reg.gauge("serve_queue_depth", 2)
    published = []
    with tship.FrameSink() as sink:
        shipper = tship.TelemetryShipper(
            sink.address, worker_id="w0", role="serve", registry=reg,
            pre_ship=lambda: published.append(1))
        assert shipper.ship_now() and shipper.ship_now()
        shipper.close()       # one final frame
        deadline = time.monotonic() + 10.0
        while sink.frame_count() < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        frames = list(sink.frames)
    assert len(frames) == 3 and len(published) == 3
    assert [f["seq"] for f in frames] == [0, 1, 2]
    assert all(f["role"] == "serve" and f["worker_id"] == "w0"
               for f in frames)
    # The JAX shipper's frame for the same registry has the same keys
    # and the same snapshot shape.
    jr = jreg.TelemetryRegistry()
    jr.count("tel_steps_total", 4)
    jr.gauge("serve_queue_depth", 2)
    with jship.FrameSink() as jsink:
        js = jship.TelemetryShipper(jsink.address, worker_id="w0",
                                    role="serve", registry=jr)
        assert js.ship_now()
        js._close_sock()
        deadline = time.monotonic() + 10.0
        while jsink.frame_count() < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        jframe = jsink.frames[0]
    assert set(frames[0]) == set(jframe)
    assert frames[0]["snapshot"]["counters"]["tel_steps_total"] == 4
    assert set(frames[0]["snapshot"]) == set(jframe["snapshot"])
    assert reg.snapshot()["counters"]["shipper_frames_total"] == 3
    assert reg.snapshot()["counters"]["shipper_reconnects_total"] == 1


def test_metrics_http_serves_the_registry_rendering():
    reg = TelemetryRegistry()
    reg.count("fleet_route_requests_total", 5)
    reg.observe("fleet_route_lat_s", 0.25)
    srv = tship.start_metrics_http(reg, port=0)
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            body = r.read().decode()
        with urllib.request.urlopen(base + "/snapshot", timeout=10) as r:
            snap = json.loads(r.read())
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope", timeout=10)
    finally:
        srv.shutdown()
        srv.server_close()
    assert body == reg.to_prometheus()
    assert "# HELP vit_fleet_route_requests_total Client request lines" \
        in body
    assert snap["counters"]["fleet_route_requests_total"] == 5


@pytest.mark.parametrize("prefix", ["shipper_", "fleet_", "replica_",
                                    "autoscale_", "cascade_", "trace_"])
def test_sink_and_fleet_instruments_equal_jax(prefix):
    port = {k: v for k, v in treg.INSTRUMENTS.items() if k.startswith(prefix)}
    jax_ = {k: v for k, v in jreg.INSTRUMENTS.items() if k.startswith(prefix)}
    assert port and port == jax_
    assert {k: treg.HELP_TEXT[k] for k in port} == \
        {k: jreg.HELP_TEXT[k] for k in jax_}


def _rows():
    return [json.loads(line) for line in MINI_JSONL.read_text().splitlines()
            if line.strip()]


SPANS = [
    {"trace_id": "a" * 32, "span_id": "1" * 16, "parent_id": None,
     "name": "router.request", "role": "router", "pid": 10,
     "t0": 1754200000.5, "t1": 1754200000.75, "args": {"path": "x.jpg"}},
    {"trace_id": "a" * 32, "span_id": "2" * 16, "parent_id": "1" * 16,
     "name": "serve.request", "role": "replica", "pid": 11,
     "t0": 1754200000.55, "t1": 1754200000.7, "args": {}},
    {"trace_id": "b" * 32, "span_id": "3" * 16, "parent_id": None,
     "name": "client.request", "role": "client", "pid": 12,
     "t0": 1754200000.1, "t1": 1754200001.0, "args": {"ok": True}},
    "not-a-span",
]


@pytest.mark.parametrize("form", ["to_chrome_trace", "merged_spans",
                                  "merged_with_rows"])
def test_chrome_trace_json_byte_equal_jax(form):
    if form == "to_chrome_trace":
        got = [m.to_chrome_trace(_rows(), pid=3, process_name="w")
               for m in (tct, jct)]
    elif form == "merged_spans":
        got = [m.merged_chrome_trace(SPANS) for m in (tct, jct)]
    else:
        got = [m.merged_chrome_trace(SPANS, process_rows={"train": _rows()})
               for m in (tct, jct)]
    assert json.dumps(got[0]) == json.dumps(got[1])
    assert tct.validate_chrome_trace(got[0]) == \
        jct.validate_chrome_trace(got[1]) > 0


def test_write_chrome_trace_file_equal_jax(tmp_path):
    tct.write_chrome_trace(_rows(), tmp_path / "t.json")
    jct.write_chrome_trace(_rows(), tmp_path / "j.json")
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    assert tct.role_pids(["router", "replica", "router"]) == \
        jct.role_pids(["router", "replica", "router"])


BAD_TRACES = [
    {"foo": []},
    {"traceEvents": {}},
    {"traceEvents": [{"name": "x", "ph": "X", "tid": 1, "ts": 0, "dur": 1}]},
    {"traceEvents": [{"name": "a", "ph": "i", "pid": 1, "tid": 1, "ts": 5},
                     {"name": "b", "ph": "i", "pid": 1, "tid": 1, "ts": 1}]},
    {"traceEvents": [{"name": "a", "ph": "X", "pid": 1, "tid": 1, "ts": 0}]},
    {"traceEvents": [{"name": "a", "ph": "i", "pid": 1, "tid": 1,
                      "ts": -1}, 3]},
]


@pytest.mark.parametrize("index", range(len(BAD_TRACES)))
def test_validate_chrome_trace_refuses_what_jax_refuses(index):
    msgs = []
    for mod in (tct, jct):
        with pytest.raises(ValueError) as e:
            mod.validate_chrome_trace(BAD_TRACES[index])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
