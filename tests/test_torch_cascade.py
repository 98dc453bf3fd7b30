"""The port's two-tier cascade held to the JAX package's on the CPU.

``serve/cascade.py``: ``softmax_margin`` equal to JAX's on the same rows;
``load_cascade_config`` refuses what JAX's refuses, with the same message,
and keeps its precedence; ``EscalationDriftAlarm`` fires on the same
observations of the same decision sequences; ``CascadeRouter`` over a
mixed fleet of stand-in replicas (``tests/data/fake_replica.py
--probs-by-path``: each image its own margin) answers what JAX's answers,
with the same counters, at threshold 0 (the student), infinity (the
teacher, bit for bit), the median student margin and a margin exactly at
the threshold (it escalates); the default-slice scope, failover and
fallback match too.
"""

import importlib.util
import json
import os
import socket
import sys
from pathlib import Path

import numpy as np
import pytest

from pytorch_vit_paper_replication_tpu.serve import cascade as jcas
from pytorch_vit_paper_replication_tpu.serve import fleet as jfleet
from pytorch_vit_paper_replication_tpu.telemetry.registry import (
    TelemetryRegistry as JRegistry)
from pytorch_vit_paper_replication_tpu_torch.serve import cascade as tcas
from pytorch_vit_paper_replication_tpu_torch.serve import fleet as tfleet
from pytorch_vit_paper_replication_tpu_torch.telemetry.registry import (
    TelemetryRegistry)

REPO = Path(__file__).resolve().parent.parent
FAKE = REPO / "tests" / "data" / "fake_replica.py"

_spec = importlib.util.spec_from_file_location("fake_replica", FAKE)
fake_replica = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fake_replica)

PACKAGES = ((tcas, tfleet, TelemetryRegistry), (jcas, jfleet, JRegistry))
PATHS = [f"img{i:02d}.jpg" for i in range(12)]


def test_softmax_margin_equal_jax():
    rng = np.random.default_rng(0)
    rows = [rng.dirichlet(np.ones(c)) for c in (1, 2, 3, 10, 1000)
            for _ in range(20)]
    rows += [np.array([0.5, 0.5]), np.array([1.0]), [0.2, 0.7, 0.1],
             np.float32([0.3, 0.3, 0.4])]
    for row in rows:
        assert tcas.softmax_margin(row) == jcas.softmax_margin(row)


CONFIGS = [None, "not json", "{}", '{"threshold": -0.5}',
           '{"threshold": "nan"}', '{"applied_threshold": null}',
           json.dumps({"threshold": 0.2, "applied_threshold": 0.15,
                       "predicted_agreement": 0.99,
                       "predicted_escalation_rate": 0.08}),
           json.dumps({"threshold": 0.3, "predicted_agreement": None}),
           '{"threshold": Infinity}']


@pytest.mark.parametrize("index", range(len(CONFIGS)))
def test_load_cascade_config_equal_jax(tmp_path, index):
    cfg = tmp_path / "cascade.json"
    if CONFIGS[index] is not None:
        cfg.write_text(CONFIGS[index])

    def run(mod):
        try:
            return mod.load_cascade_config(cfg)
        except SystemExit as e:
            return f"exit: {e}"
    assert run(tcas) == run(jcas)


def test_drift_alarm_sequences_equal_jax():
    rng = np.random.default_rng(4)
    for trial in range(12):
        expected = float(rng.uniform(0, 1))
        kw = dict(band=float(rng.uniform(0.02, 0.3)),
                  window=int(rng.integers(4, 64)),
                  min_samples=int(rng.integers(1, 40)), refit_cmd="refit")
        alarms = [mod.EscalationDriftAlarm(expected, registry=reg(), **kw)
                  for mod, _, reg in PACKAGES]
        p = rng.uniform(0, 1, 4)
        seq = [bool(rng.random() < p[i // 100]) for i in range(400)]
        fired = [[a.observe(x) for x in seq] for a in alarms]
        assert fired[0] == fired[1]
        assert alarms[0].snapshot() == alarms[1].snapshot()
        assert alarms[0]._registry.snapshot()["gauges"] == \
            alarms[1]._registry.snapshot()["gauges"]
        assert alarms[0]._registry.snapshot()["counters"] == \
            alarms[1]._registry.snapshot()["counters"]
    for bad in ((1.5, {}), (0.5, {"band": 0.0}), (-0.1, {})):
        msgs = []
        for mod, _, reg in PACKAGES:
            with pytest.raises(ValueError) as e:
                mod.EscalationDriftAlarm(bad[0], registry=reg(), **bad[1])
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def _cascade_fleet(pkg, threshold, *,
                   models=("student", "teacher"), **router_kw):
    cas, fleet, reg_cls = pkg
    registry = reg_cls()
    # The stand-in's rows are a hash of its checkpoint string and the
    # path: fixed names keep every margin (and the absence of exact ties
    # among the student's 12 rows) the same on every run.
    specs = [fleet.ReplicaSpec(rid=f"r{i}", checkpoint=m, model=m)
             for i, m in enumerate(models)]
    manager = fleet.ReplicaManager(
        specs,
        command_factory=lambda spec: [sys.executable, str(FAKE), "--ckpt",
                                      spec.checkpoint, "--probs-by-path"],
        env_factory=lambda spec: dict(os.environ),
        health_interval_s=0.05, stale_after_s=2.0, registry=registry)
    router = cas.CascadeRouter(manager, registry=registry,
                               request_timeout_s=30.0, threshold=threshold,
                               **router_kw)
    return manager, router


def _ask(address, lines, timeout=30.0):
    with socket.create_connection(address, timeout=timeout) as sock:
        sock.settimeout(timeout)
        rfile = sock.makefile("r", encoding="utf-8")
        replies = []
        for line in lines:
            sock.sendall((line + "\n").encode())
            replies.append(rfile.readline().rstrip("\n"))
        rfile.close()
        return replies


def _run_both(threshold, lines, models=("student", "teacher"),
              **router_kw):
    """Replies, router counters and per-replica completed counts of the
    port's and JAX's cascade over the same fleet shape and lines."""
    out = []
    for pkg in PACKAGES:
        manager, router = _cascade_fleet(pkg, threshold,
                                         models=models, **router_kw)
        with manager, router:
            manager.start()
            assert manager.wait_ready(20.0)
            router.start()
            replies = _ask(router.address, lines)
            completed = [json.loads(manager.request(
                f"r{i}", "::stats"))["counters"]["completed"]
                for i in range(len(models))]
            direct = {i: [manager.request(f"r{i}", f"::probs {p}")
                          for p in PATHS] for i in range(len(models))}
            out.append((replies, router.counters(), completed, direct,
                        router.snapshot()["cascade"]))
    assert out[0][:3] == out[1][:3]
    assert out[0][4] == out[1][4]
    return out[0]


def _margins():
    return {p: tcas.softmax_margin(fake_replica.probs_for_path("student", p))
            for p in PATHS}


@pytest.mark.parametrize("which", ["zero", "inf", "median", "exactly_at"])
def test_cascade_routing_equal_jax(which):
    margins = _margins()
    ranked = sorted(margins.values())
    thr = {"zero": 0.0, "inf": float("inf"),
           "median": (ranked[5] + ranked[6]) / 2.0,
           "exactly_at": margins[PATHS[3]]}[which]
    lines = [f"::probs {p}" for p in PATHS] + [PATHS[0], PATHS[3]]
    replies, counters, completed, direct, snap = _run_both(thr, lines)
    low = [p for p in PATHS if margins[p] <= thr]
    for p, reply in zip(PATHS, replies):
        assert reply == direct[1 if p in low else 0][PATHS.index(p)]
    assert counters["requests"] == len(lines)
    assert counters["escalated"] == counters["served_teacher"] == \
        len(low) + sum(p in low for p in (PATHS[0], PATHS[3]))
    assert completed[0] == len(lines)
    assert completed[1] == counters["escalated"]
    row = json.loads(direct[1 if PATHS[0] in low else 0][0])
    assert replies[-2] == f"{PATHS[0]}\tfake\t{row['prob']:.4f}"
    if which == "zero":
        assert low == [] and completed[1] == 0
    elif which == "inf":
        assert len(low) == len(PATHS)
    elif which == "exactly_at":
        assert PATHS[3] in low
    else:
        assert 0 < len(low) < len(PATHS)
    assert snap["threshold"] == thr


def test_cascade_scope_failover_and_fallback_equal_jax():
    lines = ["::model student", "img.jpg", "::model -",
             "::req head=features img2.jpg", "::req tier=batch img3.jpg",
             "::search 3 img4.jpg"]
    replies, counters, _, _, _ = _run_both(float("inf"), lines)
    assert replies[1].split("\t")[1] == \
        "student:probs:interactive:student"
    assert counters["requests"] == 0
    replies, counters, _, _, _ = _run_both(
        0.0, ["::probs img.jpg"], models=("teacher",))
    assert counters["student_failover"] == counters["served_teacher"] == 1
    replies, counters, _, _, _ = _run_both(
        float("inf"), ["::probs img.jpg"], models=("student",))
    assert counters["teacher_fallback"] == counters["served_student"] == 1


def test_cascade_drift_alarm_on_live_router_equal_jax():
    _, counters, _, _, snap = _run_both(
        float("inf"), [f"::probs {p}" for p in PATHS[:6]],
        predicted_escalation_rate=0.05, drift_band=0.10, drift_window=8,
        drift_min_samples=4, refit_cmd="refit")
    assert snap["drift"]["active"] is True and snap["drift"]["fired"] == 1
    assert counters["escalation_rate"] == 1.0


def test_cascade_router_refusals_and_config_boot_equal_jax(tmp_path):
    cfg = tmp_path / "cascade.json"
    cfg.write_text(json.dumps({"threshold": 0.3,
                               "predicted_agreement": 0.97,
                               "predicted_escalation_rate": 0.2}))
    for bad in (dict(threshold=-0.5), dict(threshold=float("nan")),
                dict(threshold=0.1, student_model="m", teacher_model="m")):
        msgs = []
        for cas, fleet, _ in PACKAGES:
            manager = fleet.ReplicaManager(
                [fleet.ReplicaSpec(rid="r0", checkpoint="ck",
                                   model="student")],
                command_factory=lambda spec: ["true"])
            with pytest.raises(ValueError) as e:
                cas.CascadeRouter(manager, **bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    snaps = []
    for cas, fleet, reg in PACKAGES:
        manager = fleet.ReplicaManager(
            [fleet.ReplicaSpec(rid="r0", checkpoint="ck", model="student")],
            command_factory=lambda spec: ["true"], registry=reg())
        with cas.CascadeRouter.from_config(manager, cfg,
                                           registry=reg()) as router:
            snaps.append((router.threshold, router.predicted_agreement,
                          router.refit_cmd, router.snapshot()["cascade"]))
    assert snaps[0] == snaps[1]
