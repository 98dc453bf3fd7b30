"""The port's trace-driven load generation held to the JAX package.

``serve/loadgen.py``: ``build_schedule`` gives the same arrival times and
head/tier/rung tags bit for bit for every committed profile; profile
refusals, marks and ``phase_report`` are equal on the same inputs;
``TraceClients`` sends the same request lines (``::rung``, inline
``::req`` tags) as JAX's against the stand-in replica and answers every
arrival exactly once; ``run_trace_engine`` replays a profile into the
port's ``InferenceEngine`` on the CPU.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from pytorch_vit_paper_replication_tpu.serve import loadgen as jlg
from pytorch_vit_paper_replication_tpu_torch.serve import loadgen as tlg

REPO = Path(__file__).resolve().parent.parent
PROFILES = sorted((REPO / "profiles").glob("*.json"))
FAKE = REPO / "tests" / "data" / "fake_replica.py"


def test_four_committed_profiles():
    assert [p.name for p in PROFILES] == [
        "burst4x.json", "deploy_flywheel.json", "diurnal.json",
        "steady.json"]


@pytest.mark.parametrize("path", PROFILES, ids=lambda p: p.stem)
def test_build_schedule_identical_to_jax(path):
    tp, jp = tlg.LoadProfile.load(path), jlg.LoadProfile.load(path)
    assert tp.describe() == jp.describe()
    assert tp.marks() == jp.marks()
    ts, js = tlg.build_schedule(tp), jlg.build_schedule(jp)
    assert len(ts) == len(js) > 0
    t_port = np.array([a.t for a in ts])
    assert t_port.tobytes() == np.array([a.t for a in js]).tobytes()
    assert [(a.head, a.tier, a.rung) for a in ts] == \
        [(a.head, a.tier, a.rung) for a in js]
    for t in np.linspace(0.0, tp.duration_s, 97):
        assert tp.rate_at(float(t)) == jp.rate_at(float(t))


BAD_PROFILES = [
    {},
    {"duration_s": 5},
    {"duration_s": 5, "baseline_rps": 1, "segments": [{"t0": 3, "t1": 2}]},
    {"duration_s": 5, "baseline_rps": 1,
     "segments": [{"t0": 0, "t1": 2, "rate_mult": -1}]},
    {"duration_s": 5, "baseline_rps": 1,
     "segments": [{"t0": 0, "t1": 3}, {"t0": 2, "t1": 4}]},
    {"duration_s": 5, "baseline_rps": 1,
     "segments": [{"t0": 0, "t1": 1, "label": "carrier"}]},
    {"duration_s": 5, "baseline_rps": 1,
     "segments": [{"t0": 0, "t1": 1, "label": "a"},
                  {"t0": 2, "t1": 3, "label": "after_a"}]},
    {"duration_s": 5, "baseline_rps": 1, "diurnal": {"period_s": 0}},
    {"duration_s": 5, "baseline_rps": 1,
     "diurnal": {"period_s": 2, "amplitude": 1.0}},
    {"duration_s": 5, "baseline_rps": 1, "head_mix": {"logits": 1}},
    {"duration_s": 5, "baseline_rps": 1, "tier_mix": {"batch": 0}},
    {"duration_s": 5, "baseline_rps": 1, "rung_mix": {"x": 1}},
    {"duration_s": 5, "baseline_rps": 1, "rung_mix": {"0": 1}},
    {"duration_s": 5, "baseline_rps": 1, "rung_mix": {"2": float("inf")}},
]


@pytest.mark.parametrize("index", range(len(BAD_PROFILES)))
def test_profile_refusals_equal_jax(index):
    msgs = []
    for mod in (tlg, jlg):
        with pytest.raises(ValueError) as e:
            mod.LoadProfile.from_dict(BAD_PROFILES[index])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_profile_load_refuses_bad_json_like_jax(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{nope")
    msgs = []
    for mod in (tlg, jlg):
        with pytest.raises(ValueError) as e:
            mod.LoadProfile.load(bad)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_diurnal_profile_with_segments_identical_to_jax():
    raw = {"seed": 7, "duration_s": 6.0, "baseline_rps": 30.0,
           "segments": [{"t0": 1.0, "t1": 2.5, "rate_mult": 3.0,
                         "label": "spike"},
                        {"t0": 4.0, "t1": 6.0, "rate_mult": 0.0,
                         "label": "gap"}],
           "diurnal": {"period_s": 3.0, "amplitude": 0.5},
           "head_mix": {"probs": 2, "features": 1, "tokens": 1},
           "tier_mix": {"interactive": 3, "batch": 1},
           "rung_mix": {"1": 1, "2": 1, "16": 2}}
    ts = tlg.build_schedule(tlg.LoadProfile.from_dict(raw))
    js = jlg.build_schedule(jlg.LoadProfile.from_dict(raw))
    assert [(a.t, a.head, a.tier, a.rung) for a in ts] == \
        [(a.t, a.head, a.tier, a.rung) for a in js]
    assert not any(4.0 <= a.t for a in ts)


def test_marks_and_phase_report_equal_jax():
    specs = ["3=during", "8.5=post", "1=pre"]
    assert tlg.parse_marks(specs) == jlg.parse_marks(specs)
    for bad in (["nolabel"], ["3="]):
        with pytest.raises(ValueError):
            tlg.parse_marks(bad)
        with pytest.raises(ValueError):
            jlg.parse_marks(bad)
    rng = np.random.default_rng(3)
    samples = [(float(t), float(lat), bool(ok)) for t, lat, ok in zip(
        rng.uniform(0, 10, 400), rng.exponential(0.05, 400),
        rng.random(400) > 0.1)]
    marks = tlg.parse_marks(specs)
    for first in ("start", "carrier"):
        assert tlg.phase_report(samples, marks, first_label=first) == \
            jlg.phase_report(samples, marks, first_label=first)
    assert tlg.phase_report([], marks) == jlg.phase_report([], marks)
    ps = tlg.PhaseSamples()
    for s in samples[:5]:
        ps.add(*s)
    assert ps.samples == samples[:5]


def _fake(tmp_path, name="ckA"):
    proc = subprocess.Popen(
        [sys.executable, str(FAKE), "--ckpt", str(tmp_path / name)],
        stderr=subprocess.PIPE, text=True)
    line = proc.stderr.readline()
    port = int(line.split("127.0.0.1:")[1].split()[0])
    return proc, ("127.0.0.1", port)


SHORT = {"name": "short", "seed": 5, "duration_s": 1.5,
         "baseline_rps": 40.0,
         "segments": [{"t0": 0.5, "t1": 1.0, "rate_mult": 2.0,
                       "label": "burst"}],
         "head_mix": {"probs": 0.6, "features": 0.4},
         "tier_mix": {"interactive": 0.7, "batch": 0.3},
         "rung_mix": {"1": 0.5, "4": 0.5}}


def test_trace_clients_send_jax_lines_exactly_once(tmp_path):
    proc, addr = _fake(tmp_path)
    try:
        reports, answers = [], []
        for mod in (tlg, jlg):
            clients = mod.TraceClients(
                addr, [f"img{i}.jpg" for i in range(5)],
                mod.LoadProfile.from_dict(SHORT), clients_per_rung=2,
                reply_timeout_s=30.0, record_answers=True).start()
            clients.join(60.0)
            reports.append(clients.report())
            answers.append(sorted(clients.answers))
    finally:
        proc.kill()
        proc.wait()
    port, jax_ = reports
    n = len(tlg.build_schedule(tlg.LoadProfile.from_dict(SHORT)))
    for rep in reports:
        req = rep["requests"]
        assert req["sent"] == req["answered"] == rep["scheduled"] == n
        assert req["dropped"] == req["double_answered"] == req["errors"] == 0
    # The fake replica echoes the relayed head/tier tags: the same
    # answers mean the same request lines went out.
    assert answers[0] == answers[1] and len(answers[0]) == n
    assert set(port["phases"]) == set(jax_["phases"]) == {
        "carrier", "burst", "after_burst"}
    assert sum(p["count"] for p in port["phases"].values()) == n
    assert port["profile"] == jax_["profile"]


def test_trace_clients_count_a_dead_server_as_dropped(tmp_path):
    proc, addr = _fake(tmp_path)
    proc.kill()
    proc.wait()
    clients = tlg.TraceClients(addr, "x.jpg",
                               tlg.LoadProfile.from_dict(SHORT),
                               clients_per_rung=1,
                               reply_timeout_s=5.0).start()
    clients.join(30.0)
    c = clients.counts()
    assert c["connect_failures"] == 2 and c["answered"] == 0
    assert c["dropped"] == c["sent"] == len(clients.schedule)


def test_run_trace_engine_on_port_engine():
    import torch

    from pytorch_vit_paper_replication_tpu_torch import configs as tcfg
    from pytorch_vit_paper_replication_tpu_torch.models import ViT
    from pytorch_vit_paper_replication_tpu_torch.serve import InferenceEngine

    torch.manual_seed(0)
    model = ViT(tcfg.ViTConfig(image_size=32, patch_size=16, num_layers=1,
                               num_heads=2, embedding_dim=32, mlp_size=64,
                               num_classes=3, dtype="float32"))
    eng = InferenceEngine(model, device="cpu", image_size=32,
                          class_names=["a", "b", "c"], buckets=(1, 4),
                          warmup=False)
    profile = tlg.LoadProfile.from_dict(SHORT)
    try:
        t0 = time.perf_counter()
        out = tlg.run_trace_engine(eng, profile, timeout_s=30.0)
        assert time.perf_counter() - t0 < 60
    finally:
        eng.close()
    n = len(tlg.build_schedule(profile))
    assert out["scheduled"] == n
    assert out["completed"] + out["failed"] + \
        out["rejected_at_admission"] == n
    assert out["completed"] == n
    assert set(out["phases"]) == {"carrier", "burst", "after_burst"}
    assert set(out["groups"]) <= {"probs/interactive", "probs/batch",
                                  "features/interactive", "features/batch"}
    json.dumps(out)
