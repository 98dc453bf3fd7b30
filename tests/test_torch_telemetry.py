"""The port's step telemetry (``telemetry/``) against the JAX package's.

The FLOP count of every preset, the MFU arithmetic, the profile-window
parser, the JSONL rows of :class:`StepTelemetry` for one step sequence
under a patched clock (the same rows, key for key and value for value,
but the wall-clock ``time`` column), and the step at which the anomaly
auto-arm fires for a seeded series of step walls. Then the port alone:
the peak table, a :class:`Watchdog` in a subprocess that fires on a
stalled loop, and a :class:`ProfileController` window on the CPU that
writes a ``torch.profiler`` trace.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_vit_paper_replication_tpu.configs import PRESETS as JPRESETS
from pytorch_vit_paper_replication_tpu.telemetry import flops as jflops
from pytorch_vit_paper_replication_tpu.telemetry import profiling as jprof
from pytorch_vit_paper_replication_tpu.telemetry import spans as jspans
from pytorch_vit_paper_replication_tpu.telemetry.registry import (
    TelemetryRegistry as JRegistry)
from pytorch_vit_paper_replication_tpu_torch.configs import PRESETS
from pytorch_vit_paper_replication_tpu_torch.telemetry import (
    ROW_KEYS, ProfileController, StepTelemetry, TelemetryRegistry, flops,
    parse_profile_steps, peaks, profiling, sample_device_memory)

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_flops_per_image_equals_jax(preset):
    for kw in ({}, {"image_size": 448, "num_classes": 10},
               {"pool": "gap"}):
        got = flops.train_step_flops_per_image(PRESETS[preset](**kw))
        want = jflops.train_step_flops_per_image(JPRESETS[preset](**kw))
        assert got == want


def test_b16_flops_and_mfu_arithmetic():
    f = flops.train_step_flops_per_image(PRESETS["ViT-B/16"]())
    assert abs(f / 1e9 - 105.4) < 0.1   # 3 x 35.1 GFLOP forward
    for ips in (1.0, 460.0, 1234.5):
        assert flops.analytic_mfu(ips, f, 989.0) == jflops.analytic_mfu(
            ips, f, 989.0)
    assert abs(flops.analytic_mfu(460.0, f, 989.0) - 0.049) < 1e-3


def test_peak_table_by_card_name():
    assert peaks("NVIDIA H100 80GB HBM3").bf16_flops == 989e12
    assert peaks("NVIDIA H100 PCIe").bf16_flops == 756e12
    assert peaks("NVIDIA H200").hbm_bytes == 4.8e12
    assert flops.bf16_peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    for unknown in ("cpu", "NVIDIA A100-SXM4-80GB", ""):
        assert peaks(unknown) is None
        assert flops.bf16_peak_tflops(unknown) is None
    assert not hasattr(flops, "V5E_PEAK_TFLOPS")


@pytest.mark.parametrize("spec", ["3:7", "1:1", "0:2", "5:4", "x", "1:2:3"])
def test_parse_profile_steps_equals_jax(spec):
    try:
        want = jprof.parse_profile_steps(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_profile_steps(spec)
        assert str(got.value) == str(e)
    else:
        assert parse_profile_steps(spec) == want


class _Clock:
    """A deterministic perf_counter: each read advances 10 ms."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.01
        return self.t


def _drive(tel, clock):
    """One seeded step sequence: 7 steps over two epochs, a checkpoint and
    an eval span each epoch."""
    rng = np.random.default_rng(1)
    step = 0
    for epoch, n in ((1, 4), (2, 3)):
        for _ in range(n):
            blocked = tel.should_block()
            tel.step_begin(step + 1)
            step += 1
            tel.step(data_wait_s=float(rng.uniform(0, 0.01)),
                     exec_s=float(rng.uniform(0.05, 0.1)), images=32,
                     step=step, epoch=epoch, blocked=blocked)
        tel.span("checkpoint", 0.5)
        tel.span("eval", 0.25)
        tel.epoch_end(epoch=epoch, step=step)
    tel.close()


@pytest.mark.parametrize("every", [1, 3])
def test_step_rows_equal_jax(tmp_path, monkeypatch, every):
    rows = {}
    # The port's trainer runs on one card and samples device memory on
    # every barrier (nothing on the CPU); JAX's takes both as arguments.
    jax_only = dict(n_chips=1, sample_memory=False)
    for name, cls, reg, extra in (
            ("port", StepTelemetry, TelemetryRegistry(), {}),
            ("jax", jspans.StepTelemetry, JRegistry(), jax_only)):
        clock = _Clock()
        monkeypatch.setattr(time, "perf_counter", clock)
        tel = cls(tmp_path / f"{name}.jsonl", registry=reg,
                  sample_every=every, flops_per_image=1e11,
                  peak_tflops=197.0, **extra)
        _drive(tel, clock)
        rows[name] = [json.loads(x) for x in
                      (tmp_path / f"{name}.jsonl").read_text().splitlines()]
        monkeypatch.undo()
    assert len(rows["port"]) == len(rows["jax"]) > 8
    for t, j in zip(rows["port"], rows["jax"]):
        t.pop("time"), j.pop("time")
        assert t == j
    keys = set().union(*rows["port"])
    assert keys - {"step", "epoch"} <= set(ROW_KEYS) | {
        "tel_data_wait_s", "tel_step_exec_s", "tel_step_s",
        "tel_images_per_sec", "tel_mfu", "tel_data_wait_frac",
        "tel_goodput_pct"}
    assert {"tel_mfu", "tel_step_amortized_s", "tel_goodput_pct"} <= keys


def test_no_peak_leaves_mfu_out(tmp_path):
    tel = StepTelemetry(tmp_path / "t.jsonl", registry=TelemetryRegistry(),
                        sample_every=1, flops_per_image=1e11)
    _drive(tel, None)
    rows = [json.loads(x) for x in
            (tmp_path / "t.jsonl").read_text().splitlines()]
    assert rows and not any("tel_mfu" in r for r in rows)
    assert "tel_mfu" not in tel.registry.snapshot()["gauges"]


def test_auto_arm_fires_on_the_same_step_as_jax(tmp_path, monkeypatch):
    """A seeded series of barrier-amortized step walls: a flat baseline,
    then a 40% regression. Both controllers arm the anomaly window at the
    same step, with the same baseline and regression."""
    rng = np.random.default_rng(7)
    walls = np.concatenate([0.1 + 0.002 * rng.standard_normal(60),
                            0.14 + 0.002 * rng.standard_normal(60)])
    # The port's arming knobs are module constants; JAX's are arguments.
    for const, v in (("AUTO_WINDOW", 16), ("WARMUP_SAMPLES", 3),
                     ("CHECK_EVERY", 4), ("SIGNAL_STEPS", 5)):
        monkeypatch.setattr(profiling, const, v)
    jax_only = dict(auto_window=16, warmup_steps=3, check_every=4,
                    signal_steps=5)
    armed = {}
    for name, cls, reg, extra in (
            ("port", ProfileController, TelemetryRegistry(), {}),
            ("jax", jprof.ProfileController, JRegistry(), jax_only)):
        ctrl = cls(tmp_path / name, registry=reg, auto=True, auto_pct=25.0,
                   **extra)
        for i, w in enumerate(walls):
            ctrl.on_step_end(i + 1, float(w))
            if ctrl._window is not None:
                break
        events = [{k: v for k, v in e.items() if k not in ("ts", "time")}
                  for e in reg.last_events()
                  if e["event"] in ("profiler_armed", "profiler_anomaly")]
        armed[name] = (i + 1, ctrl._window, events)
    assert armed["port"] == armed["jax"]
    step, window, _ = armed["port"]
    assert 60 < step < 120 and window == (step + 1, step + 5, "anomaly")


def test_watchdog_fires_on_a_stalled_loop(tmp_path):
    """A loop that beats twice, then stalls: the watchdog thread writes a
    postmortem with every thread's stack, memory and the last events, and
    the process exits cleanly once it resumes."""
    pm = tmp_path / "pm.txt"
    script = (
        "import time\n"
        "from pytorch_vit_paper_replication_tpu_torch.telemetry import "
        "Watchdog, get_registry\n"
        f"wd = Watchdog(0.3, postmortem_path={str(pm)!r})\n"
        "get_registry().event('step', step=1)\n"
        "wd.start(); wd.beat(); time.sleep(0.1); wd.beat()\n"
        "def stalled_loop():\n"
        "    time.sleep(2.5)\n"
        "stalled_loop()\n"
        "wd.beat(); wd.stop()\n"
        "print(get_registry().snapshot()['counters'])\n")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=120, cwd=REPO,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    text = pm.read_text()
    assert text.count("==== watchdog postmortem reason=stall") == 1
    for section in ("---- all-thread stacks ----", "stalled_loop",
                    "---- memory ----", "VmRSS", "---- last 64 telemetry",
                    '"event": "step"', "==== end postmortem ===="):
        assert section in text, section
    assert "'watchdog_stalls_total': 1" in proc.stdout


def test_profile_window_writes_a_trace_on_the_cpu(tmp_path):
    reg = TelemetryRegistry()
    ctrl = ProfileController(tmp_path / "prof", registry=reg, steps=(2, 3))
    a = torch.randn(64, 64)
    for step in range(1, 5):
        active = ctrl.maybe_start(step)
        assert active == (2 <= step <= 3)
        torch.mm(a, a).relu_()
        ctrl.on_step_end(step)
    ctrl.close()
    (trace,) = (tmp_path / "prof").glob("capture_000_step2_flag/trace.json")
    names = {e.get("name") for e in json.loads(trace.read_text())[
        "traceEvents"]}
    assert "aten::mm" in names
    snap = reg.snapshot()
    assert snap["counters"]["profiler_captures_total"] == 1
    assert snap["gauges"]["profiler_capture_active"] == 0
    assert snap["gauges"]["profiler_last_capture_path"] == str(trace.parent)
    # A window that a resume skipped past is dropped, not captured late.
    late = ProfileController(tmp_path / "late", registry=reg, steps=(2, 3))
    assert not late.maybe_start(5) and not (tmp_path / "late").exists()


def test_window_inside_another_profiler_is_refused(tmp_path):
    """One torch.profiler session at a time: a window that would open
    inside another (``--profile-dir``'s epoch trace) is a counted error,
    and the outer trace stays whole."""
    from torch.profiler import profile
    reg = TelemetryRegistry()
    ctrl = ProfileController(tmp_path / "prof", registry=reg, steps=(1, 1))
    with profile() as outer:
        assert not ctrl.maybe_start(1)
        torch.ones(4).sum()
    outer.export_chrome_trace(str(tmp_path / "outer.json"))
    assert json.loads((tmp_path / "outer.json").read_text())["traceEvents"]
    assert reg.snapshot()["counters"]["profiler_capture_errors_total"] == 1
    assert not (tmp_path / "prof").exists()


def test_memory_sample_without_cuda_records_nothing():
    reg = TelemetryRegistry()
    assert sample_device_memory(reg) == {}
    assert not reg.snapshot()["gauges"]
