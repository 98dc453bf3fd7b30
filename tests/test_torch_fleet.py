"""The port's serving fleet held to the JAX package's on the CPU.

``serve/fleet/``: ``partition_devices`` and the routing policies choose
what JAX's choose over hypothesis-drawn replica views; the router gives
JAX's router's replies for the same scripted line stream over the
stand-in replica (``tests/data/fake_replica.py``: control lines,
backpressure, unknown commands, ``::model``, the relays); a SIGKILLed
replica's requests are answered exactly once by its survivor; a rolling
swap moves every replica and a bad checkpoint rolls back; one real port
serve-CLI replica (``--device cpu``, ViT-Ti/16 at 32 px in float32,
converted from JAX params) behind the port router answers bit for bit
what a direct port serve CLI answers, within 1e-5 of JAX's
``predict_image``; the fleet CLI takes JAX's flags and refuses what is
not ported, and its ``::swap`` re-admits a replica only on the
``--swap-probe`` row its child process computes.
"""

import ast
import functools
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from pytorch_vit_paper_replication_tpu.serve import fleet as jfleet
from pytorch_vit_paper_replication_tpu.telemetry.registry import (
    TelemetryRegistry as JRegistry)
from pytorch_vit_paper_replication_tpu_torch.serve import fleet as tfleet
from pytorch_vit_paper_replication_tpu_torch.serve.fleet import (
    FleetRouter, ReplicaManager, ReplicaSpec, build_serve_command,
    is_backpressure, partition_devices, replica_env, rolling_swap)
from pytorch_vit_paper_replication_tpu_torch.serve.fleet import (
    __main__ as fleet_cli)
from pytorch_vit_paper_replication_tpu_torch.telemetry.registry import (
    TelemetryRegistry)

REPO = Path(__file__).resolve().parent.parent
FAKE = REPO / "tests" / "data" / "fake_replica.py"
CLASSES = ["pizza", "steak", "sushi"]


def _load_fake_module():
    import importlib.util
    spec = importlib.util.spec_from_file_location("fake_replica", FAKE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------- partitioning
@settings(max_examples=200, deadline=None)
@given(st.integers(-1, 12), st.integers(-1, 12))
def test_partition_devices_equal_jax(n_devices, n_replicas):
    def run(mod):
        try:
            return mod.partition_devices(n_devices, n_replicas)
        except ValueError as e:
            return str(e)
    assert run(tfleet) == run(jfleet)


def test_replica_env_exports_cuda_visible_devices():
    env = replica_env([2, 3], base={"KEEP": "1"})
    assert env == {"KEEP": "1", "CUDA_VISIBLE_DEVICES": "2,3",
                   "VIT_REPLICA_DEVICES": "2,3"}
    assert partition_devices(1, 2) == [[0], [0]]


def test_build_serve_command_is_jax_command_on_the_port():
    spec = ReplicaSpec(rid="s0", checkpoint="/ck", model="student",
                       extra_args=["--sync-warmup"])
    kw = dict(classes_file="/c.txt", preset="ViT-Ti/16", image_size=32,
              buckets="1,4,8", max_wait_us=500, max_queue=64,
              extra=["--ship-to", "127.0.0.1:9"])
    port = build_serve_command(spec, **kw)
    jax_ = jfleet.build_serve_command(jfleet.ReplicaSpec(
        rid="s0", checkpoint="/ck", model="student",
        extra_args=["--sync-warmup"]), **kw)
    assert port[2] == "pytorch_vit_paper_replication_tpu_torch.serve"
    assert port[:2] + port[3:] == jax_[:2] + jax_[3:]
    cpu = build_serve_command(spec, classes_file="/c.txt", device="cpu")
    assert cpu[cpu.index("--device") + 1] == "cpu"
    assert "--device" not in port


# ------------------------------------------------------------ policy
VIEW = st.fixed_dictionaries({
    "address": st.sampled_from([None, ("127.0.0.1", 1)]),
    "up": st.booleans(), "draining": st.booleans(),
    "inflight": st.integers(0, 4), "queue_depth": st.integers(0, 4),
    "warm_rungs": st.sets(st.sampled_from([1, 4, 8])).map(
        lambda s: tuple(sorted(s))),
    "model": st.sampled_from([None, "student", "teacher"])})


@settings(max_examples=300, deadline=None)
@given(st.lists(VIEW, max_size=6),
       st.sampled_from([None, 1, 4, 8, 32]),
       st.sampled_from([None, "student", "teacher", "other"]),
       st.sets(st.sampled_from(["r0", "r1", "r2"])),
       st.permutations(range(6)))
def test_policy_choice_equal_jax(views, rung, model, exclude, order):
    rids = [f"r{order[i]}" for i in range(len(views))]
    made = [[mod.ReplicaView(rid=rid, restarts=0, **v)
             for rid, v in zip(rids, views)] for mod in (tfleet, jfleet)]
    kw = dict(rung=rung, model=model, exclude=frozenset(exclude))
    assert tfleet.LeastLoadedAffinity().choose(made[0], **kw) == \
        jfleet.LeastLoadedAffinity().choose(made[1], **kw)
    rr = (tfleet.RoundRobin(), jfleet.RoundRobin())
    assert [rr[0].choose(made[0], **kw) for _ in range(5)] == \
        [rr[1].choose(made[1], **kw) for _ in range(5)]
    assert [v.routable for v in made[0]] == [v.routable for v in made[1]]


def test_make_policy_names_and_refusal_equal_jax():
    assert sorted(tfleet.POLICIES) == sorted(jfleet.POLICIES)
    for name in tfleet.POLICIES:
        assert tfleet.make_policy(name).name == name
    msgs = []
    for mod in (tfleet, jfleet):
        with pytest.raises(ValueError) as e:
            mod.make_policy("nope")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    for line in ("x\tERROR\tQueueFullError: full", '{"error": '
                 '"DrainingError: d"}', "x\tERROR\tValueError: v",
                 "x\tpizza\t0.9", "{bad json"):
        assert tfleet.is_backpressure(line) == jfleet.is_backpressure(line)
    assert tfleet.backpressure_reply("l", "K", "d", 0.25) == \
        jfleet.backpressure_reply("l", "K", "d", 0.25)


# ------------------------------------------------------ fake fleets
def _fake_factory(warm_by_rid=None, delay_s=0.0):
    def factory(spec):
        cmd = [sys.executable, str(FAKE), "--ckpt", spec.checkpoint]
        warm = (warm_by_rid or {}).get(spec.rid)
        if warm:
            cmd += ["--warm", warm]
        if delay_s:
            cmd += ["--delay-s", str(delay_s)]
        return cmd
    return factory


def _mk_fleet(mod, reg_cls, tmp_path, *, warm_by_rid=None, delay_s=0.0,
              n=2, ckpt="ckA", models=None, auto_restart=True,
              expected_rungs=None, max_inflight=1024):
    registry = reg_cls()
    specs = [mod.ReplicaSpec(rid=f"r{i}", checkpoint=str(tmp_path / ckpt),
                             model=(models[i] if models else None))
             for i in range(n)]
    manager = mod.ReplicaManager(
        specs, command_factory=_fake_factory(warm_by_rid, delay_s),
        env_factory=lambda spec: dict(os.environ),
        health_interval_s=0.05, stale_after_s=1.0,
        restart_backoff_s=(0.1, 0.5), auto_restart=auto_restart,
        expected_rungs=expected_rungs, registry=registry)
    router = mod.FleetRouter(manager, registry=registry, max_retries=2,
                             max_inflight=max_inflight,
                             request_timeout_s=30.0)
    return manager, router, registry


def _ask(address, lines, timeout=30.0):
    """One connection, one reply line per request line (a ::metrics
    block is read up to its blank line)."""
    with socket.create_connection(address, timeout=timeout) as sock:
        sock.settimeout(timeout)
        rfile = sock.makefile("r", encoding="utf-8")
        replies = []
        for line in lines:
            sock.sendall((line + "\n").encode())
            if line == "::metrics":
                block = []
                for reply in rfile:
                    if reply == "\n":
                        break
                    block.append(reply)
                replies.append("".join(block))
            else:
                replies.append(rfile.readline().rstrip("\n"))
        rfile.close()
        return replies


SCRIPT = [
    "img1.jpg", "::rung 8", "::rung x", "::head features", "::tier batch",
    "img2.jpg", "::head probs", "::tier interactive", "img3.jpg",
    "::req head=tokens img4.jpg", "::req tier=batch k=3 img5.jpg",
    "::req bogus", "::search 4 img6.jpg", "::search x img7.jpg",
    "::probs img8.jpg", "::probs", "::head logits", "::tier fast",
    "::drain 5", "::nope", "::swap", "::swap /ck/new", "::swap-status",
    "::model student", "img9.jpg", "::probs img10.jpg", "::model",
    "::model -", "img11.jpg", "::model teacher", "::req model=student "
    "img12.jpg", "img13.jpg",
]


def test_router_replies_equal_jax_router_for_a_scripted_stream(tmp_path):
    replies, metric_names, stats_keys = [], [], []
    for mod, reg_cls in ((tfleet, TelemetryRegistry), (jfleet, JRegistry)):
        manager, router, registry = _mk_fleet(
            mod, reg_cls, tmp_path, models=["student", None])
        with manager, router:
            manager.start()
            assert manager.wait_ready(20.0)
            router.start()
            out = _ask(router.address, SCRIPT + ["::stats", "::metrics"])
        replies.append(out[:-2])
        stats_keys.append(sorted(json.loads(out[-2])))
        metric_names.append(sorted(
            line.split()[2] for line in out[-1].splitlines()
            if line.startswith("# TYPE")))
    assert replies[0] == replies[1]
    assert stats_keys[0] == stats_keys[1]
    assert metric_names[0] == metric_names[1]
    got = dict(zip(SCRIPT, replies[0]))
    assert got["img2.jpg"].split("\t")[1] == "ckA:features:batch"
    assert got["::drain 5"].endswith("unknown router control command")
    assert got["::model teacher"] == "::model\tok\tteacher"
    assert "NoReplicaAvailable" in got["img13.jpg"]
    assert got["::req model=student img12.jpg"].split("\t")[1] == \
        "ckA:probs:interactive:student"


def test_router_admission_bound_equal_jax(tmp_path):
    replies = []
    for mod, reg_cls in ((tfleet, TelemetryRegistry), (jfleet, JRegistry)):
        manager, router, registry = _mk_fleet(mod, reg_cls, tmp_path,
                                              n=1, max_inflight=0)
        with manager, router:
            manager.start()
            assert manager.wait_ready(20.0)
            router.start()
            replies.append(_ask(router.address, ["x.jpg", "::probs y"]))
        assert registry.snapshot()["counters"][
            "fleet_route_rejected_total"] == 2
    assert replies[0] == replies[1]
    assert is_backpressure(replies[0][0])


def test_router_with_no_replica_up_answers_backpressure(tmp_path):
    manager, router, registry = _mk_fleet(
        tfleet, TelemetryRegistry, tmp_path, ckpt="ckbad",
        auto_restart=False)
    with manager, router:
        manager.start()     # the fakes exit(3) before listening
        router.start()
        time.sleep(0.3)
        (reply,) = _ask(router.address, ["x.jpg"])
    assert reply == ("x.jpg\tERROR\tNoReplicaAvailable: no routable "
                     "replica after 0 attempt(s); retry after ~0.050s")
    assert registry.snapshot()["counters"]["fleet_route_errors_total"] == 1


def test_replica_sigkill_redispatch_exactly_once_and_restart(tmp_path):
    manager, router, registry = _mk_fleet(
        tfleet, TelemetryRegistry, tmp_path,
        warm_by_rid={"r0": "1", "r1": "8"}, delay_s=0.25)
    with manager, router:
        manager.start()
        assert manager.wait_ready(20.0)
        router.start()
        n_clients = 12
        replies = [None] * n_clients
        barrier = threading.Barrier(n_clients + 1)

        def client(i):
            barrier.wait(timeout=20)
            (replies[i],) = _ask(router.address, [f"img{i}.jpg"],
                                 timeout=60.0)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_clients)]
        for t in threads:
            t.start()
        barrier.wait(timeout=20)
        # Wait until the victim holds requests in flight, then kill it.
        deadline = time.monotonic() + 10.0
        while router.inflight("r1") == 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        victim = manager.pid_of("r1")
        os.kill(victim, signal.SIGKILL)
        for t in threads:
            t.join(90)
        assert all(r is not None and "\tERROR\t" not in r for r in replies)
        assert sorted(r.split("\t")[0] for r in replies) == sorted(
            f"img{i}.jpg" for i in range(n_clients))
        counters = registry.snapshot()["counters"]
        assert counters["fleet_route_requests_total"] == n_clients
        assert counters["fleet_route_retries_total"] >= 1
        assert manager.wait_healthy("r1", 20.0)
        assert manager.pid_of("r1") != victim
        assert registry.snapshot()["counters"]["replica_restarts_total"] >= 1


def test_rolling_swap_and_rollback_over_fakes(tmp_path):
    fake = _load_fake_module()
    manager, router, registry = _mk_fleet(
        tfleet, TelemetryRegistry, tmp_path,
        warm_by_rid={"r0": "1,8", "r1": "1,8"}, expected_rungs=(1, 8))
    with manager, router:
        manager.start()
        assert manager.wait_ready(20.0)
        router.start()
        stop = threading.Event()
        errors, answered = [], [0]

        def background_load():
            while not stop.is_set():
                (r,) = _ask(router.address, ["bg.jpg"], timeout=30.0)
                answered[0] += 1
                if "\tERROR\t" in r:
                    errors.append(r)
                time.sleep(0.01)

        lt = threading.Thread(target=background_load, daemon=True)
        lt.start()
        new = str(tmp_path / "ckB")
        report = rolling_swap(
            manager, router, new, drain_timeout_s=5.0, warm_timeout_s=20.0,
            probe="probe.jpg",
            expect_probs=np.asarray(fake.probs_for_ckpt(new), np.float32),
            registry=registry)
        assert report["ok"] and not report["rolled_back"]
        assert report["swapped"] == ["r0", "r1"]
        assert all(r["probe"]["matched"] for r in report["replicas"])
        (after,) = _ask(router.address, ["after.jpg"])
        assert after.split("\t")[1] == "ckB"
        bad = rolling_swap(manager, router, str(tmp_path / "ckbad"),
                           drain_timeout_s=2.0, warm_timeout_s=2.5,
                           registry=registry)
        stop.set()
        lt.join(30)
        assert not bad["ok"] and bad["rolled_back"] and bad["swapped"] == []
        assert manager.wait_ready(20.0)
        assert [manager.checkpoint_of(r) for r in ("r0", "r1")] == [new] * 2
        (still,) = _ask(router.address, ["still.jpg"])
        assert still.split("\t")[1] == "ckB"
    assert not errors and answered[0] > 0
    counters = registry.snapshot()["counters"]
    assert counters["fleet_swaps_total"] == 1
    assert counters["fleet_swap_rollbacks_total"] == 1


# --------------------------------------------------- one REAL replica
@pytest.fixture(scope="module")
def export(tmp_path_factory):
    """A ViT-Ti/16 at 32 px made by JAX from a seed, converted to the
    port's export; (export dir, classes file, probe image, JAX model,
    JAX params)."""
    import jax
    import jax.numpy as jnp
    from PIL import Image

    from pytorch_vit_paper_replication_tpu.configs import vit_ti16
    from pytorch_vit_paper_replication_tpu.models import ViT as JViT
    from pytorch_vit_paper_replication_tpu_torch import configs as tcfg
    from pytorch_vit_paper_replication_tpu_torch.convert import (
        params_from_flax)
    from pytorch_vit_paper_replication_tpu_torch.models import ViT
    from pytorch_vit_paper_replication_tpu_torch.predictions import (
        save_inference_export)

    root = tmp_path_factory.mktemp("torch_fleet")
    jm = JViT(vit_ti16(num_classes=3, image_size=32, dtype="float32",
                       attention_impl="xla"))
    params = jm.init(jax.random.key(1), jnp.zeros((1, 32, 32, 3)))["params"]
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_unflatten(tree, [
        np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(
            np.float32) for x in leaves])
    tm = ViT(tcfg.vit_ti16(num_classes=3, image_size=32, dtype="float32"))
    tm.load_state_dict(params_from_flax(params))
    out = save_inference_export(root / "export", tm)
    classes = root / "classes.txt"
    classes.write_text("\n".join(CLASSES) + "\n")
    probe = root / "probe.png"
    Image.fromarray(rng.integers(0, 256, (48, 40, 3), np.uint8)).save(probe)
    return out, classes, probe, jm, params


# The port's serve CLI, unchanged, with the ViT-Ti/16 preset computing in
# float32 (the presets default to bf16), so its rows can be held to JAX's
# float32 predict_image at 1e-5.
F32_SERVE = [sys.executable, "-c", (
    "import functools, sys\n"
    "from pytorch_vit_paper_replication_tpu_torch import configs\n"
    "configs.PRESETS['ViT-Ti/16'] = functools.partial(configs.vit_ti16, "
    "dtype='float32')\n"
    "from pytorch_vit_paper_replication_tpu_torch.serve.__main__ import "
    "main\n"
    "main(sys.argv[1:])\n")]


def _f32_replica_command(spec, **kw):
    cmd = build_serve_command(spec, **kw)
    return F32_SERVE + cmd[3:]


def _serve_cli_probs(export_dir, classes, probe):
    proc = subprocess.run(
        F32_SERVE + [
            "--checkpoint", str(export_dir), "--classes-file", str(classes),
            "--preset", "ViT-Ti/16", "--device", "cpu", "--buckets", "1,4",
            "--sync-warmup", "--no-manifest"],
        input=f"::probs {probe}\n{probe}\n", capture_output=True, text=True,
        timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.splitlines()


def test_real_replica_behind_router_bit_identical(export, tmp_path):
    from pytorch_vit_paper_replication_tpu.data.transforms import (
        eval_transform)
    from pytorch_vit_paper_replication_tpu.predictions import (
        predict_image as jax_predict_image)

    export_dir, classes, probe, jm, params = export
    direct = _serve_cli_probs(export_dir, classes, probe)
    registry = TelemetryRegistry()
    manager = ReplicaManager(
        [ReplicaSpec(rid="r0", checkpoint=str(export_dir))],
        command_factory=functools.partial(
            _f32_replica_command, classes_file=str(classes),
            preset="ViT-Ti/16", buckets="1,4",
            extra=["--device", "cpu", "--no-manifest"]),
        health_interval_s=0.25, stale_after_s=10.0, expected_rungs=(1, 4),
        registry=registry)
    router = FleetRouter(manager, registry=registry)
    with manager, router:
        manager.start()
        assert manager.wait_healthy("r0", 240.0, require_rungs=(1, 4)), \
            manager.stderr_tail("r0")
        router.start()
        routed = _ask(router.address, [f"::probs {probe}", str(probe),
                                       f"::req head=features {probe}"],
                      timeout=120.0)
    assert routed[:2] == direct
    got = np.asarray(json.loads(routed[0])["probs"], np.float32)
    _, _, want = jax_predict_image(jm, params, str(probe), CLASSES,
                                   transform=eval_transform(32))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    path, head, row = routed[2].split("\t")
    assert (path, head) == (str(probe), "features") and \
        len(json.loads(row)) == 192


@pytest.mark.parametrize("extra,msg", [
    (["--deploy-watch", "d"], "--deploy-watch is not yet ported (ROADMAP "
                              "Queue 1 item 9)"),
    (["--compile-cache-dir", "c"], "--compile-cache-dir is not yet ported "
                                   "(ROADMAP Queue 1 item 9)"),
    (["--replicas", "0"], "--replicas must be >= 1"),
    (["--cascade", "c.json"], "--cascade and --cascade-teacher go together"),
    (["--cascade", "c.json", "--cascade-teacher", "t", "--autoscale"],
     "--cascade cannot combine with --autoscale"),
    (["--ship-to", "nohost"], "--ship-to: expected HOST:PORT"),
    (["--max-replicas", "3"], "--min-replicas/--max-replicas need "
                              "--autoscale"),
])
def test_fleet_cli_refusals(extra, msg):
    with pytest.raises(SystemExit, match=msg.replace("(", "\\(").replace(
            ")", "\\)")):
        fleet_cli.main(["--checkpoint", "ck", "--classes", "a", "b"] + extra)


def test_fleet_cli_flags_are_jax_flags_plus_device():
    import argparse

    def flags(main):
        seen = {}

        class Stop(Exception):
            pass

        orig = argparse.ArgumentParser.parse_args

        def capture(self, *a, **k):
            seen.update({o: act.default for act in self._actions
                         for o in act.option_strings})
            raise Stop
        argparse.ArgumentParser.parse_args = capture
        try:
            main([])
        except Stop:
            pass
        finally:
            argparse.ArgumentParser.parse_args = orig
        return seen

    from pytorch_vit_paper_replication_tpu.serve.fleet import (
        __main__ as jcli)
    port, jax_ = flags(fleet_cli.main), flags(jcli.main)
    deploy_only = {"--deploy-dir", "--eval-npz", "--probe",
                   "--max-loss-ratio", "--abs-loss-slack",
                   "--poll-interval-s", "--bootstrap"}
    jax_ = {k: v for k, v in jax_.items() if k not in deploy_only
            and not k.startswith(("--canary-", "--shadow-",
                                  "--self-probe"))}
    assert set(port) == set(jax_) | {"--device"}
    assert {k: port[k] for k in jax_} == jax_
    assert port["--device"] == "cuda"


# --------------------------------------------------------- autoscale
@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 6), st.integers(0, 40),
                          st.one_of(st.none(), st.floats(0.0, 2.0)),
                          st.sampled_from([0.0, 0.5, 1.0]),
                          st.one_of(st.none(), st.integers(0, 7)),
                          st.floats(0.0, 3.0)), max_size=40),
       st.sampled_from([
           {}, {"up_lat_s": 0.5, "down_lat_s": 0.1},
           {"min_replicas": 1, "max_replicas": 6, "breach_ticks": 1,
            "clear_ticks": 2, "cooldown_s": 2.0, "up_step": 2},
           {"up_load_per_replica": 2.0, "down_load_per_replica": 1.5,
            "up_lat_s": 1.0}]))
def test_autoscale_decisions_equal_jax(stream, cfg):
    deciders = [mod.AutoscaleDecider(mod.AutoscaleConfig(**cfg))
                for mod in (tfleet, jfleet)]
    now = 0.0
    for up, queue, lat, cov, total, dt in stream:
        now += dt
        got = [d.observe(mod.AutoscaleSignals(
            replicas_up=up, queue_depth_total=queue, lat_ema_s=lat,
            warm_coverage=cov, replicas_total=total), now)
            for d, mod in zip(deciders, (tfleet, jfleet))]
        assert (got[0].delta, got[0].reason) == (got[1].delta, got[1].reason)


@pytest.mark.parametrize("cfg", [
    {"min_replicas": 0}, {"min_replicas": 3, "max_replicas": 2},
    {"down_load_per_replica": 4.0}, {"up_lat_s": 0.1, "down_lat_s": 0.2},
    {"breach_ticks": 0}, {"down_step": 0}])
def test_autoscale_config_refusals_equal_jax(cfg):
    msgs = []
    for mod in (tfleet, jfleet):
        with pytest.raises(ValueError) as e:
            mod.AutoscaleConfig(**cfg).validate()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_autoscaler_actuates_up_and_down_over_fakes(tmp_path):
    """The actuator on a live fake fleet, driven by a synthetic signal
    stream: a breach adds a replica behind the warm gate, a clear
    drains one back out."""
    manager, router, registry = _mk_fleet(
        tfleet, TelemetryRegistry, tmp_path, n=1,
        warm_by_rid={"r0": "1,8", "r1": "1,8"}, expected_rungs=(1, 8))
    phase = {"load": 50}

    def signals():
        up = [v for v in manager.views() if v.up]
        return tfleet.AutoscaleSignals(
            replicas_up=len(up), queue_depth_total=phase["load"],
            lat_ema_s=None, warm_coverage=1.0,
            replicas_total=len(manager.replica_ids()))

    cfg = tfleet.AutoscaleConfig(min_replicas=1, max_replicas=2,
                                 breach_ticks=1, clear_ticks=1,
                                 cooldown_s=0.0, interval_s=0.05,
                                 warm_timeout_s=20.0, drain_timeout_s=2.0)
    with manager, router:
        manager.start()
        assert manager.wait_ready(20.0)
        router.start()
        scaler = tfleet.Autoscaler(
            manager, router, cfg, signals_fn=signals, registry=registry,
            spec_factory=lambda i: ReplicaSpec(
                rid=f"r{i}", checkpoint=str(tmp_path / "ckA")))
        with scaler:
            deadline = time.monotonic() + 30.0
            while len(manager.replica_ids()) < 2 and \
                    time.monotonic() < deadline:
                time.sleep(0.05)
            assert manager.wait_healthy("r1", 20.0)
            phase["load"] = 0
            while len(manager.replica_ids()) > 1 and \
                    time.monotonic() < deadline:
                time.sleep(0.05)
        assert manager.replica_ids() == ["r0"]
        (reply,) = _ask(router.address, ["x.jpg"])
        assert "\tERROR\t" not in reply
    counters = registry.snapshot()["counters"]
    assert counters["autoscale_up_total"] >= 1
    assert counters["autoscale_down_total"] >= 1


def _start_fleet_cli(argv):
    """``python -m ...serve.fleet ARGV`` as a user runs it; returns the
    process and its router's address once it says its replicas are
    ready."""
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "pytorch_vit_paper_replication_tpu_torch.serve.fleet",
         *map(str, argv)], stderr=subprocess.PIPE, text=True, cwd=REPO)
    addr, err = None, []
    for line in proc.stderr:
        err.append(line)
        if "router listening on" in line:
            host, port = line.split("listening on ")[1].split()[0].split(":")
            addr = (host, int(port))
        if "replicas ready:" in line:
            break
    if addr is None or not err or "ready: True" not in err[-1]:
        _stop_fleet_cli(proc)
        raise AssertionError("".join(err[-20:]))
    return proc, addr


def _stop_fleet_cli(proc) -> int:
    """SIGINT, the CLI's clean shutdown (it closes its replicas)."""
    proc.send_signal(signal.SIGINT)
    rc = proc.wait(timeout=60)
    proc.stderr.close()
    return rc


def _swap_via_router(addr, checkpoint, timeout_s=240.0) -> dict:
    """``::swap CHECKPOINT`` to the router, then ``::swap-status`` until
    it reports on that checkpoint."""
    started = json.loads(_ask(addr, [f"::swap {checkpoint}"])[0])
    assert started == {"swap": "started", "checkpoint": str(checkpoint)}
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        status = json.loads(_ask(addr, ["::swap-status"])[0])
        if status.get("checkpoint") == str(checkpoint):
            return status
        time.sleep(0.1)
    raise AssertionError(f"no swap report on {checkpoint}: {status}")


def test_fleet_cli_cascade_on_cpu_ships_router_frames(export, tmp_path):
    """``python -m ...serve.fleet --cascade --device cpu`` as a user runs
    it: a student and a teacher replica (the same export here), the
    router listening, ``::probs`` answered by the student at threshold 0,
    ``::stats`` with the cascade block, ``::swap`` refused on a cascade
    fleet, router frames (role ``router``) at the aggregator, exit 0 on
    SIGINT."""
    from pytorch_vit_paper_replication_tpu_torch.telemetry.shipper import (
        FrameSink)

    export_dir, classes, probe, _, _ = export
    cfg = tmp_path / "cascade.json"
    cfg.write_text(json.dumps({"threshold": 0.0,
                               "predicted_escalation_rate": 0.0}))
    with FrameSink() as sink:
        proc, addr = _start_fleet_cli([
            "--checkpoint", export_dir, "--classes-file", classes,
            "--preset", "ViT-Ti/16", "--replicas", "1", "--devices", "1",
            "--device", "cpu", "--port", "0", "--buckets", "1,4",
            "--cascade", cfg, "--cascade-teacher", export_dir,
            "--cascade-teacher-preset", "ViT-Ti/16", "--ship-to",
            f"127.0.0.1:{sink.port}", "--ship-interval-s", "0.2",
            "--worker-id", "router-x"])
        try:
            replies = _ask(addr, [f"::probs {probe}", "::stats",
                                  "::swap /x"], timeout=120.0)
            deadline = time.monotonic() + 20
            while not any(f["role"] == "router" for f in sink.frames) and \
                    time.monotonic() < deadline:
                time.sleep(0.05)
        finally:
            rc = _stop_fleet_cli(proc)
        frames = [f for f in sink.frames if f["role"] == "router"]
    assert rc == 0
    assert len(json.loads(replies[0])["probs"]) == 3
    stats = json.loads(replies[1])
    assert sorted(stats["replicas"]) == ["s0", "t0"]
    assert stats["cascade"]["served_student"] == 1
    assert stats["cascade"]["escalated"] == 0
    assert "not tier-aware" in json.loads(replies[2])["error"]
    assert frames and frames[-1]["worker_id"] == "router-x"
    assert "fleet_replicas_up" in frames[-1]["snapshot"]["gauges"]


def test_fleet_cli_swap_probe_on_cpu(export, tmp_path):
    """``::swap`` through the fleet CLI with ``--swap-probe``: the
    reference row that ``probe_reference`` computes in its child process
    equals the swapped replica's ``::probs`` bit for bit, so the swap
    completes and the fleet answers with the new export. A checkpoint the
    child cannot load, and a probe image it cannot read, each fail the
    swap loudly with no replica touched."""
    from pytorch_vit_paper_replication_tpu_torch import configs as tcfg
    from pytorch_vit_paper_replication_tpu_torch.convert import seeded_state
    from pytorch_vit_paper_replication_tpu_torch.models import ViT
    from pytorch_vit_paper_replication_tpu_torch.predictions import (
        save_inference_export)

    export_dir, classes, probe, _, _ = export
    model = ViT(tcfg.vit_ti16(num_classes=3, image_size=32))
    model.load_state_dict(seeded_state(model, 7))
    export2 = save_inference_export(tmp_path / "export2", model)
    bad = tmp_path / "bad"
    shutil.copytree(export2, bad)
    with open(bad / "params.npz", "r+b") as f:
        f.truncate(64)
    swap_probe = tmp_path / "swap_probe.png"
    shutil.copy(probe, swap_probe)
    proc, addr = _start_fleet_cli([
        "--checkpoint", export_dir, "--classes-file", classes, "--preset",
        "ViT-Ti/16", "--replicas", "1", "--devices", "1", "--device", "cpu",
        "--port", "0", "--buckets", "1,4", "--swap-probe", swap_probe])
    try:
        before = _ask(addr, [f"::probs {probe}"])[0]
        good = _swap_via_router(addr, export2)
        after = _ask(addr, [f"::probs {probe}"])[0]
        corrupt = _swap_via_router(addr, bad)
        swap_probe.write_bytes(b"not an image")
        unreadable = _swap_via_router(addr, export_dir)
        still = _ask(addr, [f"::probs {probe}", "::stats"])
    finally:
        rc = _stop_fleet_cli(proc)
    assert rc == 0
    assert good["ok"] and good["swapped"] == ["r0"], good
    assert good["replicas"][0]["probe"]["matched"] is True
    assert after != before and len(json.loads(after)["probs"]) == 3
    for report in (corrupt, unreadable):
        assert report["ok"] is False and report["rolled_back"] is False
        assert report["error"].startswith(
            "swap-probe reference failed: RuntimeError: probe reference "
            "exited 1"), report
    assert still[0] == after
    assert json.loads(still[1])["replicas"]["r0"]["restarts"] == 0


def test_replicas_booting_together_build_each_kernel_once(tmp_path):
    """Two processes loading the same kernels into one empty build
    directory at once (two replicas' first forwards): each library is
    compiled once between them — the second waits on the library's lock
    and loads what the first wrote — and ``builds.jsonl`` says so. A
    stand-in ``nvcc`` (a shell script that sleeps, then writes its
    output) takes the compiler's place on this host."""
    cuda = tmp_path / "cuda"
    (cuda / "bin").mkdir(parents=True)
    nvcc = cuda / "bin" / "nvcc"
    nvcc.write_text("#!/bin/sh\nsleep 1\nfor a in \"$@\"; do\n"
                    "  if [ \"$prev\" = -o ]; then echo lib > \"$a\"; fi\n"
                    "  prev=$a\ndone\n")
    nvcc.chmod(0o755)
    build = tmp_path / "build"
    env = dict(os.environ, CUDA_HOME=str(cuda),
               VIT_TORCH_BUILD_DIR=str(build))
    code = ("from pytorch_vit_paper_replication_tpu_torch.ops import _build\n"
            "_build.build(['fused_mlp', 'flash_attention'])\n"
            "print(sorted(n for n, v in _build.BUILD_LOG.items() "
            "if v['seconds'] > 0))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, text=True, cwd=REPO)
             for _ in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    rows = [json.loads(x) for x in
            (build / "builds.jsonl").read_text().splitlines()]
    assert sorted(r["name"] for r in rows) == ["flash_attention",
                                               "fused_mlp"]
    built = [ast.literal_eval(o.strip().splitlines()[-1]) for o in outs]
    assert sorted(built, key=len) == [[], ["flash_attention", "fused_mlp"]]
    libs = sorted(p.name for p in build.glob("lib*.so"))
    assert len(libs) == 2 and not list(build.glob("*.tmp.*"))
