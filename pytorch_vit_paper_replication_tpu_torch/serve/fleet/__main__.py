"""Fleet CLI: spawn N serve replicas behind one router address.

Port of the JAX package's ``serve/fleet/__main__.py`` (the same flags;
``--deploy-watch`` and ``--compile-cache-dir`` are parsed and refused,
not ported yet)::

    python -m pytorch_vit_paper_replication_tpu_torch.serve.fleet \\
        --checkpoint runs/ckpt --classes-file classes.txt \\
        --replicas 4 --devices 4 --port 7878

    # clients speak the unchanged serve line protocol to :7878;
    # '::stats' answers the fleet snapshot, '::metrics' Prometheus.

    # zero-downtime rolling checkpoint swap, from any client:
    printf '::swap runs/ckpt_v2\\n' | nc localhost 7878
    printf '::swap-status\\n' | nc localhost 7878

Each replica is a full port serve CLI subprocess (``--port 0``, on
``cuda`` with its own ``CUDA_VISIBLE_DEVICES`` partition, the
checkpoint's warmup manifest beside it). The router health-gates
membership through ``::stats`` polls, re-dispatches on replica death,
and load-balances with least-loaded + bucket affinity (``--policy``).
With ``--cascade CASCADE_JSON --cascade-teacher CKPT`` the fleet is two
tiers (``--checkpoint`` the student, the teacher escalated to below the
calibrated margin). ``--ship-to`` ships the router's frames (role
``router``). The router process never initializes CUDA: the card
belongs to the replicas (``--swap-probe``'s reference row is computed
in a child process on the first replica's partition).

:func:`parse_args` and :func:`build_fleet` are the CLI's assembly, for an
embedder that wants the same fleet in its own process (its replicas with
extra serve-CLI flags, its router traced there).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional, Sequence

from .policy import POLICIES, make_policy
from .replica import (ReplicaManager, ReplicaSpec, build_serve_command,
                      partition_devices, replica_env)
from .rollout import rolling_swap
from .router import FleetRouter

# Flags of the JAX fleet CLI whose path the port does not have yet, by
# the ROADMAP Queue 1 item that brings it.
NOT_PORTED = {"deploy_watch": 9, "compile_cache_dir": 9}

# The --swap-probe reference row, computed in a child process on the
# replicas' device: predict_image's float32 softmax row as JSON.
_PROBE_CODE = """
import json, sys
from pytorch_vit_paper_replication_tpu_torch.predictions import (
    load_class_names, load_inference_checkpoint, predict_image)
a = json.loads(sys.argv[1])
classes = load_class_names(a["classes_file"])
model, transform, _ = load_inference_checkpoint(
    a["checkpoint"], a["preset"], len(classes), image_size=a["image_size"],
    device=a["device"])
_, _, probs = predict_image(model, a["probe"], classes, transform=transform)
print(json.dumps([float(p) for p in probs]))
"""


def probe_reference(checkpoint: str, *, probe: str, preset: str,
                    classes_file: str, image_size, device: str,
                    devices) -> list:
    """``predict_image``'s softmax row of ``probe`` under ``checkpoint``,
    computed by a child process on ``devices`` (the replicas' device and
    numerics, so a swapped replica's ``::probs`` must equal it bit for
    bit); raises RuntimeError when the child fails."""
    args = json.dumps({"checkpoint": str(checkpoint), "probe": str(probe),
                       "preset": preset, "classes_file": str(classes_file),
                       "image_size": image_size, "device": device})
    proc = subprocess.run([sys.executable, "-c", _PROBE_CODE, args],
                          env=replica_env(devices), capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"probe reference exited {proc.returncode}: "
                           f"{proc.stderr[-1000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def build_parser() -> argparse.ArgumentParser:
    """The fleet CLI's flags (JAX's, plus the port CLIs' ``--device``)."""
    p = argparse.ArgumentParser(
        description="ViT serving fleet on PyTorch/CUDA: N replicas, "
                    "one router")
    p.add_argument("--checkpoint", required=True,
                   help="params export or training --checkpoint-dir "
                        "every replica boots")
    cls_group = p.add_mutually_exclusive_group(required=True)
    cls_group.add_argument("--classes", nargs="+",
                           help="class names, in training order")
    cls_group.add_argument("--classes-file",
                           help="file with one class name per line")
    p.add_argument("--preset", default="ViT-B/16")
    p.add_argument("--image-size", type=int, default=None,
                   help="override the checkpoint's transform.json size")
    p.add_argument("--replicas", type=int, default=2,
                   help="serve worker subprocesses to supervise")
    p.add_argument("--devices", type=int, default=None,
                   help="host accelerator count to partition across "
                        "replicas — SET THIS on multi-card hosts or "
                        "cards beyond one-per-replica sit idle (and "
                        "--replicas beyond the real card count pins "
                        "replicas to nonexistent ordinals; several "
                        "replicas on one card: --devices 1). Default: "
                        "one ordinal per replica. Not auto-detected: "
                        "initializing CUDA in the router process would "
                        "put a context on the cards the replicas need.")
    p.add_argument("--device", default="cuda",
                   help="the replicas' torch device (default cuda, each "
                        "replica on its CUDA_VISIBLE_DEVICES partition; "
                        "'cpu' runs the kernels' plain PyTorch versions)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7878,
                   help="router listen port (0 = OS-assigned)")
    p.add_argument("--buckets", default=None,
                   help="replica bucket ladder (serve CLI --buckets)")
    p.add_argument("--max-wait-us", type=int, default=None,
                   help="replica micro-batch coalescing window")
    p.add_argument("--max-queue", type=int, default=None,
                   help="per-replica admission bound")
    p.add_argument("--policy", default="affinity",
                   choices=sorted(POLICIES),
                   help="replica selection policy")
    p.add_argument("--max-retries", type=int, default=2,
                   help="re-dispatches after a replica dies "
                        "mid-request")
    p.add_argument("--max-inflight", type=int, default=1024,
                   help="fleet-level admission bound; beyond it "
                        "requests get QueueFullError backpressure")
    p.add_argument("--stale-after-s", type=float, default=3.0,
                   help="a replica silent longer than this is down "
                        "(router stops routing to it)")
    p.add_argument("--health-interval-s", type=float, default=0.5,
                   help="::stats health-poll cadence")
    p.add_argument("--swap-warm-timeout-s", type=float, default=300.0,
                   help="per-replica budget for a ::swap restart to "
                        "report the full warm ladder before rollback")
    p.add_argument("--swap-probe", default=None, metavar="IMAGE",
                   help="probe image for ::swap re-admission: a "
                        "child process on the first replica's devices "
                        "computes the new checkpoint's predict_image "
                        "softmax row and each swapped replica must "
                        "answer ::probs "
                        "with it BIT-FOR-BIT before taking traffic "
                        "(without it the gate is health + warm "
                        "ladder only)")
    p.add_argument("--compile-cache-dir", default=None,
                   help="(not ported)")
    p.add_argument("--autoscale", action="store_true",
                   help="run the telemetry-driven autoscaler: replica "
                        "count scales between "
                        "--min-replicas and --max-replicas on queue "
                        "pressure + router latency EMA, with "
                        "hysteresis and cooldown; --replicas is the "
                        "starting size")
    p.add_argument("--min-replicas", type=int, default=None,
                   help="autoscaler floor (default: --replicas)")
    p.add_argument("--max-replicas", type=int, default=None,
                   help="autoscaler ceiling (default: 2x --replicas)")
    p.add_argument("--autoscale-interval-s", type=float, default=1.0,
                   help="autoscaler observe/decide cadence")
    p.add_argument("--autoscale-up-load", type=float, default=4.0,
                   help="scale-up threshold: queued+in-flight requests "
                        "per up-replica")
    p.add_argument("--autoscale-down-load", type=float, default=1.0,
                   help="scale-down threshold (must be < the up "
                        "threshold: the gap is the hysteresis band)")
    p.add_argument("--autoscale-slo-ms", type=float, default=None,
                   help="optional latency trigger: scale up when the "
                        "router's client-observed EMA exceeds this")
    p.add_argument("--autoscale-cooldown-s", type=float, default=8.0,
                   help="hold after any scaling action")
    p.add_argument("--cascade", default=None, metavar="CASCADE_JSON",
                   help="serve as a speculative two-tier cascade: "
                        "--checkpoint/--preset become the STUDENT "
                        "tier, --cascade-teacher the escalation tier, "
                        "and every classifier request speculates on a "
                        "student replica — rows whose top-1/top-2 "
                        "margin is at or below the calibrated "
                        "threshold in this cascade.json re-ask a "
                        "teacher replica")
    p.add_argument("--cascade-teacher", default=None, metavar="CKPT",
                   help="teacher-tier checkpoint (required with "
                        "--cascade)")
    p.add_argument("--cascade-teacher-preset", default="ViT-B/16",
                   help="teacher-tier model preset")
    p.add_argument("--cascade-teacher-replicas", type=int, default=1,
                   help="teacher-tier replica count (the whole point "
                        "is needing FEWER of these than students)")
    p.add_argument("--cascade-teacher-buckets", default=None,
                   help="teacher replica bucket ladder (default: "
                        "--buckets)")
    p.add_argument("--deploy-watch", default=None, metavar="CKPT_DIR",
                   help="(not ported)")
    p.add_argument("--ship-to", default=None, metavar="HOST:PORT",
                   help="push router telemetry frames to a fleet "
                        "aggregator (role 'router')")
    p.add_argument("--ship-interval-s", type=float, default=2.0,
                   help="shipper cadence for --ship-to")
    p.add_argument("--worker-id", default=None,
                   help="identity in the fleet view (default "
                        "router-<host>-<pid>)")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    """Parse ``argv`` and refuse what the fleet cannot run, before any
    replica is spawned."""
    p = build_parser()
    args = p.parse_args(argv)
    for dest, item in NOT_PORTED.items():
        if getattr(args, dest) != p.get_default(dest):
            flag = "--" + dest.replace("_", "-")
            raise SystemExit(f"{flag} is not yet ported (ROADMAP Queue 1 "
                             f"item {item})")
    if args.replicas < 1:
        raise SystemExit("--replicas must be >= 1")
    if bool(args.cascade) != bool(args.cascade_teacher):
        raise SystemExit("--cascade and --cascade-teacher go together "
                         "(the config names the threshold, the "
                         "checkpoint names the tier)")
    if args.cascade:
        if args.cascade_teacher_replicas < 1:
            raise SystemExit("--cascade-teacher-replicas must be >= 1")
        if args.autoscale:
            raise SystemExit(
                "--cascade cannot combine with --autoscale yet: it "
                "clones replica specs with no notion of which TIER to "
                "grow")
    if args.ship_to:
        from ...telemetry.shipper import parse_address
        try:
            parse_address(args.ship_to)
        except ValueError as e:
            raise SystemExit(f"--ship-to: {e}")
    if not args.autoscale and (args.min_replicas is not None
                               or args.max_replicas is not None):
        raise SystemExit("--min-replicas/--max-replicas need "
                         "--autoscale")
    return args


@dataclasses.dataclass
class Fleet:
    """What :func:`build_fleet` assembles; nothing is started yet."""

    manager: ReplicaManager
    router: FleetRouter
    specs: List[ReplicaSpec]
    autoscaler: Optional[object] = None


def build_fleet(args: argparse.Namespace, *,
                replica_extra: Sequence[str] = ()) -> Fleet:
    """The replica manager, the router (a :class:`CascadeRouter` with
    ``--cascade``), its ``::swap`` hook and the autoscaler that ``args``
    (from :func:`parse_args`) describe. ``replica_extra`` is appended to
    every replica's serve-CLI argv, and each spec's ``extra_args`` after
    it, for an embedder that wants its replicas' own sinks (the CLI
    passes none)."""
    # Replicas take --classes-file only (their argv must not re-parse
    # a greedy --classes list); names given inline land in a temp file.
    if args.classes_file:
        from ...predictions import load_class_names
        classes = load_class_names(args.classes_file)
        classes_file = args.classes_file
    else:
        classes = list(args.classes)
        tf = tempfile.NamedTemporaryFile(
            "w", prefix="fleet_classes_", suffix=".txt", delete=False)
        tf.write("\n".join(args.classes) + "\n")
        tf.close()
        classes_file = tf.name

    n_teachers = args.cascade_teacher_replicas if args.cascade else 0
    n_total = args.replicas + n_teachers
    if args.devices is not None:
        n_devices = args.devices
    else:
        n_devices = n_total
        print(f"[fleet] --devices not set: assuming one device per "
              f"replica (ordinals 0..{n_total - 1}); pass "
              f"--devices <host chip count> to partition a bigger "
              f"host", file=sys.stderr)
    partitions = partition_devices(n_devices, n_total)
    if args.cascade:
        # A MIXED fleet: student replicas carry the model="student"
        # tag, teachers model="teacher" — the router's hard filter is
        # what keeps speculation and escalation on the right tier.
        specs = [ReplicaSpec(rid=f"s{i}", checkpoint=args.checkpoint,
                             devices=part, model="student")
                 for i, part in enumerate(partitions[:args.replicas])]
        specs += [ReplicaSpec(rid=f"t{i}",
                              checkpoint=args.cascade_teacher,
                              devices=part, model="teacher")
                  for i, part in
                  enumerate(partitions[args.replicas:])]
    else:
        specs = [ReplicaSpec(rid=f"r{i}", checkpoint=args.checkpoint,
                             devices=part)
                 for i, part in enumerate(partitions)]
    student_factory = functools.partial(
        build_serve_command, classes_file=classes_file,
        preset=args.preset, image_size=args.image_size,
        buckets=args.buckets, max_wait_us=args.max_wait_us,
        max_queue=args.max_queue, device=args.device, extra=replica_extra)
    if args.cascade:
        teacher_factory = functools.partial(
            build_serve_command, classes_file=classes_file,
            preset=args.cascade_teacher_preset,
            image_size=args.image_size,
            buckets=args.cascade_teacher_buckets or args.buckets,
            max_wait_us=args.max_wait_us, max_queue=args.max_queue,
            device=args.device, extra=replica_extra)

        def command_factory(spec):
            return (teacher_factory(spec) if spec.model == "teacher"
                    else student_factory(spec))
    else:
        command_factory = student_factory
    # Without --buckets the replicas warm the serve default ladder —
    # the swap re-admission gate must expect exactly that set, not
    # degrade to health-only (a swapped-in replica taking traffic on
    # cold rungs is the p99 blowout the gate exists to prevent). A
    # cascade fleet's two tiers may warm DIFFERENT ladders, so the
    # fleet-wide expectation is off there (::swap is refused on a
    # cascade fleet anyway, below).
    from ..bucketing import DEFAULT_BUCKETS
    expected = (tuple(int(b) for b in args.buckets.split(",")
                      if b.strip())
                if args.buckets else DEFAULT_BUCKETS)
    manager = ReplicaManager(
        specs, command_factory=command_factory,
        env_factory=lambda spec: replica_env(spec.devices),
        health_interval_s=args.health_interval_s,
        stale_after_s=args.stale_after_s,
        expected_rungs=None if args.cascade else expected)
    if args.cascade:
        from ..cascade import CascadeRouter
        router = CascadeRouter.from_config(
            manager, args.cascade, host=args.host, port=args.port,
            policy=make_policy(args.policy),
            max_retries=args.max_retries,
            max_inflight=args.max_inflight)
    else:
        router = FleetRouter(
            manager, host=args.host, port=args.port,
            policy=make_policy(args.policy),
            max_retries=args.max_retries,
            max_inflight=args.max_inflight)

    swap_state = {"thread": None, "lock": threading.Lock()}

    def on_swap(checkpoint: str) -> dict:
        if args.cascade:
            return {"error": "::swap is not tier-aware on a cascade "
                             "fleet yet: a rolling swap would point "
                             "BOTH tiers at one checkpoint (restart "
                             "the fleet to change either tier)"}
        if not Path(checkpoint).exists():
            return {"error": f"checkpoint {checkpoint!r} not found "
                             "on the router host"}
        # check-and-start under one lock: two concurrent ::swap
        # clients must not race two rolling swaps over one fleet
        # (interleaved quiesce/restart = a partly-drained fleet).
        with swap_state["lock"]:
            t = swap_state["thread"]
            if t is not None and t.is_alive():
                return {"error": "a swap is already running; "
                                 "::swap-status to watch it"}

            def run():
                probe = expect = None
                if args.swap_probe:
                    # Reference row for the NEW checkpoint, computed
                    # through the ONE inference-load contract on the
                    # replicas' device — in this thread, not the
                    # command handler (the checkpoint load takes
                    # seconds; the ::swap client already has its ack).
                    try:
                        expect = probe_reference(
                            checkpoint, probe=args.swap_probe,
                            preset=args.preset, classes_file=classes_file,
                            image_size=args.image_size,
                            device=args.device, devices=partitions[0])
                        probe = args.swap_probe
                    except Exception as e:  # noqa: BLE001 — a probe
                        # that can't be computed must fail the swap
                        # LOUDLY, not silently skip the gate.
                        router.note_swap({
                            "checkpoint": checkpoint, "ok": False,
                            "rolled_back": False,
                            "error": f"swap-probe reference failed: "
                                     f"{type(e).__name__}: {e}"})
                        return
                rolling_swap(manager, router, checkpoint,
                             warm_timeout_s=args.swap_warm_timeout_s,
                             probe=probe, expect_probs=expect)

            t = threading.Thread(target=run, name="fleet-swap",
                                 daemon=True)
            swap_state["thread"] = t
            t.start()
        return {"swap": "started", "checkpoint": checkpoint}

    router.on_swap = on_swap

    autoscaler = None
    if args.autoscale:
        from .autoscale import AutoscaleConfig, Autoscaler
        as_cfg = AutoscaleConfig(
            min_replicas=(args.min_replicas if args.min_replicas
                          is not None else args.replicas),
            max_replicas=(args.max_replicas if args.max_replicas
                          is not None else 2 * args.replicas),
            up_load_per_replica=args.autoscale_up_load,
            down_load_per_replica=args.autoscale_down_load,
            up_lat_s=(args.autoscale_slo_ms / 1e3
                      if args.autoscale_slo_ms else None),
            cooldown_s=args.autoscale_cooldown_s,
            interval_s=args.autoscale_interval_s,
            warm_timeout_s=args.swap_warm_timeout_s)
        try:
            as_cfg.validate()
        except ValueError as e:
            raise SystemExit(f"--autoscale: {e}")
        autoscaler = Autoscaler(manager, router, as_cfg)
    return Fleet(manager=manager, router=router, specs=specs,
                 autoscaler=autoscaler)


def main(argv=None) -> int:
    args = parse_args(argv)
    fleet = build_fleet(args)
    manager, router, autoscaler = fleet.manager, fleet.router, \
        fleet.autoscaler
    shipper = None
    try:
        manager.start()
        router.start()
        print(f"[fleet] router listening on {args.host}:{router.port} "
              f"({args.replicas} replicas, policy {args.policy}; "
              f"'::stats' fleet snapshot, '::metrics' Prometheus, "
              f"'::swap <ckpt>' rolling hot-swap)", file=sys.stderr)
        if args.cascade:
            print(f"[fleet] cascade: {args.replicas} student + "
                  f"{args.cascade_teacher_replicas} teacher replicas, escalate below "
                  f"margin {router.threshold:g} (from {args.cascade})",
                  file=sys.stderr)
        if autoscaler is not None:
            autoscaler.start()
            as_cfg = autoscaler.config
            print(f"[fleet] autoscaler: {as_cfg.min_replicas}.."
                  f"{as_cfg.max_replicas} replicas, up past "
                  f"{as_cfg.up_load_per_replica:g} load/replica, down "
                  f"under {as_cfg.down_load_per_replica:g}, cooldown "
                  f"{as_cfg.cooldown_s:g}s", file=sys.stderr)
        if args.ship_to:
            from ...telemetry.shipper import TelemetryShipper
            shipper = TelemetryShipper(
                args.ship_to, worker_id=args.worker_id, role="router",
                interval_s=args.ship_interval_s,
                pre_ship=router.publish_telemetry)
            shipper.start()
            print(f"[fleet] telemetry shipper: {shipper.worker_id} "
                  f"-> {args.ship_to} every {args.ship_interval_s:g}s",
                  file=sys.stderr)
        ready = manager.wait_ready()
        print(f"[fleet] replicas ready: {ready} "
              f"({json.dumps({v.rid: v.up for v in manager.views()})})",
              file=sys.stderr)
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        if autoscaler is not None:
            autoscaler.close()
        if shipper is not None:
            shipper.close()
        print(json.dumps(router.snapshot()), file=sys.stderr)
        router.close()
        manager.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
