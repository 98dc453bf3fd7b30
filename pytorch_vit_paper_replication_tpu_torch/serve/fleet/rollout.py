"""Zero-downtime rolling checkpoint hot-swap, replica by replica.

Port of the JAX package's ``serve/fleet/rollout.py``. Restarting a
replica (its kernels already built, its warmup manifest next to the
checkpoint) takes seconds, so the fleet can roll onto a new checkpoint
one replica at a time while the survivors keep answering. Per replica:

1. **quiesce** — the router stops selecting it
   (:meth:`..replica.ReplicaManager.quiesce`), its in-flight routed
   requests finish (bounded wait on the router's live count), and its
   ``MicroBatcher`` drains via the ``::drain`` protocol command (new
   submits refused with ``DrainingError`` backpressure — the router
   re-dispatches any straggler to a survivor);
2. **restart** — the process stops and respawns onto the new
   checkpoint (the spec keeps it: later supervised restarts boot the
   new checkpoint too), through the new checkpoint's warmup manifest;
3. **re-admission gate** — the replica is routed to again only after
   its health answers AND its warm-rung report covers the expected
   ladder (``ReplicaManager.expected_rungs``), and — when a probe is
   configured — after it answers ``::probs`` with EXACTLY the expected
   float32 softmax row for the new checkpoint (bit-identity, the
   serve-vs-``predict_image`` contract, now enforced across the swap);
4. **rollback** — if the new checkpoint fails warmup, health, or the
   probe, the replica restarts back onto its old checkpoint, every
   already-swapped replica is rolled back the same quiesced way, and
   the report says so. A fleet stuck half-new is worse than a fleet
   that refused the checkpoint.

``fleet_swap_*`` instruments ride the shared registry; the report dict
is what ``::swap-status`` answers.
"""

from __future__ import annotations

import json
import time
from typing import List, Optional, Sequence

import numpy as np

from ...telemetry.registry import TelemetryRegistry, get_registry
from .replica import ReplicaManager
from .router import FleetRouter


def probe_matches(manager: ReplicaManager, rid: str, probe: str,
                  expect_probs: Optional[np.ndarray], *,
                  timeout_s: float = 60.0) -> dict:
    """``::probs`` the replica and compare bit-exactly against the
    expected float32 row. Returns ``{"matched": bool, ...detail}``;
    never raises (a dead replica is a failed probe, not a traceback).
    """
    try:
        reply = json.loads(manager.request(
            rid, f"::probs {probe}", timeout_s=timeout_s))
    except (OSError, ValueError) as e:
        return {"matched": False, "error": f"{type(e).__name__}: {e}"}
    if "error" in reply:
        return {"matched": False, "error": reply["error"]}
    got = np.asarray(reply.get("probs", []), np.float32)
    if expect_probs is None:
        return {"matched": bool(got.size), "label": reply.get("label")}
    want = np.asarray(expect_probs, np.float32)
    matched = got.shape == want.shape and bool(
        np.array_equal(got, want))
    out = {"matched": matched, "label": reply.get("label")}
    if not matched:
        out["max_abs_diff"] = (
            float(np.max(np.abs(got - want)))
            if got.shape == want.shape else None)
    return out


def _wait_inflight_zero(router: FleetRouter, rid: str,
                        timeout_s: float) -> int:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        n = router.inflight(rid)
        if n == 0:
            return 0
        time.sleep(0.02)
    return router.inflight(rid)


def _swap_one(manager: ReplicaManager, router: FleetRouter, rid: str,
              checkpoint: str, *, drain_timeout_s: float,
              warm_timeout_s: float, probe: Optional[str],
              expect_probs: Optional[np.ndarray],
              reg: TelemetryRegistry) -> dict:
    """Quiesce → drain → restart-on-checkpoint → health+warm+probe
    gate → readmit. Returns the per-replica record; ``"ok"`` False
    leaves the replica QUIESCED and stopped-or-sick for the caller's
    rollback."""
    t0 = time.monotonic()
    record: dict = {"rid": rid, "from": manager.checkpoint_of(rid),
                    "to": checkpoint}
    manager.quiesce(rid)
    record["inflight_at_quiesce"] = router.inflight(rid)
    record["inflight_leftover"] = _wait_inflight_zero(
        router, rid, drain_timeout_s)
    record["drain_unfinished"] = manager.drain_replica(
        rid, drain_timeout_s)
    manager.stop_replica(rid)
    manager.start_replica(rid, checkpoint=checkpoint)
    healthy = manager.wait_healthy(
        rid, warm_timeout_s, require_rungs=manager.expected_rungs)
    record["healthy"] = healthy
    if healthy and probe is not None:
        record["probe"] = probe_matches(
            manager, rid, probe, expect_probs,
            timeout_s=warm_timeout_s)
        healthy = record["probe"]["matched"]
    record["seconds"] = round(time.monotonic() - t0, 3)
    record["ok"] = bool(healthy)
    if healthy:
        manager.readmit(rid)
        reg.gauge("fleet_swap_last_s", record["seconds"])
    return record


def rolling_swap(manager: ReplicaManager, router: FleetRouter,
                 checkpoint: str, *,
                 drain_timeout_s: float = 15.0,
                 warm_timeout_s: float = 180.0,
                 probe: Optional[str] = None,
                 expect_probs: Optional[np.ndarray] = None,
                 rollback: bool = True,
                 rids: Optional[Sequence[str]] = None,
                 registry: Optional[TelemetryRegistry] = None) -> dict:
    """Roll the fleet onto ``checkpoint``, one replica at a time (see
    module docstring). Returns the swap report (JSON-serializable).

    ``probe``/``expect_probs``: an image path plus the new
    checkpoint's expected float32 softmax row — each swapped replica
    must answer it bit-identically before re-admission.
    ``rollback=False`` stops at the first failure instead of restoring
    (debugging a bad checkpoint in place — the failed replica stays
    deliberately quiesced until ``manager.readmit(rid)``).
    """
    reg = registry if registry is not None else get_registry()
    order = list(rids) if rids is not None else manager.replica_ids()
    t0 = time.monotonic()
    report: dict = {"checkpoint": checkpoint, "replicas": [],
                    "swapped": [], "ok": False, "rolled_back": False,
                    "error": None}
    reg.gauge("fleet_swap_active", 1)
    try:
        old_checkpoints = {rid: manager.checkpoint_of(rid)
                           for rid in order}
        for rid in order:
            record = _swap_one(
                manager, router, rid, checkpoint,
                drain_timeout_s=drain_timeout_s,
                warm_timeout_s=warm_timeout_s,
                probe=probe, expect_probs=expect_probs, reg=reg)
            report["replicas"].append(record)
            if not record["ok"]:
                reg.count("fleet_swap_failures_total")
                report["error"] = (
                    f"replica {rid} failed to come up healthy on "
                    f"{checkpoint} (see its record)")
                if rollback:
                    report["rolled_back"] = True
                    reg.count("fleet_swap_rollbacks_total")
                    _roll_back(manager, router, report["swapped"],
                               rid, old_checkpoints,
                               drain_timeout_s=drain_timeout_s,
                               warm_timeout_s=warm_timeout_s,
                               report=report)
                return report
            report["swapped"].append(rid)
        report["ok"] = True
        reg.count("fleet_swaps_total")
        return report
    finally:
        reg.gauge("fleet_swap_active", 0)
        report["wall_s"] = round(time.monotonic() - t0, 3)
        router.note_swap(report)


def _roll_back(manager: ReplicaManager, router: FleetRouter,
               swapped: List[str], failed_rid: str,
               old_checkpoints: dict, *, drain_timeout_s: float,
               warm_timeout_s: float, report: dict) -> None:
    """Restore the failed replica AND every already-swapped one onto
    their old checkpoints (a half-new fleet serves two models at
    once — that is an outage with extra steps). Best-effort: a
    replica that won't come back on the OLD checkpoint stays down and
    supervised; the report records each restore."""
    restores = report.setdefault("restores", [])
    # The failed replica first (it is already quiesced and stopped).
    for rid in [failed_rid] + list(reversed(swapped)):
        old = old_checkpoints[rid]
        rec: dict = {"rid": rid, "to": old}
        if rid != failed_rid:
            manager.quiesce(rid)
            _wait_inflight_zero(router, rid, drain_timeout_s)
            manager.drain_replica(rid, drain_timeout_s)
            manager.stop_replica(rid)
        manager.start_replica(rid, checkpoint=old)
        rec["healthy"] = manager.wait_healthy(
            rid, warm_timeout_s, require_rungs=manager.expected_rungs)
        # Readmit UNCONDITIONALLY: after the restore, there is no
        # deliberate exclusion left — a still-cold replica is already
        # unroutable via up=False, and the supervised restart path
        # will bring it back. Leaving `draining` set would strand a
        # healthy replica out of the fleet forever (nothing but
        # readmit clears it).
        manager.readmit(rid)
        restores.append(rec)
