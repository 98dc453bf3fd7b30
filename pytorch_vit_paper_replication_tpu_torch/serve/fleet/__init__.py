"""Multi-replica serving fleet: one front door over N engines.

Port of the JAX package's ``serve/fleet/``. ``serve/`` is one process;
a fleet is N of them behind one address that survives any single
replica's death or checkpoint swap:

* :mod:`.policy` — pluggable replica selection:
  :class:`LeastLoadedAffinity` (least-loaded with **bucket affinity**
  — a replica warm for a ladder rung keeps receiving that rung's
  traffic) and :class:`RoundRobin`; :class:`ReplicaView` is the
  plain-data membership contract between the manager and the policy.
* :mod:`.replica` — :class:`ReplicaManager`: spawn N port serve-CLI
  worker subprocesses (devices partitioned per replica and exported as
  ``CUDA_VISIBLE_DEVICES``, :func:`partition_devices`/
  :func:`replica_env`), health-check them through ``::stats`` round
  trips + process liveness, mark them down within ``stale_after_s``,
  and restart the dead with exponential backoff.
* :mod:`.router` — :class:`FleetRouter`: the front door. Speaks the
  serve CLI's exact line protocol, admission-controls fleet-wide with
  the same ``QueueFullError``-shaped backpressure a single replica
  produces, and re-dispatches on replica death — bounded retries,
  never to a replica already tried, and every client request answered
  exactly once.
* :mod:`.autoscale` — :class:`Autoscaler`: a telemetry-driven control
  loop that grows and shrinks the replica set on signals the fleet
  already publishes (queue pressure, the router's latency EMA,
  warm-rung coverage), with hysteresis + debounce + cooldown
  (:class:`AutoscaleDecider`, a pure state machine), scale-up admitted
  only behind the warm gate, and scale-down drained through the
  health-gated membership path so in-flight requests are never reset.
* :mod:`.rollout` — :func:`rolling_swap`: zero-downtime checkpoint
  hot-swap. Quiesce one replica (router stops routing, its
  ``MicroBatcher.drain`` flushes), restart it onto the new checkpoint,
  re-admit only after health + a warm-rung report covering the ladder
  (+ optional bit-identity ``::probs`` probe), replica by replica —
  with automatic rollback when the new checkpoint fails.

CLI: ``python -m pytorch_vit_paper_replication_tpu_torch.serve.fleet``
(spawns the replicas, serves the router, accepts ``::swap <ckpt>``).
The router process imports no device library state: it never creates a
CUDA context, so the card belongs to the replicas.
"""

from .autoscale import (AutoscaleConfig, AutoscaleDecider,
                        AutoscaleSignals, Autoscaler, Decision)
from .policy import (POLICIES, LeastLoadedAffinity, ReplicaView,
                     RoundRobin, RoutingPolicy, make_policy)
from .replica import (ReplicaManager, ReplicaSpec, build_serve_command,
                      partition_devices, replica_env)
from .rollout import probe_matches, rolling_swap
from .router import FleetRouter, backpressure_reply, is_backpressure

__all__ = [
    "POLICIES", "LeastLoadedAffinity", "ReplicaView", "RoundRobin",
    "RoutingPolicy", "make_policy", "ReplicaManager", "ReplicaSpec",
    "build_serve_command", "partition_devices", "replica_env",
    "probe_matches", "rolling_swap", "FleetRouter",
    "backpressure_reply", "is_backpressure",
    "AutoscaleConfig", "AutoscaleDecider", "AutoscaleSignals",
    "Autoscaler", "Decision",
]
