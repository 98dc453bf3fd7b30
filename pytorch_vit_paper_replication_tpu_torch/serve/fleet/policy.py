"""Pluggable replica-selection policies for the fleet router.

Port of the JAX package's ``serve/fleet/policy.py`` (the same choice for
the same views). The router asks ONE question per request: "which routable replica
should take this line?". A policy answers it from
:class:`ReplicaView`s — the point-in-time membership the
:class:`..replica.ReplicaManager` health loop maintains — plus the
router's own live in-flight counts (health polls lag by an interval;
the router's counts don't).

The default, :class:`LeastLoadedAffinity`, is least-loaded with
**bucket affinity**: a replica whose ladder rung is warm for the
request keeps receiving that rung's traffic (a cold rung pays its first
forward — and, in the JAX package, a multi-second compile — per
replica), and load (router in-flight + last-polled queue depth) breaks
ties. Affinity is advisory: when no routable replica is warm for the
rung, the request still routes — a cold fleet must serve, not 404.

Model steering rides the same seam but is HARD, not
advisory: a request may declare which model must answer it
(``::model teacher`` / inline ``model=teacher`` — the cascade sends
student traffic to the student tier and escalations to the teacher
tier), and :func:`model_views` narrows candidates to replicas whose
deployment spec declares that model. When none does, the request does
NOT route — answering teacher-tagged traffic from a student would
silently break the cascade's bit-identity contract, so the router
surfaces explicit backpressure instead.
"""

from __future__ import annotations

import threading
from typing import (FrozenSet, List, NamedTuple, Optional, Sequence,
                    Tuple)


class ReplicaView(NamedTuple):
    """Point-in-time routing view of one replica (plain data — the
    policy must stay trivially testable without processes)."""

    rid: str
    address: Optional[Tuple[str, int]]   # None until the child listens
    up: bool                             # health inside stale_after_s
    draining: bool                       # quiesced by the rollout path
    inflight: int                        # router's live request count
    queue_depth: int                     # replica's last-polled queue
    warm_rungs: Tuple[int, ...]          # warmed ladder rungs
    restarts: int
    # Content identity of the checkpoint the replica last reported
    # serving (::stats checkpoint_fingerprint; None until polled, or
    # on pre-fingerprint replicas). The deploy canary judge keys on
    # it: a half-completed rollout is indistinguishable from a healthy
    # mixed fleet without it.
    fingerprint: Optional[str] = None
    # Declared model name from the deployment spec (e.g. "student" /
    # "teacher"; None on untagged replicas). Deployment config, not
    # discovered state: the cascade's bit-identity contract needs the
    # operator's word for which checkpoint is the teacher, and the
    # ``model=`` hard filter keys on this field.
    model: Optional[str] = None

    @property
    def routable(self) -> bool:
        return self.up and not self.draining and self.address is not None


def routable_views(views: Sequence[ReplicaView],
                   exclude: FrozenSet[str] = frozenset()
                   ) -> List[ReplicaView]:
    return [v for v in views if v.routable and v.rid not in exclude]


class RoutingPolicy:
    """Interface: :meth:`choose` returns a replica id or None (nothing
    routable). ``rung`` is the request's bucket-ladder hint (the
    ``::rung N`` protocol affinity, None when the client sent none);
    ``model`` the declared model filter (hard — see
    :func:`model_views`); ``exclude`` carries replicas already tried
    for THIS request (the retry-on-death path must not re-pick the
    replica that just died).
    """

    name = "base"

    def choose(self, views: Sequence[ReplicaView], *,
               rung: Optional[int] = None,
               model: Optional[str] = None,
               exclude: FrozenSet[str] = frozenset()) -> Optional[str]:
        raise NotImplementedError


def model_views(views: Sequence[ReplicaView],
                model: Optional[str]) -> List[ReplicaView]:
    """HARD model filter (contrast the advisory rung affinity): a
    request that declares ``model=M`` may only be answered by a
    replica whose spec declares M. No fallback — a student answering
    teacher-tagged traffic would break the cascade's escalated-rows-
    bit-identical contract silently, which is strictly worse than the
    explicit backpressure the router returns for an empty choice."""
    if model is None:
        return list(views)
    return [v for v in views if v.model == model]


class LeastLoadedAffinity(RoutingPolicy):
    """Bucket affinity first, least-loaded to break ties (see module
    docstring). Deterministic: equal-load candidates order by rid, so
    tests (and incident reconstructions) can predict the choice."""

    name = "affinity"

    @staticmethod
    def _load(v: ReplicaView) -> int:
        return v.inflight + v.queue_depth

    def choose(self, views: Sequence[ReplicaView], *,
               rung: Optional[int] = None,
               model: Optional[str] = None,
               exclude: FrozenSet[str] = frozenset()) -> Optional[str]:
        candidates = model_views(routable_views(views, exclude), model)
        if not candidates:
            return None
        if rung is not None:
            warm = [v for v in candidates if int(rung) in v.warm_rungs]
            if warm:
                candidates = warm
        return min(candidates, key=lambda v: (self._load(v), v.rid)).rid


class RoundRobin(RoutingPolicy):
    """Strict rotation over routable replicas — the control policy a
    load run compares affinity against, and proof the policy seam is real.
    Ignores the rung hint by design; the model filter still applies
    (``model=`` names which MODEL must answer — every policy honors
    it, only load/affinity heuristics are pluggable)."""

    name = "round-robin"

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._next = 0

    def choose(self, views: Sequence[ReplicaView], *,
               rung: Optional[int] = None,
               model: Optional[str] = None,
               exclude: FrozenSet[str] = frozenset()) -> Optional[str]:
        candidates = sorted(
            model_views(routable_views(views, exclude), model),
            key=lambda v: v.rid)
        if not candidates:
            return None
        with self._lock:
            chosen = candidates[self._next % len(candidates)]
            self._next += 1
        return chosen.rid


POLICIES = {LeastLoadedAffinity.name: LeastLoadedAffinity,
            RoundRobin.name: RoundRobin}


def make_policy(name: str) -> RoutingPolicy:
    try:
        return POLICIES[name]()
    except KeyError:
        raise ValueError(
            f"unknown routing policy {name!r}; valid: "
            f"{', '.join(sorted(POLICIES))}") from None
