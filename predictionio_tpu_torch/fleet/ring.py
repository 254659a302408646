"""Consistent-hash ring for scope→replica affinity.

Counterpart of ``predictionio_tpu/fleet/ring.py``, a copy: both
packages build the same ring from the same members.

Why consistent hashing and not round-robin: the query server's result
cache is per-process. Behind a round-robin balancer every replica
ends up caching the same hot scopes — R copies of one working set, and a
cache hit rate divided by R for the long tail. Hashing the *cache scope*
(the query's ``user`` field; see ``serving.cache.affinity_key``) pins
each scope to one replica, so the fleet's aggregate cache is the UNION
of the replicas' caches, and event-driven invalidations for a scope only
need to reach the replica that owns it (the router still broadcasts —
delivery is cheap and the broadcast is idempotent — but correctness only
depends on the owner).

Why a *ring* and not ``hash(key) % R``: modulo remaps ~every key when R
changes; the ring with virtual nodes remaps only ~1/R of keys when one
replica joins or leaves (asserted in tests/test_fleet_router.py), so a
replica kill or a rolling restart doesn't flush the whole fleet's cache
affinity.

Stdlib-only, deterministic (``blake2b``), no randomness: the same
member set always builds the same ring, so a restarted router routes
identically.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Iterable, Sequence

__all__ = ["HashRing"]


def _point(data: str) -> int:
    return int.from_bytes(
        hashlib.blake2b(data.encode(), digest_size=8).digest(), "big"
    )


class HashRing:
    """Immutable consistent-hash ring over replica ids.

    ``vnodes`` virtual points per member smooth the load split (64 keeps
    the max/min scope share within ~20% for small fleets). Build cost is
    O(R·vnodes·log); lookups are a binary search.
    """

    def __init__(self, members: Iterable[str], vnodes: int = 64):
        self.members: tuple[str, ...] = tuple(dict.fromkeys(members))
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.vnodes = vnodes
        points: list[tuple[int, str]] = []
        for member in self.members:
            for v in range(vnodes):
                points.append((_point(f"{member}#{v}"), member))
        points.sort()
        self._points = [p for p, _ in points]
        self._owners = [m for _, m in points]

    def owner(self, key: str) -> str | None:
        """The member owning ``key``, or None for an empty ring."""
        seq = self.sequence(key, limit=1)
        return seq[0] if seq else None

    def sequence(self, key: str, limit: int | None = None) -> Sequence[str]:
        """Distinct members in ring order starting at ``key``'s point —
        the failover preference order: element 0 is the owner, element 1
        the first fallback, and so on. Every member appears exactly once."""
        if not self.members:
            return []
        limit = len(self.members) if limit is None else min(limit, len(self.members))
        idx = bisect.bisect_left(self._points, _point(key))
        seen: dict[str, None] = {}
        n = len(self._owners)
        for step in range(n):
            m = self._owners[(idx + step) % n]
            if m not in seen:
                seen[m] = None
                if len(seen) >= limit:
                    break
        return list(seen)
