"""Shared-filesystem fleet registries: model generations and endpoints.

Two ledgers live here, both plain JSON on a filesystem every fleet host
mounts (the same sharedfs idiom as the storage layer's ``TYPE=sharedfs``
backend), both readable with nothing installed:

* :class:`ModelRegistry` — ONE document answering "which model should
  every replica be serving?" (generation-stamped, atomic rename).
* :class:`EndpointRegistry` — a DIRECTORY of per-replica entry files
  answering "which replicas exist right now, and where?". Replicas bind
  port 0, then announce their *actually bound* address here (closing the
  pick-then-spawn loopback TOCTOU for good: nothing ever picks a port it
  has not already bound), and keep the entry alive with heartbeat
  leases. Routers on ANY host reconcile their consistent-hash ring from
  the live entries; an entry whose lease expired is **evicted exactly
  once** across however many routers share the directory (atomic
  rename-claim), so an HA router pair never double-counts a membership
  change. Torn or unparsable entry files are surfaced as loud
  ``problems``, never silently skipped.

A fleet needs one answer to "which model should every replica be
serving?". Each replica's in-process reload counter says where *that
process* is; the registry says where the *fleet* should converge:

* ``publish(instance_id)`` — stamp a new fleet generation pointing at a
  trained engine instance. Atomic (tmp + fsync + rename) so a reader
  never sees a torn record; the generation counter is monotonic even
  across concurrent publishers (last writer wins the pointer, but never
  reuses a generation number).
* ``current()`` — the record replicas/routers/operators gate on.
* ``history()`` — recent generations, newest first (bounded), so a
  rollback target is always one read away.

The router's rolling ``/reload`` stamps the registry before rotating
replicas, then verifies every replica reports the fleet generation on
``/readyz`` — "rollout complete" is a registry⇄fleet convergence check,
not a hope (docs/operations.md, fleet runbook).

Stdlib-only by contract: the registry must be readable from the router,
``pio status``, and CI hosts with nothing installed.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import hashlib
import json
import os
import shutil
import tempfile
import time
from typing import Any

__all__ = [
    "AOT_MANIFEST_NAME",
    "EndpointRecord",
    "EndpointRegistry",
    "ModelRegistry",
    "RegistryRecord",
    "aot_artifact_dir",
    "read_aot_manifest",
    "verify_aot_artifacts",
]

_HISTORY_LIMIT = 50


def _fsync_dir(directory: str) -> None:
    """Make a just-renamed directory entry durable: without this, the
    rename itself lives only in the page cache and a crash can forget
    the file ever had its new name (PIO502)."""
    fd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


# ---------------------------------------------------------------------------
# AOT artifact schema (read side — stdlib by contract)
# ---------------------------------------------------------------------------
#
# ``pio train --aot`` (``workflow/aot.py``, the write side) serializes
# each generation's serving programs into ``<root>/<instance>/`` beside a
# ``manifest.json`` carrying the environment fingerprint and per-blob
# SHA-256 + byte-size records. The READ side lives here because the
# consumers that gate on artifact readiness — the router's rolling-reload
# gate, ``pio status`` — are stdlib-only by manifest: presence, parse,
# size, and digest checks need hashlib+json, nothing more. Fingerprint
# MATCHING against the live environment is the replica's job at
# load time; a reader here only
# reports the manifest's fingerprint for display/compare.

AOT_MANIFEST_NAME = "manifest.json"


def aot_artifact_dir(root: str, engine_instance_id: str) -> str:
    """``<root>/<instance>`` through a character allow-list, so an
    adversarial instance id cannot escape the artifact root (same
    contract as endpoint entry filenames)."""
    safe = "".join(
        c if c.isalnum() or c in "._-" else "_" for c in engine_instance_id
    )[:128]
    if not safe:
        raise ValueError(f"unusable engine instance id {engine_instance_id!r}")
    return os.path.join(root, safe)


def read_aot_manifest(instance_dir: str) -> dict | None:
    """The artifact manifest, or None when absent/torn."""
    try:
        with open(os.path.join(instance_dir, AOT_MANIFEST_NAME)) as f:
            doc = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError, OSError):
        return None
    return doc if isinstance(doc, dict) else None


def verify_aot_artifacts(instance_dir: str, deep: bool = True) -> dict:
    """Pure-stdlib readiness check of one artifact directory: manifest
    present + parseable, every blob present with the manifested size,
    and (``deep``) a matching SHA-256. Returns ``{"ok": bool,
    "problems": [...], "programs": N, "bytes": N, "fingerprint": {...}}``."""
    problems: list[str] = []
    manifest = read_aot_manifest(instance_dir)
    if manifest is None:
        return {
            "ok": False,
            "problems": [f"missing or torn {AOT_MANIFEST_NAME}"],
            "programs": 0,
            "bytes": 0,
            "fingerprint": None,
        }
    total = 0
    entries = manifest.get("entries", [])
    for entry in entries:
        path = os.path.join(instance_dir, entry.get("file", ""))
        try:
            size = os.path.getsize(path)
        except OSError:
            problems.append(f"missing blob {entry.get('file')}")
            continue
        if size != entry.get("bytes"):
            problems.append(
                f"size mismatch {entry.get('file')}: "
                f"{size} != {entry.get('bytes')}"
            )
            continue
        if deep:
            h = hashlib.sha256()
            try:
                with open(path, "rb") as f:
                    for chunk in iter(lambda: f.read(1 << 20), b""):
                        h.update(chunk)
            except OSError as e:
                problems.append(f"unreadable blob {entry.get('file')}: {e}")
                continue
            if h.hexdigest() != entry.get("sha256"):
                problems.append(f"digest mismatch {entry.get('file')}")
                continue
        total += size
    if not entries:
        problems.append("manifest lists no programs")
    return {
        "ok": not problems,
        "problems": problems,
        "programs": len(entries),
        "bytes": total,
        "fingerprint": manifest.get("fingerprint"),
    }


@dataclasses.dataclass(frozen=True)
class RegistryRecord:
    """One published fleet generation."""

    generation: int
    engine_instance_id: str
    published_at: str  # ISO-8601 UTC
    meta: dict | None = None
    #: AOT artifact stamp (``pio train --aot``): ``{"dir", "programs",
    #: "bytes", "fingerprint"}`` — the router's rolling gate and `pio
    #: status` verify readiness against this; None = generation published
    #: without AOT (replicas serve through the JIT path)
    artifacts: dict | None = None

    def to_json(self) -> dict:
        out: dict[str, Any] = {
            "generation": self.generation,
            "engineInstanceId": self.engine_instance_id,
            "publishedAt": self.published_at,
        }
        if self.meta:
            out["meta"] = dict(self.meta)
        if self.artifacts:
            out["artifacts"] = dict(self.artifacts)
        return out

    @staticmethod
    def from_json(d: dict) -> "RegistryRecord":
        return RegistryRecord(
            generation=int(d["generation"]),
            engine_instance_id=str(d["engineInstanceId"]),
            published_at=str(d.get("publishedAt", "")),
            meta=d.get("meta"),
            artifacts=d.get("artifacts"),
        )


class ModelRegistry:
    """The fleet's model-generation ledger at ``<dir>/model-registry.json``."""

    def __init__(self, directory: str):
        self.directory = directory
        self.path = os.path.join(directory, "model-registry.json")

    # --------------------------------------------------------------- read
    def _load(self) -> dict:
        try:
            with open(self.path) as f:
                doc = json.load(f)
        except FileNotFoundError:
            return {"current": None, "history": []}
        except (json.JSONDecodeError, OSError):
            # a torn read can only happen if rename atomicity was violated
            # (non-POSIX mount): treat as empty rather than wedging the
            # fleet on a parse error; the next publish rewrites it whole
            return {"current": None, "history": []}
        if not isinstance(doc, dict):
            return {"current": None, "history": []}
        return doc

    def current(self) -> RegistryRecord | None:
        cur = self._load().get("current")
        if not isinstance(cur, dict):
            return None
        try:
            return RegistryRecord.from_json(cur)
        except (KeyError, ValueError, TypeError):
            return None

    def history(self) -> list[RegistryRecord]:
        out = []
        for d in self._load().get("history", []):
            try:
                out.append(RegistryRecord.from_json(d))
            except (KeyError, ValueError, TypeError):
                continue
        return out

    # -------------------------------------------------------------- write
    def publish(
        self,
        engine_instance_id: str,
        meta: dict | None = None,
        artifacts: dict | None = None,
    ) -> RegistryRecord:
        """Stamp the next fleet generation. Atomic rename; fsync'd so an
        acked publish survives a host crash (same durability contract as
        the model blobs it points at).

        ``artifacts`` (``pio train --aot``) stamps the generation's AOT
        artifact set — ``{"dir", "programs", "bytes", "fingerprint"}`` —
        beside the instance pointer. A re-publish of an instance whose
        artifacts are already on file (e.g. the router's post-rotation
        publish) inherits the newest prior stamp automatically, so
        rolling swaps never orphan a live artifact set.

        Artifact GC rides every publish: the bounded history is the ONLY
        thing keeping artifact blobs alive, so generations evicted off
        its tail take their artifact directories with them (unless a
        surviving generation still references the same dir) — repeated
        rolling swaps cannot grow the artifact root without bound."""
        doc = self._load()
        prev = doc.get("current") or {}
        generation = int(prev.get("generation", 0)) + 1
        if artifacts is None:
            # inherit the newest prior stamp for this instance
            for d in [prev] + list(doc.get("history", [])):
                if (
                    isinstance(d, dict)
                    and d.get("engineInstanceId") == engine_instance_id
                    and d.get("artifacts")
                ):
                    artifacts = dict(d["artifacts"])
                    break
        record = RegistryRecord(
            generation=generation,
            engine_instance_id=engine_instance_id,
            published_at=_dt.datetime.now(_dt.timezone.utc).isoformat(),
            meta=meta,
            artifacts=artifacts,
        )
        history = [record.to_json()] + list(doc.get("history", []))
        kept, evicted = history[:_HISTORY_LIMIT], history[_HISTORY_LIMIT:]
        new_doc = {
            "current": record.to_json(),
            "history": kept,
        }
        os.makedirs(self.directory, exist_ok=True)
        fd, tmp = tempfile.mkstemp(
            prefix=".model-registry.", suffix=".tmp", dir=self.directory
        )
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(new_doc, f, indent=2)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            _fsync_dir(self.directory)
        finally:
            try:
                os.unlink(tmp)
            except FileNotFoundError:
                pass
        if evicted:
            self._gc_artifacts(kept, evicted)
        return record

    @staticmethod
    def _gc_artifacts(kept: list, evicted: list) -> None:
        """Delete artifact directories that left the bounded history with
        their generations. Deletion is gated twice: the dir must not be
        referenced by ANY surviving record (current is kept[0]), and it
        must actually look like an artifact set (its manifest file
        exists) — a corrupted record can never aim the rmtree at an
        arbitrary path."""
        live_dirs = {
            (d.get("artifacts") or {}).get("dir")
            for d in kept
            if isinstance(d, dict)
        }
        for d in evicted:
            if not isinstance(d, dict):
                continue
            adir = (d.get("artifacts") or {}).get("dir")
            if not adir or adir in live_dirs:
                continue
            if not os.path.isfile(os.path.join(adir, AOT_MANIFEST_NAME)):
                continue
            shutil.rmtree(adir, ignore_errors=True)


# ---------------------------------------------------------------------------
# Endpoint registry (cross-host replica discovery)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EndpointRecord:
    """One replica's self-reported address + lease."""

    replica_id: str
    host: str
    port: int
    generation: int = 0
    #: wall-clock epoch seconds the lease expires at (wall clock, not
    #: monotonic: the whole point is cross-process, cross-host validity)
    lease_expires: float = 0.0
    announced_at: float = 0.0
    meta: dict | None = None

    def to_json(self) -> dict:
        out: dict[str, Any] = {
            "replicaId": self.replica_id,
            "host": self.host,
            "port": self.port,
            "generation": self.generation,
            "leaseExpires": self.lease_expires,
            "announcedAt": self.announced_at,
        }
        if self.meta:
            out["meta"] = dict(self.meta)
        return out

    @staticmethod
    def from_json(d: dict) -> "EndpointRecord":
        return EndpointRecord(
            replica_id=str(d["replicaId"]),
            host=str(d["host"]),
            port=int(d["port"]),
            generation=int(d.get("generation", 0)),
            lease_expires=float(d.get("leaseExpires", 0.0)),
            announced_at=float(d.get("announcedAt", 0.0)),
            meta=d.get("meta"),
        )

    def lease_age_s(self, now: float | None = None) -> float:
        """Seconds since the entry was last (re)announced."""
        return max(0.0, (time.time() if now is None else now) - self.announced_at)

    def live(self, now: float | None = None) -> bool:
        return (time.time() if now is None else now) < self.lease_expires


class EndpointRegistry:
    """Directory of lease-stamped endpoint entries, one file per replica.

    Every write is atomic (tmp + fsync + rename in the same directory),
    so a reader sees either the previous whole entry or the next whole
    entry — two writers racing on the same ``replica_id`` converge on
    whichever rename lands last, never on a torn file. Filenames are
    derived from the replica id through a character allow-list, so an
    adversarial id cannot escape the directory.
    """

    #: entry filename suffix — anything else in the directory is ignored
    SUFFIX = ".endpoint.json"
    #: suffix an eviction claim renames the losing entry to before unlink
    _EVICT_SUFFIX = ".evicting"

    def __init__(self, directory: str, lease_ttl_s: float = 5.0):
        if lease_ttl_s <= 0:
            raise ValueError("lease_ttl_s must be > 0")
        self.directory = directory
        self.lease_ttl_s = float(lease_ttl_s)
        self._claim_seq = 0

    # --------------------------------------------------------------- paths
    def _entry_path(self, replica_id: str) -> str:
        safe = "".join(
            c if c.isalnum() or c in "._-" else "_" for c in replica_id
        )[:128]
        if not safe:
            raise ValueError(f"unusable replica id {replica_id!r}")
        return os.path.join(self.directory, safe + self.SUFFIX)

    # --------------------------------------------------------------- write
    def announce(
        self,
        replica_id: str,
        host: str,
        port: int,
        generation: int = 0,
        meta: dict | None = None,
        now: float | None = None,
    ) -> EndpointRecord:
        """Publish (or renew — a heartbeat IS a re-announce) one
        replica's bound address with a fresh lease."""
        now = time.time() if now is None else now
        record = EndpointRecord(
            replica_id=replica_id,
            host=host,
            port=int(port),
            generation=int(generation),
            lease_expires=now + self.lease_ttl_s,
            announced_at=now,
            meta=meta,
        )
        os.makedirs(self.directory, exist_ok=True)
        fd, tmp = tempfile.mkstemp(
            prefix=".endpoint.", suffix=".tmp", dir=self.directory
        )
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(record.to_json(), f)
                f.flush()
                os.fsync(f.fileno())
            # piolint: waive=PIO502 -- leases are ephemeral by contract: a crash-forgotten rename is indistinguishable from lease expiry, which every reader tolerates, and announce/heartbeat is the TTL/3 hot path where a per-beat dir fsync would tax the whole fleet
            os.replace(tmp, self._entry_path(replica_id))
        finally:
            try:
                os.unlink(tmp)
            except FileNotFoundError:
                pass
        return record

    def heartbeat(
        self,
        replica_id: str,
        host: str,
        port: int,
        generation: int = 0,
        meta: dict | None = None,
    ) -> EndpointRecord:
        """Lease renewal — an atomic whole-entry rewrite, so a heartbeat
        racing an eviction claim simply re-creates the entry (the replica
        is alive; the claim evicted a lease that was genuinely stale when
        claimed)."""
        return self.announce(
            replica_id, host, port, generation=generation, meta=meta
        )

    def withdraw(self, replica_id: str) -> bool:
        """Clean retirement: remove the entry now instead of letting the
        lease run out. Returns whether an entry was actually removed."""
        try:
            os.unlink(self._entry_path(replica_id))
            return True
        except FileNotFoundError:
            return False

    # ---------------------------------------------------------------- read
    def snapshot(
        self, now: float | None = None
    ) -> tuple[list[EndpointRecord], list[EndpointRecord], list[dict]]:
        """Read every entry: ``(live, expired, problems)``.

        ``problems`` carries one dict per torn/unparsable entry file —
        loud, never silently dropped: ``pio status`` prints them and the
        router surfaces them on ``/fleet/endpoints.json``. Expired
        entries are returned separately so callers can distinguish "gone"
        from "lease ran out but not yet evicted"."""
        now = time.time() if now is None else now
        live: list[EndpointRecord] = []
        expired: list[EndpointRecord] = []
        problems: list[dict] = []
        try:
            names = sorted(os.listdir(self.directory))
        except FileNotFoundError:
            return [], [], []
        for name in names:
            if not name.endswith(self.SUFFIX):
                continue
            path = os.path.join(self.directory, name)
            try:
                with open(path) as f:
                    record = EndpointRecord.from_json(json.load(f))
            except FileNotFoundError:
                continue  # lost a race with withdraw/evict — fine
            except (json.JSONDecodeError, KeyError, TypeError, ValueError,
                    OSError) as e:
                problems.append(
                    {"file": name, "error": f"{type(e).__name__}: {e}"[:200]}
                )
                continue
            (live if record.live(now) else expired).append(record)
        return live, expired, problems

    def live(self, now: float | None = None) -> list[EndpointRecord]:
        return self.snapshot(now)[0]

    # ---------------------------------------------------------------- evict
    def evict_expired(self, now: float | None = None) -> list[str]:
        """Remove entries whose lease expired (and torn entry files older
        than one lease), returning the replica ids THIS caller evicted.

        Exactly-once across concurrent callers: each eviction first
        claims the entry with an atomic ``os.rename`` to a caller-unique
        name — of N racing routers exactly one rename succeeds, and only
        the winner counts (and unlinks) the eviction. The losers see
        ``FileNotFoundError`` and report nothing, so an HA router pair
        never double-counts one membership change."""
        now = time.time() if now is None else now
        evicted: list[str] = []
        try:
            names = sorted(os.listdir(self.directory))
        except FileNotFoundError:
            return []
        for name in names:
            if not name.endswith(self.SUFFIX):
                continue
            path = os.path.join(self.directory, name)
            stale_unparsable = False
            try:
                with open(path) as f:
                    record = EndpointRecord.from_json(json.load(f))
            except FileNotFoundError:
                continue
            except (json.JSONDecodeError, KeyError, TypeError, ValueError,
                    OSError):
                record = None
                try:
                    stale_unparsable = (
                        now - os.path.getmtime(path) > self.lease_ttl_s
                    )
                except OSError:
                    continue
            if record is not None and record.live(now):
                continue
            if record is None and not stale_unparsable:
                continue  # torn but fresh: give its writer a lease to fix it
            self._claim_seq += 1
            claim = (
                f"{path}{self._EVICT_SUFFIX}.{os.getpid()}.{self._claim_seq}"
            )
            try:
                os.rename(path, claim)  # the atomic exactly-once gate
            except FileNotFoundError:
                continue  # another router (or a heartbeat) won this entry
            except OSError:
                continue
            try:
                os.unlink(claim)
            except OSError:
                pass
            evicted.append(
                record.replica_id
                if record is not None
                else name[: -len(self.SUFFIX)]
            )
        return evicted
