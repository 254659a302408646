"""SQLite tri-role storage driver — the zero-dependency default backend.

Fills the role the reference's JDBC driver plays
(``data/storage/jdbc/JDBCLEvents.scala``, ``JDBCPEvents.scala``,
``JDBCApps.scala``...): one relational backend implementing all three
repository roles (metadata, event data, model blobs). Events live in one
table per (app, channel) stream — ``pio_event_<appId>[_<channelId>]`` —
mirroring the reference's table-per-app layout; times are stored as integer
microseconds-since-epoch (UTC) for indexable range scans plus the original
formatted string so timezone fidelity survives round-trips.
"""

from __future__ import annotations

import datetime as _dt
import json
import os
import sqlite3
import threading
import uuid
from typing import Any, Iterable, Iterator, Sequence

from predictionio_tpu_torch.data.event import (
    DataMap,
    Event,
    format_event_time,
    new_event_id,
    parse_event_time,
)
from predictionio_tpu_torch.data.storage.base import (
    AccessKey,
    AccessKeysRepo,
    App,
    AppsRepo,
    BaseStorageClient,
    Channel,
    ChannelsRepo,
    EngineInstance,
    EngineInstancesRepo,
    EvaluationInstance,
    EvaluationInstancesRepo,
    LEvents,
    Model,
    ModelsRepo,
    PEvents,
    StorageClientConfig,
    StorageError,
    generate_access_key,
)

__all__ = ["StorageClient"]

_EPOCH = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)


def _to_us(dt: _dt.datetime) -> int:
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=_dt.timezone.utc)
    return int((dt - _EPOCH).total_seconds() * 1_000_000)


class _Db:
    """One shared connection with a process lock; sqlite serializes writes
    anyway, and the event server's insert path is short transactions."""

    def __init__(self, path: str):
        if path != ":memory:":
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.conn = sqlite3.connect(path, check_same_thread=False)
        self.conn.execute("PRAGMA journal_mode=WAL")
        self.conn.execute("PRAGMA synchronous=NORMAL")
        # writer contention (a second process on the same db file, e.g.
        # `pio import` beside a live event server) must queue briefly, not
        # surface as instant `database is locked` OperationalErrors — the
        # in-process RLock below only serializes THIS process's writers
        self.conn.execute("PRAGMA busy_timeout=5000")
        self.lock = threading.RLock()

    def run(self, sql: str, params: Sequence[Any] = ()) -> sqlite3.Cursor:
        with self.lock:
            cur = self.conn.execute(sql, params)
            self.conn.commit()
            return cur

    def run_many(self, sql: str, seq: Iterable[Sequence[Any]]) -> None:
        with self.lock:
            self.conn.executemany(sql, seq)
            self.conn.commit()

    def fetch(self, sql: str, params: Sequence[Any] = ()) -> list[tuple]:
        with self.lock:
            return self.conn.execute(sql, params).fetchall()

    def close(self) -> None:
        with self.lock:
            self.conn.close()


# ---------------------------------------------------------------------------
# Metadata repos
# ---------------------------------------------------------------------------


class _Apps(AppsRepo):
    def __init__(self, db: _Db, prefix: str):
        self._db = db
        self._t = f"{prefix}_meta_apps"
        db.run(
            f"CREATE TABLE IF NOT EXISTS {self._t} ("
            "id INTEGER PRIMARY KEY AUTOINCREMENT, name TEXT UNIQUE NOT NULL, "
            "description TEXT)"
        )

    def insert(self, app: App) -> int | None:
        try:
            if app.id > 0:
                cur = self._db.run(
                    f"INSERT INTO {self._t} (id, name, description) VALUES (?,?,?)",
                    (app.id, app.name, app.description),
                )
            else:
                cur = self._db.run(
                    f"INSERT INTO {self._t} (name, description) VALUES (?,?)",
                    (app.name, app.description),
                )
            return cur.lastrowid
        except sqlite3.IntegrityError:
            return None

    def _row(self, r: tuple) -> App:
        return App(id=r[0], name=r[1], description=r[2])

    def get(self, app_id: int) -> App | None:
        rows = self._db.fetch(f"SELECT id,name,description FROM {self._t} WHERE id=?", (app_id,))
        return self._row(rows[0]) if rows else None

    def get_by_name(self, name: str) -> App | None:
        rows = self._db.fetch(f"SELECT id,name,description FROM {self._t} WHERE name=?", (name,))
        return self._row(rows[0]) if rows else None

    def get_all(self) -> list[App]:
        return [self._row(r) for r in self._db.fetch(
            f"SELECT id,name,description FROM {self._t} ORDER BY id")]

    def update(self, app: App) -> bool:
        try:
            cur = self._db.run(
                f"UPDATE {self._t} SET name=?, description=? WHERE id=?",
                (app.name, app.description, app.id),
            )
            return cur.rowcount > 0
        except sqlite3.IntegrityError:
            return False

    def delete(self, app_id: int) -> bool:
        cur = self._db.run(f"DELETE FROM {self._t} WHERE id=?", (app_id,))
        return cur.rowcount > 0


class _AccessKeys(AccessKeysRepo):
    def __init__(self, db: _Db, prefix: str):
        self._db = db
        self._t = f"{prefix}_meta_accesskeys"
        db.run(
            f"CREATE TABLE IF NOT EXISTS {self._t} ("
            "accesskey TEXT PRIMARY KEY, appid INTEGER NOT NULL, events TEXT)"
        )

    def insert(self, access_key: AccessKey) -> str | None:
        key = access_key.key or generate_access_key()
        try:
            self._db.run(
                f"INSERT INTO {self._t} (accesskey, appid, events) VALUES (?,?,?)",
                (key, access_key.appid, json.dumps(list(access_key.events))),
            )
            return key
        except sqlite3.IntegrityError:
            return None

    def _row(self, r: tuple) -> AccessKey:
        return AccessKey(key=r[0], appid=r[1], events=tuple(json.loads(r[2] or "[]")))

    def get(self, key: str) -> AccessKey | None:
        rows = self._db.fetch(
            f"SELECT accesskey,appid,events FROM {self._t} WHERE accesskey=?", (key,))
        return self._row(rows[0]) if rows else None

    def get_all(self) -> list[AccessKey]:
        return [self._row(r) for r in self._db.fetch(
            f"SELECT accesskey,appid,events FROM {self._t}")]

    def get_by_appid(self, appid: int) -> list[AccessKey]:
        return [self._row(r) for r in self._db.fetch(
            f"SELECT accesskey,appid,events FROM {self._t} WHERE appid=?", (appid,))]

    def update(self, access_key: AccessKey) -> bool:
        cur = self._db.run(
            f"UPDATE {self._t} SET appid=?, events=? WHERE accesskey=?",
            (access_key.appid, json.dumps(list(access_key.events)), access_key.key),
        )
        return cur.rowcount > 0

    def delete(self, key: str) -> bool:
        cur = self._db.run(f"DELETE FROM {self._t} WHERE accesskey=?", (key,))
        return cur.rowcount > 0


class _Channels(ChannelsRepo):
    def __init__(self, db: _Db, prefix: str):
        self._db = db
        self._t = f"{prefix}_meta_channels"
        db.run(
            f"CREATE TABLE IF NOT EXISTS {self._t} ("
            "id INTEGER PRIMARY KEY AUTOINCREMENT, name TEXT NOT NULL, "
            "appid INTEGER NOT NULL, UNIQUE(appid, name))"
        )

    def insert(self, channel: Channel) -> int | None:
        if not Channel.is_valid_name(channel.name):
            return None
        try:
            if channel.id > 0:
                cur = self._db.run(
                    f"INSERT INTO {self._t} (id, name, appid) VALUES (?,?,?)",
                    (channel.id, channel.name, channel.appid),
                )
            else:
                cur = self._db.run(
                    f"INSERT INTO {self._t} (name, appid) VALUES (?,?)",
                    (channel.name, channel.appid),
                )
            return cur.lastrowid
        except sqlite3.IntegrityError:
            return None

    def get(self, channel_id: int) -> Channel | None:
        rows = self._db.fetch(
            f"SELECT id,name,appid FROM {self._t} WHERE id=?", (channel_id,))
        return Channel(*rows[0]) if rows else None

    def get_by_appid(self, appid: int) -> list[Channel]:
        return [Channel(*r) for r in self._db.fetch(
            f"SELECT id,name,appid FROM {self._t} WHERE appid=? ORDER BY id", (appid,))]

    def delete(self, channel_id: int) -> bool:
        cur = self._db.run(f"DELETE FROM {self._t} WHERE id=?", (channel_id,))
        return cur.rowcount > 0


_EI_COLS = (
    "id,status,starttime,endtime,engineid,engineversion,enginevariant,"
    "enginefactory,batch,env,meshconf,datasourceparams,preparatorparams,"
    "algorithmsparams,servingparams"
)


class _EngineInstances(EngineInstancesRepo):
    def __init__(self, db: _Db, prefix: str):
        self._db = db
        self._t = f"{prefix}_meta_engineinstances"
        db.run(
            f"CREATE TABLE IF NOT EXISTS {self._t} ("
            "id TEXT PRIMARY KEY, status TEXT, starttime INTEGER, endtime INTEGER, "
            "engineid TEXT, engineversion TEXT, enginevariant TEXT, "
            "enginefactory TEXT, batch TEXT, env TEXT, meshconf TEXT, "
            "datasourceparams TEXT, preparatorparams TEXT, "
            "algorithmsparams TEXT, servingparams TEXT)"
        )

    @staticmethod
    def _from_us(us: int) -> _dt.datetime:
        return _EPOCH + _dt.timedelta(microseconds=us)

    def _row(self, r: tuple) -> EngineInstance:
        return EngineInstance(
            id=r[0], status=r[1],
            start_time=self._from_us(r[2]), end_time=self._from_us(r[3]),
            engine_id=r[4], engine_version=r[5], engine_variant=r[6],
            engine_factory=r[7], batch=r[8],
            env=json.loads(r[9] or "{}"), mesh_conf=json.loads(r[10] or "{}"),
            datasource_params=r[11], preparator_params=r[12],
            algorithms_params=r[13], serving_params=r[14],
        )

    def insert(self, instance: EngineInstance) -> str:
        iid = instance.id or uuid.uuid4().hex
        self._db.run(
            f"INSERT OR REPLACE INTO {self._t} ({_EI_COLS}) "
            "VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
            (
                iid, instance.status, _to_us(instance.start_time),
                _to_us(instance.end_time), instance.engine_id,
                instance.engine_version, instance.engine_variant,
                instance.engine_factory, instance.batch,
                json.dumps(instance.env), json.dumps(instance.mesh_conf),
                instance.datasource_params, instance.preparator_params,
                instance.algorithms_params, instance.serving_params,
            ),
        )
        return iid

    def get(self, instance_id: str) -> EngineInstance | None:
        rows = self._db.fetch(
            f"SELECT {_EI_COLS} FROM {self._t} WHERE id=?", (instance_id,))
        return self._row(rows[0]) if rows else None

    def get_all(self) -> list[EngineInstance]:
        return [self._row(r) for r in self._db.fetch(
            f"SELECT {_EI_COLS} FROM {self._t} ORDER BY starttime")]

    def get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> list[EngineInstance]:
        return [self._row(r) for r in self._db.fetch(
            f"SELECT {_EI_COLS} FROM {self._t} WHERE status='COMPLETED' AND "
            "engineid=? AND engineversion=? AND enginevariant=? "
            "ORDER BY starttime DESC",
            (engine_id, engine_version, engine_variant),
        )]

    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> EngineInstance | None:
        completed = self.get_completed(engine_id, engine_version, engine_variant)
        return completed[0] if completed else None

    def update(self, instance: EngineInstance) -> bool:
        if self.get(instance.id) is None:
            return False
        self.insert(instance)
        return True

    def delete(self, instance_id: str) -> bool:
        cur = self._db.run(f"DELETE FROM {self._t} WHERE id=?", (instance_id,))
        return cur.rowcount > 0


_EVI_COLS = (
    "id,status,starttime,endtime,evaluationclass,engineparamsgeneratorclass,"
    "batch,env,evaluatorresults,evaluatorresultshtml,evaluatorresultsjson"
)


class _EvaluationInstances(EvaluationInstancesRepo):
    def __init__(self, db: _Db, prefix: str):
        self._db = db
        self._t = f"{prefix}_meta_evaluationinstances"
        db.run(
            f"CREATE TABLE IF NOT EXISTS {self._t} ("
            "id TEXT PRIMARY KEY, status TEXT, starttime INTEGER, endtime INTEGER, "
            "evaluationclass TEXT, engineparamsgeneratorclass TEXT, batch TEXT, "
            "env TEXT, evaluatorresults TEXT, evaluatorresultshtml TEXT, "
            "evaluatorresultsjson TEXT)"
        )

    def _row(self, r: tuple) -> EvaluationInstance:
        return EvaluationInstance(
            id=r[0], status=r[1],
            start_time=_EPOCH + _dt.timedelta(microseconds=r[2]),
            end_time=_EPOCH + _dt.timedelta(microseconds=r[3]),
            evaluation_class=r[4], engine_params_generator_class=r[5],
            batch=r[6], env=json.loads(r[7] or "{}"),
            evaluator_results=r[8], evaluator_results_html=r[9],
            evaluator_results_json=r[10],
        )

    def insert(self, instance: EvaluationInstance) -> str:
        iid = instance.id or uuid.uuid4().hex
        self._db.run(
            f"INSERT OR REPLACE INTO {self._t} ({_EVI_COLS}) "
            "VALUES (?,?,?,?,?,?,?,?,?,?,?)",
            (
                iid, instance.status, _to_us(instance.start_time),
                _to_us(instance.end_time), instance.evaluation_class,
                instance.engine_params_generator_class, instance.batch,
                json.dumps(instance.env), instance.evaluator_results,
                instance.evaluator_results_html, instance.evaluator_results_json,
            ),
        )
        return iid

    def get(self, instance_id: str) -> EvaluationInstance | None:
        rows = self._db.fetch(
            f"SELECT {_EVI_COLS} FROM {self._t} WHERE id=?", (instance_id,))
        return self._row(rows[0]) if rows else None

    def get_all(self) -> list[EvaluationInstance]:
        return [self._row(r) for r in self._db.fetch(
            f"SELECT {_EVI_COLS} FROM {self._t} ORDER BY starttime")]

    def get_completed(self) -> list[EvaluationInstance]:
        return [self._row(r) for r in self._db.fetch(
            f"SELECT {_EVI_COLS} FROM {self._t} WHERE status='EVALCOMPLETED' "
            "ORDER BY starttime DESC")]

    def update(self, instance: EvaluationInstance) -> bool:
        if self.get(instance.id) is None:
            return False
        self.insert(instance)
        return True

    def delete(self, instance_id: str) -> bool:
        cur = self._db.run(f"DELETE FROM {self._t} WHERE id=?", (instance_id,))
        return cur.rowcount > 0


class _Models(ModelsRepo):
    def __init__(self, db: _Db, prefix: str):
        self._db = db
        self._t = f"{prefix}_model"
        db.run(
            f"CREATE TABLE IF NOT EXISTS {self._t} (id TEXT PRIMARY KEY, models BLOB)"
        )

    def insert(self, model: Model) -> None:
        self._db.run(
            f"INSERT OR REPLACE INTO {self._t} (id, models) VALUES (?,?)",
            (model.id, model.models),
        )

    def get(self, model_id: str) -> Model | None:
        rows = self._db.fetch(f"SELECT id, models FROM {self._t} WHERE id=?", (model_id,))
        return Model(id=rows[0][0], models=rows[0][1]) if rows else None

    def delete(self, model_id: str) -> bool:
        cur = self._db.run(f"DELETE FROM {self._t} WHERE id=?", (model_id,))
        return cur.rowcount > 0


# ---------------------------------------------------------------------------
# Events
# ---------------------------------------------------------------------------

_EV_COLS = (
    "id,event,entitytype,entityid,targetentitytype,targetentityid,"
    "properties,eventtime,eventtime_us,tags,prid,creationtime,creationtime_us"
)


class _SqlEvents(LEvents):
    def __init__(self, db: _Db, prefix: str):
        self._db = db
        self._prefix = prefix
        self._ensured: set[tuple[int, int | None]] = set()

    def _table(self, app_id: int, channel_id: int | None) -> str:
        name = f"{self._prefix}_event_{app_id}"
        if channel_id is not None:
            name += f"_{channel_id}"
        return name

    def _ensure(self, app_id: int, channel_id: int | None) -> str:
        t = self._table(app_id, channel_id)
        if (app_id, channel_id) in self._ensured:  # keep DDL off the hot path
            return t
        self._db.run(
            f"CREATE TABLE IF NOT EXISTS {t} ("
            "id TEXT PRIMARY KEY, event TEXT NOT NULL, "
            "entitytype TEXT NOT NULL, entityid TEXT NOT NULL, "
            "targetentitytype TEXT, targetentityid TEXT, "
            "properties TEXT, eventtime TEXT, eventtime_us INTEGER, "
            "tags TEXT, prid TEXT, creationtime TEXT, creationtime_us INTEGER)"
        )
        self._db.run(
            f"CREATE INDEX IF NOT EXISTS {t}_time ON {t} (eventtime_us)")
        self._db.run(
            f"CREATE INDEX IF NOT EXISTS {t}_entity ON {t} (entitytype, entityid)")
        self._ensured.add((app_id, channel_id))
        return t

    # -- LEvents ----------------------------------------------------------
    def init(self, app_id: int, channel_id: int | None = None) -> bool:
        self._ensure(app_id, channel_id)
        return True

    def remove(self, app_id: int, channel_id: int | None = None) -> bool:
        self._db.run(f"DROP TABLE IF EXISTS {self._table(app_id, channel_id)}")
        self._ensured.discard((app_id, channel_id))
        return True

    def insert(self, event: Event, app_id: int, channel_id: int | None = None) -> str:
        t = self._ensure(app_id, channel_id)
        eid = event.event_id or new_event_id()
        self._db.run(
            f"INSERT OR REPLACE INTO {t} ({_EV_COLS}) VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?)",
            self._to_row(event.with_event_id(eid)),
        )
        return eid

    def insert_batch(
        self, events: Sequence[Event], app_id: int, channel_id: int | None = None
    ) -> list[str]:
        t = self._ensure(app_id, channel_id)
        stamped = [e if e.event_id else e.with_event_id(new_event_id()) for e in events]
        self._db.run_many(
            f"INSERT OR REPLACE INTO {t} ({_EV_COLS}) VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?)",
            [self._to_row(e) for e in stamped],
        )
        return [e.event_id for e in stamped]  # type: ignore[misc]

    def insert_dedup(
        self, event: Event, app_id: int, channel_id: int | None = None
    ) -> tuple[str, bool]:
        """Idempotent insert: the event table's ``id`` PRIMARY KEY is the
        durable dedup index (no side structure, same commit path —
        whatever survived a crash IS what dedup checks against). OR
        IGNORE keeps the first write; rowcount 0 means duplicate."""
        if not event.event_id:
            return self.insert(event, app_id, channel_id), False
        t = self._ensure(app_id, channel_id)
        cur = self._db.run(
            f"INSERT OR IGNORE INTO {t} ({_EV_COLS}) VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?)",
            self._to_row(event),
        )
        return event.event_id, cur.rowcount == 0

    def insert_batch_dedup(
        self, events: Sequence[Event], app_id: int, channel_id: int | None = None
    ) -> list[tuple[str, bool]]:
        t = self._ensure(app_id, channel_id)
        stamped = [e if e.event_id else e.with_event_id(new_event_id()) for e in events]
        client_ids = [e.event_id for e in events if e.event_id]
        with self._db.lock:
            # one transaction: pre-read which client ids already exist,
            # then OR IGNORE the whole batch (keeps the single-commit
            # amortization of the batch route). Intra-batch repeats are
            # caught by the seen-set below — OR IGNORE keeps the first.
            existing: set[str] = set()
            if client_ids:
                marks = ",".join("?" * len(client_ids))
                existing = {
                    r[0]
                    for r in self._db.conn.execute(
                        f"SELECT id FROM {t} WHERE id IN ({marks})", client_ids
                    )
                }
            self._db.conn.executemany(
                f"INSERT OR IGNORE INTO {t} ({_EV_COLS}) VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?)",
                [self._to_row(e) for e in stamped],
            )
            self._db.conn.commit()
        out: list[tuple[str, bool]] = []
        seen: set[str] = set()
        for orig, e in zip(events, stamped):
            dup = bool(orig.event_id) and (e.event_id in existing or e.event_id in seen)
            if orig.event_id:
                seen.add(e.event_id)  # type: ignore[arg-type]
            out.append((e.event_id, dup))  # type: ignore[arg-type]
        return out

    @staticmethod
    def _to_row(e: Event) -> tuple:
        return (
            e.event_id, e.event, e.entity_type, e.entity_id,
            e.target_entity_type, e.target_entity_id,
            json.dumps(e.properties.to_dict()),
            format_event_time(e.event_time), _to_us(e.event_time),
            json.dumps(list(e.tags)), e.pr_id,
            format_event_time(e.creation_time), _to_us(e.creation_time),
        )

    @staticmethod
    def _exact_time(formatted: str, us: int | None) -> _dt.datetime:
        # The formatted string carries the zone; the *_us column carries full
        # microsecond precision (the string is millisecond-truncated).
        base = parse_event_time(formatted)
        if us is None:
            return base
        return (_EPOCH + _dt.timedelta(microseconds=us)).astimezone(base.tzinfo)

    @classmethod
    def _from_row(cls, r: tuple) -> Event:
        return Event(
            event_id=r[0], event=r[1], entity_type=r[2], entity_id=r[3],
            target_entity_type=r[4], target_entity_id=r[5],
            properties=DataMap(json.loads(r[6] or "{}")),
            event_time=cls._exact_time(r[7], r[8]),
            tags=tuple(json.loads(r[9] or "[]")), pr_id=r[10],
            creation_time=cls._exact_time(r[11], r[12]),
        )

    def get(self, event_id: str, app_id: int, channel_id: int | None = None) -> Event | None:
        # read path stays read-only: no _ensure DDL for a stream nobody
        # wrote to (readiness probes hit this with a phantom app id, and
        # a probe must not mutate schema — or fail on a read-only db)
        t = self._table(app_id, channel_id)
        if (app_id, channel_id) not in self._ensured:
            if not self._db.fetch(
                "SELECT name FROM sqlite_master WHERE type='table' AND name=?",
                (t,),
            ):
                return None
            # positive existence is cacheable: tables only disappear via
            # remove(), which discards the cache entry
            self._ensured.add((app_id, channel_id))
        rows = self._db.fetch(f"SELECT {_EV_COLS} FROM {t} WHERE id=?", (event_id,))
        return self._from_row(rows[0]) if rows else None

    def delete(self, event_id: str, app_id: int, channel_id: int | None = None) -> bool:
        t = self._ensure(app_id, channel_id)
        cur = self._db.run(f"DELETE FROM {t} WHERE id=?", (event_id,))
        return cur.rowcount > 0

    def _build_where(
        self,
        start_time, until_time, entity_type, entity_id,
        event_names, target_entity_type, target_entity_id,
    ) -> tuple[str, list]:
        clauses, params = [], []
        if start_time is not None:
            clauses.append("eventtime_us >= ?")
            params.append(_to_us(start_time))
        if until_time is not None:
            clauses.append("eventtime_us < ?")
            params.append(_to_us(until_time))
        if entity_type is not None:
            clauses.append("entitytype = ?")
            params.append(entity_type)
        if entity_id is not None:
            clauses.append("entityid = ?")
            params.append(entity_id)
        if event_names is not None:
            if len(event_names) == 0:
                clauses.append("1=0")  # empty whitelist matches nothing
            else:
                clauses.append(
                    "event IN (" + ",".join("?" * len(event_names)) + ")")
                params.extend(event_names)
        if target_entity_type is not None:
            clauses.append("targetentitytype = ?")
            params.append(target_entity_type)
        if target_entity_id is not None:
            clauses.append("targetentityid = ?")
            params.append(target_entity_id)
        where = (" WHERE " + " AND ".join(clauses)) if clauses else ""
        return where, params

    def find(
        self,
        app_id: int,
        channel_id: int | None = None,
        start_time=None, until_time=None, entity_type=None, entity_id=None,
        event_names=None, target_entity_type=None, target_entity_id=None,
        limit: int | None = None,
        reversed: bool = False,
    ) -> Iterator[Event]:
        t = self._ensure(app_id, channel_id)
        where, params = self._build_where(
            start_time, until_time, entity_type, entity_id,
            event_names, target_entity_type, target_entity_id)
        order = "DESC" if reversed else "ASC"
        sql = f"SELECT {_EV_COLS} FROM {t}{where} ORDER BY eventtime_us {order}, id {order}"
        if limit is not None and limit >= 0:
            sql += f" LIMIT {int(limit)}"
        for r in self._db.fetch(sql, params):
            yield self._from_row(r)

    # -- PEvents ----------------------------------------------------------
    def pfind(
        self,
        app_id: int,
        channel_id: int | None = None,
        start_time=None, until_time=None, entity_type=None, entity_id=None,
        event_names=None, target_entity_type=None, target_entity_id=None,
        shard_index: int = 0,
        num_shards: int = 1,
    ) -> Iterator[Event]:
        t = self._ensure(app_id, channel_id)
        where, params = self._build_where(
            start_time, until_time, entity_type, entity_id,
            event_names, target_entity_type, target_entity_id)
        if num_shards > 1:
            shard = f"(rowid % {int(num_shards)}) = {int(shard_index)}"
            where = f"{where} AND {shard}" if where else f" WHERE {shard}"
        sql = f"SELECT {_EV_COLS} FROM {t}{where} ORDER BY eventtime_us ASC, id ASC"
        for r in self._db.fetch(sql, params):
            yield self._from_row(r)

    def write(self, events: Iterable[Event], app_id: int, channel_id: int | None = None) -> None:
        batch: list[Event] = []
        for e in events:
            batch.append(e)
            if len(batch) >= 1000:
                self.insert_batch(batch, app_id, channel_id)
                batch = []
        if batch:
            self.insert_batch(batch, app_id, channel_id)


class _SqlPEvents(PEvents):
    def __init__(self, events: _SqlEvents):
        self._e = events

    def find(
        self,
        app_id: int,
        channel_id: int | None = None,
        start_time=None, until_time=None, entity_type=None, entity_id=None,
        event_names=None, target_entity_type=None, target_entity_id=None,
        shard_index: int = 0,
        num_shards: int = 1,
    ) -> Iterator[Event]:
        return self._e.pfind(
            app_id, channel_id, start_time, until_time, entity_type, entity_id,
            event_names, target_entity_type, target_entity_id,
            shard_index, num_shards,
        )

    def write(self, events: Iterable[Event], app_id: int, channel_id: int | None = None) -> None:
        self._e.write(events, app_id, channel_id)

    def delete(self, app_id: int, channel_id: int | None = None) -> None:
        self._e.remove(app_id, channel_id)
        self._e.init(app_id, channel_id)


class StorageClient(BaseStorageClient):
    """Tri-role sqlite driver (``TYPE=sqlite``; property ``PATH`` = db file)."""

    def __init__(self, config: StorageClientConfig):
        super().__init__(config)
        path = config.properties.get("path")
        if not path:
            raise StorageError("sqlite driver requires a PATH property")
        self._db = _Db(os.path.expanduser(path))
        prefix = config.properties.get("prefix", "pio")
        self._apps = _Apps(self._db, prefix)
        self._keys = _AccessKeys(self._db, prefix)
        self._channels = _Channels(self._db, prefix)
        self._engine_instances = _EngineInstances(self._db, prefix)
        self._eval_instances = _EvaluationInstances(self._db, prefix)
        self._models = _Models(self._db, prefix)
        self._events = _SqlEvents(self._db, prefix)
        self._pevents = _SqlPEvents(self._events)

    def get_apps(self) -> AppsRepo:
        return self._apps

    def get_access_keys(self) -> AccessKeysRepo:
        return self._keys

    def get_channels(self) -> ChannelsRepo:
        return self._channels

    def get_engine_instances(self) -> EngineInstancesRepo:
        return self._engine_instances

    def get_evaluation_instances(self) -> EvaluationInstancesRepo:
        return self._eval_instances

    def get_models(self) -> ModelsRepo:
        return self._models

    def get_l_events(self) -> LEvents:
        return self._events

    def get_p_events(self) -> PEvents:
        return self._pevents

    def recovery_report(self) -> dict:
        return {
            "quarantined": [],
            "notes": [
                "sqlite WAL: torn transactions roll back natively on open; "
                "no file-level sweep needed"
            ],
        }

    def close(self) -> None:
        self._db.close()
