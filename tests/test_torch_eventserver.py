"""The port's event server against the JAX package's, on the CPU.

One request script goes through both packages' ``EventService.dispatch``,
each over its own columnar event store and sqlite metadata with the same
app, access keys and channel. Statuses and bodies must be equal once the
ids the store draws at random and the wall-clock fields are normalised.
The script covers create, get, delete, find with filters, batch with a
bad item, bulk NDJSON and bulk columnar chunks with retransmits, a
missing and a wrong access key, an event whitelist, channels, stats and
one webhook. Then one real HTTP round trip through the port's
``api/http.py`` (a streamed bulk body included), and ``pio app delete``
revoking a key in a live ``EventService`` of the same process.
"""

import io
import json
import re
import urllib.error
import urllib.request

import pytest

from predictionio_tpu.api import EventService as JaxEventService
from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu_torch.api import EventService
from predictionio_tpu_torch.api.http import start_background
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.data.storage.base import AccessKey, App, Channel
from predictionio_tpu_torch.tools import commands

KEY, LIMITED = "key-all", "key-view"


def _env(path) -> dict:
    return {
        "PIO_FS_BASEDIR": str(path),
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "COL",
        "PIO_STORAGE_SOURCES_COL_TYPE": "columnar",
        "PIO_STORAGE_SOURCES_COL_PATH": str(path / "events"),
    }


def _setup(storage) -> None:
    app_id = storage.get_meta_data_apps().insert(App(id=0, name="es"))
    storage.get_l_events().init(app_id)
    storage.get_meta_data_access_keys().insert(AccessKey(key=KEY, appid=app_id))
    storage.get_meta_data_access_keys().insert(AccessKey(key=LIMITED, appid=app_id, events=("view",)))
    ch = storage.get_meta_data_channels().insert(Channel(id=0, name="ch", appid=app_id))
    storage.get_l_events().init(app_id, ch)


@pytest.fixture
def stores(tmp_path):
    Storage.configure(_env(tmp_path / "port"))
    JaxStorage.configure(_env(tmp_path / "jax"))
    _setup(Storage)
    _setup(JaxStorage)
    yield tmp_path
    Storage.configure(None)
    JaxStorage.configure(None)


def _ev(n: int, **over) -> dict:
    return {"event": "rate", "entityType": "user", "entityId": f"u{n % 4}", "targetEntityType": "item",
            "targetEntityId": f"i{n % 3}", "properties": {"rating": 1.0 + n % 5},
            "eventTime": f"2021-03-01T00:00:{n:02d}.000Z", **over}


def _ndjson(objs) -> bytes:
    return "".join(json.dumps(o) + "\n" for o in objs).encode()


def _chunk_wire(n: int, start: int) -> bytes:
    obj = {
        "event": ["view"] * n, "entityType": ["user"] * n, "entityId": [f"w{i}" for i in range(n)],
        "targetEntityType": ["item"] * n, "targetEntityId": [f"i{i}" for i in range(n)],
        "tUs": [1_700_000_000_000_000 + i for i in range(n)], "cUs": [1_700_000_000_000_000] * n,
        "ids": [f"cw{start + i}" for i in range(n)], "propf": {"rating": [float(i) for i in range(n)]},
        "propint": {"rating": [False] * n}, "extra": [""] * n,
    }
    return (json.dumps(obj) + "\n").encode()


BULK = _ndjson([_ev(20 + k, eventId=f"bulk-{k}") for k in range(12)] + [{"event": "", "entityType": "user"}])

#: (method, path, params, body, extra dispatch kwargs); "{id0}" is the id
#: the first create answered
SCRIPT = [
    ("GET", "/", {}, None, {}),
    ("POST", "/events.json", {}, _ev(0), {}),
    ("POST", "/events.json", {"accessKey": "wrong"}, _ev(0), {}),
    ("POST", "/events.json", {"accessKey": KEY}, _ev(1), {}),
    ("POST", "/events.json", {"accessKey": KEY}, _ev(2, eventId="client-1"), {}),
    ("POST", "/events.json", {"accessKey": KEY}, _ev(3, eventId="client-1"), {}),
    ("POST", "/events.json", {"accessKey": KEY}, _ev(4, event="$bad"), {}),
    ("POST", "/events.json", {"accessKey": LIMITED}, _ev(5), {}),
    ("POST", "/events.json", {"accessKey": LIMITED}, _ev(6, event="view"), {}),
    ("GET", "/events/{id0}.json", {"accessKey": KEY}, None, {}),
    ("GET", "/events/client-1.json", {"accessKey": KEY}, None, {}),
    ("POST", "/batch/events.json", {"accessKey": KEY},
     [_ev(7), {"event": "", "entityType": "user", "entityId": "x"}, _ev(8, eventId="client-2"),
      _ev(9, eventId="client-1")], {}),
    ("POST", "/events/bulk.json", {"accessKey": KEY}, None, {"stream": BULK}),
    ("POST", "/events/bulk.json", {"accessKey": KEY, "chunkRows": "64"}, None, {"stream": BULK}),
    ("POST", "/events/bulk.json", {"accessKey": KEY}, None,
     {"stream": _chunk_wire(5, 0), "headers": {"Content-Type": "application/x-pio-chunks"}}),
    ("POST", "/events/bulk.json", {"accessKey": KEY}, None,
     {"stream": _chunk_wire(5, 0) + _chunk_wire(3, 5), "headers": {"Content-Type": "application/x-pio-chunks"}}),
    ("POST", "/events/bulk.json", {"accessKey": KEY}, None, {}),
    ("POST", "/events.json", {"accessKey": KEY, "channel": "ch"}, _ev(10), {}),
    ("POST", "/events.json", {"accessKey": KEY, "channel": "nope"}, _ev(11), {}),
    ("GET", "/events.json", {"accessKey": KEY, "channel": "ch"}, None, {}),
    ("GET", "/events.json", {"accessKey": KEY, "entityType": "user", "entityId": "u1"}, None, {}),
    ("GET", "/events.json", {"accessKey": KEY, "event": "rate", "targetEntityType": "item",
                             "targetEntityId": "i2", "limit": "3", "reversed": "true"}, None, {}),
    ("GET", "/events.json", {"accessKey": KEY, "startTime": "2021-03-01T00:00:21.000Z",
                             "untilTime": "2021-03-01T00:00:27.000Z"}, None, {}),
    ("DELETE", "/events/{id0}.json", {"accessKey": KEY}, None, {}),
    ("GET", "/events/{id0}.json", {"accessKey": KEY}, None, {}),
    ("DELETE", "/events/{id0}.json", {"accessKey": KEY}, None, {}),
    ("POST", "/webhooks/examplejson.json", {"accessKey": KEY},
     {"type": "userAction", "userId": "u7", "targetedItem": "i3", "properties": {"x": 1},
      "timestamp": "2021-03-02T00:00:00.000Z"}, {}),
    ("POST", "/webhooks/examplejson.json", {"accessKey": KEY}, {"type": "?"}, {}),
    ("POST", "/webhooks/nope.json", {"accessKey": KEY}, {}, {}),
    ("GET", "/events.json", {"accessKey": KEY, "limit": "-1"}, None, {}),
    ("GET", "/stats.json", {"accessKey": KEY}, None, {}),
    ("GET", "/nowhere", {}, None, {}),
]

TIME_KEYS = {"creationTime", "startTime", "bucket"}


def _run(service) -> list:
    out, first_id = [], None
    for method, path, params, body, kw in SCRIPT:
        kw = dict(kw)
        if "stream" in kw:
            kw["stream"] = io.BytesIO(kw["stream"])
        r = service.dispatch(method, path.replace("{id0}", str(first_id)), params, body, **kw)
        if hasattr(r, "chunks"):
            payload = [json.loads(line) for line in b"".join(r.chunks).splitlines()]
        else:
            payload = r.body
        if first_id is None and r.status == 201:
            first_id = payload["eventId"]
        if path == "/stats.json" and r.status == 200:
            # per-minute buckets: a run may straddle a minute, so sum them
            total: dict = {}
            for bucket in payload.pop("statsByMinute"):
                for kind in ("status", "event", "entityType"):
                    for name, n in bucket[kind].items():
                        total[f"{bucket['appId']}/{kind}/{name}"] = total.get(
                            f"{bucket['appId']}/{kind}/{name}", 0) + n
            payload["statsTotal"] = total
        out.append([method, path, r.status, payload])
    return out


def _normalise(results: list) -> list:
    """Ids drawn at random become ``<id N>`` by first appearance; wall
    clock fields and timings become ``<t>``."""
    ids: dict = {}

    def walk(x, key=None):
        if isinstance(x, dict):
            return {k: walk(v, k) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v, key) for v in x]
        if key in TIME_KEYS or (isinstance(key, str) and key.endswith("Ms")):
            return "<t>"
        if key == "eventId" and isinstance(x, str) and re.fullmatch(r"[0-9a-f]{32}|seg-.*", x):
            return ids.setdefault(x, f"<id {len(ids)}>")
        return x

    return walk(results)


def test_request_script_answers_like_the_jax_package(stores):
    port = _normalise(_run(EventService(stats=True)))
    Storage.configure(None)  # nothing of the port's store is read below
    jax = _normalise(_run(JaxEventService(stats=True)))
    assert len(port) == len(jax) == len(SCRIPT)
    for ours, ref in zip(port, jax):
        assert ours == ref, ours[:2]
    statuses = [r[2] for r in port]
    assert statuses[:9] == [200, 401, 401, 201, 201, 201, 400, 403, 201]
    bulk, retransmit = port[12][3], port[13][3]
    assert bulk[-1]["stored"] == 12 and bulk[-1]["invalid"] == 1
    assert retransmit[-1]["stored"] == 0 and retransmit[-1]["duplicates"] == 12
    assert port[15][3][-1]["duplicates"] == 5 and port[15][3][-1]["stored"] == 3
    stats = port[-2][3]
    assert stats["bulk"]["duplicates"] == 17 and stats["dedup"]["hits"] >= 2


def _post(url: str, data: bytes, ctype: str = "application/json"):
    req = urllib.request.Request(url, data=data, headers={"Content-Type": ctype}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_http_round_trip(stores):
    server, thread = start_background(EventService(stats=True).dispatch)
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        status, body = _post(f"{base}/events.json?accessKey={KEY}", json.dumps(_ev(1, eventId="h1")).encode())
        assert (status, json.loads(body)) == (201, {"eventId": "h1"})
        status, body = _post(f"{base}/events/bulk.json?accessKey={KEY}", BULK, "application/x-ndjson")
        lines = [json.loads(line) for line in body.splitlines()]
        assert status == 200 and lines[-1]["done"] and lines[-1]["stored"] == 12
        with urllib.request.urlopen(f"{base}/events/h1.json?accessKey={KEY}", timeout=30) as resp:
            got = json.loads(resp.read())
        assert got["entityId"] == "u1" and got["properties"] == {"rating": 2.0}
        with urllib.request.urlopen(f"{base}/events.json?accessKey={KEY}&limit=-1", timeout=30) as resp:
            assert len(json.loads(resp.read())) == 13
        with urllib.request.urlopen(f"{base}/readyz", timeout=30) as resp:
            assert resp.status == 200
        assert _post(f"{base}/events.json?accessKey=wrong", b"{}")[0] == 401
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def test_app_delete_revokes_the_key_in_a_live_service(stores):
    service = EventService()
    assert service.dispatch("POST", "/events.json", {"accessKey": KEY}, _ev(1)).status == 201
    commands.app_delete("es", out=lambda line: None)
    assert service.dispatch("POST", "/events.json", {"accessKey": KEY}, _ev(2)).status == 401
    assert service.dispatch("POST", "/events.json", {"accessKey": LIMITED}, _ev(3, event="view")).status == 401
