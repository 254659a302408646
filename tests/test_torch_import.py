"""``pio import`` in the port against the JAX package's, on the CPU.

One NDJSON file — valid lines of several shapes, and a second line
carrying an ``eventId`` already used — is imported by both packages into
one sqlite store, under two apps. Both report the same count and the
same duplicate count, and the two apps hold the same events field by
field (an event without a client ``eventId`` gets a fresh id on each
side, and each side stamps its own creation time). A second file with an
invalid third line aborts both imports with the same ``file:line``
message. The port's console drives the same path, and a directory that
is not a columnar export is refused with a clear error (an export
directory is imported: tests/test_torch_data_cli.py).
"""

import json

import pytest

from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu.data.storage import StorageError as JaxStorageError
from predictionio_tpu.tools import commands as jax_commands
from predictionio_tpu_torch.data.storage import Storage, StorageError
from predictionio_tpu_torch.data.store import resolve_app
from predictionio_tpu_torch.tools import commands, console

LINES = [
    {"event": "rate", "entityType": "user", "entityId": "u1", "targetEntityType": "item",
     "targetEntityId": "i1", "properties": {"rating": 4.5}, "eventTime": "2021-05-01T10:00:00.000Z"},
    {"event": "view", "entityType": "user", "entityId": "u2", "targetEntityType": "item",
     "targetEntityId": "i7", "eventTime": "2021-05-01T10:00:01.250+02:00", "eventId": "ev-1"},
    {"event": "buy", "entityType": "user", "entityId": "u2", "targetEntityType": "item",
     "targetEntityId": "i3", "properties": {"qty": 2, "tags": ["a", "b"]}, "eventId": "ev-2",
     "eventTime": "2021-05-02T00:00:00Z"},
    {"event": "$set", "entityType": "item", "entityId": "i3",
     "properties": {"categories": ["c1"], "price": 9.99}, "eventTime": "2021-05-03T12:30:00.000Z"},
    {"event": "view", "entityType": "user", "entityId": "u9", "targetEntityType": "item",
     "targetEntityId": "i8", "eventTime": "2021-05-04T01:02:03.004Z", "eventId": "ev-1"},  # a duplicate
    {"event": "like", "entityType": "user", "entityId": "u3", "targetEntityType": "item",
     "targetEntityId": "i1", "prId": "pr-7", "eventTime": "2021-05-05T00:00:00.000Z"},
]
BAD = [LINES[0], LINES[3], {"event": "", "entityType": "user", "entityId": "u1"}, LINES[5]]


@pytest.fixture
def store(tmp_path):
    env = {"PIO_FS_BASEDIR": str(tmp_path / "base")}
    Storage.configure(env)
    JaxStorage.configure(env)
    (tmp_path / "events.json").write_text("".join(json.dumps(line) + "\n" for line in LINES))
    (tmp_path / "bad.json").write_text("".join(json.dumps(line) + "\n" for line in BAD))
    yield tmp_path
    Storage.configure(None)
    JaxStorage.configure(None)


def _fields(event, client_ids: set) -> tuple:
    return (
        event.event_id if event.event_id in client_ids else None,
        event.event, event.entity_type, event.entity_id, event.target_entity_type, event.target_entity_id,
        json.dumps(event.properties.to_dict(), sort_keys=True), event.event_time, tuple(event.tags), event.pr_id,
    )


def _stored(app: str) -> list:
    app_id, _ = resolve_app(app)
    client_ids = {line["eventId"] for line in LINES if "eventId" in line}
    return sorted((_fields(e, client_ids) for e in Storage.get_l_events().find(app_id)), key=repr)


def test_import_matches_jax_count_duplicates_and_events(store):
    said, jax_said = [], []
    commands.app_new("port", out=lambda line: None)
    jax_commands.app_new("jax", out=lambda line: None)
    n = commands.import_events("port", str(store / "events.json"), out=said.append)
    jax_n = jax_commands.import_events("jax", str(store / "events.json"), out=jax_said.append)
    assert n == jax_n == len(LINES)
    assert said == [s.replace("jax", "port") for s in jax_said]
    assert said == ["Imported 6 events to app port. (1 duplicate eventIds absorbed)"]
    port, jax = _stored("port"), _stored("jax")
    assert port == jax and len(port) == len(LINES) - 1
    # the first line with an id keeps it; the later one is absorbed
    assert [p[3] for p in port if p[0] == "ev-1"] == ["u2"]


def test_invalid_line_aborts_like_jax(store):
    commands.app_new("port", out=lambda line: None)
    jax_commands.app_new("jax", out=lambda line: None)
    path = str(store / "bad.json")
    with pytest.raises(StorageError) as got:
        commands.import_events("port", path, out=lambda line: None)
    with pytest.raises(JaxStorageError) as want:
        jax_commands.import_events("jax", path, out=lambda line: None)
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith(f"{path}:3: ")


def test_console_import_and_directory_input(store, capsys):
    assert console.main(["app", "new", "port"]) == 0
    assert console.main(["import", "--appname", "port", "--input", str(store / "events.json")]) == 0
    assert "Imported 6 events to app port." in capsys.readouterr().out
    assert len(_stored("port")) == len(LINES) - 1
    with pytest.raises(StorageError, match="columnar"):
        commands.import_events("port", str(store), out=lambda line: None)
    assert console.main(["import", "--appname", "port", "--input", str(store / "bad.json")]) == 1
    assert "bad.json:3: " in capsys.readouterr().err
    assert console.main(["import", "--appname", "nobody", "--input", str(store / "events.json")]) == 1
