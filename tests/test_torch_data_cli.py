"""The port's data verbs against the JAX package's, through both consoles,
on the CPU.

``export --format columnar`` by one package is imported as a directory by
the other, in both directions, with the same events; both packages'
``export`` of one store write the same JSON-lines bytes. The ``app``,
``channel`` and ``accesskey`` verbs, run in the same order by each
console over its own columnar store, print the same lines and leave the
same apps, keys, channels and events. ``eventserver``'s flags parse to
the JAX console's values, and ``--compact-interval-s`` is refused on a
store without a tail (the sqlite driver) the same way.
"""

import json
import re

import pytest

from predictionio_tpu.data import event as jax_event
from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu.data.store import resolve_app as jax_resolve_app
from predictionio_tpu.tools import console as jax_console
from predictionio_tpu_torch.data import event as port_event
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.data.store import resolve_app
from predictionio_tpu_torch.tools import console

LINES = [
    {"event": "rate", "entityType": "user", "entityId": f"u{k % 5}", "targetEntityType": "item",
     "targetEntityId": f"i{k % 7}", "properties": {"rating": 1.0 + k % 5},
     "eventTime": f"2021-04-01T00:{k // 60:02d}:{k % 60:02d}.000Z", **({"eventId": f"e{k}"} if k % 2 else {})}
    for k in range(40)
] + [
    {"event": "$set", "entityType": "item", "entityId": "i3", "properties": {"categories": ["c1"], "price": 9.5},
     "eventTime": "2021-04-02T00:00:00.000Z", "eventId": "set-1"},
    {"event": "view", "entityType": "user", "entityId": "u1", "targetEntityType": "item", "targetEntityId": "i2",
     "tags": ["a", "b"], "prId": "p1", "eventTime": "2021-04-03T00:00:00.000Z"},
]

PACKAGES = {
    "jax": (jax_console, JaxStorage, jax_resolve_app, jax_event),
    "port": (console, Storage, resolve_app, port_event),
}


def _env(path, driver: str = "columnar") -> dict:
    env = {"PIO_FS_BASEDIR": str(path)}
    if driver == "columnar":
        env.update({
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "COL",
            "PIO_STORAGE_SOURCES_COL_TYPE": "columnar",
            "PIO_STORAGE_SOURCES_COL_PATH": str(path / "events"),
        })
    return env


@pytest.fixture
def files(tmp_path):
    (tmp_path / "events.json").write_text("".join(json.dumps(line) + "\n" for line in LINES))
    yield tmp_path
    Storage.configure(None)
    JaxStorage.configure(None)


def _main(pkg: str, argv: list) -> int:
    return PACKAGES[pkg][0].main(argv)


def _events(pkg: str, app: str, channel: str | None = None, keep_ids: bool = True) -> list:
    _, storage, resolve, event_mod = PACKAGES[pkg]
    app_id, channel_id = resolve(app, channel)
    out = []
    for event in storage.get_l_events().find(app_id, channel_id):
        obj = event_mod.event_to_json(event)
        obj.pop("creationTime")
        if not keep_ids:
            obj.pop("eventId")
        elif re.fullmatch(r"[0-9a-f]{32}", obj["eventId"]):
            obj["eventId"] = "<drawn by the store>"
        out.append(json.dumps(obj, sort_keys=True))
    return sorted(out)


@pytest.mark.parametrize("exporter, importer", [("jax", "port"), ("port", "jax")])
def test_columnar_export_imports_into_the_other_package(files, exporter, importer):
    PACKAGES[exporter][1].configure(_env(files / "src"))
    PACKAGES[importer][1].configure(_env(files / "dst"))
    assert _main(exporter, ["app", "new", "src"]) == 0
    assert _main(exporter, ["import", "--appname", "src", "--input", str(files / "events.json")]) == 0
    assert _main(exporter, ["export", "--appname", "src", "--output", str(files / "exp"), "--format",
                            "columnar"]) == 0
    assert _main(importer, ["app", "new", "dst"]) == 0
    assert _main(importer, ["import", "--appname", "dst", "--input", str(files / "exp")]) == 0
    source = _events(exporter, "src", keep_ids=False)
    assert len(source) == len(LINES)
    assert _events(importer, "dst", keep_ids=False) == source
    # an export directory is never written twice
    assert _main(exporter, ["export", "--appname", "src", "--output", str(files / "exp"), "--format",
                            "columnar"]) == 1


def test_json_export_is_the_same_bytes(files, capsys):
    for storage in (Storage, JaxStorage):
        storage.configure(_env(files / "one"))
    assert _main("port", ["app", "new", "one"]) == 0
    assert _main("port", ["import", "--appname", "one", "--input", str(files / "events.json")]) == 0
    assert _main("port", ["export", "--appname", "one", "--output", str(files / "port.json")]) == 0
    assert _main("jax", ["export", "--appname", "one", "--output", str(files / "jax.json")]) == 0
    assert (files / "port.json").read_bytes() == (files / "jax.json").read_bytes()
    assert len((files / "port.json").read_text().splitlines()) == len(LINES)
    # and each package imports the other's file back to the same events
    assert _main("jax", ["app", "new", "back"]) == 0
    assert _main("jax", ["import", "--appname", "back", "--input", str(files / "port.json")]) == 0
    assert _events("jax", "back") == _events("port", "one")
    # the round-robin shard files of multi-process reads, byte for byte
    assert _main("port", ["export", "--appname", "one", "--output", str(files / "shards"), "--sharded", "2"]) == 0
    assert _main("jax", ["export", "--appname", "one", "--output", str(files / "jshards"), "--sharded", "2"]) == 0
    for name in ("events-00000-of-00002.jsonl", "events-00001-of-00002.jsonl"):
        assert (files / "shards" / name).read_bytes() == (files / "jshards" / name).read_bytes()
    assert "Exported 2 shards" in capsys.readouterr().out


def _verbs(pkg: str, files) -> list:
    """The same verbs in the same order; returns what the console printed
    and the store's state after each step that changes it."""
    _, storage, resolve, event_mod = PACKAGES[pkg]
    storage.configure(_env(files / pkg))
    steps = [
        ["app", "new", "a", "--access-key", "ka", "--description", "first"],
        ["app", "new", "b", "--access-key", "kb"],
        ["app", "new", "a"],
        ["app", "channel-new", "a", "ch1"],
        ["app", "channel-new", "a", "ch2"],
        ["app", "channel-new", "a", "bad name!"],
        ["import", "--appname", "a", "--input", str(files / "events.json")],
        ["import", "--appname", "a", "--channel", "ch1", "--input", str(files / "events.json")],
        ["accesskey", "new", "a", "view", "buy"],
        ["accesskey", "list", "a"],
        ["accesskey", "list"],
        ["accesskey", "delete", "kb"],
        ["accesskey", "delete", "kb"],
        ["app", "show", "a"],
        ["app", "compact", "a"],
        ["app", "data-delete", "a", "--channel", "ch1"],
        ["app", "channel-delete", "a", "ch2"],
        ["app", "channel-delete", "a", "ch2"],
        ["app", "delete", "b"],
        ["app", "show", "b"],
        ["app", "list"],
    ]
    log = []
    for argv in steps:
        if argv[:2] == ["app", "compact"]:  # three events into the tail first
            app_id, _ = resolve("a", None)
            for k in range(3):
                storage.get_l_events().insert(event_mod.Event(
                    event="view", entity_type="user", entity_id=f"t{k}", target_entity_type="item",
                    target_entity_id="i1", properties=event_mod.DataMap({}), event_id=f"tail-{k}",
                    event_time=event_mod.parse_event_time("2021-05-01T00:00:00.000Z")), app_id)
        log.append((argv, _main(pkg, argv)))
    apps = sorted((a.id, a.name, a.description) for a in storage.get_meta_data_apps().get_all())
    keys = sorted((k.key if k.key in ("ka", "kb") else "<random>", k.appid, tuple(k.events))
                  for k in storage.get_meta_data_access_keys().get_all())
    channels = sorted((c.id, c.name, c.appid) for app_id, _, _ in apps
                      for c in storage.get_meta_data_channels().get_by_appid(app_id))
    events = {
        "a": _events(pkg, "a"),
        "a/ch1": _events(pkg, "a", "ch1"),
        "state": storage.get_p_events().scan_state(resolve("a", None)[0]),
    }
    events["state"].pop("stream_id")
    events["state"]["segments"] = len(events["state"]["segments"])
    return [log, apps, keys, channels, events]


def test_app_and_accesskey_verbs_leave_the_same_store(files, capsys):
    got = {}
    for pkg in PACKAGES:
        state = _verbs(pkg, files)
        printed = capsys.readouterr()
        # a minted key is random; so are the ids of events imported without one
        text = re.sub(r"[A-Za-z0-9_-]{40,}", "<key>", printed.out + printed.err)
        got[pkg] = state + [text.replace("ERROR: ", "")]
    assert got["port"] == got["jax"]
    log, apps, keys, channels, events, text = got["port"]
    assert [rc for _, rc in log] == [0, 0, 1, 0, 0, 1, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 1, 0]
    assert apps == [(1, "a", "first")] and ("ka", 1, ()) in keys and len(channels) == 1
    assert events["a/ch1"] == [] and len(events["a"]) == len(LINES) + 3
    assert events["state"]["tail_lines"] == 0 and events["state"]["compactions"] == 1
    assert "Compacted 3 tail events of app a into segments." in text


ES_ARGV = [
    [],
    ["--ip", "127.0.0.1", "--port", "0", "--stats"],
    ["--compact-interval-s", "2.5", "--compact-tail-mb", "1.5", "--compact-dead-tombstones", "7",
     "--compact-min-interval-s", "0"],
    ["--cert", "c.pem", "--key", "k.pem", "--drain-deadline-s", "3"],
]


@pytest.mark.parametrize("argv", ES_ARGV, ids=["defaults", "bind", "compaction", "tls-drain"])
def test_eventserver_flags_parse_like_the_jax_console(argv):
    ours = vars(console.build_parser().parse_args(["eventserver", *argv]))
    ref = vars(jax_console.build_parser().parse_args(["eventserver", *argv]))
    assert ours == ref


def test_eventserver_refuses_background_compaction_without_a_tail(files, capsys):
    for pkg, (_, storage, _, _) in PACKAGES.items():
        storage.configure(_env(files / f"sqlite-{pkg}", driver="sqlite"))
    errors = []
    for pkg in PACKAGES:
        with pytest.raises(SystemExit) as e:
            _main(pkg, ["eventserver", "--port", "0", "--compact-interval-s", "1"])
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "TYPE=columnar" in errors[0]
    # a half-given TLS pair fails before the server binds, in both
    assert [_main(pkg, ["eventserver", "--port", "0", "--cert", "c.pem"]) for pkg in PACKAGES] == [1, 1]
    assert capsys.readouterr().err.count("--cert and --key must be given together") == 2
