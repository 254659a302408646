"""``pio template list|get`` in the port's console, on the CPU.

Both consoles list the same six templates with the same engine
factories, and ``get`` writes the same engine.json in both. For each of
the six, the engine.json that the port's ``get`` writes trains in the
port: ``pio import`` of one small NDJSON file (rate, view and buy events,
item categories, user attributes with a plan, labelled texts) into a
sqlite store, then ``pio train --engine-json <dir>/engine.json --device
cpu`` must exit 0 and leave a COMPLETED instance whose engine factory is
the template's, and ``pio batchpredict --device cpu`` of the trained
instance must answer every query line.
"""

import json

import numpy as np
import pytest

from predictionio_tpu.tools import console as jax_console
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.tools import commands, console

APP = "MyApp"
NAMES = ["recommendation", "classification", "similarproduct", "ecommerce", "textclassification", "twotower"]
WORDS = {"sports": ["team", "goal", "match", "score", "coach"], "tech": ["gpu", "kernel", "api", "json", "code"]}


def _events() -> list:
    rng = np.random.default_rng(0)
    out = []
    for u in range(24):
        for i in rng.choice(16, size=6, replace=False).tolist():
            out.append({"event": "rate", "entityType": "user", "entityId": f"u{u}", "targetEntityType": "item",
                        "targetEntityId": f"i{i}", "properties": {"rating": float(rng.integers(1, 6))}})
            out.append({"event": "view", "entityType": "user", "entityId": f"u{u}", "targetEntityType": "item",
                        "targetEntityId": f"i{i}"})
        out.append({"event": "buy", "entityType": "user", "entityId": f"u{u}", "targetEntityType": "item",
                    "targetEntityId": f"i{u % 16}"})
        plan = u % 3
        attrs = [int(rng.poisson(1)) for _ in range(3)]
        attrs[plan] += 6
        out.append({"event": "$set", "entityType": "user", "entityId": f"u{u}",
                    "properties": {**{f"attr{a}": attrs[a] for a in range(3)}, "plan": f"p{plan}"}})
    for i in range(16):
        out.append({"event": "$set", "entityType": "item", "entityId": f"i{i}",
                    "properties": {"categories": [f"c{i % 2}"]}})
    for n in range(12):
        label = "sports" if n % 2 else "tech"
        text = " ".join(rng.choice(WORDS[label], size=5).tolist())
        out.append({"event": "$set", "entityType": "content", "entityId": f"d{n}",
                    "properties": {"text": text, "category": label}})
    return out


@pytest.fixture
def store(tmp_path):
    Storage.configure({"PIO_FS_BASEDIR": str(tmp_path / "base")})
    (tmp_path / "events.json").write_text("".join(json.dumps(e) + "\n" for e in _events()))
    assert console.main(["app", "new", APP]) == 0
    assert console.main(["import", "--appname", APP, "--input", str(tmp_path / "events.json")]) == 0
    yield tmp_path
    Storage.configure(None)


def test_both_consoles_list_the_same_templates(capsys):
    assert console.main(["template", "list"]) == 0
    port_out = capsys.readouterr().out
    assert jax_console.main(["template", "list"]) == 0
    jax_out = capsys.readouterr().out
    rows = [line.split() for line in port_out.splitlines()[1:] if not line.startswith(" ")]
    assert rows == [line.split() for line in jax_out.splitlines()[1:] if not line.startswith(" ")]
    assert [name for name, _ in rows] == NAMES
    assert list(commands.BUILTIN_TEMPLATES) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_get_writes_the_jax_consoles_engine_json(name, tmp_path):
    assert console.main(["template", "get", name, str(tmp_path / "port"), "--appname", APP]) == 0
    assert jax_console.main(["template", "get", name, str(tmp_path / "jax"), "--appname", APP]) == 0
    assert json.loads((tmp_path / "port" / "engine.json").read_text()) == json.loads(
        (tmp_path / "jax" / "engine.json").read_text())
    # a second get into the same directory refuses to overwrite
    assert console.main(["template", "get", name, str(tmp_path / "port")]) == 1


def _get_and_train(name: str, store) -> tuple:
    directory = store / name
    assert console.main(["template", "get", name, str(directory), "--appname", APP]) == 0
    variant = json.loads((directory / "engine.json").read_text())
    assert console.main(["train", "--engine-json", str(directory / "engine.json"), "--device", "cpu"]) == 0
    return directory, variant


@pytest.mark.parametrize("name", NAMES)
def test_get_writes_an_engine_json_the_ports_train_takes(name, store):
    _, variant = _get_and_train(name, store)
    assert variant["engineFactory"] == f"predictionio_tpu.templates.{name}:engine_factory"
    assert variant["datasource"]["params"]["appName"] == APP
    (instance,) = Storage.get_meta_data_engine_instances().get_all()
    assert instance.status == "COMPLETED"
    assert instance.engine_factory == variant["engineFactory"]
    assert Storage.get_model_data_models().get(instance.id) is not None


#: two query lines for each template, and the key each answer carries
QUERIES = {
    "recommendation": ([{"user": "u1", "num": 3}, {"user": "nobody"}], "itemScores"),
    "classification": ([{"attr0": 9, "attr1": 0, "attr2": 1}, {"attr0": 0, "attr1": 1, "attr2": 8}], "label"),
    "similarproduct": ([{"items": ["i1"], "num": 3}, {"items": ["i2", "i3"], "categories": ["c0"]}], "itemScores"),
    "ecommerce": ([{"user": "u1", "num": 3}, {"user": "stranger", "num": 2}], "itemScores"),
    "textclassification": ([{"text": "gpu kernel api"}, {"text": "the team and the goal"}], "category"),
    "twotower": ([{"user": "u1", "num": 3}, {"user": "u2"}], "itemScores"),
}


@pytest.mark.parametrize("name", NAMES)
def test_the_trained_template_answers_batchpredict(name, store):
    directory, _ = _get_and_train(name, store)
    queries, key = QUERIES[name]
    (store / f"{name}-q.json").write_text("".join(json.dumps(q) + "\n" for q in queries))
    assert console.main(["batchpredict", "--engine-json", str(directory / "engine.json"), "--input",
                         str(store / f"{name}-q.json"), "--output", str(store / f"{name}-out.json"),
                         "--device", "cpu"]) == 0
    lines = [json.loads(line) for line in (store / f"{name}-out.json").read_text().splitlines()]
    assert [line["query"] for line in lines] == queries
    assert all(key in line["prediction"] for line in lines), lines
    if key == "itemScores":
        assert len(lines[0]["prediction"]["itemScores"]) == 3


def test_unknown_template_fails():
    assert console.main(["template", "get", "nope", "/nonexistent"]) == 1
