"""``pio batchpredict`` of the port against the JAX package's: one query
file, one store, one trained instance (the port trains it on the CPU;
both packages read the blob), both consoles' ``batchpredict``. The
output files must be equal line for line (tolerance: none — on the CPU
both score with the same numpy GEMM and ``top_k_host`` on the same
arrays, and print the scores with ``repr``). The file takes both the
fast path (``batch_predict_json``) and, for bodies that do not bind
trivially, the slow path (``handle_batch``: a 400, a predict that raises
and an unknown user), over two score chunks.
"""

import datetime as dt
import json

import numpy as np

from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu.tools.console import main as jax_main
from predictionio_tpu_torch.controller.context import local_context
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.tools.console import main
from predictionio_tpu_torch.workflow import load_engine_variant, run_train

ENGINE = {
    "id": "bp-eng",
    "version": "1",
    "engineFactory": "predictionio_tpu.templates.recommendation:engine_factory",
    "datasource": {"params": {"appName": "bp-app"}},
    "algorithms": [{"name": "als", "params": {"rank": 8, "numIterations": 3, "lambda": 0.05, "seed": 9}}],
}


def test_both_consoles_write_the_same_lines(tmp_path):
    env = {"PIO_FS_BASEDIR": str(tmp_path / "base")}
    Storage.configure(env)
    JaxStorage.configure(env)
    try:
        app_id = Storage.get_meta_data_apps().insert(App(id=0, name="bp-app"))
        Storage.get_l_events().init(app_id)
        rng = np.random.default_rng(11)
        t0 = dt.datetime(2022, 1, 1, tzinfo=dt.timezone.utc)
        Storage.get_l_events().insert_batch(
            [
                Event(event="rate", entity_type="user", entity_id=str(u), target_entity_type="item",
                      target_entity_id=str(i), properties=DataMap({"rating": float((u + i) % 5 + 1)}),
                      event_time=t0 + dt.timedelta(seconds=k))
                for k, (u, i) in enumerate(zip(rng.integers(0, 300, 3000), rng.integers(0, 120, 3000)))
            ],
            app_id,
        )
        engine_json = tmp_path / "engine.json"
        engine_json.write_text(json.dumps(ENGINE))
        run_train(load_engine_variant(str(engine_json)), local_context("cpu"))
        queries = [{"user": str(u), "num": int(n)} for u, n in zip(rng.integers(0, 310, 2500), rng.integers(1, 15, 2500))]
        queries[7] = {"user": "3", "bogus": 1}  # does not bind: 400
        queries[8] = {"user": "5", "num": "x"}  # predict raises: 500
        queries[9] = {"user": "nobody"}
        queries[10] = {"user": "12"}
        (tmp_path / "q.json").write_text("".join(json.dumps(q) + "\n" for q in queries))
        args = ["batchpredict", "--engine-json", str(engine_json), "--input", str(tmp_path / "q.json")]
        assert jax_main(args + ["--output", str(tmp_path / "jax.json")]) == 0
        assert main(args + ["--output", str(tmp_path / "port.json"), "--device", "cpu"]) == 0
    finally:
        Storage.configure(None)
        JaxStorage.configure(None)
    jax_lines = (tmp_path / "jax.json").read_text().splitlines()
    port_lines = (tmp_path / "port.json").read_text().splitlines()
    assert len(port_lines) == len(queries)
    assert port_lines == jax_lines
    rows = [json.loads(line) for line in port_lines]
    assert rows[7]["status"] == 400 and rows[8]["status"] == 500
    assert rows[9]["prediction"] == {"itemScores": []}
    assert len(rows[10]["prediction"]["itemScores"]) == 4
    assert sum(1 for r in rows if r.get("prediction", {}).get("itemScores")) > 2000
