"""The JAX package's online-learning cases (``tests/test_online.py``) on
both packages' classes.

Every case of the subclassed JAX classes runs twice, ``[jax]`` and
``[torch]`` (``tests/torch_package_swap.py``): under ``[torch]`` the tail
follower, the fold-in solver, the streaming trainer, ``OnlineConfig``,
``QueryService``, the columnar driver, compaction, ingest, the event and
storage classes are the port's, and the Recommendation engine trains and
serves through the port on the CPU. The port's fold-in and trainer take
the CPU because the tests ask for it (``device="cpu"``); their default
is the card.

``TestIncrementalIVF`` runs on the port's ``ops.ivf`` (its ``build_ivf``
bound to the CPU, ``jax.numpy.asarray`` making CPU tensors).
``TestOnlineUnderShardFactors`` (``--shard-factors`` with fold-ins) runs
``[torch]`` only, on the port's ``(cpu,)*8`` mesh (its
``parallel.sharding.local_devices``): it is red in the reference on this
tree, whose fold gathers the prior rows by a plain index of the
row-sharded table and jax refuses that
(``predictionio_tpu/templates/recommendation/engine.py:1093-1095``). Its
assertion that the table is still a ``NamedSharding`` over the ``model``
axis reads, on the port, that it is still a ``ShardedTable`` over the same
mesh — the case's contract in the port's terms.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest

import jax

import predictionio_tpu.data.storage as jax_storage_package
import predictionio_tpu.ops as jax_ops_package
import predictionio_tpu_torch.data.aggregator as port_aggregator
import predictionio_tpu_torch.data.event as port_event
import predictionio_tpu_torch.data.ingest as port_ingest
import predictionio_tpu_torch.data.storage.base as port_storage_base
import predictionio_tpu_torch.data.storage.columnar as port_columnar
import predictionio_tpu_torch.data.storage.compaction as port_compaction
import predictionio_tpu_torch.online as port_online
import predictionio_tpu_torch.online.follower as port_follower
import predictionio_tpu_torch.online.foldin as port_foldin
import predictionio_tpu_torch.online.trainer as port_trainer
import predictionio_tpu_torch.online.types as port_types
import predictionio_tpu_torch.ops.ivf as port_ivf
import predictionio_tpu_torch.serving as port_serving_package
import predictionio_tpu_torch.workflow as port_workflow
import predictionio_tpu_torch.workflow.device_state as port_device_state
import predictionio_tpu_torch.workflow.serving as port_serving
import test_online as jax_cases
from predictionio_tpu_torch.data.storage import Storage as PortStorage
from predictionio_tpu_torch.parallel import sharding as port_sharding
from test_online import columnar_env, online_service, sharded_online_service  # noqa: F401  (the cases' fixtures)
from torch_package_swap import PACKAGES, controller_module, cpu_module, memory_storage, tensor_numpy, use_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _swap(package: str, request, monkeypatch) -> str:
    if package == "torch":
        use_port(
            monkeypatch,
            jax_cases,
            {"DataMap": port_event.DataMap, "Event": port_event.Event, "Storage": PortStorage},
            {
                "predictionio_tpu.controller": controller_module(),
                "predictionio_tpu.data.aggregator": port_aggregator,
                "predictionio_tpu.data.event": port_event,
                "predictionio_tpu.data.ingest": port_ingest,
                "predictionio_tpu.data.storage.base": port_storage_base,
                "predictionio_tpu.data.storage.columnar": port_columnar,
                "predictionio_tpu.data.storage.compaction": port_compaction,
                "predictionio_tpu.online": port_online,
                "predictionio_tpu.online.follower": port_follower,
                "predictionio_tpu.online.types": port_types,
                "predictionio_tpu.online.foldin": cpu_module(
                    "predictionio_tpu.online.foldin", port_foldin, foldin_rows=port_foldin.foldin_rows
                ),
                "predictionio_tpu.online.trainer": cpu_module(
                    "predictionio_tpu.online.trainer", port_trainer,
                    sgd_step=port_trainer.sgd_step, StreamingTrainer=port_trainer.StreamingTrainer,
                ),
                "predictionio_tpu.serving": port_serving_package,
                "predictionio_tpu.workflow": port_workflow,
                "predictionio_tpu.workflow.serving": port_serving,
                "predictionio_tpu.workflow.device_state": port_device_state,
            },
        )
        # `from predictionio_tpu.data.storage import columnar` reads the
        # package's attribute before sys.modules
        monkeypatch.setattr(jax_storage_package, "columnar", port_columnar, raising=False)
        if request.cls is TestIncrementalIVF:
            # `from predictionio_tpu.ops import ivf` and `import jax.numpy
            # as jnp` read package attributes before sys.modules
            ivf = cpu_module("predictionio_tpu.ops.ivf", port_ivf, build_ivf=port_ivf.build_ivf)
            monkeypatch.setattr(jax_ops_package, "ivf", ivf, raising=False)
            monkeypatch.setattr(jax, "numpy", tensor_numpy())
    return package


@pytest.fixture(params=PACKAGES, autouse=True)
def package(request, monkeypatch):
    return _swap(request.param, request, monkeypatch)


@pytest.fixture()
def memory_storage_env(package):
    yield from memory_storage(package)


class TestTailFollower(jax_cases.TestTailFollower):
    pass


class TestFollowerUnderSchedulerAndBulk(jax_cases.TestFollowerUnderSchedulerAndBulk):
    pass


class TestFoldinSolver(jax_cases.TestFoldinSolver):
    pass


class TestQueryServiceOnline(jax_cases.TestQueryServiceOnline):
    pass


class TestStreamingTrainer(jax_cases.TestStreamingTrainer):
    pass


class TestIncrementalIVF(jax_cases.TestIncrementalIVF):
    pass


class TestOnlineUnderShardFactors(jax_cases.TestOnlineUnderShardFactors):
    """``[torch]`` only (red in the reference on this tree: the module
    docstring)."""

    @pytest.fixture(params=("torch",), autouse=True)
    def package(self, request, monkeypatch):
        with port_sharding.local_devices(["cpu"] * 8):
            yield _swap(request.param, request, monkeypatch)

    def test_fresh_user_folds_into_sharded_tables(self, sharded_online_service):  # noqa: F811
        """The reference's case, its ``NamedSharding`` assertion read as
        the port's: the table is still a ``ShardedTable`` over the same
        8-way mesh after the fold, and the logical row count advanced."""
        Storage, app_id, qs = sharded_online_service
        pairs, _ = qs.snapshot_pairs()
        _algo, model = pairs[0]
        shards = model._pio_shards
        assert shards is not None and shards.num_shards == 8
        mesh = model.user_factors.mesh
        assert jax_cases._query(qs, "fresh-su").body == {"itemScores": []}
        Storage.get_l_events().insert_batch(
            [jax_cases._rate("fresh-su", 1, 5.0, "s1"), jax_cases._rate("fresh-su", 2, 5.0, "s2")], app_id
        )
        r = qs.dispatch("POST", "/online/fold.json", {}, None)
        assert r.status == 200
        scores = jax_cases._query(qs, "fresh-su").body["itemScores"]
        assert len(scores) == 4
        # still row-sharded over the same mesh (the swap routed the rows
        # to their owner shards), and the cold start advanced the count
        assert isinstance(model.user_factors, port_sharding.ShardedTable)
        assert model.user_factors.mesh == mesh
        assert shards.rows["user"] > 30
        uidx = model.user_index["fresh-su"]
        assert uidx < shards.rows["user"]
        row = np.asarray(model.user_factors)[uidx]
        assert np.abs(row).sum() > 0


class TestSatellites(jax_cases.TestSatellites):
    def test_online_types_import_no_jax(self, package):
        """``import <package>.online`` loads no jax, and in the port no
        torch either."""
        name = "predictionio_tpu" if package == "jax" else "predictionio_tpu_torch"
        heavy = ("jax",) if package == "jax" else ("jax", "torch")
        probe = (
            f"import sys; import {name}.online; "
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {heavy!r}); "
            "print(bad); sys.exit(1 if bad else 0)"
        )
        proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True)
        assert proc.returncode == 0, proc.stdout[-500:] + proc.stderr[-500:]


def test_cases_run_on_the_ports_classes(package, columnar_env):  # noqa: F811
    from predictionio_tpu.online import OnlineConfig
    from predictionio_tpu.online.follower import TailFollower
    from predictionio_tpu.online.foldin import foldin_rows
    from predictionio_tpu.online.trainer import StreamingTrainer, sgd_step
    from predictionio_tpu.workflow.serving import QueryService

    prefix = "predictionio_tpu." if package == "jax" else "predictionio_tpu_torch."
    for obj in (OnlineConfig, TailFollower, QueryService, jax_cases.Event, columnar_env):
        assert obj.__module__.startswith(prefix)
    for fn in (foldin_rows, sgd_step, StreamingTrainer):
        inner = fn.func if isinstance(fn, functools.partial) else fn
        assert inner.__module__.startswith(prefix)
        assert isinstance(fn, functools.partial) == (package == "torch")
