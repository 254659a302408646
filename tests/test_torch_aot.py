"""Deploy-time AOT serving (``pio train --aot`` / ``pio deploy --aot``) on
both packages.

Every case of the JAX package's ``tests/test_aot.py`` runs ``[jax]`` and
``[torch]`` (a module-scoped ``package`` fixture; ``tests/torch_package_swap.py``
rebinds the test module's ``aot``, ``QueryService``, ``local_context``,
``run_train``, ``load_engine_variant``, ``Storage``, ``Event``, ``DataMap``
and ``App``, and the module paths its cases import, to the port's). Under
``[torch]`` the trained instance lives in a sqlite + localfs base
directory (so the JAX package can read it too), the export keeps one k
bucket and the batch chunk is 16 queries, so the artifact set is three
programs; ``test_load_runtime_tier1_bit_identical_to_jit`` hands numpy
arrays to programs that take tensors through a thin adapter.
``test_serving_parity_tier1_and_on_fallback_across_modes`` is red in the
reference and runs ``[torch]`` only; ``test_fallback_tier_prefers_persistent_cache``
reads ``jax.config`` and runs ``[jax]`` only, beside a port case on
``PIO_COMPILATION_CACHE_DIR`` and ``TORCHINDUCTOR_CACHE_DIR``.

Then the cross-package contracts: one blob through the port's tier-1
service and the JAX package's plain pinned service; each package's load
refusing the other's artifact set; a program called on a grown table;
``chunked_topk(aot=)`` against the eager path.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import sys
import types

import numpy as np
import pytest
import torch

import predictionio_tpu.analysis as jax_analysis_package
import predictionio_tpu.tools as jax_tools_package
import predictionio_tpu_torch.analysis.jit_witness as port_jit_witness
import predictionio_tpu_torch.fleet as port_fleet
import predictionio_tpu_torch.fleet.registry as port_registry
import predictionio_tpu_torch.fleet.router as port_router
import predictionio_tpu_torch.ops.als as port_als
import predictionio_tpu_torch.ops.topk as port_topk
import predictionio_tpu_torch.serving as port_serving_package
import predictionio_tpu_torch.serving.ann as port_serving_ann
import predictionio_tpu_torch.templates.recommendation.engine as port_recommendation
import predictionio_tpu_torch.tools.commands as port_commands
import predictionio_tpu_torch.workflow as port_workflow
import predictionio_tpu_torch.workflow.aot as port_aot
import predictionio_tpu_torch.workflow.device_state as port_device_state
import predictionio_tpu_torch.workflow.serving as port_serving
import test_aot as jax_cases
from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu.serving import CacheConfig as JaxCacheConfig
from predictionio_tpu.workflow import aot as jax_aot
from predictionio_tpu.workflow import load_engine_variant as jax_load_variant
from predictionio_tpu.workflow.serving import QueryService as JaxQueryService
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.serving import CacheConfig
from predictionio_tpu_torch.templates.serving_util import chunked_topk
from torch_package_swap import PACKAGES, cpu_context, use_port

#: queries a chunk of the port's batch program (the export's chunk)
CHUNK = 16


def _numpy_runtime(runtime):
    """``runtime`` whose ``get`` programs take numpy arrays (the JAX
    case's ``uvec``/``items``) as CPU tensors."""
    if runtime is None:
        return None
    get = runtime.get

    def get_numpy(key):
        fn = get(key)
        if fn is None:
            return None
        return lambda *args: fn(*(torch.as_tensor(a) if isinstance(a, np.ndarray) else a for a in args))

    runtime.get = get_numpy
    return runtime


def _aot_stand_in() -> types.ModuleType:
    """``workflow.aot`` for the JAX cases: the port's, its ``load_runtime``
    returning a numpy-taking runtime."""
    module = types.ModuleType("predictionio_tpu.workflow.aot")
    module.__dict__.update({k: v for k, v in vars(port_aot).items() if not k.startswith("__")})

    def load_runtime(*args, **kwargs):
        runtime, report = port_aot.load_runtime(*args, **kwargs)
        return _numpy_runtime(runtime), report

    module.load_runtime = load_runtime
    return module


def _tensor_ops() -> tuple[types.ModuleType, types.ModuleType]:
    """``ops.als`` and ``ops.topk`` stand-ins whose ``predict_scores`` and
    ``top_k_scores`` take the JAX case's numpy arrays."""
    als = types.ModuleType("predictionio_tpu.ops.als")
    als.predict_scores = lambda u, items: port_als.predict_scores(torch.as_tensor(u), torch.as_tensor(items))
    topk = types.ModuleType("predictionio_tpu.ops.topk")
    topk.top_k_scores = lambda s, k: port_topk.top_k_scores(torch.as_tensor(s), k)
    return als, topk


_VARIANT = {
    "id": "aot-test",
    "version": "1",
    "engineFactory": "predictionio_tpu.templates.recommendation:engine_factory",
    "datasource": {"params": {"appName": "aot-test"}},
    "algorithms": [{"name": "als", "params": {"rank": 8, "numIterations": 2, "lambda": 0.05, "seed": 7}}],
}


def _port_trained(tmp_path_factory) -> types.SimpleNamespace:
    """The JAX cases' events and engine through the port, in a sqlite +
    localfs base directory (which the JAX package reads too)."""
    base = str(tmp_path_factory.mktemp("aot_store"))
    config = {"PIO_FS_BASEDIR": base}
    Storage.configure(config)
    app_id = Storage.get_meta_data_apps().insert(App(id=0, name="aot-test"))
    rng = np.random.default_rng(7)
    Storage.get_p_events().write(
        (
            Event(
                event="rate",
                entity_type="user",
                entity_id=str(i % jax_cases.N_USERS),
                target_entity_type="item",
                target_entity_id=str(int(rng.integers(jax_cases.N_ITEMS))),
                properties=DataMap({"rating": float(1 + int(rng.integers(5)))}),
            )
            for i in range(jax_cases.N_EVENTS)
        ),
        app_id,
    )
    variant = port_workflow.load_engine_variant(_VARIANT)
    ctx = cpu_context()
    instance = port_workflow.run_train(variant, ctx)
    return types.SimpleNamespace(variant=variant, ctx=ctx, instance=instance, config=config)


def _port_pairs(t) -> list:
    """The port's deploy of ``t``'s instance, as ``_fresh_pairs`` builds it."""
    engine = t.variant.build_engine()
    blob = Storage.get_model_data_models().get(t.instance.id)
    return engine.prepare_deploy(t.ctx, t.variant.engine_params(engine), t.instance.id, blob.models)[1]


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Each package's trained instance and healthy artifact set, built on
    first use and kept for the module: the JAX fixtures' own under
    ``"jax"``; under ``"torch"`` :func:`_port_trained` and a
    three-program set (one k bucket, a 16-query chunk, which stay the
    port's settings for the module)."""
    built: dict = {}
    closers: list = []

    def get(package: str):
        if package not in built:
            if package == "jax":
                gen = jax_cases.trained.__wrapped__(tmp_path_factory)
                trained = next(gen)
                closers.append(lambda: next(gen, None))
                built[package] = (trained, jax_cases.artifacts.__wrapped__(trained, tmp_path_factory))
            else:
                trained = _port_trained(tmp_path_factory)
                closers.append(lambda: Storage.configure(None))
                root = str(tmp_path_factory.mktemp("aot_root"))
                manifest = port_aot.export_instance(_port_pairs(trained), trained.instance.id, root)
                assert manifest is not None, "ALS pairs exported nothing"
                built[package] = (trained, (root, manifest))
        return built[package]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_aot, "ledger_max_buckets", lambda *_a, **_k: 1)
        mp.setattr(port_recommendation.ALSAlgorithm, "BATCH_PREDICT_CHUNK", CHUNK)
        yield get
        for close in closers:
            close()


@pytest.fixture(params=PACKAGES)
def package(request, monkeypatch):
    """``[jax]``: the JAX cases as they are; ``[torch]``: on the port."""
    if request.param == "torch":
        als, topk = _tensor_ops()
        use_port(
            monkeypatch,
            jax_cases,
            {
                "aot": _aot_stand_in(),
                "QueryService": port_serving.QueryService,
                "local_context": cpu_context,
                "run_train": port_workflow.run_train,
                "load_engine_variant": port_workflow.load_engine_variant,
                "Storage": Storage,
                "Event": Event,
                "DataMap": DataMap,
                "App": App,
            },
            {
                "predictionio_tpu.analysis.jit_witness": port_jit_witness,
                "predictionio_tpu.fleet": port_fleet,
                "predictionio_tpu.fleet.registry": port_registry,
                "predictionio_tpu.fleet.router": port_router,
                "predictionio_tpu.ops.als": als,
                "predictionio_tpu.ops.topk": topk,
                "predictionio_tpu.serving": port_serving_package,
                "predictionio_tpu.serving.ann": port_serving_ann,
                "predictionio_tpu.tools.commands": port_commands,
                "predictionio_tpu.workflow": port_workflow,
                "predictionio_tpu.workflow.device_state": port_device_state,
            },
        )
        # `from predictionio_tpu.tools import commands` and `from
        # predictionio_tpu.analysis.jit_witness import ...` read the
        # packages' attributes before sys.modules
        monkeypatch.setattr(jax_tools_package, "commands", port_commands, raising=False)
        monkeypatch.setattr(jax_analysis_package, "jit_witness", port_jit_witness, raising=False)
    return request.param


@pytest.fixture()
def trained(package, stores):
    return stores(package)[0]


@pytest.fixture()
def artifacts(package, stores):
    return stores(package)[1]


@pytest.fixture()
def port(stores):
    """The port's trained instance and artifact set, for its own cases."""
    trained, (root, manifest) = stores("torch")
    return types.SimpleNamespace(trained=trained, root=root, manifest=manifest)


# ---------------------------------------------------------------------------
# The JAX package's cases, on both packages
# ---------------------------------------------------------------------------


def test_serving_buckets_pow2_floor_and_caps(package):
    jax_cases.test_serving_buckets_pow2_floor_and_caps()


def test_export_writes_fingerprinted_atomic_manifest(trained, artifacts):
    jax_cases.test_export_writes_fingerprinted_atomic_manifest(trained, artifacts)


def test_load_runtime_tier1_bit_identical_to_jit(trained, artifacts):
    jax_cases.test_load_runtime_tier1_bit_identical_to_jit(trained, artifacts)


def test_foreign_jaxlib_fingerprint_falls_back_loudly(trained, artifacts, tmp_path, caplog):
    jax_cases.test_foreign_jaxlib_fingerprint_falls_back_loudly(trained, artifacts, tmp_path, caplog)


def test_corrupt_blob_fails_verification_and_load(trained, artifacts, tmp_path):
    jax_cases.test_corrupt_blob_fails_verification_and_load(trained, artifacts, tmp_path)


def _scrub_cache_env(monkeypatch) -> None:
    """No cache variable set, and whatever the case sets undone after it."""
    for name in ("PIO_COMPILATION_CACHE_DIR", "TORCHINDUCTOR_CACHE_DIR", "TRITON_CACHE_DIR"):
        monkeypatch.setenv(name, "")
        monkeypatch.delenv(name)


def test_fallback_tier_prefers_persistent_cache(package, monkeypatch, tmp_path):
    """The JAX case reads ``jax.config``; the port's tier 2 is the
    persistent Inductor and Triton cache that ``pio train``/``pio deploy``
    configure (``PIO_COMPILATION_CACHE_DIR`` names it; Inductor sets
    ``TORCHINDUCTOR_CACHE_DIR`` to its own default on its first compile,
    which configures nothing)."""
    if package == "jax":
        jax_cases.test_fallback_tier_prefers_persistent_cache(monkeypatch, tmp_path)
        return
    from predictionio_tpu_torch.tools.console import _setup_compilation_cache

    _scrub_cache_env(monkeypatch)
    assert port_aot.fallback_tier() == 3
    monkeypatch.setenv("TORCHINDUCTOR_CACHE_DIR", str(tmp_path / "inductor-default"))
    assert port_aot.fallback_tier() == 3
    # the flag: both caches under DIR, and tier 2
    _setup_compilation_cache(str(tmp_path / "flag"))
    assert os.environ["TORCHINDUCTOR_CACHE_DIR"] == str(tmp_path / "flag" / "inductor")
    assert os.environ["TRITON_CACHE_DIR"] == str(tmp_path / "flag" / "triton")
    assert port_aot.fallback_tier() == 2
    # the environment variable, then "0" turning the caches off
    monkeypatch.setenv("PIO_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    _setup_compilation_cache(None)
    assert os.environ["TORCHINDUCTOR_CACHE_DIR"] == str(tmp_path / "env" / "inductor")
    assert port_aot.fallback_tier() == 2
    _setup_compilation_cache("0")
    assert port_aot.fallback_tier() == 3
    # the default: <basedir>/torch_cache, an operator's own cache kept
    monkeypatch.delenv("PIO_COMPILATION_CACHE_DIR")
    monkeypatch.delenv("TORCHINDUCTOR_CACHE_DIR")
    monkeypatch.setenv("TRITON_CACHE_DIR", str(tmp_path / "own"))
    _setup_compilation_cache(None)
    assert os.environ["TORCHINDUCTOR_CACHE_DIR"] == os.path.join(Storage.base_dir(), "torch_cache", "inductor")
    assert os.environ["TRITON_CACHE_DIR"] == str(tmp_path / "own")
    assert port_aot.fallback_tier() == 2


@pytest.mark.parametrize("package", ["torch"], indirect=True)
def test_serving_parity_tier1_and_on_fallback_across_modes(package, trained, artifacts, tmp_path):
    """Red in the reference, so ``[torch]`` only: a healthy tier-1 boot
    serves the pinned eager path's bytes, and a foreign set falls back
    without changing one, in the exact, ANN, int8 and sharded modes."""
    # the JAX package serves ANN from device arrays whether or not it
    # pins; the port's counterpart on the CPU is pinned tensors (an
    # unpinned port service there serves host numpy, whose products round
    # differently), and --aot pins, so every service of the case pins
    def pinned_service(*args, **kwargs):
        kwargs.setdefault("cache", CacheConfig(pin_model=True))
        return port_serving.QueryService(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_cases, "QueryService", pinned_service)
        jax_cases.test_serving_parity_tier1_and_on_fallback_across_modes(trained, artifacts, tmp_path)


def test_registry_stamp_inheritance_and_artifact_gc(package, tmp_path, monkeypatch):
    jax_cases.test_registry_stamp_inheritance_and_artifact_gc(tmp_path, monkeypatch)


def test_router_rolling_reload_gates_on_artifacts(package, tmp_path):
    jax_cases.test_router_rolling_reload_gates_on_artifacts(tmp_path)


def test_status_reports_artifact_states(package, tmp_path, trained):
    jax_cases.test_status_reports_artifact_states(tmp_path, trained)


def test_zero_compile_gate_is_absolute(package):
    jax_cases.test_zero_compile_gate_is_absolute()


def test_aot_warm_serving_glue_hook(trained):
    jax_cases.test_aot_warm_serving_glue_hook(trained)


def test_cases_run_on_the_ports_classes(package):
    from predictionio_tpu.fleet.registry import ModelRegistry
    from predictionio_tpu.tools import commands

    prefix = "predictionio_tpu." if package == "jax" else "predictionio_tpu_torch."
    for obj in (jax_cases.QueryService, jax_cases.run_train, ModelRegistry, jax_cases.aot.AotRuntime):
        assert obj.__module__.startswith(prefix)
    assert commands.__name__.startswith(prefix)


# ---------------------------------------------------------------------------
# Across the packages, and the port's own contracts
# ---------------------------------------------------------------------------


QUERIES = [{"user": str(u), "num": n} for u, n in ((0, 7), (3, 10), (11, 1), (29, 16), (99, 4))]


def _serve(qs) -> list:
    try:
        return [qs.handle_query(dict(q)) for q in QUERIES]
    finally:
        qs.close()


@pytest.fixture()
def jax_store(port):
    """The JAX package's ``Storage`` on the port's base directory."""
    JaxStorage.configure(port.trained.config)
    try:
        yield JaxStorage
    finally:
        JaxStorage.configure(None)


def test_tier1_answers_like_the_jax_pinned_service(port, jax_store):
    """One blob: the port's tier-1 service and the JAX package's plain
    pinned service answer with the same items, scores within rtol 1e-6
    (``tests/test_torch_serving.py``'s bar across packages)."""
    root, trained = port.root, port.trained
    tier1 = port_serving.QueryService(
        trained.variant, trained.ctx, instance_id=trained.instance.id,
        aot=port_aot.AotConfig(enabled=True, root=root),
    )
    assert tier1.stats_json()["aot"]["tier"] == 1
    got = _serve(tier1)
    want = _serve(JaxQueryService(
        jax_load_variant(_VARIANT), instance_id=trained.instance.id, cache=JaxCacheConfig(pin_model=True),
    ))
    assert [s for s, _ in got] == [s for s, _ in want] == [200] * len(QUERIES)
    for (_, g), (_, w) in zip(got, want):
        assert [x["item"] for x in g["itemScores"]] == [x["item"] for x in w["itemScores"]]
        np.testing.assert_allclose(
            [x["score"] for x in g["itemScores"]], [x["score"] for x in w["itemScores"]], rtol=1e-6
        )


def test_each_package_refuses_the_others_artifacts(port, jax_store, tmp_path, caplog):
    """Both packages write ``<basedir>/fleet/aot/<instance>/``; each load
    refuses the other's set with a fingerprint mismatch, loudly, and its
    service serves the bytes of its own pinned path."""
    port_root, trained = port.root, port.trained
    jax_root = str(tmp_path / "jax_aot")
    jax_variant = jax_load_variant(_VARIANT)
    from predictionio_tpu.controller import local_context as jax_local_context

    engine = jax_variant.build_engine()
    blob = JaxStorage.get_model_data_models().get(trained.instance.id)
    _, jax_pairs = engine.prepare_deploy(
        jax_local_context(), jax_variant.engine_params(engine), trained.instance.id, blob.models
    )
    assert jax_aot.export_instance(jax_pairs, trained.instance.id, jax_root) is not None

    with caplog.at_level(logging.WARNING):
        runtime, report = port_aot.load_runtime(trained.instance.id, jax_root)
    assert runtime is None and report["tier"] in (2, 3)
    assert any("fingerprint mismatch" in p and "torchVersion" in p for p in report["problems"])
    assert "falling back to tier" in caplog.text
    runtime, report = jax_aot.load_runtime(trained.instance.id, port_root)
    assert runtime is None and any("fingerprint mismatch" in p and "jaxVersion" in p for p in report["problems"])

    port_plain = _serve(port_serving.QueryService(
        trained.variant, trained.ctx, instance_id=trained.instance.id, cache=CacheConfig(pin_model=True)
    ))
    port_fellback = port_serving.QueryService(
        trained.variant, trained.ctx, instance_id=trained.instance.id,
        aot=port_aot.AotConfig(enabled=True, root=jax_root),
    )
    assert port_fellback.stats_json()["aot"]["tier"] in (2, 3)
    assert _serve(port_fellback) == port_plain
    jax_plain = _serve(JaxQueryService(
        jax_variant, instance_id=trained.instance.id, cache=JaxCacheConfig(pin_model=True)
    ))
    jax_fellback = _serve(JaxQueryService(
        jax_variant, instance_id=trained.instance.id, aot=jax_aot.AotConfig(enabled=True, root=port_root)
    ))
    assert jax_fellback == jax_plain


def _pinned_model(trained):
    pairs, _ = port_device_state.pin_pairs(_port_pairs(trained))
    return pairs[0][1]


def test_a_grown_table_disables_the_program_before_the_call(port, caplog):
    """A program fits one table shape; called on a table one row longer
    (an online fold's growth) it is disabled with the reference's warning
    before it runs, and the caller serves eagerly."""
    root, trained = port.root, port.trained
    runtime, _ = port_aot.load_runtime(trained.instance.id, root)
    model = _pinned_model(trained)

    def never(*_args):
        raise AssertionError("an unchecked call ran")

    runtime._programs["predict_scores"] = never
    grown = torch.cat([model.item_factors, model.item_factors[:1]])
    with caplog.at_level(logging.WARNING):
        assert runtime.run("predict_scores", model.user_factors[0], grown) is None
    assert runtime.stats()["disabled"] == 1 and runtime.stats()["hits"] == 0
    assert "disabled at serve time" in caplog.text and "shape" in caplog.text
    assert runtime.run("predict_scores", model.user_factors[0], model.item_factors) is None  # stays off
    # a wrong dtype and a wrong device are refused the same way
    runtime2, _ = port_aot.load_runtime(trained.instance.id, root)
    assert runtime2.run("top_k_scores_b16", torch.zeros(grown.shape[0] - 1, dtype=torch.float64)) is None
    assert "dtype" in caplog.text


@pytest.mark.parametrize("n_users", [1, 5, 8, 13])
def test_chunked_topk_aot_is_bit_equal_to_eager(port, n_users):
    """``chunked_topk(aot=)`` runs the batch program (ids padded to 8 or
    16 rows) and answers with the eager product's ids and score bits."""
    root, trained = port.root, port.trained
    runtime, report = port_aot.load_runtime(trained.instance.id, root)
    assert runtime is not None, report
    model = _pinned_model(trained)
    rng = np.random.default_rng(n_users)
    valid = [(j, int(u), int(k)) for j, (u, k) in enumerate(zip(
        rng.integers(0, jax_cases.N_USERS, n_users), rng.integers(1, 17, n_users)
    ))]
    kw = dict(chunk=CHUNK)
    eager = list(chunked_topk(model.user_factors, model.item_factors, valid, **kw))
    tier1 = list(chunked_topk(model.user_factors, model.item_factors, valid, aot=runtime, **kw))
    assert runtime.stats()["hits"] == 1 and runtime.stats()["disabled"] == 0
    assert [p for p, _, _ in tier1] == [p for p, _, _ in eager]
    assert [i for _, i, _ in tier1] == [i for _, i, _ in eager]
    bits = lambda rows: [np.asarray(r, np.float32).view(np.int32).tolist() for r in rows]  # noqa: E731
    assert [bits(s) for _, _, s in tier1] == [bits(s) for _, _, s in eager]


def test_release_retires_the_generations_programs(port):
    """``release_pinned_model`` drops ``_pio_aot`` with the tables, and the
    runtime's extracted package directories go with its last reference."""
    root, trained = port.root, port.trained
    pairs, _ = port_device_state.pin_pairs(
        _port_pairs(trained), aot=port_aot.AotConfig(enabled=True, root=root),
        instance_id=trained.instance.id,
    )
    algo, model = pairs[0]
    assert model._pio_aot is not None and model._pio_aot_report["tier"] == 1
    assert port_device_state.aot_stats(pairs)["loaded"] == 3
    algo.release_pinned_model(model)
    assert model._pio_aot is None and not model._pio_pinned
    assert port_device_state.aot_stats(pairs)["tier"] == 1  # the load's report stays readable


def test_serve_compile_counter_counts_loads_and_builds():
    """``serveTimeCompiles`` counts from the last boot mark: program
    loads and nvcc runs noted by their call sites, Inductor and dynamo
    compiles read from ``torch._dynamo``."""
    counter = port_jit_witness.ServeCompileCounter.install()
    assert counter is port_jit_witness.ServeCompileCounter.install()
    counter.mark_boot_complete()
    assert counter.serve_time_compiles() == 0
    port_jit_witness.note_compile("nvcc")
    port_jit_witness.note_compile("aoti_load_package")
    assert counter.serve_time_compiles() == 2
    counter.mark_boot_complete()
    assert counter.serve_time_compiles() == 0
    assert set(port_jit_witness.compile_counts()) == {"nvcc", "aoti_load_package", "inductor", "dynamo"}


def test_train_aot_through_the_console(port, tmp_path, capsys, monkeypatch):
    """``pio train --aot`` exports, stamps the registry (``pio status``
    says ``present``), and a failed export warns without failing the
    train."""
    from predictionio_tpu_torch.tools import console

    engine_json = tmp_path / "engine.json"
    engine_json.write_text(json.dumps(_VARIANT))
    base = port.trained.config["PIO_FS_BASEDIR"]
    _scrub_cache_env(monkeypatch)
    try:
        assert console.main(["train", "--engine-json", str(engine_json), "--device", "cpu", "--aot",
                             "--compilation-cache-dir", str(tmp_path / "cache")]) == 0
        out = capsys.readouterr().out
        assert "AOT export: 3 programs" in out and "Training completed" in out
        assert os.environ["TORCHINDUCTOR_CACHE_DIR"] == str(tmp_path / "cache" / "inductor")
        rows = port_commands.aot_artifact_status(out=lambda _line: None, device="cpu")
        assert rows[0]["artifacts"] == "present"
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(port_aot, "export_instance", lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom")))
            assert console.main(["train", "--engine-json", str(engine_json), "--device", "cpu", "--aot"]) == 0
        captured = capsys.readouterr()
        assert "WARNING: --aot: export failed (RuntimeError: boom)" in captured.err
        assert "Training completed" in captured.out
    finally:
        shutil.rmtree(os.path.join(base, "fleet"), ignore_errors=True)



def test_worker_processes_compile_what_this_process_does(tmp_path):
    """The card's export path compiles in spawn worker processes: a
    program compiled there loads and answers as the same program compiled
    in this process does, and as the eager function."""
    from torch._inductor import aoti_load_package

    scores = torch.as_tensor(np.random.default_rng(3).standard_normal(64).astype(np.float32))
    program = port_aot.ServingProgram(port_als.TopKScoresProgram(16), (scores,))
    here, there = str(tmp_path / "here.pt2"), str(tmp_path / "there.pt2")
    cxx = port_aot._wrapper_compiler()
    assert len(port_aot._compile_all([(program, here)], cxx, 1)) == 1
    assert len(port_aot._compile_all([(program, there)], cxx, 2)) == 1
    want = port_topk.top_k_scores(scores, 16)
    for path in (here, there):
        ids, vals = aoti_load_package(path)(scores)
        assert torch.equal(ids, want[0]) and torch.equal(vals, want[1])
