"""The Engine: a typed DASE composition plus its train/eval/deploy logic.

Counterpart of ``predictionio_tpu/controller/engine.py``. Parity:
``core/src/main/scala/org/apache/predictionio/controller/Engine.scala``
(``class Engine[TD,EI,PD,Q,P,A]``, ``object Engine.train/eval``,
``makeSerializableModels``, ``prepareDeploy``, ``SimpleEngine``,
``EngineParams``) and ``EngineFactory.scala``.

An engine is data: the component *classes* plus a parallel ``EngineParams``
carrying each component's ``Params``. The workflow layer
(:mod:`predictionio_tpu_torch.workflow`) instantiates and drives it. A
:class:`~predictionio_tpu_torch.controller.components.TorchAlgorithm` is
constructed on the workflow context's device.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Mapping, Sequence, Type

from predictionio_tpu_torch.controller.base import create_doer
from predictionio_tpu_torch.controller.components import (
    Algorithm,
    DataSource,
    FirstServing,
    IdentityPreparator,
    Preparator,
    SanityCheck,
    Serving,
    TorchAlgorithm,
)
from predictionio_tpu_torch.controller.context import WorkflowContext
from predictionio_tpu_torch.controller.params import EmptyParams, Params, params_from_json
from predictionio_tpu_torch.controller.persistent import (
    PersistentModel,
    PersistentModelManifest,
    load_persistent_model,
)
from predictionio_tpu_torch.utils.serialization import dumps_model, loads_model

__all__ = [
    "EngineParams",
    "Engine",
    "SimpleEngine",
    "EngineFactory",
    "resolve_engine_factory",
]

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class EngineParams:
    """Per-component parameters for one engine variant
    (parity: ``EngineParams`` in ``Engine.scala``).

    ``algorithms`` is an ordered list of ``(algorithm_name, params)`` —
    order defines prediction order into ``Serving.serve``.
    """

    datasource: Params = dataclasses.field(default_factory=EmptyParams)
    preparator: Params = dataclasses.field(default_factory=EmptyParams)
    algorithms: tuple = ()  # tuple[tuple[str, Params], ...]
    serving: Params = dataclasses.field(default_factory=EmptyParams)


class Engine:
    """DASE composition (parity: ``class Engine`` in ``Engine.scala``)."""

    def __init__(
        self,
        datasource_class: Type[DataSource],
        preparator_class: Type[Preparator],
        algorithms_class_map: Mapping[str, Type[Algorithm]],
        serving_class: Type[Serving],
    ):
        if not algorithms_class_map:
            raise ValueError("Engine needs at least one algorithm class")
        self.datasource_class = datasource_class
        self.preparator_class = preparator_class
        self.algorithms_class_map = dict(algorithms_class_map)
        self.serving_class = serving_class

    # ------------------------------------------------------------------ params
    def params_from_json(self, obj: Mapping[str, Any]) -> EngineParams:
        """Bind an engine.json ``params`` tree to typed ``EngineParams``,
        strictly (see :func:`predictionio_tpu_torch.controller.params.params_from_json`).

        Expected shape (byte-compatible with reference engine.json)::

            {"datasource": {"params": {...}},
             "preparator": {"params": {...}},
             "algorithms": [{"name": "als", "params": {...}}, ...],
             "serving": {"params": {...}}}
        """

        def block(component: Any, label: str) -> Mapping[str, Any]:
            """Extract a component's ``params`` block, strictly: stray keys
            (e.g. params written without the ``params`` wrapper) raise
            instead of silently training with defaults."""
            if component is None:
                return {}
            if not isinstance(component, Mapping):
                raise ValueError(f"engine.json '{label}' must be an object")
            stray = set(component) - {"params", "name"}
            if stray:
                raise ValueError(
                    f"engine.json '{label}' has unexpected key(s) {sorted(stray)}; "
                    "component params belong under a 'params' block"
                )
            return component.get("params", {})

        def params_cls(cls: type) -> type:
            return getattr(cls, "params_class", EmptyParams)

        algorithms = []
        for entry in obj.get("algorithms") or []:
            if not isinstance(entry, Mapping):
                raise ValueError(
                    f"engine.json algorithms entries must be objects like "
                    f'{{"name": ..., "params": {{...}}}}; got {entry!r}'
                )
            name = entry.get("name")
            if name not in self.algorithms_class_map:
                raise ValueError(
                    f"engine.json names unknown algorithm '{name}'; "
                    f"available: {sorted(self.algorithms_class_map)}"
                )
            cls = self.algorithms_class_map[name]
            algorithms.append(
                (name, params_from_json(params_cls(cls), block(entry, f"algorithms[{name}]")))
            )
        if not algorithms:
            # Default: first registered algorithm with empty params.
            first = next(iter(self.algorithms_class_map))
            algorithms = [(first, params_from_json(params_cls(self.algorithms_class_map[first]), {}))]

        return EngineParams(
            datasource=params_from_json(
                params_cls(self.datasource_class), block(obj.get("datasource"), "datasource")
            ),
            preparator=params_from_json(
                params_cls(self.preparator_class), block(obj.get("preparator"), "preparator")
            ),
            algorithms=tuple(algorithms),
            serving=params_from_json(
                params_cls(self.serving_class), block(obj.get("serving"), "serving")
            ),
        )

    # ------------------------------------------------------------------ doers
    def _algorithm_classes(self, engine_params: EngineParams) -> list[tuple[str, type, Params]]:
        out = []
        for name, params in engine_params.algorithms:
            if name not in self.algorithms_class_map:
                raise ValueError(f"Unknown algorithm '{name}'")
            out.append((name, self.algorithms_class_map[name], params))
        return out

    def _make_algorithms(
        self, engine_params: EngineParams, ctx: WorkflowContext
    ) -> list[tuple[str, Algorithm]]:
        """One doer per algorithm; a ``TorchAlgorithm`` on ``ctx.device``."""
        return [
            (
                name,
                create_doer(cls, params, device=ctx.device)
                if issubclass(cls, TorchAlgorithm)
                else create_doer(cls, params),
            )
            for name, cls, params in self._algorithm_classes(engine_params)
        ]

    @staticmethod
    def _sanity(obj: Any, enabled: bool, label: str) -> None:
        if enabled and isinstance(obj, SanityCheck):
            logger.info("Sanity-checking %s", label)
            obj.sanity_check()

    # ------------------------------------------------------------------ train
    def train(
        self,
        ctx: WorkflowContext,
        engine_params: EngineParams,
        sanity_check: bool = False,
        stop_after_read: bool = False,
        stop_after_prepare: bool = False,
        timings: dict | None = None,
        warm_models: Sequence[tuple[str, Any]] | None = None,
    ) -> list[Any]:
        """Run DASE training; returns one model per algorithm
        (parity: ``object Engine.train``; the ``stop_after_*`` flags mirror
        ``WorkflowParams.stopAfterRead/Prepare``). When ``timings`` is a
        dict, per-phase wall-clock seconds are recorded into it
        (read/prepare/train:<name>). ``warm_models`` (``models_from_bytes``
        of a previous COMPLETED instance) hands each algorithm its
        predecessor via ``ctx.warm_model`` for warm-started retrains."""

        def _timed(label: str, fn):
            t0 = time.perf_counter()
            result = fn()
            if timings is not None:
                timings[label] = round(time.perf_counter() - t0, 3)
            return result

        # Instantiate algorithms first so a bad engine.json fails before the
        # (expensive) data read — mirrors the reference's early reflection.
        algorithms = self._make_algorithms(engine_params, ctx)
        datasource = create_doer(self.datasource_class, engine_params.datasource)
        td = _timed("read", lambda: datasource.read_training_base(ctx))
        self._sanity(td, sanity_check, "training data")
        if stop_after_read:
            return []
        preparator = create_doer(self.preparator_class, engine_params.preparator)
        pd = _timed("prepare", lambda: preparator.prepare_base(ctx, td))
        self._sanity(pd, sanity_check, "prepared data")
        if stop_after_prepare:
            return []
        # pair warm models to algorithms by NAME (position as tie-break for
        # duplicate names): a reordered algorithms list must still seed
        # every algorithm whose predecessor exists
        warm_pool = list(warm_models) if warm_models else []

        def take_warm(i: int, name: str):
            if i < len(warm_pool) and warm_pool[i] is not None and warm_pool[i][0] == name:
                model = warm_pool[i][1]
                warm_pool[i] = None
                return model
            for j, entry in enumerate(warm_pool):
                if entry is not None and entry[0] == name:
                    warm_pool[j] = None
                    return entry[1]
            return None

        models = []
        for i, (name, algo) in enumerate(algorithms):
            logger.info("Training algorithm '%s' (%s)", name, type(algo).__name__)
            key = f"train:{name}"
            if timings is not None and key in timings:
                key = f"train:{name}#{i}"  # same algorithm listed twice
            warm = take_warm(i, name)
            a_ctx = ctx if warm is None else dataclasses.replace(ctx, warm_model=warm)
            models.append(_timed(key, lambda a=algo, c=a_ctx: a.train_base(c, pd)))
        return models

    # ------------------------------------------------------------------ eval
    def read_eval_folds(self, ctx: WorkflowContext, engine_params: EngineParams) -> list:
        """Materialize the eval folds for these datasource params — split
        out so a parameter sweep whose candidates share datasource params
        reads and splits the events once (see MetricEvaluator's fold
        cache)."""
        datasource = create_doer(self.datasource_class, engine_params.datasource)
        return list(datasource.read_eval_base(ctx))

    def eval(
        self,
        ctx: WorkflowContext,
        engine_params: EngineParams,
        folds: list | None = None,
    ) -> list[tuple[Any, list[tuple[Any, Any, Any]]]]:
        """Per eval fold: train on TD, batch-predict the held-out queries,
        serve, and pair with actuals -> ``[(EI, [(Q, P, A), ...]), ...]``
        (parity: ``object Engine.eval``). ``folds`` short-circuits the
        datasource read (fold reuse across sweep candidates). Each
        algorithm trains on ``ctx.device``, and its model goes through
        ``prepare_model_for_serving`` before the predictions, as on the
        deploy path: ``train`` returns host arrays, predict reads them on
        the device."""
        preparator = create_doer(self.preparator_class, engine_params.preparator)
        serving = create_doer(self.serving_class, engine_params.serving)
        if folds is None:
            folds = self.read_eval_folds(ctx, engine_params)
        results = []
        for fold_index, (td, eval_info, qa_pairs) in enumerate(folds):
            logger.info("Evaluating fold %d (%d queries)", fold_index, len(qa_pairs))
            pd = preparator.prepare_base(ctx, td)
            algos = self._make_algorithms(engine_params, ctx)
            models = [
                algo.prepare_model_for_serving(algo.train_base(ctx, pd)) for _, algo in algos
            ]
            # supplement once, then both predict and serve see the
            # supplemented query, as on the deploy path
            supplemented = [serving.supplement_base(q) for q, _ in qa_pairs]
            indexed_queries = list(enumerate(supplemented))
            per_algo = [
                dict(algo.batch_predict_base(model, indexed_queries))
                for (_name, algo), model in zip(algos, models)
            ]
            qpa = [
                (sq, serving.serve_base(sq, [preds[i] for preds in per_algo]), a)
                for i, (sq, (_, a)) in enumerate(zip(supplemented, qa_pairs))
            ]
            results.append((eval_info, qpa))
        return results

    # ---------------------------------------------------------- persistence
    def models_to_bytes(
        self,
        instance_id: str,
        engine_params: EngineParams,
        models: Sequence[Any],
    ) -> bytes:
        """Serialize trained models for the ``Models`` repo
        (parity: ``Engine.makeSerializableModels``): each model is either

        * a :class:`PersistentModel` that saved itself -> store its manifest;
        * anything else -> pickled inline, tensors as host numpy.
        """
        algos = self._algorithm_classes(engine_params)
        if len(models) != len(algos):
            raise ValueError(
                f"Got {len(models)} models for {len(algos)} algorithms; "
                "models must align 1:1 with engine_params.algorithms"
            )
        entries: list[tuple[str, Any]] = []
        for (_name, _cls, params), model in zip(algos, models):
            if isinstance(model, PersistentModel) and model.save(instance_id, params):
                entries.append(("persistent", PersistentModelManifest(type(model).class_path())))
                continue
            entries.append(("pickle", model))
        return dumps_model(entries)

    def models_from_bytes(
        self,
        engine_params: EngineParams,
        instance_id: str,
        model_blob: bytes,
    ) -> list[tuple[str, Any]]:
        """Re-hydrate the raw trained models of a completed instance as
        ``[(algorithm_name, model), ...]`` — no serving preparation. Reads
        the JAX package's blobs too (:func:`loads_model`)."""
        algos = self._algorithm_classes(engine_params)
        entries = loads_model(model_blob)
        if len(entries) != len(algos):
            raise ValueError(
                f"Model blob holds {len(entries)} models but engine params "
                f"declare {len(algos)} algorithms"
            )
        out = []
        for (name, _cls, params), (kind, payload) in zip(algos, entries):
            if kind == "persistent":
                model = load_persistent_model(payload, instance_id, params)
            elif kind == "pickle":
                model = payload
            else:
                raise ValueError(f"Unknown model entry kind '{kind}'")
            out.append((name, model))
        return out

    def prepare_deploy(
        self,
        ctx: WorkflowContext,
        engine_params: EngineParams,
        instance_id: str,
        model_blob: bytes,
        prepare: bool = True,
    ) -> tuple[Serving, list[tuple[Algorithm, Any]]]:
        """Re-hydrate serving components + models from a completed train
        (parity: ``Engine.prepareDeploy``). Each algorithm is constructed on
        ``ctx.device`` and runs its ``prepare_model_for_serving`` (device
        placement, warm-up). ``prepare=False`` hands the models back as
        the blob holds them, for a serving tier that places them itself
        (``device_state.pin_pairs(prepared=False)``: the sharded and int8
        tiers, which never hold a replicated f32 copy on the card)."""
        serving = create_doer(self.serving_class, engine_params.serving)
        algos = self._make_algorithms(engine_params, ctx)
        named = self.models_from_bytes(engine_params, instance_id, model_blob)
        return serving, [
            (algo, algo.prepare_model_for_serving(model) if prepare else model)
            for (_name, algo), (_n, model) in zip(algos, named)
        ]


class SimpleEngine(Engine):
    """Single-datasource, single-algorithm engine with FirstServing
    (parity: ``SimpleEngine`` in ``Engine.scala``)."""

    def __init__(self, datasource_class: Type[DataSource], algorithm_class: Type[Algorithm]):
        super().__init__(
            datasource_class=datasource_class,
            preparator_class=IdentityPreparator,
            algorithms_class_map={"": algorithm_class},
            serving_class=FirstServing,
        )


#: An EngineFactory is any zero-arg callable returning an Engine
#: (parity: ``trait EngineFactory``). engine.json's ``engineFactory`` names
#: one as ``"package.module:attr"`` (or dotted path whose last element is
#: the attribute).
EngineFactory = Callable[[], Engine]


def resolve_engine_factory(path: str) -> EngineFactory:
    """Resolve an ``engineFactory`` string to the factory callable
    (parity: the reflective ``EngineFactory`` lookup in
    ``core/workflow/CreateWorkflow.scala``). A path into the JAX package
    resolves to the port's module of the same path, by text
    (:func:`~predictionio_tpu_torch.utils.reflection.resolve_attr`)."""
    from predictionio_tpu_torch.utils.reflection import resolve_attr

    obj = resolve_attr(path)
    if isinstance(obj, Engine):
        return lambda: obj
    if not callable(obj):
        raise TypeError(f"Engine factory '{path}' is not callable")
    return obj
