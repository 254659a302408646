"""Core workflow: train and evaluation runners with lineage records.

Counterpart of ``predictionio_tpu/workflow/core.py``. Parity:
``core/workflow/CoreWorkflow.scala`` (``runTrain`` — train, persist
models, insert COMPLETED ``EngineInstance`` with timings;
``runEvaluation``) and the argument surface of
``core/workflow/WorkflowParams.scala``.

In a multi-process job (``PIO_COORDINATOR_*``) every process trains —
the collectives need all of them — but only process 0 (the coordinator,
the Spark-driver role) writes the instance and the model blob, and a warm
start seeds every process from process 0's predecessor or from none.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import json
import logging
import uuid

from predictionio_tpu_torch.controller.context import WorkflowContext
from predictionio_tpu_torch.controller.engine import EngineParams
from predictionio_tpu_torch.controller.evaluation import (
    EngineParamsGenerator,
    Evaluation,
    MetricEvaluator,
    MetricEvaluatorResult,
)
from predictionio_tpu_torch.controller.params import params_to_json
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.data.storage.base import EngineInstance, EvaluationInstance, Model
from predictionio_tpu_torch.workflow.engine_json import EngineVariant

__all__ = ["WorkflowParams", "run_train", "run_evaluation", "params_json"]

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class WorkflowParams:
    """Invocation flags (parity: ``WorkflowParams.scala``)."""

    batch: str = ""
    skip_sanity_check: bool = False
    stop_after_read: bool = False
    stop_after_prepare: bool = False
    #: seed algorithms from the latest COMPLETED instance's model
    #: (`pio train --warm-start`) — retrains converge in fewer sweeps
    warm_start: bool = False


def _now() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


def params_json(ep: EngineParams) -> dict[str, str]:
    """The resolved component params as an ``EngineInstance`` stores them
    (the JAX package's ``_params_json``, field for field)."""
    return {
        "datasource_params": json.dumps(params_to_json(ep.datasource)),
        "preparator_params": json.dumps(params_to_json(ep.preparator)),
        "algorithms_params": json.dumps(
            [{"name": n, "params": params_to_json(p)} for n, p in ep.algorithms]
        ),
        "serving_params": json.dumps(params_to_json(ep.serving)),
    }


def run_train(
    variant: EngineVariant,
    ctx: WorkflowContext,
    workflow_params: WorkflowParams = WorkflowParams(),
    engine_id: str | None = None,
    engine_version: str = "",
) -> EngineInstance:
    """Train an engine variant end-to-end and record its lineage.

    Flow (parity: ``CoreWorkflow.runTrain``): insert a TRAINING
    ``EngineInstance`` -> ``Engine.train`` on ``ctx.device`` -> persist the
    model blob into the ``Models`` repo -> update the instance to
    COMPLETED with timings and the resolved component params. On error
    the instance is marked FAILED and the exception re-raised. With
    ``warm_start`` the latest COMPLETED instance of the same engine,
    version and variant seeds the algorithms (its blob may be the JAX
    package's), and the lineage records it as ``warm_start_from``; no
    predecessor, or one that does not load, is a cold start.
    """
    engine = variant.build_engine()
    engine_params = variant.engine_params(engine)
    instances = Storage.get_meta_data_engine_instances()
    is_writer = ctx.host_index == 0
    instance = EngineInstance(
        id=uuid.uuid4().hex,
        status="TRAINING",
        start_time=_now(),
        end_time=_now(),
        engine_id=engine_id or variant.id,
        engine_version=engine_version or variant.version,
        engine_variant=variant.id,
        engine_factory=variant.engine_factory,
        batch=workflow_params.batch,
        mesh_conf=ctx.mesh_conf(),
        **params_json(engine_params),
    )
    if is_writer:
        instances.insert(instance)
    try:
        warm_models = None
        warm_from = None
        if workflow_params.warm_start:
            prev = instances.get_latest_completed(
                instance.engine_id, instance.engine_version, instance.engine_variant
            )
            if ctx.num_hosts > 1:
                # every process seeds from the SAME predecessor: process
                # 0's choice wins, through the process group
                from predictionio_tpu_torch.parallel.exchange import allgather_objects

                prev_id = allgather_objects(prev.id if (is_writer and prev is not None) else None)[0]
                if prev_id is None:
                    prev = None
                elif prev is None or prev.id != prev_id:
                    prev = instances.get(prev_id)
            blob = Storage.get_model_data_models().get(prev.id) if prev is not None else None
            if blob is not None:
                try:
                    warm_models = engine.models_from_bytes(engine_params, prev.id, blob.models)
                    warm_from = prev.id
                except Exception as e:
                    # a changed algorithm list raises ValueError, a stale
                    # pickle AttributeError/ModuleNotFoundError/
                    # UnpicklingError: any of them is a cold start, not a
                    # failed train
                    logger.warning(
                        "--warm-start: could not hydrate predecessor model %s (%s: %s); cold start",
                        prev.id, type(e).__name__, e,
                    )
            else:
                logger.warning(
                    "--warm-start requested but no completed instance with a "
                    "stored model exists for this engine/variant; cold start"
                )
            if ctx.num_hosts > 1:
                # all processes warm-start from the same blob, or none does
                from predictionio_tpu_torch.parallel.exchange import allgather_objects

                have = allgather_objects(warm_from)
                if any(h != have[0] for h in have):
                    logger.warning(
                        "--warm-start: not every process could load the predecessor model (%s); "
                        "cold start everywhere", have,
                    )
                    warm_models = None
                    warm_from = None
            if warm_from is not None:
                logger.info("Warm-starting from completed instance %s", warm_from)
        timings: dict = {}
        models = engine.train(
            ctx,
            engine_params,
            sanity_check=not workflow_params.skip_sanity_check,
            stop_after_read=workflow_params.stop_after_read,
            stop_after_prepare=workflow_params.stop_after_prepare,
            timings=timings,
            warm_models=warm_models,
        )
        if workflow_params.stop_after_read or workflow_params.stop_after_prepare:
            # debugging run — nothing to persist (parity: reference aborts
            # after printing the data); record it as not-completed.
            instance = instance.with_status("STOPPED", end_time=_now())
            if is_writer:
                instances.update(instance)
            return instance
        if is_writer:
            blob = engine.models_to_bytes(instance.id, engine_params, models)
            Storage.get_model_data_models().insert(Model(id=instance.id, models=blob))
            logger.info("Saved model blob for instance %s (%d bytes)", instance.id, len(blob))
        env = {**instance.env, "phase_timings": json.dumps(timings)}
        if warm_from is not None:
            env["warm_start_from"] = warm_from
        instance = dataclasses.replace(instance, status="COMPLETED", end_time=_now(), env=env)
        if is_writer:
            instances.update(instance)
        logger.info(
            "Training completed: instance %s in %.1fs",
            instance.id,
            (instance.end_time - instance.start_time).total_seconds(),
        )
        return instance
    except Exception:
        if is_writer:
            instances.update(instance.with_status("FAILED", end_time=_now()))
        raise


def run_evaluation(
    evaluation: Evaluation,
    generator: EngineParamsGenerator,
    ctx: WorkflowContext,
    workflow_params: WorkflowParams = WorkflowParams(),
    evaluation_class: str = "",
    generator_class: str = "",
) -> tuple[EvaluationInstance, MetricEvaluatorResult]:
    """Run a parameter sweep on ``ctx.device`` and record an
    ``EvaluationInstance``: EVALUATING, then EVALCOMPLETED with the
    leaderboard and its JSON, or FAILED and the exception re-raised
    (parity: ``CoreWorkflow.runEvaluation`` + ``EvaluationWorkflow``)."""
    instances = Storage.get_meta_data_evaluation_instances()
    instance = EvaluationInstance(
        id=uuid.uuid4().hex,
        status="EVALUATING",
        start_time=_now(),
        end_time=_now(),
        evaluation_class=evaluation_class or type(evaluation).__name__,
        engine_params_generator_class=generator_class or type(generator).__name__,
        batch=workflow_params.batch,
    )
    instances.insert(instance)
    try:
        evaluator = MetricEvaluator(
            metric=evaluation.metric, other_metrics=tuple(evaluation.other_metrics)
        )
        result = evaluator.evaluate_base(
            ctx, evaluation.engine, list(generator.engine_params_list)
        )
        instance = dataclasses.replace(
            instance,
            status="EVALCOMPLETED",
            end_time=_now(),
            evaluator_results=result.leaderboard(),
            evaluator_results_json=json.dumps(result.to_json(), default=str),
        )
        instances.update(instance)
        return instance, result
    except Exception:
        instances.update(dataclasses.replace(instance, status="FAILED", end_time=_now()))
        raise
