"""User-facing DASE component base classes.

Counterpart of ``predictionio_tpu/controller/components.py``. Parity map
(reference ``core/src/main/scala/org/apache/predictionio/controller/``):

* ``PDataSource.scala`` / ``LDataSource.scala``  -> :class:`DataSource`
* ``PPreparator.scala`` / ``LPreparator.scala`` / ``IdentityPreparator.scala``
  -> :class:`Preparator`, :class:`IdentityPreparator`
* ``PAlgorithm.scala`` / ``P2LAlgorithm.scala`` / ``LAlgorithm.scala``
  -> :class:`Algorithm` (base), :class:`TorchAlgorithm`, :class:`LocalAlgorithm`
* ``LServing.scala`` / ``FirstServing.scala`` / ``AverageServing.scala``
  -> :class:`Serving`, :class:`FirstServing`, :class:`AverageServing`
* ``SanityCheck.scala`` -> :class:`SanityCheck`

Where the JAX package has ``JaxAlgorithm`` (train as jitted programs over
the context's mesh), the port has :class:`TorchAlgorithm`: train runs
PyTorch on the context's device and returns a model of host arrays;
deploy places the model on that device and warms the query path.

Every class also exposes the ``*_base`` methods the workflow layer drives
(the collapsed Base* SPI — see :mod:`predictionio_tpu_torch.controller.base`).
"""

from __future__ import annotations

import abc
from typing import Any, Callable, Generic, Sequence, TypeVar

import numpy as np
import torch

from predictionio_tpu_torch.controller.context import WorkflowContext
from predictionio_tpu_torch.controller.params import EmptyParams, Params
from predictionio_tpu_torch.device import resolve_device

__all__ = [
    "DataSource",
    "Preparator",
    "IdentityPreparator",
    "Algorithm",
    "TorchAlgorithm",
    "LocalAlgorithm",
    "Serving",
    "FirstServing",
    "AverageServing",
    "SanityCheck",
    "EvalUnit",
]

TD = TypeVar("TD")  # training data
EI = TypeVar("EI")  # evaluation info
PD = TypeVar("PD")  # prepared data
Q = TypeVar("Q")  # query
P = TypeVar("P")  # predicted result
A = TypeVar("A")  # actual result
M = TypeVar("M")  # model

#: One eval fold: (training data, eval info, [(query, actual), ...]).
EvalUnit = tuple  # (TD, EI, list[tuple[Q, A]])


class SanityCheck(abc.ABC):
    """Data classes may implement this to be checked after read/prepare when
    the workflow runs with sanity checks on (parity: ``SanityCheck.scala``)."""

    @abc.abstractmethod
    def sanity_check(self) -> None:
        """Raise on inconsistent data."""


class _Component:
    """Shared plumbing: every DASE component may hold a ``Params``."""

    def __init__(self, params: Params | None = None):
        self.params: Params = params if params is not None else EmptyParams()


class DataSource(_Component, Generic[TD, EI, Q, A]):
    """Reads training and evaluation data from the event store
    (parity: ``PDataSource.scala``; the L variant collapses in, since both
    return host-side data here — device placement happens in the algorithm).
    """

    def read_training(self, ctx: WorkflowContext) -> TD:
        raise NotImplementedError(f"{type(self).__name__} must implement read_training")

    def read_eval(self, ctx: WorkflowContext) -> list[EvalUnit]:
        """K folds of (TD, EI, [(Q, A)]) (parity: ``readEval``)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support evaluation "
            "(implement read_eval)"
        )

    # -- Base SPI ----------------------------------------------------------
    def read_training_base(self, ctx: WorkflowContext) -> TD:
        return self.read_training(ctx)

    def read_eval_base(self, ctx: WorkflowContext) -> list[EvalUnit]:
        return self.read_eval(ctx)


class Preparator(_Component, Generic[TD, PD]):
    """Transforms training data into algorithm-ready prepared data
    (parity: ``PPreparator.scala``)."""

    def prepare(self, ctx: WorkflowContext, training_data: TD) -> PD:
        raise NotImplementedError(f"{type(self).__name__} must implement prepare")

    def prepare_base(self, ctx: WorkflowContext, training_data: TD) -> PD:
        return self.prepare(ctx, training_data)


class IdentityPreparator(Preparator[TD, TD]):
    """Passes training data through unchanged
    (parity: ``IdentityPreparator.scala``)."""

    def prepare(self, ctx: WorkflowContext, training_data: TD) -> TD:
        return training_data


class Algorithm(_Component, Generic[PD, M, Q, P]):
    """Abstract algorithm: train a model, answer queries
    (parity: the shared surface of ``P/P2L/LAlgorithm.scala``)."""

    def train(self, ctx: WorkflowContext, prepared_data: PD) -> M:
        raise NotImplementedError(f"{type(self).__name__} must implement train")

    def predict(self, model: M, query: Q) -> P:
        raise NotImplementedError(f"{type(self).__name__} must implement predict")

    def batch_predict(self, model: M, queries: Sequence[tuple[int, Q]]) -> list[tuple[int, P]]:
        """Bulk prediction for evaluation (parity: ``batchPredict``).
        Default: loop ``predict``; device algorithms should override with
        a batched product."""
        return [(idx, self.predict(model, q)) for idx, q in queries]

    # -- serving lifecycle -------------------------------------------------
    def prepare_model_for_serving(self, model: M) -> M:
        """Hook run once at deploy time (warm-up, device placement).
        Parity: the model re-hydration decisions in ``Engine.prepareDeploy``."""
        return model

    # -- Base SPI ----------------------------------------------------------
    def train_base(self, ctx: WorkflowContext, prepared_data: PD) -> M:
        return self.train(ctx, prepared_data)

    def predict_base(self, model: Any, query: Any) -> Any:
        return self.predict(model, query)

    def batch_predict_base(
        self, model: Any, queries: Sequence[tuple[int, Any]]
    ) -> list[tuple[int, Any]]:
        return self.batch_predict(model, queries)


class TorchAlgorithm(Algorithm[PD, M, Q, P]):
    """An algorithm that trains and serves with PyTorch on one device
    (the port's ``JaxAlgorithm``).

    Contract:

    * the algorithm runs on ``device``, which the engine takes from the
      workflow context (``ctx.device``). ``None`` is the card: without
      one, construction raises. The CPU is used only when asked for;
    * ``train(ctx, pd)`` does its heavy compute on :attr:`device`, which
      must be ``ctx.device`` (:meth:`train_base` checks it), and
      returns a model whose arrays are host numpy, so a model crosses the
      train->serve boundary as a pickle of host arrays
      (``predictionio_tpu_torch.utils.serialization``);
    * ``predict(model, query)`` is cheap: Python-side lookup plus a call
      into device code. :meth:`kernel` memoizes what such a call needs
      built once, so the deploy-time warm-up builds it exactly once;
    * :meth:`prepare_model_for_serving` places the model's arrays on
      ``device`` and warms the query path (:meth:`warm_up`).
    """

    def __init__(self, params: Params | None = None, device: str | torch.device | None = None):
        super().__init__(params)
        self.device = resolve_device(device)
        self._kernels: dict[str, Callable] = {}

    def train_base(self, ctx: WorkflowContext, prepared_data: PD) -> M:
        if ctx.device != self.device:
            raise ValueError(
                f"{type(self).__name__} is on {self.device} but the context is on {ctx.device}"
            )
        return self.train(ctx, prepared_data)

    def kernel(self, name: str, build: Callable[[], Callable]) -> Callable:
        """Memoize ``build()`` under ``name`` (one build per algorithm)."""
        if name not in self._kernels:
            self._kernels[name] = build()
        return self._kernels[name]

    def _place(self, x: Any) -> Any:
        """Numpy arrays and tensors among ``x``'s leaves (``x`` itself, or
        the items of a dict, list or tuple) to tensors of the same dtype
        on :attr:`device`; every other leaf stays as it is."""
        if isinstance(x, np.ndarray):
            return torch.as_tensor(x, device=self.device)
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        if isinstance(x, dict):
            return {k: self._place(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(self._place(v) for v in x)
        return x

    def prepare_model_for_serving(self, model: M) -> M:
        """Place array leaves on :attr:`device`, so the first query pays no
        host-to-device copy, then :meth:`warm_up`."""
        model = self._place(model)
        self.warm_up(model)
        return model

    def warm_up(self, model: M) -> None:
        """Make the calling thread ready to serve ``model``: the query
        server calls this once on the thread every predict runs on. On
        the card, products run in full f32 (TF32 off), as in training."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
            torch.backends.cuda.matmul.allow_tf32 = False

    def check_host_serving(self) -> None:
        """A predict branch on host (numpy) tables is taken only on the
        CPU, where the caller asked for it. On the card, host tables mean
        the model was not pinned: an error, never a quiet move to the
        host."""
        if self.device.type != "cpu":
            raise RuntimeError(
                f"{type(self).__name__} on {self.device} was handed host tables: "
                "pin the model there first (prepare_model_for_serving)"
            )


class LocalAlgorithm(Algorithm[PD, M, Q, P]):
    """Plain single-host algorithm (parity: ``LAlgorithm.scala``) — numpy or
    pure-python models, no device involvement."""


class Serving(_Component, Generic[Q, P]):
    """Combines per-algorithm predictions into the served result
    (parity: ``LServing.scala``)."""

    def supplement(self, query: Q) -> Q:
        """Pre-process the incoming query (parity: ``supplement``)."""
        return query

    def serve(self, query: Q, predictions: Sequence[P]) -> P:
        raise NotImplementedError(f"{type(self).__name__} must implement serve")

    # -- Base SPI ----------------------------------------------------------
    def supplement_base(self, query: Q) -> Q:
        return self.supplement(query)

    def serve_base(self, query: Q, predictions: Sequence[P]) -> P:
        return self.serve(query, predictions)


class FirstServing(Serving[Q, P]):
    """Serve the first algorithm's prediction (parity: ``FirstServing.scala``)."""

    def serve(self, query: Q, predictions: Sequence[P]) -> P:
        if not predictions:
            raise ValueError("FirstServing got no predictions")
        return predictions[0]


class AverageServing(Serving[Q, float]):
    """Average numeric predictions (parity: ``AverageServing.scala``)."""

    def serve(self, query: Q, predictions: Sequence[float]) -> float:
        if not predictions:
            raise ValueError("AverageServing got no predictions")
        return float(sum(predictions)) / len(predictions)
