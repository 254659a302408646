"""Core SPI: reflective component construction.

Parity: ``core/src/main/scala/org/apache/predictionio/core/AbstractDoer.scala``
and the ``Base*`` trait layer (``BaseDataSource.scala`` etc.). The reference
needs a separate Base layer to erase Scala generics so the untyped workflow
can call ``trainBase``/``predictBase``; Python is duck-typed, so the Base
layer collapses into the user-facing classes in
:mod:`predictionio_tpu_torch.controller.components` — each exposes ``*_base``
methods the workflow drives. What remains here is ``Doer`` construction:
instantiating a component class with its ``Params``, matching the
reference's two-constructor convention (``C(params)`` or ``C()``).
"""

from __future__ import annotations

import inspect
from typing import Any, Type, TypeVar

from predictionio_tpu_torch.controller.params import EmptyParams, Params

__all__ = ["create_doer"]

T = TypeVar("T")


def create_doer(cls: Type[T], params: Params | None = None, **kwargs: Any) -> T:
    """Instantiate a DASE component with its params
    (parity: ``AbstractDoer.apply`` — try the ``Params`` constructor first,
    fall back to zero-arg). ``kwargs`` go to the constructor as they are:
    the engine hands a :class:`~predictionio_tpu_torch.controller.components.TorchAlgorithm`
    its context's ``device`` this way."""
    params = params if params is not None else EmptyParams()
    sig = inspect.signature(cls.__init__)
    arity = sum(
        1
        for n, p in sig.parameters.items()
        if n != "self"
        and p.kind in (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)
        and p.default is inspect.Parameter.empty
    )
    if arity >= 1:
        return cls(params, **kwargs)  # type: ignore[call-arg]
    if isinstance(params, EmptyParams):
        return cls(**kwargs)  # type: ignore[call-arg]
    # Component declared no params constructor but params were supplied:
    # still try to pass them (optional-params constructors), else fail loudly.
    try:
        return cls(params, **kwargs)  # type: ignore[call-arg]
    except TypeError as e:
        raise TypeError(
            f"{cls.__name__} takes no params but params {params!r} were given"
        ) from e
