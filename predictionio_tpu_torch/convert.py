"""Carry trained weights between the JAX package and the port.

A JAX-package ``ALSModel`` is host numpy factors plus two ``BiMap``s;
handed across as ``(user_factors, item_factors, user_index.to_dict(),
item_index.to_dict())`` it becomes the port's ``ALSModel`` with the
factors on ``device``, ready to serve. A ``TwoTowerServingModel`` goes
the same way with its seen filter: ``(user_vecs, item_vecs, user_index,
item_index, seen)``. The ``*_to_numpy`` functions are the inverses.
"""

from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np
import torch

from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.templates.recommendation.engine import ALSModel
from predictionio_tpu_torch.templates.twotower.engine import TwoTowerServingModel

__all__ = [
    "als_model_from_numpy",
    "als_model_to_numpy",
    "twotower_model_from_numpy",
    "twotower_model_to_numpy",
]


def _tables(
    users: np.ndarray, items: np.ndarray, user_index: Mapping[str, int], item_index: Mapping[str, int]
) -> tuple[np.ndarray, np.ndarray]:
    uf = np.asarray(users, np.float32)
    vf = np.asarray(items, np.float32)
    if uf.ndim != 2 or vf.ndim != 2 or uf.shape[1] != vf.shape[1]:
        raise ValueError(f"factor shapes {uf.shape} and {vf.shape} do not match")
    if len(user_index) != uf.shape[0] or len(item_index) != vf.shape[0]:
        raise ValueError("id maps and factor tables differ in length")
    return uf, vf


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy().astype(np.float32, copy=False)
    return np.asarray(a, np.float32)


def als_model_from_numpy(
    user_factors: np.ndarray,
    item_factors: np.ndarray,
    user_index: Mapping[str, int],
    item_index: Mapping[str, int],
    device: str | torch.device | None = None,
) -> ALSModel:
    """Numpy factors ``[U, K]``/``[I, K]`` and id maps -> the port's
    ``ALSModel`` with float32 factor tensors on ``device``."""
    dev = resolve_device(device)
    uf, vf = _tables(user_factors, item_factors, user_index, item_index)
    return ALSModel(
        user_factors=torch.tensor(uf, device=dev),
        item_factors=torch.tensor(vf, device=dev),
        user_index=BiMap(user_index),
        item_index=BiMap(item_index),
    )


def als_model_to_numpy(
    model: ALSModel,
) -> tuple[np.ndarray, np.ndarray, dict[str, int], dict[str, int]]:
    """The port's ``ALSModel`` -> ``(user_factors, item_factors,
    user_index, item_index)`` as float32 numpy arrays and plain dicts."""
    return (
        _host(model.user_factors),
        _host(model.item_factors),
        model.user_index.to_dict(),
        model.item_index.to_dict(),
    )


def twotower_model_from_numpy(
    user_vecs: np.ndarray,
    item_vecs: np.ndarray,
    user_index: Mapping[str, int],
    item_index: Mapping[str, int],
    seen: Mapping[str, Iterable[str]],
    device: str | torch.device | None = None,
) -> TwoTowerServingModel:
    """Numpy towers ``[U, D]``/``[I, D]``, id maps and each user's seen
    items -> the port's ``TwoTowerServingModel`` with float32 tower
    tensors on ``device``."""
    dev = resolve_device(device)
    uf, vf = _tables(user_vecs, item_vecs, user_index, item_index)
    return TwoTowerServingModel(
        user_vecs=torch.tensor(uf, device=dev),
        item_vecs=torch.tensor(vf, device=dev),
        user_index=BiMap(user_index),
        item_index=BiMap(item_index),
        seen={u: set(items) for u, items in seen.items()},
    )


def twotower_model_to_numpy(
    model: TwoTowerServingModel,
) -> tuple[np.ndarray, np.ndarray, dict[str, int], dict[str, int], dict[str, set]]:
    """The port's ``TwoTowerServingModel`` -> ``(user_vecs, item_vecs,
    user_index, item_index, seen)`` as float32 numpy arrays, plain dicts
    and sets."""
    return (
        _host(model.user_vecs),
        _host(model.item_vecs),
        model.user_index.to_dict(),
        model.item_index.to_dict(),
        {u: set(items) for u, items in model.seen.items()},
    )
