"""Carry trained weights between the JAX package and the port.

A JAX-package ``ALSModel`` is host numpy factors plus two ``BiMap``s;
handed across as ``(user_factors, item_factors, user_index.to_dict(),
item_index.to_dict())`` it becomes the port's ``ALSModel`` with the
factors on ``device``, ready to serve. A ``TwoTowerServingModel`` goes
the same way with its seen filter: ``(user_vecs, item_vecs, user_index,
item_index, seen)``. The ``*_to_numpy`` functions are the inverses.

An IVF index crosses as its arrays (:func:`ivf_index_from_numpy`,
:func:`ivf_index_to_numpy`; the JAX ``IVFIndex`` fields by name), so one
index built by either package feeds both query paths; an int8 table as
its codes and scales (:func:`quantized_table_from_numpy`,
:func:`quantized_table_to_numpy`). These import ``ops.ivf`` and
``ops.quant`` when called, not with this module.
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
    "ivf_index_from_numpy",
    "ivf_index_to_numpy",
    "quantized_table_from_numpy",
    "quantized_table_to_numpy",
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


def quantized_table_from_numpy(codes: np.ndarray, scales: np.ndarray, device: str | torch.device | None = None):
    """int8 codes ``[N, K]`` and f32 scales ``[N]`` -> the port's
    ``QuantizedTable`` on ``device``."""
    from predictionio_tpu_torch.ops.quant import QuantizedTable

    dev = resolve_device(device)
    return QuantizedTable(
        torch.tensor(np.asarray(codes, np.int8), device=dev), torch.tensor(np.asarray(scales, np.float32), device=dev)
    )


def quantized_table_to_numpy(table) -> tuple[np.ndarray, np.ndarray]:
    """A ``QuantizedTable`` (either package's) -> ``(codes, scales)`` as
    numpy."""
    return (
        np.asarray(table.codes.cpu() if isinstance(table.codes, torch.Tensor) else table.codes),
        np.asarray(table.scales.cpu() if isinstance(table.scales, torch.Tensor) else table.scales),
    )


def ivf_index_from_numpy(
    centroids: np.ndarray,
    slabs: np.ndarray,
    slab_ids: np.ndarray,
    num_items: int,
    nlist: int,
    slab_width: int,
    slab_scales: np.ndarray | None = None,
    items=None,
    device: str | torch.device | None = None,
):
    """The arrays of an IVF index (numpy) -> the port's ``IVFIndex`` on
    ``device``. ``items`` is the id-ordered table the full probe scores;
    by default it is rebuilt from the slabs (each real lane is its item's
    row: f32 values, or the lane's codes and scale)."""
    from predictionio_tpu_torch.ops.ivf import IVFIndex
    from predictionio_tpu_torch.ops.quant import QuantizedTable

    dev = resolve_device(device)
    slabs = np.asarray(slabs)
    ids = np.asarray(slab_ids, np.int32)
    if items is None:
        real = ids < num_items
        n = int(ids[real].max()) + 1 if real.any() else 0
        rows = np.zeros((n, slabs.shape[-1]), slabs.dtype)
        rows[ids[real]] = slabs[real]
        if slab_scales is None:
            items = torch.tensor(rows, device=dev)
        else:
            scales = np.zeros(n, np.float32)
            scales[ids[real]] = np.asarray(slab_scales, np.float32)[real]
            items = QuantizedTable(torch.tensor(rows, device=dev), torch.tensor(scales, device=dev))
    return IVFIndex(
        centroids=torch.tensor(np.asarray(centroids, np.float32), device=dev),
        slabs=torch.tensor(slabs, device=dev),
        slab_ids=torch.tensor(ids, device=dev),
        num_items=int(num_items),
        nlist=int(nlist),
        slab_width=int(slab_width),
        slab_scales=None if slab_scales is None else torch.tensor(np.asarray(slab_scales, np.float32), device=dev),
        items=items,
    )


def ivf_index_to_numpy(index) -> dict:
    """An ``IVFIndex`` (either package's) -> its fields as numpy arrays
    and ints, by the JAX ``IVFIndex``'s field names."""

    def host(a):
        if a is None:
            return None
        return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)

    return {
        "centroids": host(index.centroids),
        "slabs": host(index.slabs),
        "slab_ids": host(index.slab_ids),
        "num_items": int(index.num_items),
        "nlist": int(index.nlist),
        "slab_width": int(index.slab_width),
        "slab_scales": host(index.slab_scales),
    }
