"""Carry trained weights between the JAX package and the port.

A JAX-package ``ALSModel`` is host numpy factors plus two ``BiMap``s;
handed across as ``(user_factors, item_factors, user_index.to_dict(),
item_index.to_dict())`` it becomes the port's ``ALSModel`` with the
factors on ``device``, ready to serve. A ``TwoTowerServingModel`` goes
the same way with its seen filter: ``(user_vecs, item_vecs, user_index,
item_index, seen)``. The ``*_to_numpy`` functions are the inverses.

The four other templates' models cross as host numpy, as they serve
from blobs: a ``SimilarProductModel`` as ``(item_factors, item_index,
categories)``, an ``ECommModel`` as ``(user_factors, item_factors,
user_index, item_index, categories, popularity)``, and a Classification
or Text-Classification model (a dict) as the same dict with its
NamedTuples as plain tuples of arrays — ``"nb"`` ``(log_prior,
log_theta)``, ``"lr"`` ``(w, b)``, ``"featurizer"`` ``(idf,
num_features, stopwords)`` — and its ``label_index`` as a plain dict.
Either package's NamedTuples are tuples, so a JAX model's dict goes
into :func:`classifier_model_from_numpy` as it is.

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
from predictionio_tpu_torch.ops.classify import LogRegModel, NaiveBayesModel
from predictionio_tpu_torch.ops.text import HashingTfIdf
from predictionio_tpu_torch.templates.ecommerce.engine import ECommModel
from predictionio_tpu_torch.templates.recommendation.engine import ALSModel
from predictionio_tpu_torch.templates.similarproduct.engine import SimilarProductModel
from predictionio_tpu_torch.templates.twotower.engine import TwoTowerServingModel

__all__ = [
    "als_model_from_numpy",
    "als_model_to_numpy",
    "classifier_model_from_numpy",
    "classifier_model_to_numpy",
    "ecomm_model_from_numpy",
    "ecomm_model_to_numpy",
    "ivf_index_from_numpy",
    "ivf_index_to_numpy",
    "quantized_table_from_numpy",
    "quantized_table_to_numpy",
    "similarproduct_model_from_numpy",
    "similarproduct_model_to_numpy",
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


def _index(m) -> dict[str, int]:
    return m.to_dict() if hasattr(m, "to_dict") else dict(m)


def similarproduct_model_from_numpy(
    item_factors: np.ndarray, item_index: Mapping[str, int], categories: Mapping[str, Iterable[str]]
) -> SimilarProductModel:
    """A unit item table ``[I, K]``, its id map and each item's categories
    -> the port's ``SimilarProductModel`` (host numpy, as a blob holds it)."""
    items = np.asarray(item_factors, np.float32)
    if items.ndim != 2 or items.shape[0] != len(item_index):
        raise ValueError(f"item table {items.shape} does not match {len(item_index)} items")
    return SimilarProductModel(
        item_factors=items, item_index=BiMap(_index(item_index)),
        categories={i: tuple(c) for i, c in categories.items()},
    )


def similarproduct_model_to_numpy(model: SimilarProductModel) -> tuple[np.ndarray, dict[str, int], dict]:
    """``(item_factors, item_index, categories)`` as numpy and plain dicts."""
    return _host(model.item_factors), model.item_index.to_dict(), dict(model.categories)


def ecomm_model_from_numpy(
    user_factors: np.ndarray,
    item_factors: np.ndarray,
    user_index: Mapping[str, int],
    item_index: Mapping[str, int],
    categories: Mapping[str, Iterable[str]],
    popularity: np.ndarray,
) -> ECommModel:
    """Factor tables, id maps, categories and the popularity vector ``[I]``
    -> the port's ``ECommModel`` (host numpy)."""
    uf, vf = _tables(user_factors, item_factors, user_index, item_index)
    pop = np.asarray(popularity, np.float32)
    if pop.shape != (vf.shape[0],):
        raise ValueError(f"popularity {pop.shape} does not match {vf.shape[0]} items")
    return ECommModel(
        user_factors=uf, item_factors=vf, user_index=BiMap(_index(user_index)),
        item_index=BiMap(_index(item_index)), categories={i: tuple(c) for i, c in categories.items()},
        popularity=pop,
    )


def ecomm_model_to_numpy(model: ECommModel) -> tuple:
    """``(user_factors, item_factors, user_index, item_index, categories,
    popularity)`` as numpy and plain dicts."""
    return (
        _host(model.user_factors), _host(model.item_factors), model.user_index.to_dict(),
        model.item_index.to_dict(), dict(model.categories), _host(model.popularity),
    )


#: a classifier model's NamedTuple fields, by its key in the model dict
_CLASSIFIERS = {"nb": NaiveBayesModel, "lr": LogRegModel}


def classifier_model_from_numpy(model: Mapping) -> dict:
    """A Classification or Text-Classification model dict (either
    package's, or :func:`classifier_model_to_numpy`'s plain form) -> the
    port's: its NamedTuples the port's, arrays float32 numpy, the label
    index a ``BiMap``."""
    out = {}
    for key, value in model.items():
        if key in _CLASSIFIERS:
            value = _CLASSIFIERS[key](*(np.asarray(t, np.float32) for t in value))
        elif key == "featurizer":
            idf, num_features, stopwords = value
            value = HashingTfIdf(np.asarray(idf, np.float32), int(num_features), frozenset(stopwords))
        elif key == "label_index":
            value = BiMap(_index(value))
        elif key in ("mean", "std"):
            value = np.asarray(value, np.float32)
        out[key] = value
    return out


def classifier_model_to_numpy(model: Mapping) -> dict:
    """The inverse of :func:`classifier_model_from_numpy`: NamedTuples as
    plain tuples of numpy arrays (the featurizer as ``(idf, num_features,
    stopwords)``), the label index as a dict."""
    out = {}
    for key, value in model.items():
        if key in _CLASSIFIERS:
            value = tuple(_host(t) for t in value)
        elif key == "featurizer":
            value = (np.asarray(value.idf, np.float32), int(value.num_features), frozenset(value.stopwords))
        elif key == "label_index":
            value = value.to_dict()
        elif key in ("mean", "std"):
            value = np.asarray(value, np.float32)
        out[key] = value
    return out


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
