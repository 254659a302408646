"""Classification: multinomial Naive Bayes and softmax regression.

Counterpart of ``predictionio_tpu/ops/classify.py`` (parity: Spark
MLlib's ``NaiveBayes`` and ``LogisticRegressionWithLBFGS`` in the
reference's Classification and Text-Classification templates). Plain
torch ops on an explicit device (default: the card): the reference
computes both outside any Pallas kernel, so no hand kernel is on this
path.

* Naive Bayes is one product ``one_hotᵀ·x`` and two log-normalisations.
* Logistic regression is the reference's full-batch gradient descent
  step for step: zero init, ``g = (p − one_hot)/n``, ``gw = xᵀg + reg·w``,
  ``gb = Σ g``, the same iteration count. Where the reference runs the
  loop under ``lax.scan``, here it is a Python loop of torch ops.

All arithmetic is float32 with TF32 off, as the JAX package's. The model
NamedTuples keep the reference's field names (``log_prior``/``log_theta``,
``w``/``b``); their fields are tensors on the training device until the
caller moves them (:func:`to_numpy`, :func:`to_device`).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from predictionio_tpu_torch.device import resolve_device

__all__ = [
    "NaiveBayesModel",
    "train_naive_bayes",
    "nb_predict_log_proba",
    "LogRegModel",
    "train_logreg",
    "logreg_predict_proba",
    "to_numpy",
    "to_device",
]


class NaiveBayesModel(NamedTuple):
    """log-prior [C] + log-likelihood [C, F] (parity: MLlib NaiveBayesModel
    ``pi``/``theta``)."""

    log_prior: Any
    log_theta: Any


class LogRegModel(NamedTuple):
    """weights [F, C] + bias [C]."""

    w: Any
    b: Any


def _full_f32(dev: torch.device) -> None:
    if dev.type == "cuda":
        # full f32 products, as the JAX package's: TF32 keeps ~3 digits
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")


def _inputs(x, y, dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    xt = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    yt = torch.as_tensor(np.asarray(y, np.int64), device=dev)
    return xt, yt


def train_naive_bayes(
    x: np.ndarray, y: np.ndarray, num_classes: int, smoothing: float = 1.0,
    device: str | torch.device | None = None,
) -> NaiveBayesModel:
    """Multinomial NB (parity: MLlib ``NaiveBayes.train`` with lambda) on
    ``device``. ``x`` must be non-negative feature counts/weights."""
    dev = resolve_device(device)
    _full_f32(dev)
    xt, yt = _inputs(x, y, dev)
    if bool((xt < 0).any()):
        raise ValueError("multinomial Naive Bayes requires non-negative features")
    one_hot = torch.nn.functional.one_hot(yt, num_classes).to(xt.dtype)  # [N, C]
    class_counts = one_hot.sum(dim=0)  # [C]
    feat = one_hot.T @ xt  # [C, F]: feature mass per class
    log_prior = torch.log(class_counts + smoothing) - torch.log(
        class_counts.sum() + num_classes * smoothing
    )
    log_theta = torch.log(feat + smoothing) - torch.log(
        feat.sum(dim=1, keepdim=True) + smoothing * xt.shape[1]
    )
    return NaiveBayesModel(log_prior, log_theta)


def nb_predict_log_proba(model: NaiveBayesModel, x: torch.Tensor) -> torch.Tensor:
    """[B, F] -> [B, C] unnormalized log-posteriors, on the model's device."""
    return model.log_prior + x @ model.log_theta.T


def train_logreg(
    x: np.ndarray,
    y: np.ndarray,
    num_classes: int,
    iterations: int = 200,
    lr: float = 1.0,
    reg: float = 1e-4,
    device: str | torch.device | None = None,
) -> LogRegModel:
    """Softmax regression by full-batch gradient descent on ``device``, the
    reference's descent step for step (parity surface: MLlib
    ``LogisticRegressionWithLBFGS``; the optimizer differs, the
    model/served probabilities match)."""
    dev = resolve_device(device)
    _full_f32(dev)
    xt, yt = _inputs(x, y, dev)
    n, f = xt.shape
    one_hot = torch.nn.functional.one_hot(yt, num_classes).to(xt.dtype)
    w = torch.zeros((f, num_classes), dtype=xt.dtype, device=dev)
    b = torch.zeros((num_classes,), dtype=xt.dtype, device=dev)
    with torch.no_grad():
        for _ in range(int(iterations)):
            p = torch.softmax(xt @ w + b, dim=-1)
            g = (p - one_hot) / n  # [N, C]
            gw = xt.T @ g + reg * w
            gb = g.sum(dim=0)
            w = w - lr * gw
            b = b - lr * gb
    return LogRegModel(w, b)


def logreg_predict_proba(model: LogRegModel, x: torch.Tensor) -> torch.Tensor:
    """[B, F] -> [B, C] class probabilities, on the model's device."""
    return torch.softmax(x @ model.w + model.b, dim=-1)


def to_numpy(model: NamedTuple) -> NamedTuple:
    """The model with every field as float32 host numpy (what a blob holds)."""
    return type(model)(*(
        t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32) for t in model
    ))


def to_device(model: NamedTuple, device: str | torch.device) -> NamedTuple:
    """The model with every field as a float32 tensor on ``device``."""
    return type(model)(*(
        t.to(device, torch.float32) if isinstance(t, torch.Tensor)
        else torch.tensor(np.asarray(t), dtype=torch.float32, device=device)
        for t in model
    ))
