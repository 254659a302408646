"""Eval split helpers (parity: ``e2/.../evaluation/CommonHelperFunctions.scala``
``splitData``; the classification examples additionally stratify by
label, which :func:`stratified_k_fold_split` provides)."""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Hashable, Sequence, TypeVar

__all__ = ["k_fold_split", "stratified_k_fold_split"]

T = TypeVar("T")


def k_fold_split(data: Sequence[T], k: int) -> list[tuple[list[T], list[T]]]:
    """Deterministic k folds: element i goes to fold ``i % k``. Returns
    ``[(train, test), ...]`` per fold — the reference's round-robin split."""
    if k < 2:
        raise ValueError("k must be >= 2")
    folds: list[tuple[list[T], list[T]]] = []
    for fold in range(k):
        train = [x for i, x in enumerate(data) if i % k != fold]
        test = [x for i, x in enumerate(data) if i % k == fold]
        folds.append((train, test))
    return folds


def stratified_k_fold_split(
    data: Sequence[T], k: int, label: Callable[[T], Hashable]
) -> list[tuple[list[T], list[T]]]:
    """Deterministic k folds with class balance: round-robin WITHIN each
    label group, so every fold's test split carries each label in
    ~len(group)/k proportion (a plain round-robin can starve a fold of a
    rare class entirely). Within-fold order follows the input order, so
    the split is reproducible without a seed."""
    if k < 2:
        raise ValueError("k must be >= 2")
    # element -> fold assignment, round-robin per label group
    seen: defaultdict[Hashable, int] = defaultdict(int)
    assignment = []
    for x in data:
        lab = label(x)
        assignment.append(seen[lab] % k)
        seen[lab] += 1
    folds: list[tuple[list[T], list[T]]] = []
    for fold in range(k):
        train = [x for x, a in zip(data, assignment) if a != fold]
        test = [x for x, a in zip(data, assignment) if a == fold]
        folds.append((train, test))
    return folds
