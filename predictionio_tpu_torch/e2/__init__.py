"""e2 — engine/eval helper library.

A copy of ``predictionio_tpu/e2/`` (jax-free there too; the port keeps
its own). Parity: the reference's ``e2/`` module (SURVEY.md section
3.5): ``CategoricalNaiveBayes``, ``MarkovChain``, ``BinaryVectorizer``
small learners plus the k-fold ``splitData`` eval helper. Pure functions
over host data.
"""

from predictionio_tpu_torch.e2.engine import (
    BinaryVectorizer,
    CategoricalNaiveBayes,
    MarkovChain,
)
from predictionio_tpu_torch.e2.evaluation import k_fold_split, stratified_k_fold_split

__all__ = [
    "BinaryVectorizer",
    "CategoricalNaiveBayes",
    "MarkovChain",
    "k_fold_split",
    "stratified_k_fold_split",
]
