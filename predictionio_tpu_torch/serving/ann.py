"""Approximate-retrieval configuration surface (``pio deploy --ann``).

Counterpart of ``predictionio_tpu/serving/ann.py``. Only the config
lives here, so the serving package imports neither torch nor numpy: the
IVF index build and its two-stage query are
:mod:`predictionio_tpu_torch.ops.ivf`, reached through
:mod:`predictionio_tpu_torch.workflow.device_state` only when a deploy
asks for ``--ann``. With ``enabled`` False (the default) nothing imports
``ops.ivf`` and every query takes the exact path.
"""

from __future__ import annotations

import dataclasses

__all__ = ["AnnConfig"]


@dataclasses.dataclass(frozen=True)
class AnnConfig:
    """Knobs of the IVF retrieval stage (docs/performance.md has the
    sizing rule of thumb: ``nlist ~ sqrt(catalog)``, then raise
    ``nprobe`` until measured recall@K meets the product bar)."""

    #: route template top-K through the clustered index
    enabled: bool = False
    #: number of k-means clusters; 0 = auto (~sqrt(catalog items))
    nlist: int = 0
    #: clusters scored per query — the recall/latency dial. Per-query
    #: cost scales with ``nprobe * (catalog / nlist)``; ``nprobe >=
    #: nlist`` reproduces exact top-K bit-identically.
    nprobe: int = 8
    #: k-means seed (build is deterministic per (factors, seed))
    seed: int = 0
    #: Lloyd iterations after k-means++ seeding
    kmeans_iters: int = 8

    def __post_init__(self) -> None:
        if self.nprobe < 1:
            raise ValueError("nprobe must be >= 1")
        if self.kmeans_iters < 0:
            raise ValueError("kmeans_iters must be >= 0")

    @property
    def cache_mode(self) -> str:
        """Retrieval-mode tag mixed into result-cache/singleflight keys
        so exact and ANN entries can never serve each other — an ANN
        answer is a different (approximate) result for the same body."""
        if not self.enabled:
            return "exact"
        return f"ann[nlist={self.nlist},nprobe={self.nprobe}]"
