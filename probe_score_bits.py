"""Count, on a CUDA card, the item scores whose float32 bits depend on how
many rows the scoring product has: the question behind
``predictionio_tpu_torch/ops/als.py::score_rows``.

For each catalog size (65,536 / 262,144 / 1,048,576 items, rank 64, seed
17, the JAX bench's sharded sweep) and each query count (1, 7, 32, 512):

* ``plain``: ``q @ V.T`` over the whole table against the same rows'
  scores from the 8 per-shard products ``q @ V[s*I/8:(s+1)*I/8].T``;
* ``score_rows``: the same comparison through ``score_rows``;

and, on 128 blocks of 8,192 rows, cuBLAS's batched product
``bmm([nb, M, K], [nb, K, 8192])`` at batch counts 1, 2, 3, 4, 16, 128
(queries as given, 1 to 512): the first block's scores against the batch
of one, and against ``q @ block.T``. Prints one JSON line a measurement,
then the card's name and power limit. Needs one card::

    python3 probe_score_bits.py
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

SIZES = (65_536, 262_144, 1_048_576)
QUERIES = (1, 7, 32, 512)
SHARDS = 8
RANK = 64
SEED = 17
BLOCK = 8192
BATCHES = (1, 2, 3, 4, 16, 128)


def differ(a: torch.Tensor, b: torch.Tensor) -> int:
    """Entries of two float32 tensors whose bits differ."""
    return int((a.contiguous().view(torch.int32) != b.contiguous().view(torch.int32)).sum())


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_score_bits: no CUDA card", file=sys.stderr)
        return 1
    from predictionio_tpu_torch.ops.als import score_rows

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(SEED)
    for n in SIZES:
        table = torch.as_tensor(rng.standard_normal((n, RANK)).astype(np.float32), device=dev)
        rps = n // SHARDS
        for m in QUERIES:
            q = torch.as_tensor(rng.standard_normal((m, RANK)).astype(np.float32), device=dev)
            row = {"items": n, "queries": m}
            for label, fn in (("plain", lambda a, t: a @ t.T), ("score_rows", score_rows)):
                whole = fn(q, table)
                row[label] = sum(differ(fn(q, table[s * rps:(s + 1) * rps]), whole[:, s * rps:(s + 1) * rps])
                                 for s in range(SHARDS))
                del whole
            row["of"] = m * n
            print(json.dumps(row), flush=True)
        del table
    table = torch.as_tensor(rng.standard_normal((max(BATCHES) * BLOCK, RANK)).astype(np.float32), device=dev)
    for m in (1, 2, 7, 8, 13, 32, 512):
        q = torch.as_tensor(rng.standard_normal((m, RANK)).astype(np.float32), device=dev)
        first = {}
        for nb in BATCHES:
            blocks = table[: nb * BLOCK].view(nb, BLOCK, RANK).transpose(1, 2)
            first[nb] = torch.bmm(q.expand(nb, m, RANK), blocks)[0]
        mm = q @ table[:BLOCK].T
        print(json.dumps({"bmm_queries": m, "block_rows": BLOCK,
                          "first_block_vs_batch_of_one": {nb: differ(first[nb], first[1]) for nb in BATCHES},
                          "first_block_vs_mm": {nb: differ(first[nb], mm) for nb in BATCHES},
                          "of": m * BLOCK}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
