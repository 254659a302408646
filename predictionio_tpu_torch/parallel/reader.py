"""Sharded event-file layout: the training input path at scale.

Counterpart of ``predictionio_tpu/parallel/reader.py``, copied. Parity: replaces the reference's HBase-scan-to-RDD locality
(``storage/hbase/HBPEvents.scala`` ``TableInputFormat`` splits) with a
deterministic shard-per-host file layout (SURVEY.md section 8.3):
``pio export --sharded`` writes ``events-00000-of-00008.jsonl`` style
shards; each training host reads only the shards assigned to it by round
robin, so multi-host input needs no coordination and no shuffle.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Iterable, Iterator

from predictionio_tpu_torch.data.event import Event, event_from_json, event_to_json

__all__ = ["write_event_shards", "read_event_shards", "shard_paths"]

_SHARD_RE = re.compile(r"events-(\d{5})-of-(\d{5})\.jsonl$")


def write_event_shards(
    events: Iterable[Event], out_dir: str, num_shards: int = 8
) -> list[str]:
    """Write events into ``num_shards`` JSONL shard files (round-robin —
    balanced regardless of entity skew). Returns the shard paths."""
    os.makedirs(out_dir, exist_ok=True)
    # remove stale shards from a prior export (a different shard count
    # would otherwise leave a mixed set that shard_paths rejects)
    for stale in glob.glob(os.path.join(out_dir, "events-*-of-*.jsonl")):
        os.remove(stale)
    paths = [
        os.path.join(out_dir, f"events-{i:05d}-of-{num_shards:05d}.jsonl")
        for i in range(num_shards)
    ]
    files = [open(p, "w") for p in paths]
    try:
        for n, event in enumerate(events):
            files[n % num_shards].write(
                json.dumps(event_to_json(event), default=str) + "\n"
            )
    finally:
        for f in files:
            f.close()
    return paths


def shard_paths(in_dir: str) -> list[str]:
    """All shard files of a directory, sorted; validates the -of- counts."""
    paths = sorted(
        p for p in glob.glob(os.path.join(in_dir, "events-*-of-*.jsonl"))
        if _SHARD_RE.search(p)
    )
    if not paths:
        raise FileNotFoundError(f"No event shards under {in_dir}")
    declared = {int(_SHARD_RE.search(p).group(2)) for p in paths}
    if len(declared) != 1 or len(paths) != declared.pop():
        raise ValueError(f"Incomplete/mixed shard set under {in_dir}")
    return paths


def read_event_shards(
    in_dir: str,
    host_index: int = 0,
    num_hosts: int = 1,
    validate: bool = False,
) -> Iterator[Event]:
    """Stream this host's events: shard files are assigned round-robin to
    hosts (file granularity keeps reads sequential — the locality story).
    ``validate=False`` by default: shards written by ``write_event_shards``
    are already validated on the ingest path."""
    for i, path in enumerate(shard_paths(in_dir)):
        if i % num_hosts != host_index:
            continue
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    yield event_from_json(json.loads(line), validate=validate)
