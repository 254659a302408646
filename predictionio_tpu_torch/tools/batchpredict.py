"""Batch prediction: JSON-lines queries in, JSON-lines results out.

Counterpart of ``predictionio_tpu/tools/batchpredict.py``. Parity:
``core/workflow/BatchPredict.scala`` (``pio batchpredict``) — load the
trained instance like ``deploy`` does (on ``device``: the card unless the
caller asks for the CPU), then map the query file through the full
supplement/predict/serve pipeline without binding an HTTP port. The
output lines are the JAX package's, byte for byte, where the scores are.
"""

from __future__ import annotations

import contextlib
import json

from predictionio_tpu_torch.controller.context import local_context
from predictionio_tpu_torch.workflow.engine_json import load_engine_variant
from predictionio_tpu_torch.workflow.serving import QueryService

__all__ = ["run_batch_predict"]


#: queries handed to QueryService.handle_batch at a time — bounds resident
#: query/result memory while staying well above the algorithms' device
#: chunk size so the GEMM amortization is never starved
CHUNK = 8192


def run_batch_predict(
    engine_json: str,
    input_path: str,
    output_path: str,
    engine_instance_id: str | None = None,
    device: str | None = None,
) -> int:
    variant = load_engine_variant(engine_json)
    service = QueryService(variant, local_context(device), instance_id=engine_instance_id)
    n = 0
    with contextlib.closing(service), open(input_path) as fin, open(output_path, "w") as fout:
        batch: list = []

        def flush() -> None:
            nonlocal n
            if not batch:
                return
            # fast path first: payload strings straight from the
            # vectorized scorer (None = unavailable for this engine; a
            # None ENTRY = that body needs the exact slow path)
            fast = service.handle_batch_jsonlines(batch)
            slow_idx = (
                [i for i, line in enumerate(fast) if line is None]
                if fast is not None
                else list(range(len(batch)))
            )
            slow = {}
            if slow_idx:
                # ONE chunked device dispatch per algorithm (ref
                # BatchPredict.scala batchPredictBase) instead of a
                # supplement/predict/serve round trip per line
                slow = dict(zip(
                    slow_idx,
                    service.handle_batch([batch[i] for i in slow_idx]),
                ))
            for i, query in enumerate(batch):
                if fast is not None and fast[i] is not None:
                    # the input line IS the query JSON; compose without
                    # re-serializing either side
                    fout.write(
                        '{"query": %s, "prediction": %s}\n'
                        % (json.dumps(query), fast[i])
                    )
                else:
                    status, payload = slow[i]
                    fout.write(
                        json.dumps(
                            {"query": query, "prediction": payload}
                            if status == 200
                            else {
                                "query": query,
                                "error": payload,
                                "status": status,
                            },
                            default=str,
                        )
                        + "\n"
                    )
                n += 1
            batch.clear()

        for line_no, line in enumerate(fin, 1):
            line = line.strip()
            if not line:
                continue
            try:
                batch.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{input_path}:{line_no}: malformed JSON: {e}") from e
            if len(batch) >= CHUNK:
                flush()
        flush()
    return n
