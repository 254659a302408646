"""Event Server — REST event ingestion (default port 7070).

Parity: ``data/src/main/scala/org/apache/predictionio/data/api/``
(SURVEY.md section 3.4): ``/events.json`` CRUD, ``/batch/events.json``,
``/stats.json``, access-key auth, channels, webhooks. The spray actor
stack is replaced by a transport-agnostic handler core
(:mod:`predictionio_tpu_torch.api.service`) behind a stdlib threading HTTP
server (:mod:`predictionio_tpu_torch.api.http`) — tests drive the handlers
in-process, the reference's spray-testkit pattern (SURVEY.md section 5.1).
"""

from predictionio_tpu_torch.api.service import EventService, Response

__all__ = ["EventService", "Response"]
