"""Evaluation dashboard (default port 9000).

Counterpart of ``predictionio_tpu/tools/dashboard.py``, over the port's
metadata store; it imports no torch.

Parity: ``tools/dashboard/Dashboard.scala`` — lists completed
``EvaluationInstance``s with their params and metric scores. The twirl
HTML template becomes a small self-contained HTML page + a JSON API
(``/evaluations.json``) the reference never had.
"""

from __future__ import annotations

import html
import json
from typing import Any, Mapping

from predictionio_tpu_torch.data.storage import Storage

__all__ = ["DashboardService"]


class DashboardService:
    def readiness(self) -> dict:
        """``GET /readyz``: the dashboard renders evaluation instances
        from the metadata store — ready iff that store answers."""
        from predictionio_tpu_torch.api.health import readiness_report, storage_check

        return readiness_report(storage=storage_check())

    def _instances(self):
        return sorted(
            Storage.get_meta_data_evaluation_instances().get_completed(),
            key=lambda i: i.start_time,
            reverse=True,
        )

    def evaluations_json(self) -> list[dict]:
        out = []
        for inst in self._instances():
            out.append(
                {
                    "id": inst.id,
                    "status": inst.status,
                    "startTime": inst.start_time.isoformat(),
                    "endTime": inst.end_time.isoformat(),
                    "evaluationClass": inst.evaluation_class,
                    "engineParamsGeneratorClass": inst.engine_params_generator_class,
                    "batch": inst.batch,
                    "result": json.loads(inst.evaluator_results_json or "{}"),
                }
            )
        return out

    def index_html(self) -> str:
        rows = []
        for inst in self._instances():
            result = json.loads(inst.evaluator_results_json or "{}")
            best = result.get("bestScore", {}).get("score", "")
            rows.append(
                "<tr>"
                f"<td>{html.escape(inst.id)}</td>"
                f"<td>{html.escape(inst.evaluation_class)}</td>"
                f"<td>{html.escape(str(inst.start_time))}</td>"
                f"<td>{html.escape(str(best))}</td>"
                f"<td><pre>{html.escape(inst.evaluator_results or '')}</pre></td>"
                "</tr>"
            )
        return (
            "<!doctype html><html><head><title>predictionio_tpu_torch dashboard"
            "</title></head><body><h1>Evaluation Dashboard</h1>"
            "<table border='1' cellpadding='4'>"
            "<tr><th>ID</th><th>Evaluation</th><th>Started</th>"
            "<th>Best score</th><th>Leaderboard</th></tr>"
            + "".join(rows)
            + "</table></body></html>"
        )

    def dispatch(
        self,
        method: str,
        path: str,
        params: Mapping[str, str],
        body: Any = None,
        headers: Mapping[str, str] | None = None,
        form: Mapping[str, str] | None = None,
    ):
        from predictionio_tpu_torch.api.service import Response

        if method.upper() != "GET":
            return Response(404, {"message": "Not Found"})
        if path == "/":
            return _HtmlResponse(200, self.index_html())
        if path == "/evaluations.json":
            return Response(200, self.evaluations_json())
        return Response(404, {"message": "Not Found"})


class _HtmlResponse:
    """Duck-typed Response whose payload is raw HTML; the HTTP wrapper
    reads ``content_type`` for the header."""

    content_type = "text/html; charset=UTF-8"

    def __init__(self, status: int, html_text: str):
        self.status = status
        self.body = html_text

    def json_bytes(self) -> bytes:  # name kept for wrapper compatibility
        return self.body.encode()
