"""Admin server — REST mirror of the app-management CLI.

Counterpart of ``predictionio_tpu/tools/adminserver.py``, over the port's
command layer and storage; it imports no torch.

Parity: ``tools/src/main/scala/.../admin/AdminServer.scala`` (the
experimental admin API): ``GET /`` status, ``GET /cmd/app`` list,
``POST /cmd/app`` create, ``DELETE /cmd/app/<name>`` delete,
``DELETE /cmd/app/<name>/data`` wipe events.
"""

from __future__ import annotations

from typing import Any, Mapping

from predictionio_tpu_torch.data.storage import Storage, StorageError
from predictionio_tpu_torch.tools import commands

__all__ = ["AdminService"]


class AdminService:
    def readiness(self) -> dict:
        """``GET /readyz``: the admin API is metadata CRUD — ready iff
        the metadata store answers."""
        from predictionio_tpu_torch.api.health import readiness_report, storage_check

        return readiness_report(storage=storage_check())

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

        method = method.upper()
        sink: list[str] = []
        try:
            if path == "/" and method == "GET":
                return Response(200, {"status": "alive"})
            if path == "/cmd/app" and method == "GET":
                apps = commands.app_list(out=sink.append)
                keys = Storage.get_meta_data_access_keys()
                return Response(
                    200,
                    [
                        {
                            "name": a.name,
                            "id": a.id,
                            "accessKeys": [k.key for k in keys.get_by_appid(a.id)],
                        }
                        for a in apps
                    ],
                )
            if path == "/cmd/app" and method == "POST":
                if not isinstance(body, Mapping) or not body.get("name"):
                    return Response(400, {"message": "Field 'name' is required."})
                app, key = commands.app_new(
                    str(body["name"]),
                    body.get("description"),
                    str(body.get("accessKey", "") or ""),
                    out=sink.append,
                )
                return Response(
                    201, {"name": app.name, "id": app.id, "accessKey": key.key}
                )
            if path.startswith("/cmd/app/") and method == "DELETE":
                rest = path[len("/cmd/app/"):]
                if rest.endswith("/data"):
                    commands.app_data_delete(rest[: -len("/data")], out=sink.append)
                    return Response(200, {"message": "Data deleted."})
                commands.app_delete(rest, out=sink.append)
                return Response(200, {"message": "App deleted."})
        except StorageError as e:
            return Response(400, {"message": str(e)})
        return Response(404, {"message": "Not Found"})
