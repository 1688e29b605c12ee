"""Job REST API server; the port of ``raytpu/job/server.py``.

Reference analogue: ``dashboard/modules/job/job_head.py`` — the REST
surface (``/api/jobs/``) the SDK and CLI talk to, over a
:class:`JobManager`. The JAX package's server is an aiohttp app; the
port's runs the same five routes, statuses and JSON on
:class:`~raytpu_torch.util.http_server.HttpServer` (the chip machine has
no aiohttp).
"""

from __future__ import annotations

from typing import Optional

from raytpu_torch.job.manager import JobManager
from raytpu_torch.util.http_server import (HttpRequest, HttpServer, Reply,
                                           Routes)


class JobServer:
    def __init__(self, manager: JobManager, host: str = "127.0.0.1",
                 port: int = 0):
        self.manager = manager
        self._host = host
        self._port = port
        self._server: Optional[HttpServer] = None
        self.address: Optional[str] = None

    def start(self) -> str:
        routes = Routes()
        routes.post("/api/jobs/", self._submit)
        routes.get("/api/jobs/", self._list)
        routes.get("/api/jobs/{job_id}", self._get)
        routes.get("/api/jobs/{job_id}/logs", self._logs)
        routes.post("/api/jobs/{job_id}/stop", self._stop)
        self._server = HttpServer(routes, self._host, self._port,
                                  name="raytpu-job-server")
        self.address = self._server.start()
        return self.address

    def stop(self) -> None:
        if self._server is not None:
            self._server.stop()
            self._server = None

    # -- handlers ----------------------------------------------------------

    def _submit(self, request: HttpRequest) -> Reply:
        body = request.json()
        try:
            job_id = self.manager.submit_job(
                body["entrypoint"],
                submission_id=body.get("submission_id"),
                runtime_env=body.get("runtime_env"),
                metadata=body.get("metadata"),
            )
        except (KeyError, ValueError) as e:
            return Reply.json({"error": str(e)}, status=400)
        return Reply.json({"job_id": job_id, "submission_id": job_id})

    def _list(self, request: HttpRequest) -> Reply:
        return Reply.json([j.to_dict() for j in self.manager.list_jobs()])

    def _get(self, request: HttpRequest, job_id: str) -> Reply:
        try:
            info = self.manager.get_job_info(job_id)
        except KeyError:
            return Reply.json({"error": "no such job"}, status=404)
        return Reply.json(info.to_dict())

    def _logs(self, request: HttpRequest, job_id: str) -> Reply:
        try:
            logs = self.manager.get_job_logs(job_id)
        except KeyError:
            return Reply.json({"error": "no such job"}, status=404)
        return Reply.json({"logs": logs})

    def _stop(self, request: HttpRequest, job_id: str) -> Reply:
        try:
            stopped = self.manager.stop_job(job_id)
        except KeyError:
            return Reply.json({"error": "no such job"}, status=404)
        return Reply.json({"stopped": stopped})
