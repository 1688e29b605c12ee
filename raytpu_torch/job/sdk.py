"""Job submission SDK; the port of ``raytpu/job/sdk.py``.

Reference analogue: ``dashboard/modules/job/sdk.py:39``
(``JobSubmissionClient``) — the typed HTTP client for the job REST API.
The JAX package's client is on ``requests``, which the chip machine
lacks; the port's is on the standard library's ``urllib.request``, with
the same calls, results and errors.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

# Seconds one request may take (the JAX client's).
TIMEOUT_S = 30


class JobSubmissionClient:
    def __init__(self, address: str):
        self.address = address.rstrip("/")

    def _url(self, path: str) -> str:
        return f"{self.address}{path}"

    def _request(self, method: str, path: str,
                 body: Optional[dict] = None) -> Tuple[int, bytes]:
        """(status, body) of one request; an HTTP error status is a
        result, not an exception (as ``requests`` gives it)."""
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(
            self._url(path), data=data, method=method,
            headers={} if data is None else
            {"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=TIMEOUT_S) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            with e:
                return e.code, e.read()

    def _json(self, method: str, path: str,
              body: Optional[dict] = None) -> Any:
        status, data = self._request(method, path, body)
        if status == 404:
            raise KeyError(path.split("/")[3])
        return json.loads(data)

    def submit_job(self, *, entrypoint: str,
                   submission_id: Optional[str] = None,
                   runtime_env: Optional[dict] = None,
                   metadata: Optional[Dict[str, str]] = None) -> str:
        status, data = self._request("POST", "/api/jobs/", {
            "entrypoint": entrypoint,
            "submission_id": submission_id,
            "runtime_env": runtime_env,
            "metadata": metadata,
        })
        if status != 200:
            raise RuntimeError(f"submit failed: {status} "
                               f"{data.decode(errors='replace')}")
        return json.loads(data)["job_id"]

    def get_job_status(self, job_id: str) -> str:
        return self.get_job_info(job_id)["status"]

    def get_job_info(self, job_id: str) -> dict:
        return self._json("GET", f"/api/jobs/{job_id}")

    def get_job_logs(self, job_id: str) -> str:
        return self._json("GET", f"/api/jobs/{job_id}/logs")["logs"]

    def stop_job(self, job_id: str) -> bool:
        return self._json("POST", f"/api/jobs/{job_id}/stop")["stopped"]

    def list_jobs(self) -> List[dict]:
        return self._json("GET", "/api/jobs/")

    def wait_until_finished(self, job_id: str,
                            timeout: float = 300.0) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            status = self.get_job_status(job_id)
            if status in ("SUCCEEDED", "FAILED", "STOPPED"):
                return status
            time.sleep(0.2)
        raise TimeoutError(f"job {job_id} not finished in {timeout}s")
