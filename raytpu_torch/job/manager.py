"""Job manager: run driver scripts as supervised subprocesses; the port
of ``raytpu/job/manager.py``.

Reference analogue: ``dashboard/modules/job/job_manager.py`` — each
submitted job gets a supervisor that launches the entrypoint shell command
with the driver's address in its environment, captures logs, tracks a
status state machine (PENDING → RUNNING → SUCCEEDED/FAILED/STOPPED), and
supports stop. The reference supervises via an actor; ours supervises with
a thread per job (the job itself is always a separate process).

The address is the port's (:func:`raytpu_torch.runtime.api.driver_address`
of the process that runs the manager, unless one is given), in
:data:`~raytpu_torch.runtime.api.ADDRESS_ENV`: a job that calls
``raytpu_torch.runtime.init(address=os.environ[ADDRESS_ENV])`` joins that
driver's tree, and its records reach the driver's store. Of
``runtime_env`` the manager takes ``env_vars`` and ``working_dir`` (a
local directory), as the JAX manager does.
"""

from __future__ import annotations

import os
import signal
import subprocess
import tempfile
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class JobInfo:
    job_id: str
    entrypoint: str
    status: str = "PENDING"  # PENDING|RUNNING|SUCCEEDED|FAILED|STOPPED
    submission_time: float = field(default_factory=time.time)
    start_time: Optional[float] = None
    end_time: Optional[float] = None
    return_code: Optional[int] = None
    metadata: Dict[str, str] = field(default_factory=dict)
    log_path: str = ""
    message: str = ""

    def to_dict(self) -> dict:
        return dict(self.__dict__)


class JobManager:
    def __init__(self, cluster_address: Optional[str] = None,
                 log_dir: Optional[str] = None):
        from raytpu_torch.runtime import api

        self.cluster_address = cluster_address or api.driver_address()
        self.log_dir = log_dir or os.path.join(
            tempfile.gettempdir(), "raytpu_torch", "job_logs")
        os.makedirs(self.log_dir, exist_ok=True)
        self._jobs: Dict[str, JobInfo] = {}
        self._procs: Dict[str, subprocess.Popen] = {}
        self._lock = threading.Lock()

    def submit_job(self, entrypoint: str, *,
                   submission_id: Optional[str] = None,
                   runtime_env: Optional[dict] = None,
                   metadata: Optional[Dict[str, str]] = None) -> str:
        job_id = submission_id or f"raytpu-job-{uuid.uuid4().hex[:10]}"
        with self._lock:
            if job_id in self._jobs:
                raise ValueError(f"job {job_id!r} already exists")
            info = JobInfo(job_id=job_id, entrypoint=entrypoint,
                           metadata=dict(metadata or {}),
                           log_path=os.path.join(self.log_dir,
                                                 f"{job_id}.log"))
            self._jobs[job_id] = info
        threading.Thread(target=self._supervise,
                         args=(info, dict(runtime_env or {})),
                         name=f"job-{job_id}", daemon=True).start()
        return job_id

    def _supervise(self, info: JobInfo, runtime_env: dict) -> None:
        from raytpu_torch.runtime.api import ADDRESS_ENV

        env = dict(os.environ)
        env.update({str(k): str(v)
                    for k, v in (runtime_env.get("env_vars") or {}).items()})
        env[ADDRESS_ENV] = self.cluster_address
        cwd = runtime_env.get("working_dir") or os.getcwd()
        try:
            log_f = open(info.log_path, "wb")
        except OSError as e:
            info.status = "FAILED"
            info.message = f"cannot open log file: {e}"
            return
        try:
            proc = subprocess.Popen(
                info.entrypoint, shell=True, cwd=cwd, env=env,
                stdout=log_f, stderr=subprocess.STDOUT,
                start_new_session=True,  # own group so stop kills children
            )
        except OSError as e:
            info.status = "FAILED"
            info.message = str(e)
            log_f.close()
            return
        with self._lock:
            self._procs[info.job_id] = proc
            # stop_job may already have marked it STOPPED between launch
            # and here; RUNNING must not clobber that.
            if info.status == "PENDING":
                info.status = "RUNNING"
        info.start_time = time.time()
        rc = proc.wait()
        log_f.close()
        info.end_time = time.time()
        info.return_code = rc
        with self._lock:
            if info.status != "STOPPED":
                info.status = "SUCCEEDED" if rc == 0 else "FAILED"
                if rc != 0:
                    info.message = f"entrypoint exited with code {rc}"
        with self._lock:
            self._procs.pop(info.job_id, None)

    def stop_job(self, job_id: str) -> bool:
        with self._lock:
            info = self._jobs.get(job_id)
            proc = self._procs.get(job_id)
        if info is None:
            raise KeyError(job_id)
        if proc is None or proc.poll() is not None:
            return False
        with self._lock:
            info.status = "STOPPED"
        info.message = "stopped by user"
        try:
            os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
        except ProcessLookupError:
            pass
        # escalate after a grace period
        def _escalate():
            time.sleep(3)
            if proc.poll() is None:
                try:
                    os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
                except ProcessLookupError:
                    pass
        threading.Thread(target=_escalate, daemon=True).start()
        return True

    def get_job_info(self, job_id: str) -> JobInfo:
        with self._lock:
            info = self._jobs.get(job_id)
        if info is None:
            raise KeyError(job_id)
        return info

    def get_job_status(self, job_id: str) -> str:
        return self.get_job_info(job_id).status

    def get_job_logs(self, job_id: str) -> str:
        info = self.get_job_info(job_id)
        try:
            with open(info.log_path, "rb") as f:
                return f.read().decode(errors="replace")
        except OSError:
            return ""

    def list_jobs(self) -> List[JobInfo]:
        with self._lock:
            return list(self._jobs.values())

    def wait_until_finished(self, job_id: str,
                            timeout: float = 300.0) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            status = self.get_job_status(job_id)
            if status in ("SUCCEEDED", "FAILED", "STOPPED"):
                return status
            time.sleep(0.1)
        raise TimeoutError(f"job {job_id} still "
                           f"{self.get_job_status(job_id)}")
