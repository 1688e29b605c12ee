"""Durable workflow storage, the port of :mod:`raytpu.workflow.storage`:
the JAX package's layout and root, with the port's serializer
(:mod:`raytpu_torch.runtime.serialization`, no ``cloudpickle``) in place
of ``cloudpickle``. Per-step checkpointed results and workflow metadata
under a filesystem root; writes are atomic (a temporary file, then
rename) so a crash mid-write never corrupts a step result. A CPU tensor
in a step's value is written as its bytes, in band.

Layout::

    <root>/<workflow_id>/
        status.json                # RUNNING | SUCCESSFUL | FAILED | ...
        steps/<step_id>.pkl        # checkpointed step output
        steps/<step_id>.meta.json  # name, state, timestamps
        output.pkl                 # final workflow output
    <root>/.events/<hex name>.pkl  # durable external events
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

from raytpu_torch.runtime import serialization

DEFAULT_ROOT = os.path.expanduser("~/.raytpu/workflows")


class WorkflowStorage:
    def __init__(self, root: Optional[str] = None):
        self.root = root or os.environ.get("RAYTPU_WORKFLOW_ROOT",
                                           DEFAULT_ROOT)
        os.makedirs(self.root, exist_ok=True)

    # -- paths -------------------------------------------------------------

    def _wf_dir(self, workflow_id: str) -> str:
        safe = workflow_id.replace("/", "_")
        return os.path.join(self.root, safe)

    def _steps_dir(self, workflow_id: str) -> str:
        return os.path.join(self._wf_dir(workflow_id), "steps")

    def _events_dir(self) -> str:
        # Dotted: can never collide with a workflow dir (ids starting
        # with '.' are rejected at run()).
        return os.path.join(self.root, ".events")

    def _event_path(self, name: str) -> str:
        # Hex encoding is injective — 'a/b' and 'a_b' must not share a
        # file (a lossy replace() cross-delivers payloads).
        return os.path.join(self._events_dir(),
                            name.encode().hex() + ".pkl")

    # -- durable events (reference: workflow event support) ----------------

    def post_event(self, name: str, payload: Any = None) -> None:
        self._atomic_write(self._event_path(name),
                           serialization.dumps(payload))

    def has_event(self, name: str) -> bool:
        return os.path.exists(self._event_path(name))

    def get_event(self, name: str):
        """(exists, payload) — durable once posted."""
        try:
            with open(self._event_path(name), "rb") as f:
                return True, serialization.loads(f.read())
        except FileNotFoundError:
            return False, None

    # -- atomic helpers ----------------------------------------------------

    @staticmethod
    def _atomic_write(path: str, data: bytes) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # -- workflow level ----------------------------------------------------

    def create_workflow(self, workflow_id: str, dag_blob: bytes,
                        workflow_input: Any = None) -> None:
        self._atomic_write(
            os.path.join(self._wf_dir(workflow_id), "dag.pkl"), dag_blob)
        # Input must be durable too: resume() replays with the SAME input.
        self._atomic_write(
            os.path.join(self._wf_dir(workflow_id), "input.pkl"),
            serialization.dumps(workflow_input))
        self.set_status(workflow_id, "RUNNING")

    def load_dag(self, workflow_id: str) -> bytes:
        with open(os.path.join(self._wf_dir(workflow_id), "dag.pkl"),
                  "rb") as f:
            return f.read()

    def load_input(self, workflow_id: str) -> Any:
        path = os.path.join(self._wf_dir(workflow_id), "input.pkl")
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return serialization.loads(f.read())

    def set_status(self, workflow_id: str, status: str) -> None:
        self._atomic_write(
            os.path.join(self._wf_dir(workflow_id), "status.json"),
            json.dumps({"status": status, "ts": time.time()}).encode(),
        )

    def get_status(self, workflow_id: str) -> Optional[str]:
        path = os.path.join(self._wf_dir(workflow_id), "status.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)["status"]

    def list_workflows(self) -> List[Dict[str, Any]]:
        out = []
        if not os.path.isdir(self.root):
            return out
        for wid in sorted(os.listdir(self.root)):
            status = self.get_status(wid)
            if status is not None:
                out.append({"workflow_id": wid, "status": status})
        return out

    def delete_workflow(self, workflow_id: str) -> None:
        import shutil

        shutil.rmtree(self._wf_dir(workflow_id), ignore_errors=True)

    # -- step level --------------------------------------------------------

    def save_step(self, workflow_id: str, step_id: str, name: str,
                  value: Any) -> None:
        self._atomic_write(
            os.path.join(self._steps_dir(workflow_id), f"{step_id}.pkl"),
            serialization.dumps(value),
        )
        self._atomic_write(
            os.path.join(self._steps_dir(workflow_id),
                         f"{step_id}.meta.json"),
            json.dumps({"name": name, "state": "SUCCESSFUL",
                        "ts": time.time()}).encode(),
        )

    def has_step(self, workflow_id: str, step_id: str) -> bool:
        return os.path.exists(
            os.path.join(self._steps_dir(workflow_id), f"{step_id}.pkl"))

    def load_step(self, workflow_id: str, step_id: str) -> Any:
        with open(os.path.join(self._steps_dir(workflow_id),
                               f"{step_id}.pkl"), "rb") as f:
            return serialization.loads(f.read())

    def list_steps(self, workflow_id: str) -> List[Dict[str, Any]]:
        d = self._steps_dir(workflow_id)
        out = []
        if not os.path.isdir(d):
            return out
        for fn in sorted(os.listdir(d)):
            if fn.endswith(".meta.json"):
                with open(os.path.join(d, fn)) as f:
                    meta = json.load(f)
                meta["step_id"] = fn[: -len(".meta.json")]
                out.append(meta)
        return out

    # -- output ------------------------------------------------------------

    def save_output(self, workflow_id: str, value: Any) -> None:
        self._atomic_write(
            os.path.join(self._wf_dir(workflow_id), "output.pkl"),
            serialization.dumps(value),
        )

    def has_output(self, workflow_id: str) -> bool:
        return os.path.exists(
            os.path.join(self._wf_dir(workflow_id), "output.pkl"))

    def load_output(self, workflow_id: str) -> Any:
        with open(os.path.join(self._wf_dir(workflow_id), "output.pkl"),
                  "rb") as f:
            return serialization.loads(f.read())
