"""Workflow public API, the port of :mod:`raytpu.workflow.api`:
``workflow.run`` / ``run_async``, ``resume``, ``resume_all``,
``get_status``, ``get_output``, ``list_all``, ``list_steps``,
``delete`` and the durable events (``post_event``, ``event_exists``,
``wait_for_event``). A workflow is a DAG of ``.bind()`` task nodes of
the port's runtime executed with per-step durable checkpoints; resuming
re-executes only the steps that never checkpointed. The DAG is stored
with the port's serializer (by value where a function cannot be found
by name), in place of ``cloudpickle``.
"""

from __future__ import annotations

import threading
import uuid
from typing import Any, Dict, List, Optional

from raytpu_torch.dag.node import DAGNode
from raytpu_torch.runtime import serialization
from raytpu_torch.workflow.executor import WorkflowExecutor
from raytpu_torch.workflow.storage import WorkflowStorage

_storage: Optional[WorkflowStorage] = None
_lock = threading.Lock()
_running: Dict[str, threading.Thread] = {}


def init(storage_root: Optional[str] = None) -> None:
    """Optional: choose the durable storage root before the first run."""
    global _storage
    with _lock:
        _storage = WorkflowStorage(storage_root)


def _get_storage() -> WorkflowStorage:
    global _storage
    with _lock:
        if _storage is None:
            _storage = WorkflowStorage()
        return _storage


def run(dag: DAGNode, *, workflow_id: Optional[str] = None,
        workflow_input: Any = None) -> Any:
    """Execute a DAG durably; blocks and returns the output."""
    from raytpu_torch.runtime import api

    if not api.is_initialized():
        api.init()
    storage = _get_storage()
    workflow_id = workflow_id or f"wf-{uuid.uuid4().hex[:12]}"
    if workflow_id.startswith("."):
        raise ValueError(
            "workflow ids must not start with '.' (reserved for storage "
            "internals like .events)")
    if storage.get_status(workflow_id) == "SUCCESSFUL":
        return storage.load_output(workflow_id)
    storage.create_workflow(workflow_id, serialization.dumps(dag),
                            workflow_input)
    return _execute_tracked(storage, workflow_id, dag, workflow_input)


def _execute_tracked(storage, workflow_id, dag, workflow_input) -> Any:
    me = threading.current_thread()
    with _lock:
        _running[workflow_id] = me
    try:
        return WorkflowExecutor(storage).execute(workflow_id, dag,
                                                 workflow_input)
    finally:
        with _lock:
            if _running.get(workflow_id) is me:
                del _running[workflow_id]


def run_async(dag: DAGNode, *, workflow_id: Optional[str] = None,
              workflow_input: Any = None) -> str:
    """Start a workflow in the background; returns its id. The durable
    record (dag + input + RUNNING status) is written synchronously so
    get_status/get_output on the returned id never race the thread."""
    from raytpu_torch.runtime import api

    if not api.is_initialized():
        api.init()
    storage = _get_storage()
    workflow_id = workflow_id or f"wf-{uuid.uuid4().hex[:12]}"
    if workflow_id.startswith("."):
        raise ValueError(
            "workflow ids must not start with '.' (reserved for storage "
            "internals like .events)")
    if storage.get_status(workflow_id) != "SUCCESSFUL":
        storage.create_workflow(workflow_id, serialization.dumps(dag),
                                workflow_input)
        t = threading.Thread(
            target=lambda: _swallow(_execute_tracked, storage, workflow_id,
                                    dag, workflow_input),
            name=f"workflow-{workflow_id}", daemon=True,
        )
        t.start()
    return workflow_id


def _swallow(fn, *a, **kw):
    try:
        fn(*a, **kw)
    except Exception:
        pass  # status already persisted as FAILED


def resume(workflow_id: str) -> Any:
    """Re-run a stored workflow; completed steps load from checkpoints."""
    from raytpu_torch.runtime import api

    if not api.is_initialized():
        api.init()
    storage = _get_storage()
    status = storage.get_status(workflow_id)
    if status is None:
        raise ValueError(f"no workflow {workflow_id!r}")
    if status == "SUCCESSFUL":
        return storage.load_output(workflow_id)
    with _lock:
        live = _running.get(workflow_id)
    if live is not None and live.is_alive() and \
            live is not threading.current_thread():
        raise RuntimeError(
            f"workflow {workflow_id} is already executing in this process")
    dag = serialization.loads(storage.load_dag(workflow_id))
    workflow_input = storage.load_input(workflow_id)
    storage.set_status(workflow_id, "RUNNING")
    return _execute_tracked(storage, workflow_id, dag, workflow_input)


def resume_all(include_running: bool = False) -> List[str]:
    """Resume FAILED workflows (and, with ``include_running=True``, ones
    left RUNNING by a crashed process — only safe when no other process is
    still executing them)."""
    storage = _get_storage()
    states = ("RUNNING", "FAILED") if include_running else ("FAILED",)
    resumed = []
    for meta in storage.list_workflows():
        wid = meta["workflow_id"]
        with _lock:
            live = _running.get(wid)
        if live is not None and live.is_alive():
            continue  # executing in THIS process right now
        if meta["status"] in states:
            try:
                resume(wid)
                resumed.append(wid)
            except Exception:
                pass
    return resumed


def post_event(name: str, payload: Any = None) -> None:
    """Durably deliver an external event (reference: workflow events —
    ``workflow.wait_for_event`` + event listeners). Any pending
    ``wait_for_event`` step on this name unblocks with the payload;
    late waiters see it immediately (events persist)."""
    _get_storage().post_event(name, payload)


def event_exists(name: str) -> bool:
    return _get_storage().has_event(name)


def wait_for_event(name: str, *, poll_interval_s: float = 0.2,
                   timeout_s: Optional[float] = None):
    """A DAG node that completes when the named event is posted,
    returning its payload (reference: ``workflow.wait_for_event``).
    Durable like any step: a resumed workflow whose wait already
    completed skips it; one still waiting re-enters the wait."""
    from raytpu_torch.runtime import api

    root = _get_storage().root

    # num_cpus=0: a pending wait holds no CPU of the ledger, so the tasks
    # that could post the event still get theirs (in the port it still
    # occupies one worker process of the pool while it waits).
    @api.remote(num_cpus=0, name=f"workflow::wait_event::{name}")
    def _wait_event(_event_name: str, _root: str,
                    _poll: float, _timeout):
        import time as _time

        from raytpu_torch.workflow import api as _api
        from raytpu_torch.workflow.storage import WorkflowStorage

        # A task worker of the port is a process of its own, whose module
        # has no storage set: it reads the root bound here.
        storage = _api._storage or WorkflowStorage(_root)
        deadline = (None if _timeout is None
                    else _time.monotonic() + _timeout)
        while True:
            exists, payload = storage.get_event(_event_name)
            if exists:
                return payload
            if deadline is not None and _time.monotonic() >= deadline:
                raise TimeoutError(
                    f"workflow event {_event_name!r} not posted within "
                    f"{_timeout}s")
            _time.sleep(_poll)

    return _wait_event.bind(name, root, poll_interval_s, timeout_s)


def get_status(workflow_id: str) -> Optional[str]:
    return _get_storage().get_status(workflow_id)


def get_output(workflow_id: str, *, timeout: Optional[float] = None) -> Any:
    import time as _t

    storage = _get_storage()
    deadline = None if timeout is None else _t.monotonic() + timeout
    while True:
        status = storage.get_status(workflow_id)
        if status == "SUCCESSFUL":
            return storage.load_output(workflow_id)
        if status == "FAILED":
            raise RuntimeError(f"workflow {workflow_id} failed")
        if status is None:
            raise ValueError(f"no workflow {workflow_id!r}")
        if deadline is not None and _t.monotonic() >= deadline:
            raise TimeoutError(f"workflow {workflow_id} still {status}")
        _t.sleep(0.05)


def list_all() -> List[Dict[str, Any]]:
    return _get_storage().list_workflows()


def list_steps(workflow_id: str) -> List[Dict[str, Any]]:
    return _get_storage().list_steps(workflow_id)


def delete(workflow_id: str) -> None:
    _get_storage().delete_workflow(workflow_id)
