"""raytpu_torch.workflow — durable DAG execution over the port's tasks
(the port of :mod:`raytpu.workflow`)."""

from raytpu_torch.workflow.api import (
    delete,
    get_output,
    get_status,
    init,
    list_all,
    list_steps,
    resume,
    resume_all,
    run,
    run_async,
    event_exists,
    post_event,
    wait_for_event,
)
from raytpu_torch.workflow.storage import WorkflowStorage

__all__ = [
    "post_event",
    "event_exists",
    "wait_for_event",
    "WorkflowStorage", "delete", "get_output", "get_status", "init",
    "list_all", "list_steps", "resume", "resume_all", "run", "run_async",
]

from raytpu_torch.util import usage_stats as _usage_stats

_usage_stats.record_library_usage("workflow")
