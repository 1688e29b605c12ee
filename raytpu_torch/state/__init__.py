"""raytpu_torch.state: introspection of the port's process tree, the
counterpart of :mod:`raytpu.state` (reference: python/ray/util/state/)."""

from raytpu_torch.state.api import (
    get_request_timeline,
    get_timeline,
    list_actors,
    list_events,
    list_nodes,
    list_metric_series,
    list_objects,
    list_placement_groups,
    list_serve_requests,
    list_tasks,
    object_summary,
    query_metrics,
    summarize_tasks,
    summary_actors,
    summary_tasks,
)

__all__ = [
    "get_request_timeline", "get_timeline", "list_actors", "list_events",
    "list_metric_series", "list_nodes", "list_objects",
    "list_placement_groups", "list_serve_requests", "list_tasks",
    "object_summary", "query_metrics", "summarize_tasks", "summary_actors",
    "summary_tasks",
]
