"""Prometheus / Grafana config generation; a copy of
``raytpu/util/metrics_export.py``.

Reference analogue: ``dashboard/modules/metrics``: the reference ships a
Prometheus scrape config and generated Grafana dashboards next to its
metrics endpoint. Ours generates the same two artifacts over the same
``raytpu_*`` series names. The port's scrape target is the driver's
``/metrics`` (:func:`raytpu_torch.util.metrics.start_metrics_server`),
which serves its TSDB's exposition: every process's shipped series,
labeled by ``proc``, so ONE target covers the whole process tree. Panels
over series the port does not mint (nodes, resources, placement groups)
stay empty.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence

SCRAPE_INTERVAL_S = 5


def prometheus_config(targets: Sequence[str]) -> str:
    """Minimal prometheus.yml scraping the dashboard /metrics endpoints."""
    target_list = "".join(f"\n          - {t!r}" for t in targets)
    return f"""# generated by `raytpu metrics export-config`
global:
  scrape_interval: {SCRAPE_INTERVAL_S}s
  evaluation_interval: {SCRAPE_INTERVAL_S}s

scrape_configs:
  - job_name: raytpu
    metrics_path: /metrics
    static_configs:
      - targets:{target_list}
        labels:
          cluster: raytpu
"""


def _panel(pid: int, title: str, expr: str, legend: str,
           x: int, y: int, unit: str = "short") -> Dict:
    return {
        "id": pid, "title": title, "type": "timeseries",
        "gridPos": {"h": 8, "w": 12, "x": x, "y": y},
        "fieldConfig": {"defaults": {"unit": unit}, "overrides": []},
        "targets": [{"expr": expr, "legendFormat": legend,
                     "refId": "A"}],
    }


def grafana_dashboard() -> Dict:
    """A Grafana dashboard JSON for the built-in cluster metrics.

    Exprs target the cluster-aggregated ``/metrics`` endpoint: shipped
    series carry a ``proc`` label (``head``, ``node:<id>``,
    ``worker:<node>.<id>``), so per-process breakdowns are label
    selections, not separate scrape targets.
    """
    panels: List[Dict] = [
        _panel(1, "Cluster nodes", "raytpu_cluster_nodes",
               "{{state}}", 0, 0),
        _panel(2, "Live actors", "raytpu_actors", "actors", 12, 0),
        _panel(3, "Tasks submitted vs finished /s",
               "sum(rate(raytpu_tasks_submitted_total[1m]))",
               "submitted/s", 0, 8),
        _panel(4, "Task completions /s",
               "sum(rate(raytpu_tasks_done_total[1m]))", "tasks/s",
               12, 8),
        _panel(5, "Queue depth by node",
               "raytpu_node_pending_tasks", "{{proc}}", 0, 16),
        _panel(6, "Worker task throughput /s",
               "sum by (proc) (rate(raytpu_worker_tasks_total[1m]))",
               "{{proc}}", 12, 16),
        _panel(7, "Process RSS", "raytpu_node_rss_bytes", "{{proc}}",
               0, 24, unit="bytes"),
        _panel(8, "Shared-memory occupancy",
               "raytpu_node_shm_used_bytes / "
               "raytpu_node_shm_capacity_bytes",
               "{{proc}}", 12, 24, unit="percentunit"),
        _panel(9, "Transfer throughput",
               "sum by (proc) (rate(raytpu_node_pull_bytes_total[1m]) "
               "+ rate(raytpu_node_push_rx_bytes_total[1m]))",
               "{{proc}}", 0, 32, unit="Bps"),
        _panel(10, "TTFT p95",
               "histogram_quantile(0.95, sum by (le) "
               "(rate(raytpu_infer_ttft_seconds_bucket[5m])))",
               "p95", 12, 32, unit="s"),
        _panel(11, "KV page utilization",
               "max(raytpu_infer_kv_page_utilization)", "kv util",
               0, 40, unit="percentunit"),
        _panel(12, "Resources available",
               "raytpu_resources_available", "{{resource}}", 12, 40),
        _panel(13, "Resource utilization",
               "1 - (raytpu_resources_available / "
               "raytpu_resources_total)",
               "{{resource}}", 0, 48, unit="percentunit"),
        _panel(14, "Metric series dropped (cardinality cap) /s",
               "sum(rate(raytpu_metrics_series_dropped_total[5m]))",
               "dropped/s", 12, 48),
        _panel(15, "Placement groups", "raytpu_placement_groups",
               "pgs", 0, 56),
    ]
    return {
        "title": "raytpu cluster", "uid": "raytpu-cluster",
        "schemaVersion": 39, "refresh": f"{SCRAPE_INTERVAL_S}s",
        "time": {"from": "now-30m", "to": "now"},
        "panels": panels,
        "templating": {"list": []},
        "tags": ["raytpu"],
    }


def export_config(out_dir: str, targets: Sequence[str]) -> List[str]:
    """Write prometheus.yml + grafana_raytpu.json into ``out_dir``."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    prom = os.path.join(out_dir, "prometheus.yml")
    with open(prom, "w") as f:
        f.write(prometheus_config(targets))
    graf = os.path.join(out_dir, "grafana_raytpu.json")
    with open(graf, "w") as f:
        json.dump(grafana_dashboard(), f, indent=1)
    return [prom, graf]
