"""Serve SLO instruments: per-request latency series + the goodput
ledger; the port of ``raytpu/util/serve_slo.py``.

Reference analogue: Ray Serve's per-deployment latency/QPS metrics and
the goodput accounting argued for in disaggregated-serving work
(DistServe: SLO *attainment* — tokens that reached a consumer inside
their latency budget — is the capacity metric, not raw throughput).

One module owns every serving-plane SLO instrument so the router,
replica, engine scheduler and client-side response generator all book
into the SAME named series:

- ``raytpu_serve_ttft_seconds`` / ``raytpu_serve_tpot_seconds`` /
  ``raytpu_serve_e2e_seconds`` / ``raytpu_serve_queue_seconds`` —
  per-deployment+tenant histograms, observed ONCE per request (TPOT is
  the mean inter-token gap ``(t_last - t_first) / (n - 1)``, not a
  per-token observation — the hot loop never touches a histogram).
- ``raytpu_serve_tokens_delivered_total`` vs
  ``raytpu_serve_tokens_wasted_total{cause}`` — the goodput ledger.
  Causes: ``abort`` (consumer vanished / stream failed),
  ``preempt_recompute`` (generated tokens whose KV a preemption
  discarded — they will be re-prefilled), ``handoff_fallback`` (prompt
  tokens a failed KV pull forces back through local prefill).

In the port the scheduler and the replica body book ``wasted``; the
latency histograms and ``delivered`` are booked by a serve handle and
router, which the port does not have yet (ROADMAP.md). The tenant tag
uses the reserved cardinality headroom so SLO evidence never folds into
``<other>``.
"""

from __future__ import annotations

from raytpu_torch.util.metrics import Counter, Histogram

_LAT_BOUNDARIES = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                   2.5, 5.0, 10.0, 30.0)
_TPOT_BOUNDARIES = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                    0.25, 0.5, 1.0)

DEFAULT_TENANT = "default"

ttft_hist = Histogram(
    "raytpu_serve_ttft_seconds",
    "Request time-to-first-token, by deployment and tenant",
    boundaries=_LAT_BOUNDARIES, tag_keys=("deployment", "tenant"))
tpot_hist = Histogram(
    "raytpu_serve_tpot_seconds",
    "Inter-token latency (time per output token), by deployment/tenant",
    boundaries=_TPOT_BOUNDARIES, tag_keys=("deployment", "tenant"))
e2e_hist = Histogram(
    "raytpu_serve_e2e_seconds",
    "Request end-to-end latency, by deployment and tenant",
    boundaries=_LAT_BOUNDARIES, tag_keys=("deployment", "tenant"))
queue_hist = Histogram(
    "raytpu_serve_queue_seconds",
    "Replica queue wait (enqueue to semaphore), by deployment/tenant",
    boundaries=_LAT_BOUNDARIES, tag_keys=("deployment", "tenant"))
tokens_delivered = Counter(
    "raytpu_serve_tokens_delivered_total",
    "Tokens streamed to consumers, by deployment and tenant",
    tag_keys=("deployment", "tenant"))
tokens_wasted = Counter(
    "raytpu_serve_tokens_wasted_total",
    "Tokens whose work was discarded, by cause",
    tag_keys=("cause", "deployment", "tenant"))


def _tags(deployment: str, tenant: str) -> dict:
    return {"deployment": deployment or "", "tenant": tenant or
            DEFAULT_TENANT}


def observe_ttft(seconds: float, deployment: str, tenant: str) -> None:
    ttft_hist.observe(seconds, _tags(deployment, tenant))


def observe_tpot(seconds: float, deployment: str, tenant: str) -> None:
    tpot_hist.observe(seconds, _tags(deployment, tenant))


def observe_e2e(seconds: float, deployment: str, tenant: str) -> None:
    e2e_hist.observe(seconds, _tags(deployment, tenant))


def observe_queue(seconds: float, deployment: str, tenant: str) -> None:
    queue_hist.observe(seconds, _tags(deployment, tenant))


def delivered(n: int, deployment: str, tenant: str) -> None:
    if n > 0:
        tokens_delivered.inc(n, _tags(deployment, tenant))


def wasted(cause: str, n: int, deployment: str = "",
           tenant: str = "") -> None:
    if n > 0:
        tokens_wasted.inc(n, {"cause": cause, **_tags(deployment, tenant)})
