"""Prefix-cache-aware replica selection (routing policy layer); the
port's copy of :mod:`raytpu.serve._private.prefix_router`, with the port's
own ``chain_hashes`` and the same use of the caller's RNG, so decisions on
the same summaries equal the JAX package's.

Reference analogue: SGLang's cache-aware load balancer and the
prefix-affinity router in vLLM's P/D disaggregation work — route a
request to the replica whose prefix cache already holds the longest
chain of the prompt's KV pages, so a shared system prompt is prefilled
at most once per replica instead of once per request.

Mechanics: every replica periodically advertises a compact summary of
its registered prefix pages — the first 8 bytes of each blake2b chain
digest, hex-encoded (see ``PrefixCache.summary``). The chain digest of
page ``i`` commits to EVERY token through page ``i``, so the router can
score "how many leading pages of THIS prompt does replica R hold" with
a pure set-membership walk, no token data shipped anywhere. Scoring:

1. longest matched prefix wins (cache hits dominate TTFT);
2. ties break power-of-two-choices by queue length (never herd every
   request carrying a popular prefix onto one replica);
3. zero matches anywhere -> ``None``: caller falls back to the blind
   power-of-two policy, byte-identical to routing with the feature off.

The policy is deliberately a pure function over (digests, summaries,
probes, rng) so tests can pin a seeded ``random.Random`` and assert the
decision is deterministic for a fixed cluster snapshot. Everything
stateful (TTL-cached summaries) lives in :class:`PrefixSummaryCache`.

Default-off behind ``RAYTPU_PREFIX_ROUTING``; with the flag unset the
router never computes digests, never probes summaries, and never draws
from the RNG — decisions are identical to the pre-disaggregation
router.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from raytpu_torch.cluster import constants as tuning


def prompt_digests(prompt: Sequence[int], page_size: int) -> List[str]:
    """The prompt's full-page chain digests in wire form (8-byte hex),
    matching ``PrefixCache.summary`` entries byte-for-byte."""
    # Lazy import: the policy layer must stay importable in thin router
    # processes that never load the inference stack.
    from raytpu_torch.inference.prefix_cache import chain_hashes

    return [h[:8].hex() for h in chain_hashes(prompt, page_size)]


def match_len(digests: Sequence[str],
              replica_digests: Sequence[str]) -> int:
    """Longest matched page-chain prefix: walk the prompt's chain until
    the first digest the replica doesn't hold. Chain hashing makes a
    non-contiguous match impossible by construction, so membership of
    digest ``i`` implies the replica holds pages ``0..i``."""
    have = set(replica_digests)
    n = 0
    for d in digests:
        if d not in have:
            break
        n += 1
    return n


def select_replica(
    digests: Sequence[str],
    summaries: Sequence[Tuple[str, object, Sequence[str]]],
    probe_qlen: Callable[[object], float],
    max_ongoing: int,
    rng,
) -> Optional[object]:
    """Pick the replica handle to route to, or ``None`` for the blind
    fallback.

    ``summaries`` is the routing snapshot: ``(replica_id, handle,
    advertised_digests)`` per replica. Only replicas with a non-zero
    match are candidates; among the longest-match ties, two are sampled
    (power-of-two) and the shorter queue wins — a saturated winner
    (queue >= ``max_ongoing``) also returns ``None`` so the caller's
    blind path applies its own backoff instead of this policy spinning.
    """
    if not digests:
        return None
    scored = []
    for rid, handle, replica_digests in summaries:
        m = match_len(digests, replica_digests)
        if m > 0:
            scored.append((m, rid, handle))
    if not scored:
        return None
    best = max(m for m, _, _ in scored)
    # Sort ties by replica id before sampling: the draw depends only on
    # the rng state and the snapshot, not on summary arrival order.
    tied = sorted(((rid, h) for m, rid, h in scored if m == best),
                  key=lambda t: t[0])
    candidates = tied if len(tied) <= 2 else rng.sample(tied, 2)
    probed = sorted(
        ((probe_qlen(handle), rid, handle) for rid, handle in candidates),
        key=lambda t: (t[0], t[1]))
    if probed and probed[0][0] < max_ongoing:
        return probed[0][2]
    return None


class PrefixSummaryCache:
    """TTL cache of per-replica prefix summaries.

    Summaries go stale the moment a replica registers or evicts a page,
    so they are advisory by design: a stale hit routes a request to a
    replica that re-prefills locally (correct, just slower), never to a
    wrong answer. The TTL (``RAYTPU_PREFIX_SUMMARY_TTL_S``) bounds both
    the staleness window and the probe rate per replica. Fetch failures
    cache an empty summary for one TTL — an unreachable replica simply
    stops attracting prefix traffic until it answers again.
    """

    def __init__(self, fetch: Callable[[object], Optional[dict]]):
        self._fetch = fetch
        self._lock = threading.Lock()
        self._entries: Dict[str, Tuple[float, dict]] = {}

    def get(self, replica_id: str, handle: object) -> dict:
        ttl = tuning.PREFIX_SUMMARY_TTL_S
        now = time.monotonic()
        with self._lock:
            ent = self._entries.get(replica_id)
            if ent is not None and ent[0] > now:
                return ent[1]
        try:
            summary = self._fetch(handle)
        except Exception:
            summary = None
        if not isinstance(summary, dict):
            summary = {}
        with self._lock:
            self._entries[replica_id] = (now + ttl, summary)
        return summary

    def drop(self, replica_id: str) -> None:
        with self._lock:
            self._entries.pop(replica_id, None)
