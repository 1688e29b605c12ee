"""The port's KV handoff (raytpu_torch/inference/disagg.py) against the JAX
package's (raytpu/inference/disagg.py), on tiny Llama and GPT-2 in fp32
with the JAX weights carried across: a handoff that is token-identical
and prefills only the tail (tests/test_disagg.py:176-219), a short
prompt that never pulls (:220-236), streams crossing between the
packages in both directions, the export's meta and bytes against JAX's,
the fallback to a local prefill when a peer fails, the TTL sweep, a
layout mismatch, and the transfer window admitting a jumbo chunk."""

import threading
import time

import numpy as np
import pytest

from raytpu import serve
from raytpu_torch.cluster import constants as tuning
from raytpu_torch.cluster.transfer import ByteWindow
from raytpu_torch.inference import disagg

import test_torch_serving as serving_cases
from test_torch_serving import (ENGINE_OPTIONS, jax_replicas,  # noqa: F401
                                port_deployment, watched)

# 19 tokens at page_size 8: two FULL pages (16 tokens) are shippable,
# the 3-token tail always prefills on the serving replica.
PROMPT = list(range(1, 20))
COVERED = 16
NEW = 8


@pytest.fixture(scope="module", params=serving_cases.FAMILIES)
def family(request):
    return request.param


@pytest.fixture(scope="module")
def reference(family, jax_replicas):
    """Greedy tokens of the JAX replica for a prompt (its prefix cache
    gives a prefix hit the same tokens as a fresh prefill)."""
    dep = jax_replicas(family)
    return lambda prompt, n: list(dep.generate(prompt, max_new_tokens=n))


def _pair(jax_replicas, family):
    jax_dep = jax_replicas(family)
    prefill = port_deployment(jax_dep, family, role="prefill")
    decode = port_deployment(jax_dep, family, role="decode", prefill=prefill)
    return prefill, decode


def page_bytes(dep) -> int:
    cache = dep._engine.cache
    return (dep._engine.page_size * cache.num_kv_heads * cache.head_dim
            * cache.dtype.itemsize)


def test_handoff_is_token_identical_and_tail_only(family, jax_replicas,
                                                  reference, monkeypatch):
    # A many-chunk pull, so offsets and the short-read check matter.
    monkeypatch.setattr(tuning, "KV_STREAM_CHUNK_BYTES", 1000)
    prefill, decode = _pair(jax_replicas, family)
    with watched(decode, prefill):
        before = disagg.stats()
        assert list(decode.generate(PROMPT, max_new_tokens=NEW)) == \
            reference(PROMPT, NEW)
        after = disagg.stats()
        # The prefill replica paid the whole prompt, the decode replica
        # only the tail past the grafted pages.
        assert prefill.stats()["prefill_tokens"] == len(PROMPT)
        assert decode.stats()["prefill_tokens"] == len(PROMPT) - COVERED
        assert after["pages"] - before["pages"] == 2
        cache = decode._engine.cache
        assert after["bytes"] - before["bytes"] == \
            cache.num_layers * 2 * 2 * page_bytes(decode)
        assert prefill._handoff_source.open_exports() == 0
        # A second request sharing the prefix: the pages are local now.
        tail = PROMPT[:COVERED] + [31, 32, 33]
        assert list(decode.generate(tail, max_new_tokens=4)) == \
            reference(tail, 4)
        assert disagg.stats()["pages"] == after["pages"]


def test_short_prompt_never_pulls(family, jax_replicas):
    prefill, decode = _pair(jax_replicas, family)
    with watched(decode, prefill):
        before = disagg.stats()
        assert len(list(decode.generate([1, 2, 3], max_new_tokens=2))) == 2
        assert disagg.stats() == before
        assert prefill.stats()["prefill_tokens"] == 0
        assert prefill._handoff_source.open_exports() == 0


def test_jax_prefill_feeds_port_decode(family, jax_replicas, reference):
    jax_prefill = serve.LLMDeployment._target(
        model=family, engine_options=ENGINE_OPTIONS, seed=0,
        role="prefill")
    try:
        decode = port_deployment(jax_prefill, family, role="decode",
                                 prefill=jax_prefill)
        with watched(decode):
            before = disagg.stats()
            assert list(decode.generate(PROMPT, max_new_tokens=NEW)) == \
                reference(PROMPT, NEW)
            assert disagg.stats()["pages"] - before["pages"] == 2
            assert decode.stats()["prefill_tokens"] == len(PROMPT) - COVERED
            assert jax_prefill._handoff_source.open_exports() == 0
    finally:
        jax_prefill.shutdown()


def test_port_prefill_feeds_jax_decode(family, jax_replicas, reference):
    from raytpu.inference import disagg as jax_disagg

    prefill = port_deployment(jax_replicas(family), family, role="prefill")
    with watched(prefill):
        jax_decode = serve.LLMDeployment._target(
            model=family, engine_options=ENGINE_OPTIONS, seed=0,
            role="decode", prefill=prefill)
        try:
            pages = jax_disagg._handoff_pages_total.value
            assert list(jax_decode.generate(PROMPT, max_new_tokens=NEW)) \
                == reference(PROMPT, NEW)
            assert jax_disagg._handoff_pages_total.value - pages == 2
            assert jax_decode.stats()["prefill_tokens"] == \
                len(PROMPT) - COVERED
            assert prefill._handoff_source.open_exports() == 0
        finally:
            jax_decode.shutdown()


def _export_all(dep, prompt):
    meta = dep.kv_export_begin(prompt)
    data = dep.kv_export_read(meta["handoff_id"], 0, meta["total_bytes"])
    assert dep.kv_export_end(meta["handoff_id"])
    return meta, data


def test_export_meta_and_bytes_match_jax(family, jax_replicas):
    jax_prefill = serve.LLMDeployment._target(
        model=family, engine_options=ENGINE_OPTIONS, seed=0,
        role="prefill")
    try:
        prefill = port_deployment(jax_prefill, family, role="prefill")
        with watched(prefill):
            jm, jdata = _export_all(jax_prefill, PROMPT)
            pm, pdata = _export_all(prefill, PROMPT)
        assert set(pm) == set(jm)
        for key in jm:
            if key != "handoff_id":
                assert pm[key] == jm[key], key
        assert pm["dtype"] == "float32" and len(pdata) == len(jdata)
        # Every segment: the same K or V of the same page, fp32 values
        # within the 1e-5 of the JAX package's paged-attention tests.
        seg = pm["page_bytes"]
        for off in range(0, len(pdata), seg):
            np.testing.assert_allclose(
                np.frombuffer(pdata[off:off + seg], np.float32),
                np.frombuffer(jdata[off:off + seg], np.float32),
                atol=1e-5, rtol=1e-5)
    finally:
        jax_prefill.shutdown()


class FaultyPeer:
    """A prefill peer that raises in ``kv_export_begin``, or in
    ``kv_export_read`` once half the stream has been read."""

    def __init__(self, dep, fail: str):
        self.dep, self.fail = dep, fail
        self.ended = []

    def kv_export_begin(self, prompt, max_pages=None):
        if self.fail == "begin":
            raise ConnectionError("peer lost before the export")
        meta = self.dep.kv_export_begin(prompt, max_pages)
        self.total = meta["total_bytes"]
        return meta

    def kv_export_read(self, handoff_id, offset, length):
        if self.fail == "read" and offset >= self.total // 2:
            raise OSError("peer lost mid-stream")
        return self.dep.kv_export_read(handoff_id, offset, length)

    def kv_export_end(self, handoff_id):
        self.ended.append(handoff_id)
        return self.dep.kv_export_end(handoff_id)


@pytest.mark.parametrize("fail", ["read", "begin"])
def test_failed_peer_falls_back_to_local_prefill(fail, family, jax_replicas,
                                                 reference, monkeypatch):
    monkeypatch.setattr(tuning, "KV_STREAM_CHUNK_BYTES", 1000)
    jax_dep = jax_replicas(family)
    prefill = port_deployment(jax_dep, family, role="prefill")
    peer = FaultyPeer(prefill, fail)
    decode = port_deployment(jax_dep, family, role="decode", prefill=peer)
    with watched(decode, prefill):
        before = disagg.stats()
        assert list(decode.generate(PROMPT, max_new_tokens=NEW)) == \
            reference(PROMPT, NEW)
        after = disagg.stats()
        assert after["fallbacks"] - before["fallbacks"] == 1
        # A sink was begun only when the export was.
        assert after["aborts"] - before["aborts"] == (fail == "read")
        assert after["pages"] == before["pages"]
        assert decode.stats()["prefill_tokens"] == len(PROMPT)
        assert decode._engine.cache.num_sequences() == 0
        assert prefill._engine.cache.num_sequences() == 0
        assert prefill._handoff_source.open_exports() == 0
        assert len(peer.ended) == (fail == "read")


def test_orphaned_export_dies_by_ttl_sweep(jax_replicas, monkeypatch):
    prefill = port_deployment(jax_replicas("llama"), "llama",
                              role="prefill")
    with watched(prefill):
        meta = prefill.kv_export_begin(PROMPT)
        assert meta is not None and meta["num_pages"] == 2
        assert prefill._handoff_source.open_exports() == 1
        assert prefill._engine.cache.num_sequences() == 1  # the pin
        with prefill._cv:
            assert prefill._handoff_source.sweep() == 0  # within the TTL
        monkeypatch.setattr(tuning, "KV_HANDOFF_TTL_S", 0.0)
        before = disagg.stats()["aborts"]
        with prefill._cv:
            assert prefill._handoff_source.sweep(
                now=time.monotonic() + 1.0) == 1
        assert disagg.stats()["aborts"] - before == 1
        assert prefill._handoff_source.open_exports() == 0
        assert prefill._engine.cache.num_sequences() == 0
        with pytest.raises(KeyError):
            prefill.kv_export_read(meta["handoff_id"], 0, 8)


@pytest.mark.parametrize("field,value", [("dtype", "bfloat16"),
                                         ("page_size", 16),
                                         ("head_dim", 7)])
def test_layout_mismatch_raises(field, value, jax_replicas):
    prefill = port_deployment(jax_replicas("llama"), "llama",
                              role="prefill")
    decode = port_deployment(jax_replicas("llama"), "llama", role="decode")
    with watched(decode, prefill):
        meta = prefill.kv_export_begin(PROMPT)
        prefill.kv_export_end(meta["handoff_id"])
        sink = disagg.KVHandoffSink(decode._engine)
        with decode._cv, pytest.raises(ValueError, match="layout mismatch"):
            sink.begin(dict(meta, **{field: value}), PROMPT)
        assert decode._engine.cache.num_sequences() == 0


def test_byte_window_admits_a_jumbo_chunk_alone():
    window = ByteWindow(100)
    window.acquire(500)  # over the budget: admitted into an empty window
    assert window.in_flight() == 500
    admitted = threading.Event()

    def small():
        window.acquire(10)
        admitted.set()

    t = threading.Thread(target=small, daemon=True)
    t.start()
    # While the jumbo chunk is in flight nothing else fits.
    assert not admitted.wait(0.2)
    window.release(500)
    assert admitted.wait(60)
    t.join(timeout=60)
    assert not t.is_alive() and window.in_flight() == 10
    window.release(10)
    assert window.in_flight() == 0


def test_handoff_constants_mirror_the_jax_package():
    from raytpu.cluster import constants as jax_tuning
    from raytpu_torch.cluster import constants

    for name in ("TRANSFER_WINDOW_BYTES", "PREFIX_SUMMARY_MAX",
                 "KV_STREAM_CHUNK_BYTES", "KV_HANDOFF_TTL_S"):
        assert getattr(constants, name) == getattr(jax_tuning, name), name
