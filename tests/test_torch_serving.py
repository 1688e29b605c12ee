"""The port's LLMDeployment (raytpu_torch/inference/serving.py, on the
CPU) against the JAX package's replica body (``serve.LLMDeployment.
_target``) on tiny Llama and GPT-2 in fp32, the port's weights carried
across from the JAX deployment's by raytpu_torch/models/convert.py:
token identity of concurrent streams, the stepping loop decoding with
nobody pulling (tests/test_inference_serve.py:205-224), the idle
pressure snapshot (:226-252, without the gauges), a closed stream
freeing its pages, an out-of-band abort ending its stream, the request
context's id reaching the engine, ``engine_pressure()`` and
``prefix_summary()`` equal to JAX's for the same traffic,
``PrefixCache.adopt`` / ``summary`` against the JAX ones, and the engine
lock that the stepping loop hands to its oldest waiter on release.

No assertion races a wall clock: waits poll with generous deadlines, and
where a test needs the loop to stand still it gates the engine's step.
Every deployment is shut down in ``finally``, and a stepping loop that
died before its shutdown fails the test with the exception it died of.
"""

import contextlib
import threading
import time

import jax
import numpy as np
import pytest

from raytpu import serve
from raytpu.inference.kv_cache import PagedKVCache as JaxPagedKVCache
from raytpu.inference.prefix_cache import PrefixCache as JaxPrefixCache
from raytpu.inference.prefix_cache import chain_hashes as jax_chain_hashes
from raytpu_torch.inference import LLMDeployment, PagedKVCache, PrefixCache
from raytpu_torch.inference import serving
from raytpu_torch.inference.prefix_cache import chain_hashes
from raytpu_torch.models.convert import (gpt2_state_from_jax,
                                         llama_state_from_jax)

ENGINE_OPTIONS = {"page_size": 8, "max_num_seqs": 4, "max_model_len": 64}
FAMILIES = ("llama", "gpt2")
DEADLINE_S = 120.0
CONVERT = {"llama": llama_state_from_jax, "gpt2": gpt2_state_from_jax}


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    return request.param


@pytest.fixture(scope="module")
def jax_replicas():
    """One JAX replica body per family, built once: the weights every
    port deployment of this module is given, and greedy reference
    tokens. Shut down at the module's end."""
    deps = {}
    yield lambda fam: deps.setdefault(fam, serve.LLMDeployment._target(
        model=fam, engine_options=ENGINE_OPTIONS, seed=0))
    for dep in deps.values():
        dep.shutdown()


def load_jax_weights(port_dep, jax_dep, family: str) -> None:
    """Give ``port_dep``'s model the JAX deployment's weights (before its
    first request)."""
    params = jax.tree_util.tree_map(np.asarray, jax_dep._engine._params)
    model = port_dep._engine.model
    model.load_state_dict(CONVERT[family](params, model.config))


def port_deployment(jax_dep, family: str, **kw) -> LLMDeployment:
    opts = dict(ENGINE_OPTIONS)
    opts.update(kw.pop("engine_options", {}))
    dep = LLMDeployment(model=family, engine_options=opts, seed=0,
                        device="cpu", **kw)
    load_jax_weights(dep, jax_dep, family)
    return dep


@contextlib.contextmanager
def watched(*deps):
    """Shut ``deps`` down on the way out, after checking that each
    stepping loop is still alive; a loop thread's exception fails the
    test as the exception it died of."""
    died = []
    hook = threading.excepthook

    def record(args):
        died.append(args.exc_value)
        hook(args)

    threading.excepthook = record
    try:
        yield deps
        if died:
            raise died[0]
        for dep in deps:
            assert dep._step_thread.is_alive(), "the stepping loop died"
    finally:
        threading.excepthook = hook
        for dep in deps:
            dep.shutdown()
        for dep in deps:
            assert not dep._step_thread.is_alive(), "the loop did not join"


def poll(fn, what: str, deadline_s: float = DEADLINE_S):
    """Call ``fn`` until it returns a truthy value; fail after the
    deadline."""
    end = time.monotonic() + deadline_s
    while time.monotonic() < end:
        got = fn()
        if got:
            return got
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def drain_concurrently(dep, prompts, max_new_tokens: int):
    """Every prompt on its own thread, all started together; returns the
    tokens of each."""
    out = [None] * len(prompts)
    start = threading.Barrier(len(prompts))

    def run(i):
        start.wait()
        out[i] = list(dep.generate(prompts[i],
                                   max_new_tokens=max_new_tokens))

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=DEADLINE_S)
    assert not any(t.is_alive() for t in threads)
    return out


def idle(dep) -> bool:
    p = dep.engine_pressure()
    return (p["running_requests"] == 0.0 and p["waiting_requests"] == 0.0
            and p["kv_utilization"] == 0.0)


PROMPTS = [list(range(1, 9)), list(range(3, 25)), [7, 8],
           list(range(40, 50))]


def test_concurrent_streams_match_jax(family, jax_replicas):
    jax_dep = jax_replicas(family)
    want = [list(jax_dep.generate(p, max_new_tokens=8)) for p in PROMPTS]
    dep = port_deployment(jax_dep, family)
    with watched(dep):
        got = drain_concurrently(dep, PROMPTS, 8)
        assert got == want
        # Some step decoded several streams together.
        assert max(dep.stats()["decode_batch_hist"]) >= 2


def test_loop_decodes_without_consumer_pulling(family, jax_replicas):
    jax_dep = jax_replicas(family)
    prompt = list(range(1, 9))
    want = list(jax_dep.generate(prompt, max_new_tokens=8))
    dep = port_deployment(jax_dep, family)
    with watched(dep):
        gen = dep.generate(prompt, max_new_tokens=8)
        first = next(gen)
        # Nobody pulls from here on: the loop's thread must run the
        # sequence to completion on its own.
        st = poll(lambda: (lambda s: s if s["running"] == 0
                           and s["waiting"] == 0 else None)(dep.stats()),
                  "the loop to finish the sequence")
        assert st["decode_tokens"] == 7
        assert [first] + list(gen) == want


def test_idle_loop_maintains_pressure_snapshot(family, jax_replicas):
    dep = port_deployment(jax_replicas(family), family)
    with watched(dep):
        assert len(list(dep.generate([1, 2, 3], max_new_tokens=2))) == 2
        poll(lambda: idle(dep), "the idle snapshot")
        p = dep.engine_pressure()
        assert set(p) == {"waiting_requests", "running_requests",
                          "kv_utilization", "ttft_p95_s"}
        assert all(type(v) is float for v in p.values())
        assert p["ttft_p95_s"] > 0.0  # recent-window history kept


def test_closed_stream_frees_its_pages(jax_replicas):
    dep = port_deployment(jax_replicas("llama"), "llama")
    with watched(dep):
        gen = dep.generate(list(range(1, 12)), max_new_tokens=40)
        assert [next(gen), next(gen)]
        gen.close()  # generate's finally aborts the request
        eng = dep._engine
        poll(lambda: not dep.stats()["running"] and idle(dep),
             "the closed request to leave the engine")
        with dep._cv:
            assert eng.cache.num_sequences() == 0
            assert not dep._buffers and not dep._live
            assert (len(eng.cache._free) + eng.prefix_cache.reclaimable()
                    == eng.cache.total_pages)


def gate_after_first_token(dep, request_id: str) -> threading.Event:
    """Hold the stepping loop still once ``request_id`` has its first
    token, until the returned event is set. The loop waits on its own
    condition, which releases the engine lock, so request threads and
    ``abort`` go on meanwhile."""
    gate = threading.Event()
    step = dep._engine.step
    seen = []

    def gated_step():
        while seen and not gate.is_set():
            dep._cv.wait(timeout=0.05)
        outs = step()
        seen.extend(o for o in outs if o.request_id == request_id)
        return outs

    dep._engine.step = gated_step
    return gate


def test_abort_from_outside_ends_the_stream(jax_replicas):
    jax_dep = jax_replicas("llama")
    prompt = list(range(5, 15))
    want = list(jax_dep.generate(prompt, max_new_tokens=40))
    dep = port_deployment(jax_dep, "llama")
    with watched(dep):
        gate = gate_after_first_token(dep, "to-abort")
        got, first = [], threading.Event()

        def consume():
            serving._request_context.set({"request_id": "to-abort"})
            for tok in dep.generate(prompt, max_new_tokens=40):
                got.append(tok)
                first.set()

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        assert first.wait(DEADLINE_S)
        assert dep.abort("to-abort") is True
        t.join(timeout=DEADLINE_S)
        assert not t.is_alive()
        gate.set()
        assert got == want[:1]
        assert dep.abort("to-abort") is False  # gone from the engine
        poll(lambda: idle(dep), "the idle snapshot")
        assert dep._engine.cache.num_sequences() == 0


def test_request_context_id_reaches_the_engine(jax_replicas):
    dep = port_deployment(jax_replicas("llama"), "llama")
    with watched(dep):
        added = []
        add = dep._engine.add_request

        def recording_add(request_id, prompt, sampling=None):
            added.append(request_id)
            return add(request_id, prompt, sampling)

        dep._engine.add_request = recording_add
        token = serving._request_context.set({"request_id": "client-7"})
        try:
            assert len(list(dep.generate([1, 2, 3], max_new_tokens=3))) == 3
        finally:
            serving._request_context.reset(token)
        assert list(dep.generate([4, 5], max_new_tokens=1))
        assert added[0] == "client-7"
        assert added[1] not in ("", "client-7")  # a fresh id


def test_pressure_and_prefix_summary_equal_jax(family):
    """The same traffic (a shared 16-token prefix, three sequential
    requests) through a fresh deployment of each package: the idle
    pressure snapshot and the prefix summary agree in every key but the
    TTFT quantile, which is wall-clock."""
    system = list(range(1, 17))
    prompts = [system + [30 + i, 40 + i, 50 + i] for i in range(3)]
    jax_dep = serve.LLMDeployment._target(
        model=family, engine_options=ENGINE_OPTIONS, seed=0)
    try:
        dep = port_deployment(jax_dep, family)
        with watched(dep):
            # The prefix counters are process-wide: read this run's.
            hits0 = dep.stats()["prefix_cache"]["hit_tokens"]
            for d in (jax_dep, dep):
                outs = [list(d.generate(p, max_new_tokens=4))
                        for p in prompts]
                assert all(len(o) == 4 for o in outs)
            poll(lambda: idle(dep) and idle(jax_dep), "both idle")
            jp, pp = jax_dep.engine_pressure(), dep.engine_pressure()
            js, ps = jax_dep.prefix_summary(), dep.prefix_summary()
            assert set(pp) == set(jp) and set(ps) == set(js)
            for k in jp:
                if k != "ttft_p95_s":
                    assert pp[k] == jp[k], k
            for k in js:
                if k != "ttft_p95_s":
                    assert ps[k] == js[k], k
            assert len(ps["digests"]) == 2
            assert dep.stats()["prefix_cache"]["hit_tokens"] - hits0 == 32
    finally:
        jax_dep.shutdown()


def _caches(num_pages=12, page_size=4):
    jax_cache = JaxPagedKVCache(1, num_pages, page_size, 1, 8)
    port_cache = PagedKVCache(1, num_pages, page_size, 1, 8, device="cpu")
    return ((jax_cache, JaxPrefixCache(jax_cache)),
            (port_cache, PrefixCache(port_cache)))


def test_prefix_cache_adopt_and_summary_match_jax():
    tokens = list(range(100, 117))  # four full pages of 4 and one token
    assert chain_hashes(tokens, 4) == jax_chain_hashes(tokens, 4)
    hashes = chain_hashes(tokens, 4)
    readings = []
    for cache, pc in _caches():
        assert cache.allocate("pin-a", 16)
        pages = cache.block_table("pin-a")
        adopted = pc.adopt(pages, hashes)
        # A second pin adopting the same hashes: first writer wins.
        assert cache.allocate("pin-b", 8)
        dup = pc.adopt(cache.block_table("pin-b"), hashes[:2])
        cache.free("pin-a")
        cache.free("pin-b")
        readings.append({
            "adopted": adopted, "dup": dup, "pages": pages,
            "match": pc.match(tokens, max_pages=4),
            "summary": pc.summary(), "summary_3": pc.summary(3),
            "reclaimable": pc.reclaimable(),
            "free": len(cache._free),
        })
    assert readings[0] == readings[1]
    assert readings[1]["adopted"] == 4 and readings[1]["dup"] == 0
    assert readings[1]["summary"] == [h[:8].hex() for h in hashes]
    assert readings[1]["reclaimable"] == 4


def test_handoff_lock_serves_a_waiter_before_its_releaser():
    """The stepping loop's pattern: release, then take the lock straight
    back. A thread already waiting gets it first."""
    lock = serving._HandoffLock()
    lock.acquire()
    owned, done = threading.Event(), threading.Event()

    def waiter():
        with lock:
            owned.set()
            done.wait(DEADLINE_S)

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    poll(lambda: len(lock._queue) == 1, "the waiter to queue")
    lock.release()
    assert lock.acquire(blocking=False) is False  # handed over, not free
    assert owned.wait(DEADLINE_S)
    done.set()
    t.join(timeout=DEADLINE_S)
    assert not t.is_alive()
    assert lock.acquire(blocking=False) is True
    assert lock.acquire() is True  # reentrant
    lock.release()
    lock.release()
    with pytest.raises(RuntimeError):
        lock.release()


def test_handoff_lock_under_a_condition_stress():
    """More threads than cores, a short switch interval: no increment is
    lost and every waiter on the condition is woken."""
    import sys

    cv = threading.Condition(serving._HandoffLock())
    count, ready = [0], []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            with cv:
                ready.append(1)
                cv.wait_for(lambda: len(ready) >= 16, timeout=DEADLINE_S)
                cv.notify_all()
            for _ in range(500):
                with cv:
                    with cv:  # reentrant
                        count[0] += 1

        threads = [threading.Thread(target=work, daemon=True)
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=DEADLINE_S)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert count[0] == 16 * 500 and len(ready) == 16
