"""Tiny Llama served through the port's serve (raytpu_torch.serve) on the
CPU, held to the JAX package: ``serve.LLMDeployment`` in a replica
process, given the JAX deployment's weights (``state_dict=`` from
``llama_state_from_jax``), streams through ``handle.generate.
remote_streaming`` the JAX greedy reference's tokens exactly. The
behaviours of tests/test_inference_serve.py:56-169, each checked in the
port alone: staggered streams that share a decode step, the first token
in hand while the request still runs, a closed stream freeing its pages,
a shared system prompt prefilled once; and, with two replicas and prefix
routing on, a request that shares a cached prefix routed to the replica
that holds it.

Where a test needs the replica's engine to stand still it gates the
engine's step inside the replica process (``runtime.call`` of the
module-level functions below): overlap is held by events, never by
timings. Replicas rebuild this module by name, so it imports nothing of
JAX or of the JAX package at its top level.
"""

import multiprocessing
import threading
import time

import numpy as np
import pytest

from raytpu_torch import runtime
from raytpu_torch import serve
from raytpu_torch.cluster import constants as tuning
from raytpu_torch.models.convert import llama_state_from_jax
from raytpu_torch.models.llama import LlamaConfig
from raytpu_torch.serve._private.controller import get_controller

ENGINE_OPTIONS = {"page_size": 8, "max_num_seqs": 4, "max_model_len": 64}
DEADLINE_S = 120.0


# ---- run inside a replica process (runtime.call) -----------------------


def gate_steps(replica) -> None:
    """Make the engine's step wait for permits, once a test sets them
    (the stepping loop waits on the engine condition, so request threads
    still add and abort meanwhile)."""
    dep = replica._callable
    step = dep._engine.step
    dep._permits = -1  # open until a test closes it

    def gated():
        while dep._permits == 0:
            dep._cv.wait(timeout=0.05)
        if dep._permits > 0:
            dep._permits -= 1
        return step()

    dep._engine.step = gated


def permit(replica, n: int) -> None:
    """Let ``n`` more steps run; -1 opens the gate."""
    dep = replica._callable
    with dep._cv:
        dep._permits = n
        dep._cv.notify_all()


def counters(replica) -> dict:
    """The replica process's prefill and prefix-cache counters."""
    from raytpu_torch.inference import engine, prefix_cache

    return {"prefill_tokens": engine._prefill_tokens_total.value,
            "hit_tokens": prefix_cache._hit_tokens_total.value,
            "hits": prefix_cache._hits_total.value}


# ---- the JAX reference and the port's deployment -----------------------


@pytest.fixture(scope="module")
def reference():
    """Greedy decode over the JAX deployment's weights, and those weights
    as the port's state dict."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from raytpu.models.llama import Llama, LlamaConfig as JaxLlamaConfig
    from raytpu.models.llama import init_params

    cfg = dataclasses.replace(JaxLlamaConfig.tiny(), dtype=jnp.float32,
                              attn_impl="reference", remat=False)
    model = Llama(cfg)
    params = init_params(model, cfg, seed=0, batch=1)
    # One compiled forward over a fixed length: the model is causal, so
    # the logits at the last real position do not see the padding.
    forward = jax.jit(lambda toks: model.apply({"params": params}, toks))

    def decode(prompt, n_new):
        toks, outs = list(prompt), []
        for _ in range(n_new):
            padded = np.zeros((1, ENGINE_OPTIONS["max_model_len"]), np.int32)
            padded[0, :len(toks)] = toks
            logits = forward(jnp.asarray(padded))
            tok = int(jnp.argmax(logits[0, len(toks) - 1]))
            toks.append(tok)
            outs.append(tok)
        return outs

    state = llama_state_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                 LlamaConfig.tiny())
    return decode, state


def llm_app(state, **options):
    return serve.LLMDeployment.options(**options).bind(
        model="llama", engine_options=ENGINE_OPTIONS, seed=0, device="cpu",
        state_dict=state)


@pytest.fixture(scope="module")
def served(reference):
    """One port serve instance for the module: ``llm`` (one replica, its
    engine gated) and its replica handle. Shut down at the end, leaving
    no replica process."""
    before = {p.pid for p in multiprocessing.active_children()}
    handle = serve.run(llm_app(reference[1]), name="llm", route_prefix=None)
    [(_, replica)] = get_controller().call("get_running_replicas",
                                           "llm#LLMDeployment")
    runtime.get(runtime.call(replica, gate_steps), timeout=DEADLINE_S)
    yield handle, replica
    serve.shutdown()
    assert [p.pid for p in multiprocessing.active_children()
            if p.pid not in before] == []


@pytest.fixture
def gate(served):
    """``gate(n)``: let n more engine steps run (-1: all); the gate is
    open again after the test."""
    _, replica = served

    def set_permits(n):
        runtime.get(runtime.call(replica, permit, n), timeout=DEADLINE_S)

    set_permits(0)
    yield set_permits
    set_permits(-1)


def poll(fn, what: str):
    end = time.monotonic() + DEADLINE_S
    while time.monotonic() < end:
        got = fn()
        if got:
            return got
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def stats(handle) -> dict:
    return handle.stats.remote().result(timeout_s=DEADLINE_S)


def settled(handle) -> dict:
    return poll(lambda: (lambda s: s["running"] == 0 and s["waiting"] == 0
                         and s["kv_utilization"] == 0.0 and s)(stats(handle)),
                "the engine to settle")


def test_staggered_streams_share_decode_and_match_reference(
        served, gate, reference):
    handle, _ = served
    decode, _ = reference
    pa, pb = list(range(1, 12)), [7, 3, 9]
    results, first = {}, {"a": threading.Event(), "b": threading.Event()}

    def consume(tag, prompt, n):
        toks = []
        for tok in handle.generate.remote_streaming(prompt, max_new_tokens=n):
            toks.append(tok)
            first[tag].set()
        results[tag] = toks

    before = stats(handle)["decode_batch_hist"]
    ta = threading.Thread(target=consume, args=("a", pa, 48))
    ta.start()
    gate(2)  # a's prefill and one decode step, then the engine waits
    assert first["a"].wait(DEADLINE_S)
    tb = threading.Thread(target=consume, args=("b", pb, 5))
    tb.start()
    # b waits for admission while a, its first tokens out, still runs.
    poll(lambda: stats(handle)["waiting"] == 1, "b in the engine's queue")
    gate(-1)
    ta.join(timeout=DEADLINE_S)
    tb.join(timeout=DEADLINE_S)
    assert not ta.is_alive() and not tb.is_alive()
    assert results["a"] == decode(pa, 48)
    assert results["b"] == decode(pb, 5)
    s = settled(handle)
    hist = s["decode_batch_hist"][len(before):]
    assert 2 in hist and 1 in hist  # a shared decode step, and solo ones


def test_tokens_arrive_before_sequence_finishes(served, gate, reference):
    handle, _ = served
    decode, _ = reference
    prompt = list(range(1, 9))
    gen = handle.generate.remote_streaming(prompt, max_new_tokens=10)
    gate(1)
    tok = next(gen)
    # The first token in hand while the replica still runs the request.
    s = stats(handle)
    assert s["running"] + s["waiting"] >= 1
    gate(-1)
    assert [tok] + list(gen) == decode(prompt, 10)


def test_client_cancellation_frees_kv_pages(served, gate):
    handle, _ = served
    decoded = stats(handle)["decode_tokens"]
    gen = handle.generate.remote_streaming(list(range(1, 9)),
                                           max_new_tokens=40)
    gate(3)
    got = [next(gen), next(gen), next(gen)]
    assert len(got) == 3
    gen.close()
    # The close reaches the replica, whose generate() aborts the request
    # once its next() in flight returns: its pages go back to the pool.
    gate(-1)
    s = settled(handle)
    assert s["decode_tokens"] - decoded < 40


def test_shared_system_prompt_prefills_shared_pages_once(served, reference):
    handle, replica = served
    decode, _ = reference
    system = list(range(101, 117))  # two full pages, shared by all three
    prompts = [system + tail for tail in
               ([31, 32, 33], [41, 42, 43], [51, 52, 53])]
    before = runtime.get(runtime.call(replica, counters), timeout=DEADLINE_S)
    # Stream 1 runs to completion first: its prefill registers the
    # system prompt's pages before the others are admitted.
    first = list(handle.generate.remote_streaming(prompts[0],
                                                  max_new_tokens=4))
    assert first == decode(prompts[0], 4)
    results = {}

    def consume(i):
        results[i] = list(handle.generate.remote_streaming(
            prompts[i], max_new_tokens=4))

    threads = [threading.Thread(target=consume, args=(i,)) for i in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=DEADLINE_S)
    assert not any(t.is_alive() for t in threads)
    assert results[1] == decode(prompts[1], 4)
    assert results[2] == decode(prompts[2], 4)
    after = runtime.get(runtime.call(replica, counters), timeout=DEADLINE_S)
    # Stream 1 paid all 19 tokens; 2 and 3 grafted the two shared pages
    # and paid only their 3-token tails: 19 + 3 + 3.
    assert after["prefill_tokens"] - before["prefill_tokens"] == 25
    assert after["hit_tokens"] - before["hit_tokens"] == 32


def test_a_shared_prefix_is_routed_to_the_replica_that_holds_it(
        served, reference, monkeypatch):
    decode, state = reference
    monkeypatch.setattr(tuning, "PREFIX_ROUTING", 1)
    handle = serve.run(llm_app(state, num_replicas=2,
                               health_check_period_s=0.1),
                       name="llm2", route_prefix=None)
    router = handle._get_router()
    replicas = dict(get_controller().call("get_running_replicas",
                                          "llm2#LLMDeployment"))
    assert len(replicas) == 2

    def read_all():
        return {rid: runtime.get(runtime.call(r, counters),
                                 timeout=DEADLINE_S)
                for rid, r in replicas.items()}

    system = list(range(201, 217))
    before = read_all()
    assert list(handle.generate.remote_streaming(
        system + [1], max_new_tokens=2)) == decode(system + [1], 2)
    mid = read_all()
    [holder] = [rid for rid in replicas
                if mid[rid]["prefill_tokens"] > before[rid]["prefill_tokens"]]
    # The controller pushes the holder's cache summary to the router.
    poll(lambda: (router._replica_set.pushed_summary(holder) or {}).get(
        "digests"), "the holder's pushed prefix summary")
    for tail in range(2, 6):
        prompt = system + [tail]
        assert list(handle.generate.remote_streaming(
            prompt, max_new_tokens=2)) == decode(prompt, 2)
    after = read_all()
    for rid in replicas:
        hits = after[rid]["hits"] - mid[rid]["hits"]
        assert hits == (4 if rid == holder else 0), (rid, holder, hits)
    serve.delete("llm2")
