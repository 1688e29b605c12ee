"""Prefill/decode disaggregation through the port's serve, on the CPU: a
decode deployment bound to a prefill deployment (both
``serve.LLMDeployment``, tiny Llama in fp32 with the JAX deployment's
weights, each in a replica process) pulls every prompt's KV pages from
the prefill replica through ``_HandlePeer``, as
tests/test_disagg.py:313 does through the JAX serve. Held to the JAX
greedy reference: the streamed tokens, the decode replica's own counters
(the grafted pages, a prefill of the tail only), nothing pinned on
either side once a stream has closed, a prompt under a page that pulls
nothing; a failpoint halfway through a pull, on either side, that falls
back to a local prefill with the same tokens (tests/test_disagg.py:238);
and a prefill replica killed by its pid, after which the next request
falls back and the request after the controller's replacement pulls
again.

The replicas' counters and failpoints live in their processes, read and
armed with ``runtime.call`` of the module-level functions below.
Replicas rebuild this module by name, so it imports nothing of JAX or of
the JAX package at its top level."""

import multiprocessing
import os
import signal
import time

import numpy as np
import pytest

from raytpu_torch import runtime
from raytpu_torch import serve
from raytpu_torch.models.convert import llama_state_from_jax
from raytpu_torch.models.llama import LlamaConfig
from raytpu_torch.serve._private.controller import get_controller

ENGINE_OPTIONS = {"page_size": 8, "max_num_seqs": 4, "max_model_len": 64}
DEADLINE_S = 120.0
APP = "llm-disagg"
PAGES = 2  # a 19-token prompt: two full pages ship, a 3-token tail stays
NEW = 8
# One chunk a page segment: a tiny Llama's 2 pages x 2 layers x K/V make
# 8 chunks, so a failpoint can fire halfway through a pull.
CHUNK_BYTES = 8 * 2 * 32 * 4


def prompt(i: int) -> list:
    """A fresh 19-token prompt (no replica has seen it) for each use."""
    return list(range(1 + 19 * i, 20 + 19 * i))


# ---- run inside a replica process (runtime.call) -----------------------


def facts(replica) -> dict:
    """The replica's handoff and prefill counters and what it pins."""
    from raytpu_torch.inference import disagg, engine

    dep = replica._callable
    with dep._cv:
        return {**disagg.stats(),
                "prefill_tokens": engine._prefill_tokens_total.value,
                "open_exports": dep._handoff_source.open_exports(),
                "sequences": dep._engine.cache.num_sequences(),
                "pid": os.getpid()}


def small_chunks(replica) -> None:
    from raytpu_torch.cluster import constants as tuning

    tuning.KV_STREAM_CHUNK_BYTES = CHUNK_BYTES


def arm(replica, name: str, spec: str) -> None:
    from raytpu_torch.util import failpoints

    failpoints.cfg(name, spec)


def disarm(replica, name: str):
    """Clear the replica's failpoints; the named one's counts."""
    from raytpu_torch.util import failpoints

    stat = failpoints.stat(name)
    failpoints.clear()
    return stat


# ---- the JAX reference and the application -----------------------------


@pytest.fixture(scope="module")
def reference():
    """Greedy decode over the JAX deployment's weights (seed 0), and
    those weights as the port's state dict."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from raytpu.models.llama import Llama, LlamaConfig as JaxLlamaConfig
    from raytpu.models.llama import init_params

    cfg = dataclasses.replace(JaxLlamaConfig.tiny(), dtype=jnp.float32,
                              attn_impl="reference", remat=False)
    model = Llama(cfg)
    params = init_params(model, cfg, seed=0, batch=1)
    forward = jax.jit(lambda toks: model.apply({"params": params}, toks))

    def decode(tokens, n_new):
        toks, outs = list(tokens), []
        for _ in range(n_new):
            padded = np.zeros((1, ENGINE_OPTIONS["max_model_len"]), np.int32)
            padded[0, :len(toks)] = toks
            tok = int(jnp.argmax(forward(jnp.asarray(padded))[0,
                                                              len(toks) - 1]))
            toks.append(tok)
            outs.append(tok)
        return outs

    state = llama_state_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                 LlamaConfig.tiny())
    return decode, state


@pytest.fixture(scope="module")
def app(reference):
    """The composed application (tests/test_disagg.py:318-325): its
    handle and a function giving each role's replica handle. Shut down
    at the end, leaving no process."""
    before = {p.pid for p in multiprocessing.active_children()}
    state = reference[1]
    common = dict(model="llama", engine_options=ENGINE_OPTIONS, seed=0,
                  device="cpu", state_dict=state)
    prefill = serve.LLMDeployment.options(
        name="llm-prefill", role="prefill",
        health_check_period_s=0.2).bind(role="prefill", **common)
    handle = serve.run(serve.LLMDeployment.options(
        name="llm-decode", role="decode").bind(
            role="decode", prefill=prefill, **common),
        name=APP, route_prefix=None, wait_for_ready_timeout_s=DEADLINE_S)

    def replica(role):
        [(_, rep)] = get_controller().call("get_running_replicas",
                                           f"{APP}#llm-{role}")
        runtime.get(runtime.call(rep, small_chunks), timeout=DEADLINE_S)
        return rep

    try:
        yield handle, replica
    finally:
        controller = get_controller().actor.pid
        serve.shutdown()
    assert [p.pid for p in multiprocessing.active_children()
            if p.pid not in before] == []
    with pytest.raises(ProcessLookupError):
        os.kill(controller, 0)


def read(replica) -> dict:
    return runtime.get(runtime.call(replica, facts), timeout=DEADLINE_S)


def settled(replica) -> dict:
    """The replica's facts once it pins nothing (its streams' ends run
    in the replica just after the client has its last token)."""
    end = time.monotonic() + DEADLINE_S
    while True:
        got = read(replica)
        if not got["sequences"] and not got["open_exports"]:
            return got
        assert time.monotonic() < end, f"still pinned: {got}"
        time.sleep(0.05)


def stream(handle, tokens, n=NEW):
    return list(handle.generate.remote_streaming(tokens, max_new_tokens=n))


def test_disagg_over_the_wire_via_handles(app, reference):
    handle, replica = app
    decode, prefill = replica("decode"), replica("prefill")
    before_d, before_p = read(decode), read(prefill)
    assert before_d["pid"] != before_p["pid"] != os.getpid()
    out = stream(handle, prompt(0))
    assert out == reference[0](prompt(0), NEW)
    d, p = settled(decode), settled(prefill)
    assert d["pages"] - before_d["pages"] == PAGES
    assert d["bytes"] - before_d["bytes"] == 2 * 2 * PAGES * CHUNK_BYTES
    # The decode replica prefilled only the tail; the prefill replica the
    # whole prompt (and pinned nothing once the export ended).
    assert d["prefill_tokens"] - before_d["prefill_tokens"] == 3
    assert p["prefill_tokens"] - before_p["prefill_tokens"] == 19
    assert d["fallbacks"] == before_d["fallbacks"]
    # A prompt under a page pulls nothing.
    short = stream(handle, [5, 6, 7], 4)
    assert short == reference[0]([5, 6, 7], 4)
    assert settled(decode)["pages"] == d["pages"]
    assert settled(prefill)["prefill_tokens"] == p["prefill_tokens"]


@pytest.mark.parametrize("side,site,exc", [
    ("decode", "disagg.pull_chunk", "ConnectionError"),
    ("prefill", "disagg.read_chunk", "OSError")])
def test_a_failpoint_halfway_through_a_pull_falls_back(app, reference, side,
                                                       site, exc):
    handle, replica = app
    decode, prefill = replica("decode"), replica("prefill")
    tokens = prompt(1 if side == "decode" else 2)
    before = read(decode)
    runtime.get(runtime.call(replica(side), arm, site,
                             f"3*off->1*raise({exc})"), timeout=DEADLINE_S)
    try:
        out = stream(handle, tokens)
    finally:
        stat = runtime.get(runtime.call(replica(side), disarm, site),
                           timeout=DEADLINE_S)
    assert out == reference[0](tokens, NEW)
    assert stat["fires"] == 1 and stat["hits"] == 4
    d = settled(decode)
    settled(prefill)
    assert d["fallbacks"] - before["fallbacks"] == 1
    assert d["aborts"] - before["aborts"] == 1
    assert d["pages"] == before["pages"]
    assert d["prefill_tokens"] - before["prefill_tokens"] == 19


def test_a_killed_prefill_replica_falls_back_then_pulls_again(app,
                                                              reference):
    handle, replica = app
    decode, prefill = replica("decode"), replica("prefill")
    assert stream(handle, prompt(3)) == reference[0](prompt(3), NEW)
    before = settled(decode)
    dead = read(prefill)["pid"]
    os.kill(dead, signal.SIGKILL)
    # The decode replica's sticky peer is the dead replica: it falls back.
    assert stream(handle, prompt(4)) == reference[0](prompt(4), NEW)
    d = settled(decode)
    assert d["fallbacks"] - before["fallbacks"] == 1
    assert d["pages"] == before["pages"]
    end = time.monotonic() + DEADLINE_S
    while True:
        try:
            fresh = replica("prefill")
            if read(fresh)["pid"] != dead:
                break
        except (ValueError, runtime.ActorDiedError, runtime.TaskError):
            pass  # not yet replaced
        assert time.monotonic() < end, "the prefill replica was not replaced"
        time.sleep(0.1)
    assert stream(handle, prompt(5)) == reference[0](prompt(5), NEW)
    d = settled(decode)
    assert d["pages"] - before["pages"] == PAGES
    assert d["fallbacks"] - before["fallbacks"] == 1
    assert settled(fresh)["open_exports"] == 0
