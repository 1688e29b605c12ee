"""DAGs, compiled graphs and channels of the port (raytpu_torch/dag/,
raytpu_torch/runtime/channel.py) held to the JAX package's
(raytpu/dag/, raytpu/runtime/channel.py).

- Every case of tests/test_dag.py: the six channel cases through both
  packages' ``Channel`` (the port's pickles with its own serializer and
  maps the same ring), the classic chain, and each compiled case as one
  script run through the JAX local backend and through the port, whose
  results must be equal, and equal to the JAX test's.
- The port's own cases: its stages are processes, so a channel crosses
  processes (written in one actor, read in another and in the driver),
  backpressure and ``close()`` reach every process, a value above the
  slot size goes through the object store and is freed after its last
  read, an idle compiled graph holds no core, a stage's death makes a
  parked ``get()`` raise, no ring is left in ``/dev/shm`` after
  ``teardown()`` or ``shutdown()``, and ``bind`` works on a handle
  unpickled in another process.
- The slice as a whole: a tiny GPT-2 generate-then-score graph on two
  port actors against the JAX engine and forward with the same weights.

One runtime of each package for the module. This module imports nothing
of JAX at its top: the port's actors import it by name.
"""

import os
import signal
import threading
import time
import types

import numpy as np
import pytest
import torch

import raytpu_torch as rt
from raytpu_torch.runtime import channel as port_channel
from raytpu_torch.runtime import object_store, serialization

T = 30.0
# The scores: sums of fp32 log-probabilities after two fp32 layers, the
# JAX package's bound for fp32 results through several matmuls
# (tests/test_torch_gpt2.py's TOL).
SCORE_TOL = 1e-4


@pytest.fixture(scope="module")
def pkgs():
    """Both packages' runtimes: the JAX local backend and the port's (two
    task workers; actors are processes of their own)."""
    import raytpu

    raytpu.shutdown()
    raytpu.init(num_cpus=4)
    rt.init(num_cpus=2)
    yield
    raytpu.shutdown()
    rt.shutdown()


def _ns(name: str):
    """What a script needs of one package."""
    if name == "raytpu":
        import raytpu as r
        from raytpu.dag import InputNode, MultiOutputNode
    else:
        r = rt
        from raytpu_torch.dag import InputNode, MultiOutputNode
    return types.SimpleNamespace(remote=r.remote, get=r.get,
                                 InputNode=InputNode,
                                 MultiOutputNode=MultiOutputNode)


def _channel_cls(name: str):
    if name == "raytpu":
        from raytpu.runtime.channel import Channel, ChannelClosed
    else:
        from raytpu_torch.runtime.channel import Channel, ChannelClosed
    return Channel, ChannelClosed


PACKAGES = ("raytpu", "raytpu_torch")


# ---- the channel: tests/test_dag.py's TestChannel ------------------------


@pytest.mark.parametrize("pkg", PACKAGES)
class TestChannel:
    def test_write_read_roundtrip(self, pkg):
        Channel, _ = _channel_cls(pkg)
        ch = Channel(num_readers=1)
        rid = ch.reader_id()
        ch.write({"a": 1})
        assert ch.read(rid) == {"a": 1}

    def test_backpressure_blocks_writer(self, pkg):
        Channel, _ = _channel_cls(pkg)
        ch = Channel(num_readers=1)
        rid = ch.reader_id()
        ch.write(1)
        with pytest.raises(TimeoutError):
            ch.write(2, timeout=0.1)  # reader hasn't consumed v1
        assert ch.read(rid) == 1
        ch.write(2, timeout=1.0)
        assert ch.read(rid) == 2

    def test_broadcast_to_all_readers(self, pkg):
        Channel, _ = _channel_cls(pkg)
        ch = Channel(num_readers=3)
        rids = [ch.reader_id() for _ in range(3)]
        ch.write("x")
        assert [ch.read(r) for r in rids] == ["x", "x", "x"]
        ch.write("y", timeout=1.0)  # unblocked only after all 3 read
        assert [ch.read(r) for r in rids] == ["y", "y", "y"]

    def test_read_blocks_until_write(self, pkg):
        Channel, _ = _channel_cls(pkg)
        ch = Channel(num_readers=1)
        rid = ch.reader_id()
        got = []

        def reader():
            got.append(ch.read(rid, timeout=5.0))

        t = threading.Thread(target=reader)
        t.start()
        time.sleep(0.05)
        ch.write(42)
        t.join(timeout=5)
        assert got == [42]

    def test_close_wakes_blocked(self, pkg):
        Channel, ChannelClosed = _channel_cls(pkg)
        ch = Channel(num_readers=1)
        rid = ch.reader_id()
        errs = []

        def reader():
            try:
                ch.read(rid, timeout=5.0)
            except ChannelClosed:
                errs.append("closed")

        t = threading.Thread(target=reader)
        t.start()
        time.sleep(0.05)
        ch.close()
        t.join(timeout=5)
        assert errs == ["closed"]

    def test_pickle_resolves_same_buffer(self, pkg):
        Channel, _ = _channel_cls(pkg)
        ch = Channel(num_readers=1)
        if pkg == "raytpu":
            import cloudpickle

            assert cloudpickle.loads(cloudpickle.dumps(ch)) is ch
        else:
            assert serialization.loads(serialization.dumps(ch)) is ch
            ch.close()


# ---- the stages ------------------------------------------------------------


class Stage:
    def __init__(self, mult):
        self.mult = mult
        self.calls = 0

    def apply(self, x):
        self.calls += 1
        return x * self.mult

    def add(self, x, y):
        return x + y

    def call_count(self):
        return self.calls

    def getpid(self):
        return os.getpid()


class Picky:
    def check(self, x):
        if x < 0:
            raise ValueError("negative!")
        return x


class KwStage:
    def apply(self, *, x, offset=0):
        return x * 2 + offset


def ident(x):
    return x


def test_execute_chain(pkgs):
    """tests/test_dag.py's TestClassicDAG, through both packages."""
    out = []
    for name in PACKAGES:
        r = _ns(name)
        a = r.remote(Stage).remote(2)
        with r.InputNode() as inp:
            dag = a.apply.bind(inp)
        out.append(r.get(dag.execute(21)))
    assert out == [42, 42]


# ---- compiled: tests/test_dag.py's TestCompiledDAG -------------------------


def _compiled(r, dag, rounds):
    compiled = dag.experimental_compile()
    try:
        return rounds(compiled)
    finally:
        compiled.teardown()


def script_linear_pipeline(r):
    a = r.remote(Stage).remote(2)
    b = r.remote(Stage).remote(10)
    with r.InputNode() as inp:
        dag = b.apply.bind(a.apply.bind(inp))
    return _compiled(r, dag, lambda c: [c.execute(3).get(timeout=T),
                                        c.execute(5).get(timeout=T)])


def script_pipelined_executes(r):
    a = r.remote(Stage).remote(3)
    with r.InputNode() as inp:
        dag = a.apply.bind(inp)
    return _compiled(r, dag, lambda c: [x.get(timeout=T) for x in [
        c.execute(i) for i in range(5)]])


def script_fan_out_multi_output(r):
    a = r.remote(Stage).remote(2)
    b = r.remote(Stage).remote(5)
    with r.InputNode() as inp:
        dag = r.MultiOutputNode([a.apply.bind(inp), b.apply.bind(inp)])
    return _compiled(r, dag, lambda c: c.execute(4).get(timeout=T))


def script_fan_in_two_args(r):
    a = r.remote(Stage).remote(2)
    b = r.remote(Stage).remote(3)
    c = r.remote(Stage).remote(1)
    with r.InputNode() as inp:
        dag = c.add.bind(a.apply.bind(inp), b.apply.bind(inp))
    return _compiled(r, dag, lambda g: g.execute(10).get(timeout=T))


def script_const_args_mixed_with_channels(r):
    a = r.remote(Stage).remote(1)
    with r.InputNode() as inp:
        dag = a.add.bind(inp, 100)
    return _compiled(r, dag, lambda c: c.execute(7).get(timeout=T))


def script_error_propagates_and_pipeline_survives(r):
    p = r.remote(Picky).remote()
    with r.InputNode() as inp:
        dag = p.check.bind(inp)

    def rounds(c):
        out = [c.execute(1).get(timeout=T)]
        try:
            c.execute(-1).get(timeout=T)
        except ValueError as exc:  # the stage's own type
            out.append(f"ValueError: {exc}")
        out.append(c.execute(2).get(timeout=T))  # the loop keeps running
        return out

    return _compiled(r, dag, rounds)


def script_teardown_frees_actor(r):
    a = r.remote(Stage).remote(2)
    with r.InputNode() as inp:
        dag = a.apply.bind(inp)
    compiled = dag.experimental_compile()
    out = [compiled.execute(1).get(timeout=T)]
    compiled.teardown()
    # Actor usable for normal calls again after teardown.
    out.append(r.get(a.call_count.remote(), timeout=T))
    return out


def script_kwarg_bound_input(r):
    a = r.remote(KwStage).remote()
    b = r.remote(KwStage).remote()
    with r.InputNode() as inp:
        dag = b.apply.bind(x=a.apply.bind(x=inp, offset=1), offset=100)
    # a: 5*2+1=11; b: 11*2+100=122
    return _compiled(r, dag, lambda c: c.execute(5).get(timeout=T))


def script_task_nodes_rejected(r):
    with r.InputNode() as inp:
        dag = r.remote(ident).bind(inp)
    try:
        dag.experimental_compile()
    except TypeError as exc:
        return "actor-method" in str(exc)
    return "compiled"


COMPILED = {
    "linear_pipeline": (script_linear_pipeline, [60, 100]),
    "pipelined_executes": (script_pipelined_executes, [0, 3, 6, 9, 12]),
    "fan_out_multi_output": (script_fan_out_multi_output, [8, 20]),
    "fan_in_two_args": (script_fan_in_two_args, 50),  # 20 + 30
    "const_args_mixed_with_channels": (script_const_args_mixed_with_channels,
                                       107),
    "error_propagates_and_pipeline_survives": (
        script_error_propagates_and_pipeline_survives,
        [1, "ValueError: negative!", 2]),
    "teardown_frees_actor": (script_teardown_frees_actor, [2, 1]),
    "kwarg_bound_input": (script_kwarg_bound_input, 122),
    "task_nodes_rejected": (script_task_nodes_rejected, True),
}


@pytest.mark.parametrize("case", list(COMPILED))
def test_compiled_as_the_jax_package(pkgs, case):
    script, want = COMPILED[case]
    got = {name: script(_ns(name)) for name in PACKAGES}
    assert got["raytpu_torch"] == got["raytpu"] == want


# ---- the port's own: processes -------------------------------------------


class Peer:
    """An actor that writes and reads channels handed to it."""

    def write(self, ch, values, timeout=None):
        out = []
        for v in values:
            try:
                ch.write(v, timeout=timeout)
                out.append("ok")
            except TimeoutError:
                out.append("timeout")
            except port_channel.ChannelClosed:
                out.append("closed")
        return out

    def read(self, ch, rid, n, timeout=None):
        try:
            return [ch.read(rid, timeout=timeout) for _ in range(n)]
        except port_channel.ChannelClosed:
            return "closed"

    def hold(self, ch):
        """Map ``ch`` here and keep it (a call arriving after its close
        then finds it mapped)."""
        self.held = ch
        return ch.name

    def read_sum(self, ch, rid):
        return ch.read(rid, timeout=T).sum().item()

    def bind_and_execute(self, handle, x):
        """``bind`` on a handle unpickled in this process."""
        return rt.get(handle.apply.bind(x).execute(), timeout=T)

    def getpid(self):
        return os.getpid()


def _peers(n):
    peer = rt.remote(Peer)
    return [peer.remote() for _ in range(n)]


def test_a_channel_crosses_actor_processes_and_the_driver(pkgs):
    ch = port_channel.Channel(num_readers=2, capacity=4)
    mine, theirs = ch.reader_id(), ch.reader_id()
    w, r = _peers(2)
    values = [0, {"k": [1, 2]}, torch.arange(6), "s", 4.5, None]
    wrote = w.write.remote(ch, values, T)
    read = r.read.remote(ch, theirs, len(values), T)
    here = [ch.read(mine, timeout=T) for _ in values]
    got = rt.get(read, timeout=T)
    assert rt.get(wrote, timeout=T) == ["ok"] * len(values)
    for a, b in zip((here, got), (values, values)):
        assert torch.equal(a[2], b[2])
        assert [x for i, x in enumerate(a) if i != 2] == \
            [x for i, x in enumerate(b) if i != 2]
    ch.close()


def test_backpressure_reaches_another_process(pkgs):
    ch = port_channel.Channel(num_readers=1, capacity=2)
    rid = ch.reader_id()
    (w,) = _peers(1)
    # Two versions unread fill the ring: the third write times out there.
    assert rt.get(w.write.remote(ch, [1, 2, 3], 0.3), timeout=T) == [
        "ok", "ok", "timeout"]
    assert ch.read(rid, timeout=T) == 1
    assert rt.get(w.write.remote(ch, [3], 5.0), timeout=T) == ["ok"]
    assert [ch.read(rid, timeout=T) for _ in range(2)] == [2, 3]
    ch.close()


def test_close_wakes_readers_and_writers_in_every_process(pkgs):
    empty = port_channel.Channel(num_readers=2, capacity=1)
    full = port_channel.Channel(num_readers=1, capacity=1)
    theirs, mine = empty.reader_id(), empty.reader_id()
    full.reader_id()
    r, w = _peers(2)
    assert rt.get([r.hold.remote(empty), w.hold.remote(full)],
                  timeout=T) == [empty.name, full.name]
    read = r.read.remote(empty, theirs, 1)        # blocks: nothing written
    wrote = w.write.remote(full, ["a", "b"])      # blocks on "b"
    end = time.monotonic() + T
    while full._version() < 1 and time.monotonic() < end:
        time.sleep(0.01)
    here = []

    def driver_reader():
        try:
            empty.read(mine)
        except port_channel.ChannelClosed:
            here.append("closed")

    t = threading.Thread(target=driver_reader)
    t.start()
    time.sleep(0.5)  # all three parked in the kernel
    assert rt.wait([read, wrote], num_returns=2, timeout=0)[0] == []
    t0 = time.monotonic()
    empty.close()
    full.close()
    assert rt.get(read, timeout=T) == "closed"
    assert rt.get(wrote, timeout=T) == ["ok", "closed"]
    t.join(timeout=T)
    assert here == ["closed"]
    assert time.monotonic() - t0 < 5.0


def _store_segments():
    return [n for n, _ in object_store.segments(os.getpid())
            if ".chan" not in n]


def test_a_value_above_the_slot_goes_through_the_store(pkgs):
    ch = port_channel.Channel(num_readers=2, capacity=2)
    mine, theirs = ch.reader_id(), ch.reader_id()
    (r,) = _peers(1)
    big = torch.arange(port_channel.SLOT_BYTES // 4 + 1024,
                       dtype=torch.int32)
    small = torch.arange(1024)  # fits a slot: no segment
    before = set(_store_segments())
    ch.write(small)
    assert set(_store_segments()) == before
    assert torch.equal(ch.read(mine, timeout=T), small)
    rt.get(r.read.remote(ch, theirs, 1, T), timeout=T)
    ch.write(big)
    sealed = set(_store_segments()) - before
    assert len(sealed) == 1
    assert torch.equal(ch.read(mine, timeout=T), big)
    assert set(_store_segments()) - before == sealed  # one reader left
    assert rt.get(r.read_sum.remote(ch, theirs), timeout=T) == \
        big.sum().item()
    assert set(_store_segments()) - before == set()  # freed at its last read
    ch.close()


def _cpu_seconds(pid: int) -> float:
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def test_an_idle_compiled_graph_holds_no_core(pkgs):
    stage = rt.remote(Stage)
    a, b = stage.remote(2), stage.remote(3)
    pids = rt.get([a.getpid.remote(), b.getpid.remote()], timeout=T)
    from raytpu_torch.dag import InputNode

    with InputNode() as inp:
        dag = b.apply.bind(a.apply.bind(inp))
    compiled = dag.experimental_compile()
    try:
        assert compiled.execute(1).get(timeout=T) == 6
        time.sleep(0.2)
        before = [_cpu_seconds(p) for p in pids]
        time.sleep(1.0)
        used = [_cpu_seconds(p) - b0 for p, b0 in zip(pids, before)]
        # Parked in FUTEX_WAIT: a spinning loop would use ~1 s each.
        assert max(used) < 0.1, used
        assert compiled.execute(2).get(timeout=T) == 12
    finally:
        compiled.teardown()


def _rings(compiled) -> set:
    """The names of a compiled graph's rings still in ``/dev/shm``."""
    names = {ch.name for ch in compiled._channels}
    return {n for n, _ in port_channel.segments()} & names


def test_a_stage_death_raises_at_a_parked_get(pkgs):
    from raytpu_torch.core.errors import ActorDiedError
    from raytpu_torch.dag import InputNode

    stage = rt.remote(Stage)
    a, b = stage.remote(1), stage.remote(1)
    victim = rt.get(b.getpid.remote(), timeout=T)
    with InputNode() as inp:
        dag = b.apply.bind(a.apply.bind(inp))
    compiled = dag.experimental_compile()
    assert compiled.execute(1).get(timeout=T) == 1
    ref = compiled.execute(2)
    os.kill(victim, signal.SIGKILL)
    t0 = time.monotonic()
    with pytest.raises(ActorDiedError):
        ref.get()  # no timeout
    assert time.monotonic() - t0 < 10.0
    t0 = time.monotonic()
    compiled.teardown()
    assert time.monotonic() - t0 < 10.0
    assert _rings(compiled) == set()


def test_no_ring_left_after_teardown(pkgs):
    from raytpu_torch.dag import InputNode, MultiOutputNode

    stage = rt.remote(Stage)
    a, b = stage.remote(2), stage.remote(5)
    with InputNode() as inp:
        dag = MultiOutputNode([a.apply.bind(inp), b.apply.bind(inp)])
    compiled = dag.experimental_compile()
    assert len(_rings(compiled)) == 3  # the input and two outputs
    refs = [compiled.execute(i) for i in range(3)]
    assert refs[0].get(timeout=T) == [0, 0]  # two results never taken
    compiled.teardown()
    assert _rings(compiled) == set()
    assert rt.get([a.call_count.remote(), b.call_count.remote()],
                  timeout=T) == [3, 3]


def test_bind_on_handles_classes_and_functions(pkgs):
    from raytpu_torch.dag import ActorMethodNode, ClassNode, FunctionNode

    s = rt.remote(Stage).remote(7)
    (p,) = _peers(1)
    # A handle unpickled in the peer's process keeps bind.
    assert rt.get(p.bind_and_execute.remote(s, 3), timeout=T) == 21
    node = rt.remote(Stage).bind(4)
    assert isinstance(node, ClassNode)
    method = node.apply.bind(5)
    assert isinstance(method, ActorMethodNode)
    assert rt.get(method.execute(), timeout=T) == 20
    fn = rt.remote(ident).bind(s.apply.bind(2))
    assert isinstance(fn, FunctionNode)
    assert rt.get(fn.execute(), timeout=T) == 14


# ---- the slice: a tiny GPT-2 generate-then-score graph --------------------


def _tiny(dtype=torch.float32):
    import dataclasses

    from raytpu_torch.models.gpt2 import GPT2Config

    return dataclasses.replace(GPT2Config.tiny(), dtype=dtype)


def _port_gpt2(state):
    from raytpu_torch.models.gpt2 import GPT2

    model = GPT2(_tiny(), device="cpu")
    model.load_state_dict(state)
    return model


ENGINE = dict(page_size=8, max_num_seqs=4, max_model_len=64,
              prefill_chunk=16)
NEW_TOKENS = 4


class TinyGenerator:
    """The generate stage: the port's engine over a tiny GPT-2, greedy."""

    def __init__(self, state):
        self.model = _port_gpt2(state)

    def generate(self, prompts: dict) -> dict:
        from raytpu_torch.inference import InferenceEngine, SamplingParams

        eng = InferenceEngine(self.model, device="cpu", **ENGINE)
        for rid in sorted(prompts):
            eng.add_request(rid, prompts[rid],
                            SamplingParams(max_new_tokens=NEW_TOKENS))
        out = {rid: [] for rid in prompts}
        while eng.has_unfinished():
            for o in eng.step():
                out[o.request_id].append(o.token_id)
        return out


def padded_batch(prompts: dict, toks: dict):
    """(rids, [B, T] right-padded int64 batch, prompt lengths)."""
    rids = sorted(prompts)
    seqs = [list(prompts[r]) + list(toks[r]) for r in rids]
    batch = np.zeros((len(seqs), max(map(len, seqs))), np.int64)
    for i, s in enumerate(seqs):
        batch[i, :len(s)] = s
    return rids, batch, [len(prompts[r]) for r in rids]


def completion_logprobs(logp: np.ndarray, rids, batch, plens, toks):
    """Each sequence's summed log-probability of its completion."""
    out = {}
    for i, r in enumerate(rids):
        n = len(toks[r])
        pos = np.arange(plens[i] - 1, plens[i] - 1 + n)
        out[r] = float(logp[i, pos, batch[i, plens[i]:plens[i] + n]].sum())
    return out


class TinyScorer:
    """The score stage: one causal forward over the right-padded batch."""

    def __init__(self, state):
        self.model = _port_gpt2(state)

    def score(self, prompts: dict, toks: dict) -> dict:
        rids, batch, plens = padded_batch(prompts, toks)
        with torch.no_grad():
            logits = self.model(torch.from_numpy(batch)).float()
        logp = torch.log_softmax(logits, dim=-1).numpy()
        return completion_logprobs(logp, rids, batch, plens, toks)


def test_gpt2_generate_then_score_against_jax(pkgs):
    import dataclasses

    import jax
    import jax.numpy as jnp
    from raytpu.inference import InferenceEngine as JaxEngine
    from raytpu.inference import SamplingParams as JaxSampling
    from raytpu.models.gpt2 import GPT2 as JaxGPT2
    from raytpu.models.gpt2 import GPT2Config as JaxGPT2Config
    from raytpu.models.gpt2 import init_params

    from raytpu_torch.dag import InputNode, MultiOutputNode
    from raytpu_torch.models.convert import gpt2_state_from_jax

    jcfg = dataclasses.replace(JaxGPT2Config.tiny(), dtype=jnp.float32,
                               attn_impl="reference", paged_attn="reference",
                               remat=False)
    gen_params = init_params(JaxGPT2(jcfg), jcfg, seed=0, batch=1)
    score_params = init_params(JaxGPT2(jcfg), jcfg, seed=1, batch=1)
    states = [gpt2_state_from_jax(jax.tree_util.tree_map(np.asarray, p),
                                  _tiny())
              for p in (gen_params, score_params)]
    rng = np.random.default_rng(3)
    prompts = {f"q{i}": rng.integers(1, 512, n).tolist()
               for i, n in enumerate((5, 19, 24))}

    # JAX: its engine, then its forward.
    eng = JaxEngine(jcfg, gen_params, **ENGINE)
    for rid in sorted(prompts):
        eng.add_request(rid, prompts[rid],
                        JaxSampling(max_new_tokens=NEW_TOKENS))
    want_toks = {rid: [] for rid in prompts}
    while eng.has_unfinished():
        for o in eng.step():
            want_toks[o.request_id].append(o.token_id)
    rids, batch, plens = padded_batch(prompts, want_toks)
    logits = JaxGPT2(jcfg).apply({"params": score_params},
                                 jnp.asarray(batch))
    logp = np.asarray(jax.nn.log_softmax(logits.astype(jnp.float32), -1))
    want_scores = completion_logprobs(logp, rids, batch, plens, want_toks)

    # The port: a compiled graph over two actor processes.
    gen = rt.remote(TinyGenerator).remote(states[0])
    scorer = rt.remote(TinyScorer).remote(states[1])
    with InputNode() as inp:
        toks = gen.generate.bind(inp)
        dag = MultiOutputNode([toks, scorer.score.bind(inp, toks)])
    compiled = dag.experimental_compile()
    try:
        rounds = [compiled.execute(prompts) for _ in range(2)]
        got = [r.get(timeout=120) for r in rounds]
    finally:
        compiled.teardown()
    for got_toks, got_scores in got:
        assert got_toks == want_toks
        assert all(len(t) == NEW_TOKENS for t in got_toks.values())
        np.testing.assert_allclose([got_scores[r] for r in rids],
                                   [want_scores[r] for r in rids],
                                   rtol=SCORE_TOL, atol=0)
    assert got[0] == got[1]


_EXIT_SCRIPT = """
import json, raytpu_torch as rt
from raytpu_torch.dag import InputNode

class Echo:
    def echo(self, x):
        return x

a, b = rt.remote(Echo).remote(), rt.remote(Echo).remote()
with InputNode() as inp:
    dag = b.echo.bind(a.echo.bind(inp))
g = dag.experimental_compile()
assert g.execute(1).get(timeout=60) == 1
g.execute(2)  # never taken
print(json.dumps(sorted(ch.name for ch in g._channels)))
"""


def test_a_graph_alive_at_the_driver_exit_does_not_hang_it(pkgs):
    """A driver that exits with a live graph (no teardown, no shutdown)
    exits, and leaves none of its rings."""
    import json
    import subprocess
    import sys

    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", _EXIT_SCRIPT],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert time.monotonic() - t0 < 60.0
    rings = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(rings) == 3
    assert not [r for r in rings if os.path.exists(f"/dev/shm/{r}")]


def test_a_graph_alive_at_shutdown_does_not_hang_it(pkgs):
    """Last: it ends the module's port runtime, and starts it again."""
    from raytpu_torch.dag import InputNode

    stage = rt.remote(Stage)
    a, b = stage.remote(2), stage.remote(3)
    with InputNode() as inp:
        dag = b.apply.bind(a.apply.bind(inp))
    compiled = dag.experimental_compile()
    assert compiled.execute(1).get(timeout=T) == 6
    pending = compiled.execute(2)  # its result never taken
    t0 = time.monotonic()
    rt.shutdown()
    assert time.monotonic() - t0 < 10.0
    assert _rings(compiled) == set()
    with pytest.raises(RuntimeError, match="torn down"):
        compiled.execute(3)
    del pending
    rt.init(num_cpus=2)
