"""The port's gRPC proxy (raytpu_torch/serve/_private/grpc_proxy.py)
held to the JAX package's: tests/test_serve.py:708 through both — a
unary call and a stream through the generic byte service, routed by the
``route`` metadata entry, and an unknown route answered ``NOT_FOUND`` —
and the proxy's start where ``grpc`` cannot be imported, which raises
the same ``ImportError`` in both.

Replicas of the port rebuild these classes by importing this module by
name, so it imports nothing of JAX, of the JAX package or of ``grpc``
at its top level. Ports are picked free at run time (the JAX tests bind
18432-18456).
"""

import asyncio
import json
import multiprocessing
import socket
import sys

import pytest

from raytpu_torch import serve as port_serve

DEADLINE_S = 60.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Predictor:
    def __call__(self, request):
        payload = request.json()
        return {"doubled": payload["x"] * 2, "route": request.path,
                "method": request.method}


class Tokens:
    def __call__(self, request):
        for i in range(4):
            yield f"tok{i}"


@pytest.fixture(scope="module")
def channels():
    """``{"jax": grpc channel, "port": grpc channel}``, each to its
    package's gRPC proxy with Predictor at /predict and Tokens at
    /tokens; both shut down at the module's end, leaving no process."""
    grpc = pytest.importorskip("grpc")
    import raytpu
    from raytpu import serve as jax_serve

    raytpu.shutdown()
    raytpu.init(num_cpus=4)
    before = {p.pid for p in multiprocessing.active_children()}
    out = {}
    try:
        for tag, serve in (("jax", jax_serve), ("port", port_serve)):
            port = free_port()
            serve.start(host="127.0.0.1", port=free_port(), grpc_port=port)
            serve.run(serve.deployment(Predictor).bind(), name="pred",
                      route_prefix="/predict")
            serve.run(serve.deployment(Tokens).bind(), name="toks",
                      route_prefix="/tokens")
            out[tag] = grpc.insecure_channel(f"127.0.0.1:{port}")
        yield out
    finally:
        for ch in out.values():
            ch.close()
        port_serve.shutdown()
        jax_serve.shutdown()
        raytpu.shutdown()
    left = [(p.name, p.pid) for p in multiprocessing.active_children()
            if p.pid not in before]
    assert left == []


def call(ch, route: str, payload: bytes):
    """A unary call; retried while the proxy's route table has not yet
    seen the app (it long-polls the controller)."""
    import grpc

    unary = ch.unary_unary("/raytpu.serve/Call")
    for _ in range(100):
        try:
            return unary(payload, metadata=(("route", route),),
                         timeout=DEADLINE_S)
        except grpc.RpcError as err:
            if err.code() != grpc.StatusCode.NOT_FOUND:
                raise
            import time

            time.sleep(0.05)
    raise AssertionError(f"route {route} never reached the proxy")


def test_unary_calls_agree(channels):
    got = {tag: json.loads(call(ch, "/predict", json.dumps(
        {"x": 21}).encode())) for tag, ch in channels.items()}
    assert got["port"] == got["jax"] == {"doubled": 42, "route": "/predict",
                                         "method": "GRPC"}


def test_streams_agree(channels):
    call(channels["port"], "/predict", b'{"x": 0}')  # the routes are in
    got = {}
    for tag, ch in channels.items():
        stream = ch.unary_stream("/raytpu.serve/Stream")
        got[tag] = list(stream(b"", metadata=(("route", "/tokens"),),
                               timeout=DEADLINE_S))
    assert got["port"] == got["jax"] == [b"tok0", b"tok1", b"tok2", b"tok3"]


def test_an_unknown_route_is_not_found(channels):
    import grpc

    for tag, ch in channels.items():
        with pytest.raises(grpc.RpcError) as err:
            ch.unary_unary("/raytpu.serve/Call")(
                b"{}", metadata=(("route", "/nope"),), timeout=10)
        assert err.value.code() == grpc.StatusCode.NOT_FOUND, tag
        assert "no deployment at route '/nope'" in err.value.details()


def test_without_grpc_the_start_raises_the_same_import_error(
        channels, monkeypatch):
    """Where ``grpc`` cannot be imported (as on a machine without it),
    the proxy's start raises its ImportError, in both packages alike."""
    from raytpu.serve._private.grpc_proxy import GrpcProxyActor as JaxProxy

    from raytpu_torch.serve._private.grpc_proxy import \
        GrpcProxyActor as PortProxy

    monkeypatch.setitem(sys.modules, "grpc", None)
    errors = {}
    for tag, cls in (("jax", JaxProxy), ("port", PortProxy)):
        with pytest.raises(ImportError) as err:
            asyncio.run(cls("127.0.0.1", free_port()).ready())
        errors[tag] = (type(err.value), str(err.value))
    assert errors["port"] == errors["jax"]
