"""The port's HTTP proxy (raytpu_torch/serve/_private/proxy.py, on the
standard library's asyncio streams) held to the JAX package's (on
aiohttp): the same deployments go behind both proxies, and the same raw
requests go through ``requests`` (or ``http.client``, where a request
repeats a header) to each. Status, Content-Type and body must be equal
case by case: a dict, a str and a bytes result, ``(status, body)``
tuples, longest-prefix routes (``/echo``, ``/echo/``, ``/echo/x``,
``/echox`` and ``/`` as a catch-all), a repeated query key and a
mixed-case or repeated header as the handler's ``Request`` sees them,
an empty body's ``json()``, ``serve_multiplexed_model_id``, 404,
``/-/healthz`` and ``/-/routes`` (as JSON). A raised ``ValueError`` is a 500 whose
body is the replica's ``TaskError`` in both: its first line and its last
(``ValueError: kaboom``) are compared, since the traceback between them
names each package's files. SSE: a multi-line chunk's framing, a dict
chunk, ``[DONE]``, and a mid-stream error in band; the first event
arrives before a 2 s sleep in the handler ends. The ASGI ingress of
tests/test_serve.py:647 (a bare app, and a plain deployment on the same
proxy), with two ``Set-Cookie`` headers surviving. Then the port alone:
a client that drops an SSE stream ends the handler in its replica (the
JAX proxy leaves it running: ROADMAP.md, Queue 3), a streaming
deployment asked without SSE is a 500, and ``start`` after ``shutdown``
binds the same port again.

Replicas of the port rebuild these classes by importing this module by
name, so it imports nothing of JAX or of the JAX package at its top
level. One serve instance of each package serves the module, each on a
free port picked at run time (the JAX tests bind 18432-18456).
"""

import http.client
import importlib
import json
import multiprocessing
import os
import socket
import threading
import time

import pytest
import requests

from raytpu_torch import serve as port_serve

DEADLINE_S = 60.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---- deployment bodies, shared by both packages ------------------------


class Echo:
    """What the handler's Request holds, or a result picked by the path's
    last part."""

    def __init__(self, pkg: str):
        self.pkg = pkg  # the serve package whose replica this is

    # A coroutine: a sync handler runs on the replica's executor, which
    # does not carry the request context, so it would read no model id
    # in either package.
    async def __call__(self, request):
        kind = request.path.rsplit("/", 1)[-1]
        if kind == "str":
            return "plain text"
        if kind == "bytes":
            return b"\x00raw\xff"
        if kind == "tuple":
            return (201, "made")
        if kind == "tuple-json":
            return (418, {"teapot": True})
        if kind == "empty-json":
            return {"json": request.json()}
        if kind == "boom":
            raise ValueError("kaboom")
        mux = importlib.import_module(self.pkg).get_multiplexed_model_id()
        return {"path": request.path, "method": request.method,
                "route_prefix": request.route_prefix,
                "query": request.query, "headers": request.headers,
                "body": request.text, "model": mux}


class Root:
    def __call__(self, request):
        return {"root": request.path, "route_prefix": request.route_prefix}


class Tokens:
    """SSE bodies: a multi-line chunk, a dict chunk, then the end or an
    error; a slow stream whose second token waits 2 s."""

    def __call__(self, request):
        if request.path.endswith("/slow"):
            yield "tok0"
            time.sleep(2.0)
            yield "tok1"
            return
        yield "line one\nline two"
        yield {"k": [1, 2]}
        yield b"bytes chunk"
        if request.path.endswith("/fail"):
            raise ValueError("mid")


class Endless:
    """A stream that never ends on its own; its ``finally`` (run when the
    stream is closed) writes the file it was given."""

    def __init__(self, marker: str):
        self.marker = marker

    def __call__(self, request):
        try:
            i = 0
            while True:
                yield f"t{i}"
                i += 1
                time.sleep(0.05)
        finally:
            with open(self.marker, "w") as f:
                f.write("closed")


async def asgi_app(scope, receive, send):
    """tests/test_serve.py:647's bare ASGI app, plus two cookies."""
    assert scope["type"] == "http"
    msg = await receive()
    body = msg.get("body", b"")
    payload = {
        "path": scope["path"],
        "method": scope["method"],
        "root_path": scope["root_path"],
        "raw_path": scope["raw_path"].decode(),
        "query": scope["query_string"].decode(),
        "headers": sorted(k.decode() for k, _ in scope["headers"]),
        "echo": body.decode() if body else None,
    }
    await send({
        "type": "http.response.start",
        "status": 201,
        "headers": [(b"content-type", b"application/json"),
                    (b"x-served-by", b"raytpu-asgi"),
                    (b"set-cookie", b"a=1"), (b"set-cookie", b"b=2")],
    })
    await send({"type": "http.response.body",
                "body": json.dumps(payload).encode()})


@port_serve.ingress(asgi_app)
class AsgiServer:
    """The port's ``ingress`` sets the attribute the JAX replica reads
    too (``__raytpu_asgi_app__``), so one class serves both."""


class Plain:
    def __call__(self, request):
        return {"plain": True}


# ---- the two serve instances ------------------------------------------

# name: (route prefix, target, init args by package).
APPS = {
    "echo": ("/echo", Echo, lambda pkg: (pkg,)),
    "root": ("/", Root, lambda pkg: ()),
    "toks": ("/toks", Tokens, lambda pkg: ()),
    "asgi": ("/svc", AsgiServer, lambda pkg: ()),
    "plain": ("/plain", Plain, lambda pkg: ()),
}


def wait_routes(base: str, prefixes) -> None:
    """Until the proxy's route table holds every prefix: it long-polls
    the controller, so a route lands just after ``run`` returns."""
    end = time.monotonic() + DEADLINE_S
    while time.monotonic() < end:
        try:
            if set(prefixes) <= set(requests.get(f"{base}/-/routes",
                                                 timeout=10).json()):
                return
        except requests.RequestException:
            pass
        time.sleep(0.05)
    raise AssertionError(f"routes {prefixes} never reached {base}")


@pytest.fixture(scope="module")
def bases():
    """``{"jax": url, "port": url}``: each package's serve instance with
    APPS deployed behind its HTTP proxy; both shut down at the module's
    end, leaving no process."""
    import raytpu
    from raytpu import serve as jax_serve

    raytpu.shutdown()
    raytpu.init(num_cpus=4)
    before = {p.pid for p in multiprocessing.active_children()}
    pkgs = {"jax": (jax_serve, "raytpu.serve"),
            "port": (port_serve, "raytpu_torch.serve")}
    out = {}
    try:
        for tag, (serve, pkg) in pkgs.items():
            port = free_port()
            serve.start(host="127.0.0.1", port=port)
            out[tag] = f"http://127.0.0.1:{port}"
        errors = []

        def run(serve, pkg, name, prefix, target, args):
            try:
                serve.run(serve.deployment(target).bind(*args(pkg)),
                          name=name, route_prefix=prefix)
            except Exception as exc:  # reported below
                errors.append((pkg, name, exc))

        starts = [threading.Thread(target=run, args=(serve, pkg, name, *app))
                  for serve, pkg in pkgs.values()
                  for name, app in APPS.items()]
        for t in starts:
            t.start()
        for t in starts:
            t.join(timeout=DEADLINE_S)
        assert not any(t.is_alive() for t in starts) and errors == []
        for base in out.values():
            wait_routes(base, [p for p, *_ in APPS.values()])
        yield out
    finally:
        port_serve.shutdown()
        jax_serve.shutdown()
        raytpu.shutdown()
    left = [(p.name, p.pid) for p in multiprocessing.active_children()
            if p.pid not in before]
    assert left == []


def normalized(base: str, r) -> tuple:
    """(status, Content-Type, body) with the proxy's port written PORT
    (the Host header the handler sees names it)."""
    port = base.rsplit(":", 1)[1]
    return (r.status_code, r.headers.get("Content-Type"),
            r.content.replace(port.encode(), b"PORT"))


def both(bases, method: str, path: str, **kw) -> dict:
    return {tag: normalized(base, requests.request(
        method, base + path, timeout=DEADLINE_S, **kw))
        for tag, base in bases.items()}


# ---- the same requests through both proxies ----------------------------


@pytest.mark.parametrize("method,path,kw", [
    ("GET", "/echo", {}),
    ("POST", "/echo", {"json": {"x": 4}}),
    ("GET", "/echo/str", {}),
    ("GET", "/echo/bytes", {}),
    ("GET", "/echo/tuple", {}),
    ("GET", "/echo/tuple-json", {}),
    ("POST", "/echo/empty-json", {}),
    ("PUT", "/echo/a%20b/x?a=1&a=2&b=c+d&e=%C3%A9&f", {"data": b"raw"}),
    ("GET", "/echo", {"headers": {"X-Mixed-Case": "v",
                                  "serve_multiplexed_model_id": "m7"}}),
    ("GET", "/nope-not-routed-by-prefix", {}),
    ("GET", "/-/healthz", {}),
], ids=["dict", "post-json", "str", "bytes", "tuple", "tuple-json",
        "empty-json", "query-and-path", "headers-and-model-id", "catch-all",
        "healthz"])
def test_same_status_type_and_body(bases, method, path, kw):
    got = both(bases, method, path, **kw)
    assert got["port"] == got["jax"]
    if "serve_multiplexed_model_id" in kw.get("headers", {}):
        assert json.loads(got["port"][2])["model"] == "m7"


def test_route_tables_agree(bases):
    """``/-/routes``: the same table (its keys in the order the apps were
    deployed, which the fixture's threads do not fix)."""
    got = both(bases, "GET", "/-/routes")
    assert [g[:2] for g in got.values()] == [
        (200, "application/json; charset=utf-8")] * 2
    assert json.loads(got["port"][2]) == json.loads(got["jax"][2]) == {
        prefix: [name, target.__name__]
        for name, (prefix, target, _) in APPS.items()}


@pytest.mark.parametrize("path", ["/echo", "/echo/", "/echo/x", "/echox",
                                  "/", "/other/deep"])
def test_longest_prefix_routes_agree(bases, path):
    got = both(bases, "GET", path)
    assert got["port"] == got["jax"]
    want_root = path == "/echox" or not path.startswith("/echo")
    assert (b'"root"' in got["port"][2]) == want_root


def test_repeated_and_mixed_case_headers_agree(bases):
    """Two headers of one name in different cases: the handler's dict
    keeps both spellings, each holding the first value (aiohttp's
    ``dict(request.headers)``)."""
    got = {}
    for tag, base in bases.items():
        host, port = base[len("http://"):].split(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=DEADLINE_S)
        try:
            conn.putrequest("GET", "/echo/x?k=1&k=2")
            conn.putheader("X-Dup", "first")
            conn.putheader("x-dup", "second")
            conn.putheader("X-DUP", "third")
            conn.endheaders()
            r = conn.getresponse()
            got[tag] = (r.status, r.getheader("Content-Type"),
                        r.read().replace(port.encode(), b"PORT"))
        finally:
            conn.close()
    assert got["port"] == got["jax"]
    seen = json.loads(got["port"][2])
    assert {k: v for k, v in seen["headers"].items()
            if k.lower() == "x-dup"} == {"X-Dup": "first", "x-dup": "first",
                                         "X-DUP": "first"}
    assert seen["query"] == {"k": "1"}


def test_a_raised_error_is_a_500_naming_it(bases):
    got = both(bases, "GET", "/echo/boom")
    for status, ctype, body in got.values():
        assert (status, ctype) == (500, "text/plain; charset=utf-8")
    heads = {tag: (b[2].split(b"\n")[0].split(b".")[-1],
                   b[2].strip().split(b"\n")[-1]) for tag, b in got.items()}
    assert heads["port"] == heads["jax"] == (b"handle_request failed:",
                                             b"ValueError: kaboom")
    assert all(b[2].startswith(b"TaskError: task ") for b in got.values())


def sse(base: str, path: str) -> tuple:
    """(status, Content-Type, raw body, seconds to the first event)."""
    t0 = time.monotonic()
    first = None
    chunks = []
    with requests.get(base + path, headers={"Accept": "text/event-stream"},
                      stream=True, timeout=DEADLINE_S) as r:
        for chunk in r.iter_content(chunk_size=None):
            if first is None and b"data:" in chunk:
                first = time.monotonic() - t0
            chunks.append(chunk)
        return r.status_code, r.headers.get("Content-Type"), \
            b"".join(chunks), first


def test_sse_framing_and_done_agree(bases):
    got = {tag: sse(base, "/toks/ok") for tag, base in bases.items()}
    assert got["port"][:3] == got["jax"][:3]
    assert got["port"][:3] == (
        200, "text/event-stream",
        b'data: line one\ndata: line two\n\ndata: {"k": [1, 2]}\n\n'
        b"data: bytes chunk\n\ndata: [DONE]\n\n")


def test_sse_error_in_band_agrees(bases):
    got = {tag: sse(base, "/toks/fail") for tag, base in bases.items()}
    parts = {}
    for tag, (status, ctype, body, _) in got.items():
        head, sep, error = body.partition(b"event: error\ndata: ")
        assert (status, ctype) == (200, "text/event-stream") and sep, body
        parts[tag] = (head, error.split(b"\n")[0].split(b".")[-1],
                      error.strip().split(b"\n")[-1])
    assert parts["port"] == parts["jax"]
    assert parts["port"][1:] == (b"handle_request_streaming failed:",
                                 b"ValueError: mid")


def test_sse_streams_before_the_handler_ends(bases):
    for tag, base in bases.items():
        status, _, body, first = sse(base, "/toks/slow")
        assert status == 200 and body.endswith(b"data: [DONE]\n\n"), tag
        assert first is not None and first < 2.0, (tag, first)


def test_asgi_ingress_beside_a_plain_deployment(bases):
    """tests/test_serve.py:647 through both: a bare ASGI app in the
    replica, its status, headers (two Set-Cookie kept) and body; a plain
    deployment on the same proxy keeps the Request contract."""
    got = {}
    for tag, base in bases.items():
        host, port = base[len("http://"):].split(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=DEADLINE_S)
        try:
            conn.request("POST", "/svc/predict?k=v&x=a%2Bb+c", body=b"hi",
                         headers={"X-Case": "1"})
            r = conn.getresponse()
            cookies = [v for k, v in r.getheaders()
                       if k.lower() == "set-cookie"]
            got[tag] = (r.status, r.getheader("Content-Type"),
                        r.getheader("x-served-by"), cookies, r.read())
        finally:
            conn.close()
    assert got["port"] == got["jax"]
    status, ctype, served, cookies, body = got["port"]
    assert (status, ctype, served, cookies) == (
        201, "application/json", "raytpu-asgi", ["a=1", "b=2"])
    out = json.loads(body)
    assert (out["path"], out["root_path"], out["method"], out["echo"]) == (
        "/predict", "/svc", "POST", "hi")
    assert out["query"] == "k=v&x=a%2Bb c"
    plain = both(bases, "GET", "/plain")
    assert plain["port"] == plain["jax"]
    assert json.loads(plain["port"][2]) == {"plain": True}


# ---- the port alone ----------------------------------------------------


def test_a_dropped_sse_stream_ends_in_the_replica(bases, tmp_path):
    marker = str(tmp_path / "closed")
    port_serve.run(port_serve.deployment(Endless).bind(marker),
                   name="endless", route_prefix="/endless")
    try:
        base = bases["port"]
        wait_routes(base, ["/endless"])
        host, port = base[len("http://"):].split(":")
        sock = socket.create_connection((host, int(port)), timeout=10)
        sock.sendall(b"GET /endless HTTP/1.1\r\nHost: x\r\n"
                     b"Accept: text/event-stream\r\n\r\n")
        got = b""
        while got.count(b"data: ") < 3:
            got += sock.recv(4096)
        assert b"data: t0" in got and not os.path.exists(marker)
        sock.close()
        end = time.monotonic() + DEADLINE_S
        while not os.path.exists(marker):
            assert time.monotonic() < end, "the stream was never closed"
            time.sleep(0.05)
    finally:
        port_serve.delete("endless")


def test_a_stream_asked_without_sse_is_a_500(bases):
    """A generator deployment asked without ``text/event-stream``: its
    result (a generator) cannot cross, and the port answers 500 naming
    that (the JAX proxy never answers: ROADMAP.md, Queue 3)."""
    r = requests.get(bases["port"] + "/toks/ok", timeout=DEADLINE_S)
    assert (r.status_code, r.headers["Content-Type"]) == (
        500, "text/plain; charset=utf-8")
    assert "cannot pickle 'generator' object" in r.text


def test_start_after_shutdown_binds_the_same_port(bases):
    port = int(bases["port"].rsplit(":", 1)[1])
    before = {p.pid for p in multiprocessing.active_children()}
    port_serve.shutdown()
    assert {p.pid for p in multiprocessing.active_children()} < before
    with pytest.raises(requests.ConnectionError):
        requests.get(f"{bases['port']}/-/healthz", timeout=10)
    port_serve.start(host="127.0.0.1", port=port)
    port_serve.run(port_serve.deployment(Plain).bind(), name="plain",
                   route_prefix="/plain")
    wait_routes(bases["port"], ["/plain"])
    r = requests.get(f"{bases['port']}/plain", timeout=DEADLINE_S)
    assert (r.status_code, r.json()) == (200, {"plain": True})
