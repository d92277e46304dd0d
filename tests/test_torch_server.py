"""The port's BatchingServer (CPU, f32) against the JAX package's on the
same tiny GGUF and the same image bytes, and its behaviour case by case as
tests/test_server.py holds the JAX server's."""

import http.client
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from dinov2_tpu.io.synthetic import write_synthetic_gguf
from dinov2_tpu.models.config import DinoConfig
from dinov2_tpu.runtime.engine import DinoEngine as JaxEngine
from dinov2_tpu.runtime.server import BatchingServer as JaxServer
from dinov2_tpu.runtime.server import sniff_image_dims as jax_sniff_image_dims
from dinov2_tpu_torch.runtime.engine import DinoEngine
from dinov2_tpu_torch.runtime.server import BatchingServer, _Pending, sniff_image_dims

TINY = DinoConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                  num_classes=4, patch_size=14, img_size=70)
PROB_ATOL = 1e-5  # /classify probs, port f32 against JAX f32
TOKEN_REL = 6e-6  # docs/PARITY.md f32 envelope on S/B tokens, of max|token|
PCA_AGREE = 0.99  # share of PNG values at most one u8 level apart


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_synthetic_gguf(tmp_path_factory.mktemp("srv") / "m.gguf", TINY, seed=3)


def _engine(ckpt):
    return DinoEngine(ckpt, dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def servers(ckpt):
    """(port server, JAX server) on port 0, each started."""
    pair = (BatchingServer(_engine(ckpt), port=0, max_wait_ms=20.0),
            JaxServer(JaxEngine(ckpt, dtype=jnp.float32), port=0, max_wait_ms=20.0))
    for srv in pair:
        srv.start()
    yield pair
    for srv in pair:
        srv.stop()


@pytest.fixture
def server(servers):
    return servers[0]


def _request(port, path, data=None, timeout=120):
    """(status, content type, body bytes) of one request."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _post_json(port, path, data):
    status, _, body = _request(port, path, data)
    assert status == 200, body
    return json.loads(body)


def _encode(img, ext=".jpg"):
    ok, buf = cv2.imencode(ext, img)
    assert ok
    return buf.tobytes()


def _image(seed, h=96, w=128):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("endpoint", ["/classify", "/features", "/pca", "/healthz"])
def test_endpoints_match_jax(servers, endpoint):
    """The same bytes to both servers, each reply held to the other's."""
    ours, theirs = servers
    data = None if endpoint == "/healthz" else _encode(_image(1), ".png")
    got, want = _request(ours.port, endpoint, data), _request(theirs.port, endpoint, data)
    assert got[0] == want[0] == 200
    assert got[1] == want[1]
    if endpoint == "/pca":
        a, b = (cv2.imdecode(np.frombuffer(r[2], np.uint8), cv2.IMREAD_COLOR) for r in (got, want))
        assert a.shape == b.shape == (96, 128, 3)
        agree = (np.abs(a.astype(np.int32) - b.astype(np.int32)) <= 1).mean()
        assert agree >= PCA_AGREE
        return
    got, want = json.loads(got[2]), json.loads(want[2])
    if endpoint == "/classify":
        assert [label for label, _ in got["topk"]] == [label for label, _ in want["topk"]]
        np.testing.assert_allclose([p for _, p in got["topk"]], [p for _, p in want["topk"]],
                                   atol=PROB_ATOL, rtol=0)
    elif endpoint == "/features":
        assert got["grid"] == want["grid"] == [96 // 14 + 1, 128 // 14 + 1]
        a, b = np.asarray(got["cls_token"]), np.asarray(want["cls_token"])
        assert a.shape == (64,)
        assert np.abs(a - b).max() <= TOKEN_REL * np.abs(b).max()
    else:
        assert got["ok"] and got["model"] == want["model"]


@pytest.mark.parametrize("endpoint", ["/classify", "/features"])
def test_concurrent_requests_coalesce(server, endpoint):
    """Six concurrent same-size requests run in fewer than six batches, and
    every engine call runs on the batcher thread."""
    engine = server.engine
    name = "classify" if endpoint == "/classify" else "extract_features_mixed"
    original, threads_seen = getattr(engine, name), set()

    def recording(*args, **kwargs):
        threads_seen.add(threading.current_thread())
        return original(*args, **kwargs)

    setattr(engine, name, recording)
    results, errors = [None] * 6, []

    def call(i):
        try:
            results[i] = _post_json(server.port, endpoint, _encode(_image(10 + i, 70, 70)))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    before = server.stats["batches"]
    clients = [threading.Thread(target=call, args=(i,)) for i in range(6)]
    try:
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=120)
    finally:
        delattr(engine, name)
    assert not any(t.is_alive() for t in clients)
    assert not errors and all(r is not None for r in results)
    assert server.stats["batches"] - before < 6
    assert threads_seen == {server._batcher}


@pytest.mark.parametrize("endpoint", ["/classify", "/features", "/pca"])
def test_forwards_build_no_autograd_graph(server, endpoint):
    """torch.inference_mode is thread-local: every forward the batcher
    thread runs for a request is inside it."""
    model, modes = server.engine.model, []
    original = model.forward

    def recording(*args, **kwargs):
        modes.append((torch.is_inference_mode_enabled(), threading.current_thread()))
        return original(*args, **kwargs)

    model.forward = recording
    try:
        assert _request(server.port, endpoint, _encode(_image(40, 70, 70)))[0] == 200
    finally:
        del model.forward
    assert modes and modes == [(True, server._batcher)] * len(modes)


def test_listen_backlog_holds_a_burst(ckpt):
    """64 clients complete their connect while nothing accepts yet, and each
    is answered once the server runs: socketserver's default backlog of 5
    left the rest to time out, or reset them under a burst of posts."""
    srv = BatchingServer(_engine(ckpt), port=0)
    sockets = []
    try:
        try:
            for _ in range(64):
                sockets.append(socket.create_connection(("127.0.0.1", srv.port), timeout=2))
                sockets[-1].sendall(b"GET /healthz HTTP/1.1\r\nHost: x\r\n\r\n")
        finally:
            srv.start()  # stop() below waits for the serve loop
        for s in sockets:
            s.settimeout(30)
            assert b" 200 " in s.recv(4096).split(b"\r\n", 1)[0]
    finally:
        for s in sockets:
            s.close()
        srv.stop()


def _truncated_png():
    """A PNG whose header sizes it (24x16) and whose data is cut off."""
    return _encode(np.zeros((16, 24, 3), np.uint8), ".png")[:40]


@pytest.mark.parametrize("body,error,decoded", [
    (b"not an image", "container", False),
    (b"P4\n12000 12000\n" + b"\xff" * 1024, "container", False),  # PBM: unsniffable
    (_truncated_png(), "decode failed", True),
], ids=["garbage", "pbm-bomb", "truncated-png"])
def test_bad_images_400(server, monkeypatch, body, error, decoded):
    """400 for a body that does not decode; an unsniffable container is
    refused before cv2.imdecode allocates its frame."""
    calls, original = [], cv2.imdecode
    monkeypatch.setattr(cv2, "imdecode", lambda *a, **k: calls.append(1) or original(*a, **k))
    status, _, reply = _request(server.port, "/classify", body)
    assert status == 400
    assert error in json.loads(reply)["error"]
    assert bool(calls) == decoded


@pytest.fixture(scope="module")
def capped(ckpt):
    srv = BatchingServer(_engine(ckpt), port=0, max_body_mb=0.05, max_side=200)
    srv.start()
    yield srv
    srv.stop()


@pytest.mark.parametrize("case", ["body", "side", "bomb", "compliant"])
def test_request_caps(capped, monkeypatch, case):
    """413 for a body over the cap; 400 for a side over the cap, from the
    header before decode (a 2000x2000 PNG is a small body); a compliant
    request on the same server still classifies."""
    body = {
        "body": b"\0" * 80_000,
        "side": _encode(_image(3, 50, 300)),
        "bomb": _encode(np.zeros((2000, 2000, 3), np.uint8), ".png"),
        "compliant": _encode(_image(4, 70, 70)),
    }[case]
    assert len(body) < capped.max_body_bytes or case == "body"
    calls, original = [], cv2.imdecode
    monkeypatch.setattr(cv2, "imdecode", lambda *a, **k: calls.append(1) or original(*a, **k))
    status, _, reply = _request(capped.port, "/classify", body)
    if case == "compliant":
        assert status == 200 and "topk" in json.loads(reply)
        return
    assert status == (413 if case == "body" else 400)
    message = json.loads(reply)["error"]
    assert ("limit" if case == "body" else "side limit") in message
    assert "compiles" not in message  # the port's own reason
    assert not calls


@pytest.mark.parametrize("length", ["-1", "abc"])
def test_invalid_content_length_400(server, length):
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
    try:
        conn.putrequest("POST", "/classify")
        conn.putheader("Content-Length", length)
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 400
        assert "Content-Length" in json.loads(resp.read())["error"]
    finally:
        conn.close()


def test_unknown_path_404(server):
    assert _request(server.port, "/nope")[0] == 404
    assert _request(server.port, "/nope", b"x")[0] == 404


def test_wedged_batcher_504(ckpt):
    """With the batcher never running, the handler replies 504, never 200."""
    srv = BatchingServer(_engine(ckpt), port=0, request_timeout_s=0.3)
    threading.Thread(target=srv._http.serve_forever, daemon=True).start()
    try:
        assert _request(srv.port, "/classify", _encode(_image(5)))[0] == 504
    finally:
        srv._http.shutdown()
        srv._http.server_close()


def test_requests_counter_latency_and_empty_error_500(ckpt):
    """/healthz counts every inference POST and reports latency percentiles;
    an engine exception whose str() is empty is still a 500."""
    srv = BatchingServer(_engine(ckpt), port=0)
    srv.start()
    try:
        for i in range(3):
            _post_json(srv.port, "/classify", _encode(_image(20 + i, 70, 70)))
        health = json.loads(_request(srv.port, "/healthz")[2])
        assert health["stats"]["requests"] == 3
        lat = health["latency_ms"]
        assert lat["count"] == 3 and 0 < lat["p50"] <= lat["p90"] <= lat["p99"] <= lat["max"]

        def boom(*args, **kwargs):
            raise ValueError()

        srv.engine.classify = boom
        status, _, reply = _request(srv.port, "/classify", _encode(_image(6, 70, 70)))
        assert status == 500 and json.loads(reply)["error"] == "inference failed"
    finally:
        srv.stop()
    assert srv._http.socket.fileno() == -1  # the listening socket is released


def test_stop_fails_queued_requests(ckpt):
    srv = BatchingServer(_engine(ckpt), port=0)
    srv.start()
    srv.stop()
    srv._batcher.join(timeout=10)
    assert not srv._batcher.is_alive()
    pending = _Pending(image=np.zeros((32, 32, 3), np.uint8), mode="classify")
    srv._queue.put(pending)
    srv.stop()  # idempotent; fails the straggler
    assert pending.event.is_set() and pending.error == "server stopped"


@pytest.fixture(scope="module")
def impatient(ckpt):
    srv = BatchingServer(_engine(ckpt), port=0, read_timeout_s=1.0)
    srv.start()
    yield srv
    srv.stop()


@pytest.mark.parametrize("client", ["slowloris", "dripfeed"])
def test_slow_clients_are_cut_off(impatient, client):
    """A client that declares a body and never sends it is closed by the
    per-recv timeout; one that drips a byte every 0.2 s gets a 408 from the
    whole-request deadline. Both within a few seconds at read_timeout_s=1."""
    s = socket.create_connection(("127.0.0.1", impatient.port), timeout=30)
    stop_drip = threading.Event()
    try:
        s.sendall(b"POST /classify HTTP/1.1\r\nHost: x\r\nContent-Length: 100000\r\n\r\n")
        if client == "dripfeed":
            def drip():
                while not stop_drip.is_set():
                    try:
                        s.sendall(b"x")
                    except OSError:
                        return
                    time.sleep(0.2)

            threading.Thread(target=drip, daemon=True).start()
        start = time.perf_counter()
        data = s.recv(4096)
        elapsed = time.perf_counter() - start
    finally:
        stop_drip.set()
        s.close()
    if client == "slowloris":
        assert data == b"", data[:100]
    else:
        assert b"408" in data.split(b"\r\n", 1)[0], data[:100]
    assert elapsed < 15


def _gif():
    return b"GIF89a" + (96).to_bytes(2, "little") + (48).to_bytes(2, "little") + b"\0" * 16


def _bmp_core():
    return (b"BM" + b"\0" * 12 + (12).to_bytes(4, "little") + (96).to_bytes(2, "little")
            + (48).to_bytes(2, "little") + (1).to_bytes(2, "little") + (24).to_bytes(2, "little"))


def _jpeg_fill(n):
    jpg = _encode(np.zeros((48, 96, 3), np.uint8))
    return jpg[:2] + b"\xff" * n + jpg[2:]


@pytest.mark.parametrize("make,dims", [
    (lambda: _encode(np.zeros((48, 96, 3), np.uint8), ".png"), (96, 48)),
    (lambda: _encode(np.zeros((48, 96, 3), np.uint8), ".jpg"), (96, 48)),
    (lambda: _jpeg_fill(1), (96, 48)),
    (lambda: _jpeg_fill(3), (96, 48)),
    (_gif, (96, 48)),
    (lambda: _encode(np.zeros((48, 96, 3), np.uint8), ".bmp"), (96, 48)),
    (_bmp_core, (96, 48)),
    (lambda: _encode(np.zeros((48, 96, 3), np.uint8), ".webp"), (96, 48)),
    (lambda: b"\0" * 64, None),
    (lambda: b"", None),
], ids=["png", "jpeg", "jpeg-fill-1", "jpeg-fill-3", "gif", "bmp", "bmp-core", "webp",
        "unknown", "empty"])
def test_sniff_image_dims(make, dims):
    """(width, height) from the container header, as the JAX sniffer reads it."""
    data = make()
    assert sniff_image_dims(data) == dims == jax_sniff_image_dims(data)
