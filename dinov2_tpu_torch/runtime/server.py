"""Batching inference server (port of dinov2_tpu/runtime/server.py;
stdlib-only HTTP, no extra dependencies).

A background batcher coalesces concurrent requests into one batched
forward of the DinoEngine in front of it: the card is fed by batches, not
by single images.

Endpoints:
  POST /classify   body: raw image bytes (jpg/png)   -> {"topk": [[label, p], ...]}
  POST /features   body: raw image bytes             -> {"cls_token": [...], "grid": [h, w]}
  POST /pca        body: raw image bytes             -> PNG bytes (the uint8 PCA
                   visualization, the reference feature mode's product, over HTTP)
  GET  /healthz                                      -> {"ok": true, "model": {...}}

Batching: requests arriving within `max_wait_ms` (or until `max_batch`) run
as one forward. Handler threads read and decode on the host and never touch
a device tensor; every engine call runs on the batcher thread alone. On a
CUDA device that matters twice: the kernel wrappers launch on the calling
thread's current stream, and a first call may build a kernel library.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import numpy as np


def sniff_image_dims(data: bytes) -> tuple[int, int] | None:
    """(width, height) from the container header bytes of PNG / JPEG / GIF /
    BMP / WebP payloads, WITHOUT decoding. None for unknown containers.

    This is the pre-decode resolution cap: cv2.imdecode allocates the full
    w*h*3 frame (even with IMREAD_REDUCED_* for PNG — measured ~1 GB peak on
    a 0.8 MB 16000^2 PNG), so a small decompression bomb would bypass a
    post-decode check. Lying headers are impossible for these formats — the
    decoder reads the same fields."""
    n = len(data)
    if n >= 24 and data[:8] == b"\x89PNG\r\n\x1a\n":
        return (
            int.from_bytes(data[16:20], "big"),
            int.from_bytes(data[20:24], "big"),
        )
    if n >= 4 and data[:2] == b"\xff\xd8":  # JPEG: walk segments to a SOF
        i = 2
        while i + 1 < n:
            if data[i] != 0xFF:
                return None
            # ISO 10918-1 B.1.1.2: any number of 0xFF fill bytes may precede
            # the marker code and decoders skip them — a bomb with one fill
            # byte would otherwise sail past this sniff straight to imdecode
            while i < n and data[i] == 0xFF:
                i += 1
            if i >= n:
                return None
            marker = data[i]
            if marker == 0xD8 or 0xD0 <= marker <= 0xD7 or marker == 0x01:
                i += 1
                continue
            if i + 2 >= n:
                return None
            seg_len = int.from_bytes(data[i + 1 : i + 3], "big")
            if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
                if i + 8 > n:
                    return None
                return (
                    int.from_bytes(data[i + 6 : i + 8], "big"),
                    int.from_bytes(data[i + 4 : i + 6], "big"),
                )
            i += 1 + seg_len
        return None
    if n >= 10 and data[:6] in (b"GIF87a", b"GIF89a"):
        return (
            int.from_bytes(data[6:8], "little"),
            int.from_bytes(data[8:10], "little"),
        )
    if n >= 26 and data[:2] == b"BM":
        dib = int.from_bytes(data[14:18], "little")
        if dib == 12:  # OS/2 BITMAPCOREHEADER: u16 width/height at 18/20
            return (
                int.from_bytes(data[18:20], "little"),
                int.from_bytes(data[20:22], "little"),
            )
        return (
            abs(int.from_bytes(data[18:22], "little", signed=True)),
            abs(int.from_bytes(data[22:26], "little", signed=True)),
        )
    if n >= 30 and data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        chunk = data[12:16]
        if chunk == b"VP8X":
            return (
                int.from_bytes(data[24:27], "little") + 1,
                int.from_bytes(data[27:30], "little") + 1,
            )
        if chunk == b"VP8 ":
            return (
                int.from_bytes(data[26:28], "little") & 0x3FFF,
                int.from_bytes(data[28:30], "little") & 0x3FFF,
            )
        if chunk == b"VP8L" and data[20] == 0x2F:
            bits = int.from_bytes(data[21:25], "little")
            return ((bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1)
    return None


class _HTTPServer(ThreadingHTTPServer):
    # socketserver listens with a backlog of 5: a burst of concurrent clients
    # (64 in flight) overflows it, and the connections the kernel cannot queue
    # are reset before any handler runs. The kernel caps this at somaxconn.
    request_queue_size = 1024


@dataclass
class _Pending:
    image: np.ndarray
    mode: str  # "classify" | "features"
    event: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: str | None = None
    t_enq: float = 0.0  # perf_counter at enqueue, for request-latency stats


class BatchingServer:
    def __init__(
        self,
        engine,
        host: str = "127.0.0.1",
        port: int = 8000,
        max_batch: int = 32,
        max_wait_ms: float = 5.0,
        topk: int = 5,
        request_timeout_s: float = 600.0,
        max_body_mb: float = 32.0,
        max_side: int = 4096,
        read_timeout_s: float = 30.0,
    ):
        self.engine = engine
        self.topk = topk
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.request_timeout_s = request_timeout_s
        # Request caps: an unbounded body is a memory-DoS, and an unbounded
        # image resolution holds the device: the token count T grows with
        # the pixels, attention's time and memory with T squared (a 100-MP
        # PNG would hold the card for minutes or exhaust its memory).
        # 413/400 instead, with the limit in the message.
        self.max_body_bytes = int(max_body_mb * 1024 * 1024)
        self.max_side = max_side
        self.read_timeout_s = read_timeout_s
        self._queue: queue.Queue[_Pending] = queue.Queue()
        self._stop = threading.Event()
        self._batcher = threading.Thread(target=self._batch_loop, daemon=True)
        self.stats = {"requests": 0, "batches": 0, "images": 0}
        # requests is bumped from concurrent handler threads; dict-int += is
        # not atomic under the GIL (read/add/store), so guard it
        self._stats_lock = threading.Lock()
        # enqueue->completion wall time of the last 1024 successful requests
        # (deque.append is atomic under the GIL; readers snapshot)
        import collections

        self._latencies: collections.deque[float] = collections.deque(maxlen=1024)

        server = self

        class Handler(BaseHTTPRequestHandler):
            # per-recv socket timeout: a fully stalled read raises
            # socket.timeout, which handle_one_request turns into a close.
            # This alone does NOT bound a drip-feeding client (1 byte per
            # 29 s keeps every recv inside the window) — _read_body below
            # adds the whole-request deadline for that.
            timeout = read_timeout_s

            def _read_body(self, length: int) -> bytes | None:
                """Read the declared body under a WHOLE-REQUEST deadline of
                read_timeout_s: without it, a slowloris client dripping one
                byte per almost-timeout pins this handler thread (one per
                connection under ThreadingHTTPServer) for length*timeout
                seconds. None = deadline exceeded."""
                deadline = time.monotonic() + server.read_timeout_s
                chunks, remaining = [], length
                while remaining > 0:
                    if time.monotonic() >= deadline:
                        return None
                    # read1 = at most ONE underlying recv, so the deadline is
                    # re-checked after every packet; plain read(n) blocks
                    # until n bytes arrive and a drip-feed never returns
                    chunk = self.rfile.read1(min(65536, remaining))
                    if not chunk:  # client closed early; let decode fail it
                        break
                    chunks.append(chunk)
                    remaining -= len(chunk)
                return b"".join(chunks)

            def log_message(self, *args):  # quiet
                pass

            def _reply(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    cfg = server.engine.config
                    self._reply(
                        200,
                        {
                            "ok": True,
                            "model": {
                                "hidden_size": cfg.hidden_size,
                                "layers": cfg.num_hidden_layers,
                                "registers": cfg.num_register_tokens,
                            },
                            "stats": server.stats,
                            "latency_ms": server.latency_stats(),
                        },
                    )
                else:
                    self._reply(404, {"error": "not found"})

            def _reply_png(self, data: bytes):
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_POST(self):
                mode = {
                    "/classify": "classify",
                    "/features": "features",
                    "/pca": "pca",
                }.get(self.path)
                if mode is None:
                    self._reply(404, {"error": "not found"})
                    return
                with server._stats_lock:
                    server.stats["requests"] += 1
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    self.close_connection = True
                    self._reply(400, {"error": "invalid Content-Length"})
                    return
                if length < 0:
                    # rfile.read(-N) would block until client EOF — a handler
                    # thread hang, not a parse error
                    self.close_connection = True
                    self._reply(400, {"error": "invalid Content-Length"})
                    return
                if length > server.max_body_bytes:
                    self.close_connection = True  # don't drain the huge body
                    self._reply(413, {
                        "error": f"body {length} bytes exceeds the "
                        f"{server.max_body_bytes}-byte limit"
                    })
                    return
                data = self._read_body(length)
                if data is None:
                    self.close_connection = True
                    self._reply(408, {"error": "request body read timed out"})
                    return
                dims = sniff_image_dims(data)
                if dims is None:
                    # Containers the sniffer can't size (TIFF, PNM, ...) must
                    # not reach imdecode: a small P4 PBM body can declare a
                    # huge canvas and allocate the full frame before the
                    # post-decode check — the exact DoS the sniff exists for.
                    self._reply(400, {
                        "error": "unsupported or unrecognized image container "
                        "(send PNG, JPEG, GIF, BMP, or WebP)"
                    })
                    return
                if max(dims) > server.max_side:
                    # pre-decode: cv2.imdecode would allocate the full frame
                    self._reply(400, {
                        "error": f"image {dims[0]}x{dims[1]} exceeds the "
                        f"{server.max_side}px side limit (the device's time and "
                        f"memory grow with the image's tokens)"
                    })
                    return
                try:
                    import cv2

                    buf = np.frombuffer(data, dtype=np.uint8)
                    img = cv2.imdecode(buf, cv2.IMREAD_COLOR)
                    if img is None:
                        raise ValueError("image decode failed")
                    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
                except Exception as e:  # noqa: BLE001
                    self._reply(400, {"error": str(e)})
                    return
                if max(img.shape[0], img.shape[1]) > server.max_side:
                    self._reply(400, {
                        "error": f"image {img.shape[1]}x{img.shape[0]} exceeds "
                        f"the {server.max_side}px side limit (the device's time "
                        f"and memory grow with the image's tokens)"
                    })
                    return
                if server._stop.is_set():
                    # stop() has drained the queue; enqueueing now would wait
                    # on an event nothing will ever set
                    self._reply(503, {"error": "server stopped"})
                    return
                pending = _Pending(image=img, mode=mode, t_enq=time.perf_counter())
                server._queue.put(pending)
                # wait in 1 s slices so a stop() racing past the enqueue (its
                # drain ran before our put landed) fails this request within
                # ~1 s instead of the full request_timeout_s
                deadline = time.monotonic() + server.request_timeout_s
                while not pending.event.is_set():
                    if pending.event.wait(timeout=min(1.0, max(0.0, deadline - time.monotonic()))):
                        break
                    if server._stop.is_set() and pending.error is None:
                        pending.error = "server stopped"
                        break
                    if time.monotonic() >= deadline:
                        break
                if not pending.event.is_set() and pending.error is None:
                    # Batcher thread dead/wedged — never reply 200 with null.
                    self._reply(504, {"error": "inference timed out"})
                elif pending.error is not None:
                    # `is not None`, not truthiness: an exception whose str()
                    # is empty must still be a 500, never a 200 with null
                    self._reply(500, {"error": pending.error or "inference failed"})
                else:
                    server._latencies.append(time.perf_counter() - pending.t_enq)
                    if isinstance(pending.result, bytes):
                        self._reply_png(pending.result)
                    else:
                        self._reply(200, pending.result)

        self._http = _HTTPServer((host, port), Handler)
        self.port = self._http.server_address[1]

    # ------------------------------------------------------------------
    def latency_stats(self) -> dict[str, float] | None:
        """p50/p90/p99/max over the last <=1024 request latencies, in ms.
        None until the first request completes (healthz before any traffic)."""
        snap = sorted(self._latencies)
        if not snap:
            return None
        pick = lambda q: snap[min(len(snap) - 1, int(q * len(snap)))]  # noqa: E731
        return {
            "count": len(snap),
            "p50": round(pick(0.50) * 1e3, 2),
            "p90": round(pick(0.90) * 1e3, 2),
            "p99": round(pick(0.99) * 1e3, 2),
            "max": round(snap[-1] * 1e3, 2),
        }

    # ------------------------------------------------------------------
    def _batch_loop(self):
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.perf_counter() + self.max_wait_ms / 1e3
            while len(batch) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            self._run_batch(batch)

    def _run_batch(self, batch: list[_Pending]):
        self.stats["batches"] += 1
        self.stats["images"] += len(batch)
        by_mode: dict[str, list[_Pending]] = {}
        for p in batch:
            by_mode.setdefault(p.mode, []).append(p)
        for mode, items in by_mode.items():
            try:
                if mode == "classify":
                    results = self.engine.classify(
                        [p.image for p in items], topk=self.topk
                    )
                    for p, r in zip(items, results):
                        p.result = {"topk": [[label, prob] for label, prob in r]}
                elif mode == "pca":
                    # the engine runs one preprocess + forward + batched PCA
                    # per image size
                    import cv2

                    for p, vis in zip(
                        items, self.engine.pca_visualizations([p.image for p in items])
                    ):
                        ok, png = cv2.imencode(".png", cv2.cvtColor(vis, cv2.COLOR_RGB2BGR))
                        if not ok:
                            raise ValueError("png encode failed")
                        p.result = png.tobytes()
                else:
                    # one batched forward per (H, W) group: mixed sizes cannot
                    # share one (the patch grid depends on the size), but
                    # same-size concurrent requests coalesce
                    feats = self.engine.extract_features_mixed(
                        [p.image for p in items]
                    )
                    for p, f in zip(items, feats):
                        p.result = {
                            "cls_token": f["cls_token"].tolist(),
                            "grid": list(f["grid"]),
                        }
            except Exception as e:  # noqa: BLE001
                for p in items:
                    p.error = str(e)
            finally:
                for p in items:
                    p.event.set()

    # ------------------------------------------------------------------
    def start(self):
        self._batcher.start()
        threading.Thread(target=self._http.serve_forever, daemon=True).start()

    def stop(self):
        self._stop.set()
        self._http.shutdown()
        self._http.server_close()  # release the bound listening socket
        # fail any requests still queued: their events would otherwise never
        # be set, leaving handler threads (and clients) blocked for the full
        # request_timeout_s before a 504
        while True:
            try:
                pending = self._queue.get_nowait()
            except queue.Empty:
                break
            pending.error = "server stopped"
            pending.event.set()

    def serve_forever(self):
        self._batcher.start()
        self._http.serve_forever()
