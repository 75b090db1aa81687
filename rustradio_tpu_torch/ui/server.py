"""HTTP server for the live spectrum/waterfall dashboard (port of
``rustradio_tpu/ui/server.py``; the HTTP handler is a stdlib copy).

Stdlib-only (http.server); frames are produced by a background feed thread
running the batched spectrogram (utils/waterfall.py) on the feed's device,
the rows coming back to the host once per chunk, and polled
by the page with incremental ``/api/frames?since=`` requests — the same
snoop-a-stream model as the reference's UI worker protocol
(rustradio-ui/src/lib.rs:44-62, doc/ui.md "stream snooping").
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from .._device import target_device
from ..ops.fft import as_stream

_HTML_PATH = os.path.join(os.path.dirname(__file__), "index.html")


class SpectrumFeed(threading.Thread):
    """Pulls IQ chunks from an iterator, keeps a ring of dB spectrum rows.

    A chunk is a complex tensor or numpy array; it goes through
    ``utils.waterfall.spectrogram`` on ``device`` (the card by default;
    ``device="cpu"`` runs there), and its rows come back to the host in one
    copy.  A failure ends the feed: its traceback is printed and the
    exception kept in ``error``."""

    def __init__(
        self,
        chunks,
        samp_rate: float,
        fft_size: int = 512,
        center_freq: float = 0.0,
        fps: float = 20.0,
        history: int = 512,
        realtime: bool = True,
        stats_fn=None,
        device="cuda",
    ):
        super().__init__(daemon=True)
        self.device = target_device(device, "SpectrumFeed")
        self.error: BaseException | None = None
        self.chunks = chunks
        self.samp_rate = float(samp_rate)
        self.fft_size = int(fft_size)
        self.center_freq = float(center_freq)
        self.fps = float(fps)
        self.realtime = realtime
        self.stats_fn = stats_fn
        self.rows: collections.deque = collections.deque(maxlen=history)
        self.seq = 0  # sequence number of the NEXT row to be appended
        self.lock = threading.Lock()
        self.done = False
        # Running dB scale for quantization: a slow-release envelope so the
        # color mapping is stable across poll batches (per-batch min/max
        # would stretch quiet noise to full scale).
        self.lo = None
        self.hi = None

    def run(self):
        from ..utils.waterfall import spectrogram

        try:
            # One spectrum row per 1/fps seconds of signal.
            hop = max(int(self.samp_rate / self.fps), self.fft_size)
            for chunk in self.chunks:
                t0 = time.time()
                x = as_stream(chunk, self.device, "SpectrumFeed")
                db = spectrogram(x, self.fft_size, hop).cpu().numpy()
                with self.lock:
                    for row in db:
                        self.rows.append(row.astype(np.float32))
                        self.seq += 1
                    if len(db):
                        blo = float(np.percentile(db, 5))
                        bhi = float(db.max())
                        if self.lo is None:
                            self.lo, self.hi = blo, bhi
                        else:  # fast attack, slow release
                            self.lo = min(blo, 0.98 * self.lo + 0.02 * blo)
                            self.hi = max(bhi, 0.98 * self.hi + 0.02 * bhi)
                if self.realtime:
                    budget = x.shape[0] / self.samp_rate
                    delay = budget - (time.time() - t0)
                    if delay > 0:
                        time.sleep(delay)
        except Exception as e:  # surface feed failures instead of dying silently
            import traceback

            traceback.print_exc()
            self.error = e
        finally:
            self.done = True

    def frames_since(self, since: int, limit: int = 256):
        with self.lock:
            first = self.seq - len(self.rows)
            start = max(since, first)
            out = [self.rows[i - first] for i in range(start, min(self.seq, start + limit))]
            # next = what the client has after this batch; when truncated to
            # `limit` the client must resume from start+len, not the tip.
            return start, start + len(out), out


class _Handler(BaseHTTPRequestHandler):
    feed: SpectrumFeed = None  # set by UiServer
    control = None  # optional hw.SdrControl for live retuning

    def log_message(self, *a):  # quiet
        pass

    def _send(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Cache-Control", "no-store")
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        url = urlparse(self.path)
        feed = self.feed
        if url.path in ("/", "/index.html"):
            with open(_HTML_PATH, "rb") as f:
                return self._send(200, f.read(), "text/html; charset=utf-8")
        if url.path == "/api/meta":
            meta = {
                "samp_rate": feed.samp_rate,
                "fft_size": feed.fft_size,
                "center_freq": feed.center_freq,
                "history": feed.rows.maxlen,
                "fps": feed.fps,
                "control": self.control is not None,
            }
            return self._send(200, json.dumps(meta).encode(), "application/json")
        if url.path == "/api/retune":
            # live command channel into the SDR driver (hw.SdrControl):
            # the dashboard's retune form lands here
            if self.control is None:
                return self._send(400, b"no control plane", "text/plain")
            q = parse_qs(url.query)
            applied = {}
            if "frequency" in q:
                f = float(q["frequency"][0])
                self.control.set_frequency(f)
                feed.center_freq = f  # relabel the axis
                applied["frequency"] = f
            if "gain" in q:
                g = float(q["gain"][0])
                self.control.set_gain(g)
                applied["gain"] = g
            if "sample_rate" in q:
                r = float(q["sample_rate"][0])
                self.control.set_sample_rate(r)
                feed.samp_rate = r
                applied["sample_rate"] = r
            return self._send(200, json.dumps(applied).encode(), "application/json")
        if url.path == "/api/frames":
            q = parse_qs(url.query)
            since = int(q.get("since", ["0"])[0])
            start, nxt, rows = feed.frames_since(since)
            lo = feed.lo if feed.lo is not None else 0.0
            hi = feed.hi if feed.hi is not None else 1.0
            span = max(hi - lo, 1e-9)
            # Quantize rows to u8 for compact transport.
            quant = [
                np.clip((r - lo) / span * 255.0, 0, 255).astype(np.uint8).tobytes().hex()
                for r in rows
            ]
            body = {
                "start": start,
                "next": nxt,
                "lo": lo,
                "hi": hi,
                "done": feed.done,
                "rows": quant,
            }
            return self._send(200, json.dumps(body).encode(), "application/json")
        if url.path == "/api/stats":
            text = feed.stats_fn() if feed.stats_fn else ""
            return self._send(200, json.dumps({"text": text}).encode(), "application/json")
        if url.path == "/ws":
            return self._serve_ws(url)
        self._send(404, b"not found", "text/plain")

    def _serve_ws(self, url):
        """Pushed frame stream over a websocket (reference: the browser
        UI consumes a pushed DATA_STREAM over ws, rustradio-ui/src/
        worker/source.rs; here the dashboard's frame batches push the
        same JSON bodies /api/frames serves, so the page stops polling).

        Synchronous send loop — ThreadingHTTPServer gives this
        connection its own thread; the RFC 6455 framing is shared with
        io/websocket.py.
        """
        from ..io.websocket import OP_BINARY, accept_key, encode_frame

        key = self.headers.get("Sec-WebSocket-Key")
        if not key or self.headers.get("Upgrade", "").lower() != "websocket":
            return self._send(400, b"websocket upgrade required", "text/plain")
        self.send_response(101, "Switching Protocols")
        self.send_header("Upgrade", "websocket")
        self.send_header("Connection", "Upgrade")
        self.send_header("Sec-WebSocket-Accept", accept_key(key))
        self.end_headers()
        self.close_connection = True
        feed = self.feed
        q = parse_qs(url.query)
        since = int(q.get("since", ["0"])[0])
        last_stats = 0.0
        try:
            while True:
                start, nxt, rows = feed.frames_since(since)
                if rows:
                    since = nxt
                    lo = feed.lo if feed.lo is not None else 0.0
                    hi = feed.hi if feed.hi is not None else 1.0
                    span = max(hi - lo, 1e-9)
                    quant = [
                        np.clip((r - lo) / span * 255.0, 0, 255)
                        .astype(np.uint8).tobytes().hex()
                        for r in rows
                    ]
                    body = {"start": start, "next": nxt, "lo": lo, "hi": hi,
                            "done": feed.done, "rows": quant}
                    self.wfile.write(encode_frame(json.dumps(body).encode(),
                                                  OP_BINARY))
                now = time.time()
                if feed.stats_fn and now - last_stats > 2.0:
                    last_stats = now
                    self.wfile.write(encode_frame(json.dumps(
                        {"stats": feed.stats_fn()}).encode(), OP_BINARY))
                if feed.done and not rows:
                    break
                if not rows:
                    time.sleep(1.0 / max(feed.fps, 1.0))
        except (ConnectionError, OSError, BrokenPipeError):
            pass  # client went away


class UiServer:
    """Serves the dashboard for one SpectrumFeed."""

    def __init__(self, feed: SpectrumFeed, host: str = "127.0.0.1", port: int = 0,
                 control=None):
        handler = type("Handler", (_Handler,), {"feed": feed, "control": control})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.feed = feed
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)

    @property
    def address(self) -> str:
        h, p = self.httpd.server_address[:2]
        return f"http://{h}:{p}"

    def start(self):
        if not self.feed.is_alive():
            self.feed.start()
        self.thread.start()
        return self

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
