"""HTTP server for the streaming spectrogram app.

The counterpart of ``kofft_tpu.web.server``, computing on ``device``
(default the card). Python analog of the reference's axum server
(``web-spectrogram/src/main.rs:11-33``): static file serving with index
fallback (SPA), permissive CORS, ``/health`` -> 200, plus JSON compute
endpoints replacing the WASM exports (``web-spectrogram/src/lib.rs:
70-252``):

  POST /api/compute_frame   {"samples": [...]} -> {"row": [r,g,b,a, ...]}
  POST /api/stft            {"samples": [...], "win_len": n, "hop": h}
                            -> {"mags": [[...]], "max_mag": m}
  POST /api/set_colormap    {"name": "viridis"}
  POST /api/reset
"""

from __future__ import annotations

import json
import threading
from http import HTTPStatus
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np

from ..visual.spectrogram import stft_magnitudes
from .state import StreamingSpectrogram

_STATIC = Path(__file__).parent / "static"
_MIME = {".html": "text/html", ".js": "text/javascript",
         ".mjs": "text/javascript", ".css": "text/css",
         ".json": "application/json", ".png": "image/png",
         ".svg": "image/svg+xml", ".webmanifest": "application/manifest+json"}


def app_routes():
    """Route table (path -> handler name) for introspection/tests."""
    return {"/health": "health", "/api/compute_frame": "compute_frame",
            "/api/stft": "stft", "/api/set_colormap": "set_colormap",
            "/api/reset": "reset", "/": "static"}


class _Handler(BaseHTTPRequestHandler):
    state: StreamingSpectrogram  # class attr, set by make_server
    static_dir: Path

    def log_message(self, *a):  # quiet
        pass

    def _cors(self):
        self.send_header("Access-Control-Allow-Origin", "*")
        self.send_header("Access-Control-Allow-Headers", "*")
        self.send_header("Access-Control-Allow-Methods", "*")

    def _send(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self._cors()
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj, code: int = 200):
        self._send(code, json.dumps(obj).encode(), "application/json")

    def do_OPTIONS(self):
        self._send(HTTPStatus.NO_CONTENT, b"", "text/plain")

    def do_GET(self):
        from urllib.parse import unquote, urlsplit
        path = unquote(urlsplit(self.path).path)   # drop ?query, %-decode
        if path == "/health":
            self._send(200, b"", "text/plain")
            return
        # static with SPA fallback (axum ServeDir + index fallback)
        rel = path.lstrip("/") or "index.html"
        f = (self.static_dir / rel).resolve()
        root = self.static_dir.resolve()
        try:
            contained = f == root or f.is_relative_to(root)
        except AttributeError:  # pragma: no cover (py<3.9)
            contained = str(f).startswith(str(root) + "/")
        if not contained or not f.is_file():
            f = self.static_dir / "index.html"
        if f.is_file():
            self._send(200, f.read_bytes(),
                       _MIME.get(f.suffix, "application/octet-stream"))
        else:
            self._send(404, b"not found", "text/plain")

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        try:
            body = json.loads(self.rfile.read(n) or b"{}")
        except json.JSONDecodeError:
            self._json({"error": "invalid json"}, 400)
            return
        if not isinstance(body, dict):
            self._json({"error": "body must be a JSON object"}, 400)
            return
        if self.path == "/api/compute_frame":
            try:
                row = self.state.compute_frame(body.get("samples", []))
            except Exception as e:
                self._json({"error": str(e)}, 400)
                return
            # chunked path: one launch may complete k frames; "rows"
            # tells the client how many columns the flat RGBA holds
            per = (self.state.win_len // 2) * 4
            self._json({"row": row.tolist(),
                        "rows": int(row.size) // per if per else 0})
        elif self.path == "/api/stft":
            samples = np.asarray(body.get("samples", []), np.float32)
            win = int(body.get("win_len", 1024))
            hop = int(body.get("hop", win // 2))
            try:
                mags, mx = stft_magnitudes(samples, win, hop,
                                           device=self.state.device)
            except Exception as e:
                self._json({"error": str(e)}, 400)
                return
            self._json({"mags": mags.tolist(), "max_mag": mx})
        elif self.path == "/api/set_colormap":
            try:
                self.state.set_colormap(str(body.get("name", "rainbow")))
            except Exception as e:
                self._json({"error": str(e)}, 400)
                return
            self._json({"ok": True})
        elif self.path == "/api/reset":
            self.state.reset()
            self._json({"ok": True})
        else:
            self._json({"error": "unknown endpoint"}, 404)


def make_server(port: int = 3000, static_dir: Path | None = None,
                device="cuda") -> ThreadingHTTPServer:
    """Build the HTTP server (bind 0.0.0.0:port; caller serves_forever),
    computing on ``device``."""
    handler = type("Handler", (_Handler,), {
        "state": StreamingSpectrogram(device=device),
        "static_dir": Path(static_dir) if static_dir else _STATIC,
    })
    return ThreadingHTTPServer(("0.0.0.0", port), handler)


def serve_background(port: int = 0, static_dir: Path | None = None,
                     device="cuda"):
    """Start in a daemon thread; returns (server, actual_port). Stop it
    with ``server.shutdown()`` and ``server.server_close()``."""
    srv = make_server(port, static_dir, device)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, srv.server_address[1]


if __name__ == "__main__":
    import sys
    port = int(sys.argv[1]) if len(sys.argv) > 1 else 3000
    srv = make_server(port)
    print(f"listening on 0.0.0.0:{port}")
    srv.serve_forever()
