"""Web GUI server on the port's ModelInterface, as in
speaker_recognition_tpu/gui/server.py.

The reference GUI (src/gui/gui.py:45-474) is a desktop Qt application:
record background noise, enroll speakers by microphone or file, train,
recognize single or batch utterances, and a streaming "conversation mode"
that classifies the last 1.5 s of audio every 0.4 s and paints a timeline
(gui.py:165-213, BurningWidget gui.py:489-667). The JAX package re-hosts
that surface as a single-page web app (the browser supplies the microphone
and the timeline canvas; this stdlib-only HTTP server holds the session),
and this is the port's copy: the same endpoints and the same JSON, with
the session on a torch device (`device`, "cuda" unless the caller asks
for the CPU).

    python -m speaker_recognition_tpu_torch.gui [--device cuda|cpu]

Endpoints (all JSON unless noted):
  GET  /                    single-page app
  GET  /api/status          session state: speakers, trained, noise, users
  POST /api/noise           wav bytes -> VAD noise calibration (gui.py:426-442)
  POST /api/enroll?name=N   wav bytes -> filter + enroll (gui.py:294-306)
  POST /api/train           fit all enrolled speakers (gui.py:308-311)
  POST /api/predict         wav bytes -> {"label": ...} (gui.py:250-267);
                            ?filter=1 applies VAD first like reco_files
  POST /api/conv/start      reset conversation session (gui.py:165-173)
  POST /api/conv/feed       raw int16 PCM chunk -> new timeline events
  POST /api/conv/stop
  GET  /api/conv/timeline   full (time, label) event list
  POST /api/dump            {"path": ...} save session (gui.py:406-414)
  POST /api/load            {"path": ...} load session (gui.py:416-424)
  GET/POST /api/users       user metadata, the avatar/metainfo.txt analogue
                            (gui.py:329-390): [{name, age, sex}, ...]
"""

from __future__ import annotations

import io
import json
import os
import threading
import urllib.parse
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

__all__ = ["GuiApp", "make_server", "main"]

STATIC_DIR = os.path.join(os.path.dirname(__file__), "static")
FS = 8000  # gui.py Main.FS


def decode_wav(data: bytes):
    """PCM wav bytes -> (fs, mono float array). Stdlib `wave` handles the
    browser-encoded 16-bit files; channels are averaged like
    utils.monophonic."""
    with wave.open(io.BytesIO(data)) as w:
        fs = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        raw = w.readframes(n)
        dtype = {1: np.uint8, 2: np.int16, 4: np.int32}.get(width)
        if dtype is None:
            raise ValueError(f"unsupported sample width {width}")
        sig = np.frombuffer(raw, dtype=dtype).astype(np.float64)
        if width == 1:
            sig = sig - 128.0
        ch = w.getnchannels()
        if ch > 1:
            sig = sig.reshape(-1, ch).mean(axis=1)
    return fs, sig


class GuiApp:
    """Session state + operations; one lock serializes model mutations."""

    def __init__(self, model=None, users_file: str | None = None,
                 device="cuda"):
        from ..api.interface import ModelInterface
        self.device = device
        self.model = model or ModelInterface(device=device)
        self.lock = threading.Lock()
        self.noise_initialized = False
        self.trained = False
        self.conv = None
        self.users_file = users_file
        self.users: list[dict] = []
        if users_file and os.path.exists(users_file):
            with open(users_file) as f:
                self.users = json.load(f)

    # -- operations (each returns a JSON-able dict or raises ValueError) ----

    def status(self):
        # union of pending enrollments and the trained bank's labels (a
        # loaded session has an empty feature pool but a full bank)
        labels = set(self.model.features) | set(self.model.gmmset.y)
        return {
            "speakers": sorted(labels),
            "trained": self.trained,
            "noise_initialized": self.noise_initialized,
            "users": self.users,
            "fs": FS,
        }

    def init_noise(self, fs, signal):
        self.model.init_noise(fs, signal)
        self.noise_initialized = True
        return {"seconds": len(signal) / fs}

    def enroll(self, name, fs, signal):
        if not name:
            raise ValueError("Please Input Your Name")  # gui.py:296-298
        if self.noise_initialized:
            filtered = self.model.filter(fs, signal)
        else:
            filtered = signal
        if len(filtered) == 0:  # gui.py:303-305
            raise ValueError("Input is silent! Please enroll again")
        self.model.enroll(name, fs, filtered)
        return {"name": name, "kept": int(len(filtered)),
                "original": int(len(signal))}

    def train(self):
        if not self.model.features:
            raise ValueError("No speaker enrolled")
        self.model.train()
        self.trained = True
        return {"speakers": sorted(self.model.features.keys())}

    def predict(self, fs, signal, apply_filter=False):
        if not self.trained:
            raise ValueError("Not trained")
        if apply_filter:
            if not self.noise_initialized:
                raise ValueError("Noise not initialized")
            signal = self.model.filter(fs, signal)
            if len(signal) == 0:
                return {"label": "Nobody"}
        label = self.model.predict(fs, signal)
        return {"label": label if label else "Nobody"}

    def conv_start(self, fs):
        from ..api.conversation import ConversationSession
        if not self.trained:
            raise ValueError("Not trained")
        if not self.noise_initialized:
            raise ValueError("Noise not initialized")
        self.conv = ConversationSession(self.model, fs)
        return {"interval": self.conv.CONV_INTERVAL,
                "duration": self.conv.CONV_DURATION}

    def conv_feed(self, samples):
        if self.conv is None:
            raise ValueError("Conversation not started")
        events = self.conv.feed(samples)
        shown = self.conv._last_shown
        return {"events": [{"time": t, "label": l} for t, l in events],
                "label": shown if shown else "Nobody",
                "ticks": len(self.conv.result_list)}

    def conv_stop(self):
        timeline = self.conv.timeline if self.conv else []
        self.conv = None
        return {"timeline": [{"time": t, "label": l} for t, l in timeline]}

    def conv_timeline(self):
        if self.conv is None:
            return {"timeline": []}
        return {"timeline": [{"time": t, "label": l}
                             for t, l in self.conv.timeline]}

    def dump(self, path):
        if not self.trained:
            raise ValueError("Not trained")
        self.model.dump(path)
        return {"path": path}

    def load(self, path):
        from ..api.interface import ModelInterface
        self.model = ModelInterface.load(path, device=self.device)
        self.trained = self.model.gmmset.bank is not None
        self.noise_initialized = self.model.vad.noise_amp is not None
        return self.status()

    def set_users(self, users):
        for u in users:
            if not isinstance(u, dict) or "name" not in u:
                raise ValueError("each user needs at least a name")
        self.users = users
        if self.users_file:
            with open(self.users_file, "w") as f:
                json.dump(self.users, f)
        return {"users": self.users}


def _make_handler(app: GuiApp):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        # -- plumbing --------------------------------------------------------
        def _send(self, code, body: bytes, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code=200):
            self._send(code, json.dumps(obj).encode())

        def _error(self, msg, code=400):
            self._json({"error": str(msg)}, code)

        def _body(self) -> bytes:
            n = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(n) if n else b""

        def _route(self):
            parsed = urllib.parse.urlparse(self.path)
            return parsed.path, dict(urllib.parse.parse_qsl(parsed.query))

        # -- GET -----------------------------------------------------------
        def do_GET(self):
            path, _ = self._route()
            if path in ("/", "/index.html"):
                with open(os.path.join(STATIC_DIR, "index.html"), "rb") as f:
                    self._send(200, f.read(), "text/html; charset=utf-8")
            elif path == "/api/status":
                with app.lock:
                    self._json(app.status())
            elif path == "/api/conv/timeline":
                with app.lock:
                    self._json(app.conv_timeline())
            elif path == "/api/users":
                self._json({"users": app.users})
            else:
                self._error("not found", 404)

        # -- POST ----------------------------------------------------------
        def do_POST(self):
            path, q = self._route()
            body = self._body()
            try:
                with app.lock:
                    self._json(self._dispatch(path, q, body))
            except ValueError as e:
                self._error(e)
            except Exception as e:  # surface, don't kill the server thread
                self._error(f"{type(e).__name__}: {e}", 500)

        def _dispatch(self, path, q, body):
            if path == "/api/noise":
                return app.init_noise(*decode_wav(body))
            if path == "/api/enroll":
                return app.enroll(q.get("name", "").strip(), *decode_wav(body))
            if path == "/api/train":
                return app.train()
            if path == "/api/predict":
                fs, sig = decode_wav(body)
                return app.predict(fs, sig,
                                   apply_filter=q.get("filter") == "1")
            if path == "/api/conv/start":
                return app.conv_start(int(q.get("fs", FS)))
            if path == "/api/conv/feed":
                samples = np.frombuffer(body, dtype="<i2").astype(np.float64)
                return app.conv_feed(samples)
            if path == "/api/conv/stop":
                return app.conv_stop()
            if path == "/api/dump":
                return app.dump(json.loads(body)["path"])
            if path == "/api/load":
                return app.load(json.loads(body)["path"])
            if path == "/api/users":
                return app.set_users(json.loads(body).get("users", []))
            raise ValueError(f"unknown endpoint {path}")

    return Handler


def make_server(host="127.0.0.1", port=0, app: GuiApp | None = None):
    """-> (ThreadingHTTPServer, GuiApp); port 0 picks a free port."""
    app = app or GuiApp()
    server = ThreadingHTTPServer((host, port), _make_handler(app))
    return server, app


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description="Speaker-recognition web GUI")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8950)
    p.add_argument("--model", help="session artifact (.npz) to preload")
    p.add_argument("--users-file",
                   help="user-metadata json (metainfo.txt analogue)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the session (default: cuda)")
    args = p.parse_args(argv)
    app = GuiApp(users_file=args.users_file, device=args.device)
    if args.model:
        app.load(args.model)
    server, _ = make_server(args.host, args.port, app)
    print(f"speaker-recognition GUI on "
          f"http://{args.host}:{server.server_address[1]}/")
    server.serve_forever()


if __name__ == "__main__":
    main()
