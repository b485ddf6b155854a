"""REST API server (counterpart of ``alphazero_tpu/api_server.py``, the
same routes and JSON): a session-based JSON API over the standard library's
``http.server``.

Endpoints:
  POST /api/games                {game, board_size, simulations?} -> {id, ...}
  GET  /api/games/<id>           game state
  POST /api/games/<id>/move      {action} -> state
  POST /api/games/<id>/ai_move   engine move -> state
  DELETE /api/games/<id>         close session
  GET  /api/model                engine/model info
  GET  /                         browser GUI (webui.py)

Chess moves also accept {from, to, promo} click pairs (resolved to the
action encoding server-side, castling by a two-square king click).
Optional API-key auth via --api-key (X-API-Key header).  Each session's
engine runs on ``--device`` (default cuda), with the ``--model`` bundle
where it fits the session's game and the uniform engine otherwise.

Run:  python -m alphazero_tpu_torch.api_server --port 8080 \
          [--model models_zoo/flagship_gomoku15] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from alphazero_tpu_torch import __version__

SESSION_TTL_S = 3600


class SessionStore:
    """The live game sessions, each on ``device``; a thread drops sessions
    idle for ``SESSION_TTL_S`` until ``close``."""

    def __init__(self, model_path=None, simulations=200, device="cuda"):
        self.lock = threading.Lock()
        self.sessions = {}
        self.model_path = model_path
        self.simulations = simulations
        self.device = device
        self._closed = threading.Event()
        self._cleaner = threading.Thread(target=self._cleanup_loop,
                                         daemon=True)
        self._cleaner.start()

    def close(self):
        self._closed.set()
        self._cleaner.join()

    def _cleanup_loop(self):
        while not self._closed.wait(60):
            now = time.time()
            with self.lock:
                dead = [
                    sid for sid, (sess, ts) in self.sessions.items()
                    if now - ts > SESSION_TTL_S
                ]
                for sid in dead:
                    del self.sessions[sid]

    def _model_for(self, game, board_size):
        """The bundle for a session of ``game``: the server's, where its
        action count fits the game, else None (the uniform engine).  (The
        JAX server loads the bundle into every session, and the engine's
        first move in a game it does not fit fails.)"""
        if not self.model_path:
            return None
        from alphazero_tpu_torch.core import registry

        with open(self.model_path + ".json") as f:
            num_actions = json.load(f)["num_actions"]
        fits = registry.create_game(game, board_size).num_actions == num_actions
        return self.model_path if fits else None

    def create(self, game, board_size, simulations=None, **variant):
        from alphazero_tpu_torch.cli import GameSession

        sess = GameSession(
            game=game, board_size=board_size,
            model_path=self._model_for(game, board_size),
            simulations=simulations or self.simulations, device=self.device,
            **variant,
        )
        sid = uuid.uuid4().hex[:12]
        with self.lock:
            self.sessions[sid] = (sess, time.time())
        return sid, sess

    def get(self, sid):
        with self.lock:
            entry = self.sessions.get(sid)
            if entry:
                self.sessions[sid] = (entry[0], time.time())
                return entry[0]
        return None

    def delete(self, sid):
        with self.lock:
            return self.sessions.pop(sid, None) is not None


def state_payload(sid, sess):
    info = sess.info()
    return {
        "id": sid,
        **info,
        "board": sess.show(),
        "cells": sess.cells(),
        "legal_actions": [int(a) for a in sess.legal_actions()],
    }


def make_handler(store: SessionStore, api_key=None):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _auth_ok(self):
            return api_key is None or (
                self.headers.get("X-API-Key") == api_key
            )

        def _send(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self):
            n = int(self.headers.get("Content-Length") or 0)
            if not n:
                return {}
            return json.loads(self.rfile.read(n) or b"{}")

        def do_GET(self):
            import urllib.parse

            path = urllib.parse.urlsplit(self.path).path
            # The GUI page is served before the auth check: it contains no
            # secrets, and the page itself carries a key field whose value
            # is attached to its API calls as X-API-Key.
            if path in ("/", "/ui", "/index.html"):
                from alphazero_tpu_torch.webui import PAGE

                body = PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return None
            if not self._auth_ok():
                return self._send(401, {"error": "unauthorized"})
            parts = path.strip("/").split("/")
            if parts[:2] == ["api", "model"]:
                return self._send(200, {
                    "engine": "alphazero_tpu",
                    "version": __version__,
                    "model": store.model_path or "uniform-random",
                    "simulations": store.simulations,
                })
            if len(parts) == 3 and parts[:2] == ["api", "games"]:
                sess = store.get(parts[2])
                if not sess:
                    return self._send(404, {"error": "no such game"})
                return self._send(200, state_payload(parts[2], sess))
            return self._send(404, {"error": "not found"})

        def do_POST(self):
            import urllib.parse

            if not self._auth_ok():
                return self._send(401, {"error": "unauthorized"})
            parts = urllib.parse.urlsplit(self.path).path.strip("/").split("/")
            try:
                body = self._body()
            except (ValueError, json.JSONDecodeError):
                return self._send(400, {"error": "bad json"})
            if parts == ["api", "games"]:
                game = body.get("game", "gomoku")
                if game not in ("gomoku", "go", "chess"):
                    return self._send(400, {"error": f"bad game {game}"})
                sid, sess = store.create(
                    game,
                    int(body.get("board_size",
                                 15 if game == "gomoku"
                                 else 9 if game == "go" else 8)),
                    body.get("simulations"),
                )
                return self._send(201, state_payload(sid, sess))
            if len(parts) == 4 and parts[:2] == ["api", "games"]:
                sess = store.get(parts[2])
                if not sess:
                    return self._send(404, {"error": "no such game"})
                if parts[3] == "move":
                    action = body.get("action")
                    if action is None and "from" in body and "to" in body:
                        # chess GUI click pair -> action index.  Chess only:
                        # for gomoku/go the chess encoding could alias onto
                        # an in-range legal board action and silently play a
                        # move the client never intended.
                        if sess.game != "chess":
                            return self._send(
                                400, {"error": "from/to moves are chess-only"}
                            )
                        action = sess.move_from_squares(
                            body["from"], body["to"], body.get("promo"))
                    if action is None or not sess.play(int(action)):
                        return self._send(400, {"error": "illegal move"})
                    return self._send(200, state_payload(parts[2], sess))
                if parts[3] == "ai_move":
                    action, info = sess.ai_move()
                    payload = state_payload(parts[2], sess)
                    payload["ai"] = {"action": int(action), **info}
                    return self._send(200, payload)
            return self._send(404, {"error": "not found"})

        def do_DELETE(self):
            import urllib.parse

            if not self._auth_ok():
                return self._send(401, {"error": "unauthorized"})
            parts = urllib.parse.urlsplit(self.path).path.strip("/").split("/")
            if len(parts) == 3 and parts[:2] == ["api", "games"]:
                if store.delete(parts[2]):
                    return self._send(200, {"ok": True})
                return self._send(404, {"error": "no such game"})
            return self._send(404, {"error": "not found"})

    return Handler


def serve(host="127.0.0.1", port=8080, model=None, simulations=200,
          api_key=None, device="cuda"):
    """The server (not yet serving); ``server.store`` is its
    ``SessionStore``, to ``close`` after ``server.shutdown()``."""
    store = SessionStore(model, simulations, device)
    server = ThreadingHTTPServer((host, port), make_handler(store, api_key))
    server.store = store
    return server


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--model", default=None)
    p.add_argument("--simulations", type=int, default=200)
    p.add_argument("--api-key", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)
    server = serve(args.host, args.port, args.model, args.simulations,
                   args.api_key, args.device)
    print(f"alphazero_tpu_torch API on http://{args.host}:{args.port}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        server.store.close()


if __name__ == "__main__":
    main()
