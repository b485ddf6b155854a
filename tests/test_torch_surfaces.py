"""The port's interactive surfaces (``alphazero_tpu_torch/utils/render.py``,
``cli.py``, ``webui.py`` and ``api_server.py``) against the JAX package's:
the same rendered boards, the same ``GameSession`` transcripts from a
shared tiny bundle (T 0, no root noise, 4 simulations), the same REST
routes, status codes and JSON from both servers, and the same page."""
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu import cli as jcli
from alphazero_tpu.utils import render as jrender
from alphazero_tpu_torch import cli as tcli
from alphazero_tpu_torch.core import registry
from alphazero_tpu_torch.utils import render as trender
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

KIWIPETE = "r3k2r/p1ppqpb1/bn2pnp1/3PN3/1p2P3/2N2Q1p/PPPBBPPP/R3K2R w KQkq - 0 1"
POS5 = "rnbq1k1r/pp1Pbppp/2p5/8/2B5/8/PPP1NnPP/RNBQK2R w KQ - 1 8"


def _play(game, size, moves):
    """(JAX env and state, port env and state) after ``moves`` (actions, or
    chess (from, to) square pairs)."""
    from alphazero_tpu.core import registry as jregistry
    from alphazero_tpu_torch.games.chess_tables import encode_move

    jenv = jregistry.create_game(game, size)
    env = registry.create_game(game, size)
    js, ts = jenv.init(), env.init(1, device="cpu")
    for a in moves:
        a = encode_move(*a) if isinstance(a, tuple) else a
        js = jenv.step(js, jnp.asarray(a))
        ts = env.step(ts, torch.tensor([a], dtype=torch.int32))
    return jenv, js, env, ts


@pytest.mark.parametrize("game,size,moves", [
    ("gomoku", 9, (40, 41, 0, 80)),
    ("gomoku", 15, ()),
    # Go 5x5: a capture at 11 (prisoners 1/0), then a pass.
    ("go", 5, (7, 12, 11, 6, 13, 17, 3, 16, 25)),
    ("chess", 8, ((12, 28), (52, 36), (6, 21))),  # e4 e5 Nf3
])
def test_render_matches_jax(game, size, moves):
    jenv, js, env, ts = _play(game, size, moves)
    assert trender.render(env, ts) == jrender.render(jenv, js)


def test_render_chess_positions_match_jax():
    from alphazero_tpu.games import chess as jchess
    from alphazero_tpu.games import chess_fen as jfen
    from alphazero_tpu_torch.games import chess, chess_fen

    jenv, env = jchess.ChessEnv(), chess.ChessEnv()
    ts = chess_fen.state_from_fen(env, [KIWIPETE, POS5], device="cpu")
    for lane, fen in enumerate((KIWIPETE, POS5)):
        want = jrender.render_chess(jfen.state_from_fen(jenv, fen))
        assert trender.render_chess(ts, lane) == want
        assert trender.render(env, ts, lane) == want


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """A tiny ResNet bundle (1 x 16) for Gomoku 5x5, written by the JAX
    package: its init with BN statistics and affines and the two
    zero-initialised head kernels drawn from a numpy seed.  (Go and chess
    sessions would add a JAX search compile of 20-30 s each.)"""
    from alphazero_tpu.models import io as jio
    from alphazero_tpu.models.resnet import ResNetConfig

    tmp = tmp_path_factory.mktemp("bundles")
    out = {}
    for game, A, planes in (("gomoku", 25, 11),):
        model, cfg = jio.build_model("resnet", A, dict(num_blocks=1, channels=16))
        variables = model.init(jax.random.key(0), jnp.zeros((1, planes, 5, 5)))
        rng = np.random.RandomState(5)

        def rand(path, x):
            k = jax.tree_util.keystr(path)
            if "var" in k:
                return jnp.asarray(rng.uniform(0.5, 2.0, x.shape), jnp.float32)
            if "mean" in k or "bias" in k or "scale" in k:
                return (jnp.asarray(rng.normal(0, 0.2, x.shape), jnp.float32)
                        + (1.0 if "scale" in k else 0.0))
            if "'Dense_0'" in k and "SEBlock" not in k or "'Dense_2'" in k:
                return jnp.asarray(rng.normal(0, 0.05, x.shape), jnp.float32)
            return x

        path = str(tmp / game)
        jio.save_model(path, jax.tree_util.tree_map_with_path(rand, variables),
                       "resnet", A, ResNetConfig(num_blocks=1, channels=16))
        out[game] = path
    return out


def _transcript(sess):
    """play / ai_move / info / undo / show, as the REPL drives them."""
    out = [sess.show(), sess.play(12), sess.play(12), sess.info()]
    for _ in range(3):
        action, info = sess.ai_move()
        out.append((action, info["visits"], round(info["value"], 2)))
        out.append(sess.info())
    out += [sess.undo(), sess.info(), sess.show(), sess.cells(),
            [int(a) for a in sess.legal_actions()]]
    out.append(sess.ai_move()[0])  # a fresh tree after the undo
    out += [sess.undo(), sess.undo(), sess.undo(), sess.undo(), sess.undo(),
            sess.info()]
    return out


@pytest.mark.parametrize("game", ["gomoku"])
def test_game_session_transcript_matches_jax(game, bundles):
    """T 0, no root noise, 4 simulations (one wave), the search tree carried
    across moves: equal actions, visits, boards and infos; the root value
    to 2 decimals (bf16 nets round apart in the two frameworks)."""
    j = jcli.GameSession(game=game, board_size=5, model_path=bundles[game],
                         simulations=4)
    t = tcli.GameSession(game=game, board_size=5, model_path=bundles[game],
                         simulations=4, device="cpu", seed=0)
    assert _transcript(t) == _transcript(j)


def test_game_session_save_load_and_options(tmp_path):
    """The JAX surface tests' save/load and setoption cases; the saved
    record is the JAX package's schema and reads back in its session."""
    sess = tcli.GameSession(game="gomoku", board_size=5, simulations=4,
                            device="cpu", seed=0)
    for a in (12, 7, 13):
        assert sess.play(a)
    path = str(tmp_path / "game.json")
    sess.save_game(path)
    again = tcli.GameSession(game="gomoku", board_size=5, simulations=4,
                             device="cpu", seed=0)
    assert again.load_game(path) and again.info()["move_count"] == 3
    assert torch.equal(again.state.board, sess.state.board)
    jsess = jcli.GameSession(game="gomoku", board_size=5, simulations=4)
    assert jsess.load_game(path) and jsess.show() == sess.show()
    chess = tcli.GameSession(game="chess", board_size=8, simulations=4, device="cpu")
    assert not chess.load_game(path) and chess.info()["move_count"] == 0
    sess.options["simulations"] = 12
    _, info = sess.ai_move()
    assert info["visits"] == 12


def _api(base, method, path, body=None, key=None):
    headers = {"Content-Type": "application/json"}
    if key:
        headers["X-API-Key"] = key
    req = urllib.request.Request(
        base + path, method=method, headers=headers,
        data=json.dumps(body).encode() if body is not None else None)
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            ctype = resp.headers["Content-Type"]
            raw = resp.read()
            return resp.status, ctype, (json.loads(raw) if "json" in ctype
                                        else raw.decode())
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], json.loads(e.read())


def _session(base, key=None):
    """The requests of ``tests/test_surfaces.py``'s REST, web UI and API
    key cases, in order: (method, path, status, content type, body) with
    each game id replaced by its order of creation and the engine's think
    time dropped; the engine's root values apart; the page."""
    ids, out, values = [], [], []

    def call(method, tpl, body=None, use_key=key):
        path = tpl
        for i, gid in enumerate(ids):
            path = path.replace(f"<{i}>", gid)
        code, ctype, payload = _api(base, method, path, body, use_key)
        if isinstance(payload, dict):
            if "id" in payload and payload["id"] not in ids:
                ids.append(payload["id"])
            if "id" in payload:
                payload["id"] = ids.index(payload["id"])
            if "ai" in payload:
                payload["ai"].pop("time_s")
                values.append(payload["ai"].pop("value"))
        out.append((method, tpl, code, ctype, payload))
        return payload

    call("GET", "/api/model")
    call("POST", "/api/games", {"game": "gomoku", "board_size": 5})
    call("GET", "/api/games/<0>")
    call("POST", "/api/games/<0>/move", {"action": 12})
    call("POST", "/api/games/<0>/move", {"action": 12})
    call("POST", "/api/games/<0>/ai_move", {})
    call("POST", "/api/games/<0>/move", {"from": 0, "to": 1})
    call("DELETE", "/api/games/<0>")
    call("GET", "/api/games/<0>")
    call("DELETE", "/api/games/<0>")
    call("POST", "/api/games", {"game": "checkers"})
    call("POST", "/api/games", {"game": "gomoku", "board_size": 9})
    call("POST", "/api/games", {"game": "chess", "board_size": 8})
    call("POST", "/api/games/<2>/move", {"from": 12, "to": 28})
    call("POST", "/api/games/<2>/move", {"from": 12, "to": 28})
    call("POST", "/api/games/<2>/move", {"from": 52, "to": 36, "promo": "n"})
    call("GET", "/api/nowhere")
    call("POST", "/api/games/<1>/resign", {})
    page = call("GET", "/")
    call("GET", "/?foo=1")
    if key:
        call("GET", "/api/model", use_key=None)
        call("POST", "/api/games", {"game": "gomoku"}, use_key="wrong")
    return out, values, page


@pytest.fixture(scope="module")
def servers():
    """Both packages' servers on 127.0.0.1:0, 4 simulations, without and
    with an API key; yields their base URLs."""
    from alphazero_tpu import api_server as japi
    from alphazero_tpu_torch import api_server as tapi

    started = []
    for key in (None, "sekrit"):
        started.append(japi.serve(host="127.0.0.1", port=0, simulations=4,
                                  api_key=key))
        started.append(tapi.serve(host="127.0.0.1", port=0, simulations=4,
                                  api_key=key, device="cpu"))
    threads = [threading.Thread(target=s.serve_forever, daemon=True)
               for s in started]
    for t in threads:
        t.start()
    urls = [f"http://127.0.0.1:{s.server_address[1]}" for s in started]
    yield {"jax": urls[0], "port": urls[1], "jax_key": urls[2], "port_key": urls[3]}
    for s in started:
        s.shutdown()
        s.server_close()
    for s in started[1::2]:
        s.store.close()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()


@pytest.mark.parametrize("key", [None, "sekrit"], ids=["open", "api_key"])
def test_rest_api_matches_jax(servers, key):
    """Every route, status code, content type and JSON payload equal (the
    uniform stub's search at T 0 picks the same moves in both packages),
    the root value within 1e-3; the page served at / is the JAX
    server's."""
    suffix = "_key" if key else ""
    jax_out, jax_values, jax_page = _session(servers["jax" + suffix], key)
    port_out, port_values, port_page = _session(servers["port" + suffix], key)
    assert port_out == jax_out
    # The root value: the mean of the backed-up stub values, summed in
    # another order (JAX reads child statistics through bf16).
    np.testing.assert_allclose(port_values, jax_values, atol=1e-3)
    codes = [c for _, _, c, _, _ in port_out]
    assert codes[:11] == [200, 201, 200, 200, 400, 200, 400, 200, 404, 404, 400]
    assert codes[13:18] == [200, 400, 200, 404, 404]
    if key:
        assert codes[-2:] == [401, 401]
    assert port_page == jax_page and "alphazero_tpu" in port_page


def test_server_bundle_serves_only_its_game(tmp_path):
    """With a Gomoku 15x15 bundle, a Go 9x9 session plays on the uniform
    engine in the port's server; the JAX server's session loads the bundle
    anyway, and its engine's first move fails on the planes' shape."""
    import os

    from alphazero_tpu_torch import api_server as tapi

    flagship = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "models_zoo", "flagship_gomoku15")
    with pytest.raises(Exception, match="shape"):
        jcli.GameSession(game="go", board_size=9, model_path=flagship,
                         simulations=4).ai_move()
    server = tapi.serve(host="127.0.0.1", port=0, model=flagship, simulations=4,
                        device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        code, _, info = _api(base, "GET", "/api/model")
        assert code == 200 and info["model"] == flagship
        for game, size in (("go", 9), ("gomoku", 15)):
            code, _, st = _api(base, "POST", "/api/games",
                               {"game": game, "board_size": size})
            assert code == 201
            code, _, st = _api(base, "POST", f"/api/games/{st['id']}/ai_move", {})
            assert code == 200 and st["move_count"] == 1 and st["ai"]["visits"] == 4
        sessions = [s for s, _ in server.store.sessions.values()]
        assert [s.game for s in sessions] == ["go", "gomoku"]
        # the stub's logits are zeros; the flagship's are not
        assert [bool(s.eval_fn(s.env.observation(s.state))[0].any())
                for s in sessions] == [False, True]
    finally:
        server.shutdown()
        server.server_close()
        server.store.close()
        thread.join(timeout=10)


def test_page_equals_jax():
    from alphazero_tpu import webui as jwebui
    from alphazero_tpu_torch import webui as twebui

    assert twebui.PAGE == jwebui.PAGE
