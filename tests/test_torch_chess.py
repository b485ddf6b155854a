"""The port's chess env against the JAX package, exactly (tolerance 0
everywhere: every state field, the legal mask, the 18 bf16 planes bit for
bit, both hash lanes, ``position_hash`` and the arena-row round trip).

One batch of 64 lanes is played to its end with numpy-chosen legal moves
(up to 512 plies): standard starts, Chess960 numbers 0, 333 and 959, and
FEN starts (the perft positions, and positions near the ply cap and the
50-move rule); a quarter of the lanes undo their last move when they
can, so threefold repetitions occur.  The JAX step is compiled once for
the module (``jax_fns``, always at 64 lanes).  Then the repetition ring's
16-slot boundary, the Chess960 starts and the registry.  FEN positions,
SAN and perft are in ``tests/test_torch_chess_fen.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.games import chess as jchess
from alphazero_tpu_torch.core import registry
from alphazero_tpu_torch.core.types import GameType, cat_states
from alphazero_tpu_torch.games import chess, chess_fen, chess_tables
from alphazero_tpu_torch.games.chess_tables import encode_move
from test_torch_core_gomoku import _pair
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

B = 64
FIELDS = ("board", "to_play", "castling", "rook_start", "king_start",
          "ep_square", "halfmove", "move_count", "terminal", "winner",
          "in_check", "legal", "hash", "history", "rep_count")
# The JAX step's legality graph (about 10,000 HLO lines) compiles about a
# third faster at XLA's optimisation level 1 than at the default level,
# and runs a 64-lane step in about 20 ms there on the CPU (level 0
# compiles a little faster still but steps 25 times slower).  The graph is
# integer and boolean but for the observation's two divisions, which every
# level rounds as IEEE does.
FAST = {"xla_backend_optimization_level": 1}

START = "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 0 1"
KIWIPETE = "r3k2r/p1ppqpb1/bn2pnp1/3PN3/1p2P3/2N2Q1p/PPPBBPPP/R3K2R w KQkq - 0 1"
POS3 = "8/2p5/3p4/KP5r/1R3p1k/8/4P1P1/8 w - - 0 1"
POS4 = "r3k2r/Pppp1ppp/1b3nbN/nP6/BBP1P3/q4N2/Pp1P2PP/R2Q1RK1 w kq - 0 1"
POS5 = "rnbq1k1r/pp1Pbppp/2p5/8/2B5/8/PPP1NnPP/RNBQK2R w KQ - 1 8"
POS6 = "r4rk1/1pp1qppp/p1np1n2/2b1p1B1/2B1P1b1/P1NP1N2/1PP1QPPP/R4RK1 w - - 0 10"
# FEN starts of the playout batch: near the 512-ply cap (fullmove 250 is
# ply 498), near the 50-move rule, and the rook shuffles of the
# repetition tests.
PLAYOUT_FENS = (KIWIPETE, POS3, POS4, POS5,
                "r3k2r/8/8/8/8/8/8/R3K2R w KQkq - 0 250",
                "k7/8/8/8/8/8/8/K6R w - - 95 80",
                "k7/8/8/8/8/8/R7/K7 w - - 0 1",
                "4k3/8/8/3pP3/8/8/8/4K3 w - d6 0 40")
def envs(**kw):
    return jchess.ChessEnv(**kw), chess.ChessEnv(**kw)


@pytest.fixture(scope="module")
def jax_fns():
    """The JAX step, and a probe of the observation (standard and Chess960)
    and the position hash, each jitted and vmapped once at 64 lanes."""
    jenv, j960 = jchess.ChessEnv(), jchess.ChessEnv(chess960_position=0)

    def probe(s):
        return dict(obs=jenv.observation(s), obs960=j960.observation(s),
                    hash=jenv.position_hash(s))

    step = jax.jit(jax.vmap(jenv.step), compiler_options=FAST)
    return step, jax.jit(jax.vmap(probe), compiler_options=FAST)


def to_numpy(st: chess.ChessState) -> dict:
    """A port state's fields as JAX's: the legal bitboards as the 4,672
    booleans, hash lanes as u32."""
    out = {f: getattr(st, f).numpy() for f in FIELDS}
    out["legal"] = chess.legal_bits_to_mask(st.legal).numpy()
    out["hash"] = out["hash"].astype(np.uint32)
    out["history"] = out["history"].astype(np.uint32)
    return out


def to_jax(st: chess.ChessState) -> jchess.ChessState:
    return jchess.ChessState(**{f: jnp.asarray(v) for f, v in to_numpy(st).items()})


def stack(states):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)


def assert_state_equal(tst: chess.ChessState, jst, where=""):
    got, want = to_numpy(tst), jax.device_get(jst)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], getattr(want, f), err_msg=f"{f} {where}")


def assert_probe_equal(tst, want, c960, where=""):
    """Observation (bit for bit; Chess960 lanes with the flag plane) and
    position hash of ``tst`` against the JAX probe ``want``."""
    want = jax.device_get(want)
    obs = chess.ChessEnv().observation(tst)
    obs960 = chess.ChessEnv(chess960_position=0).observation(tst)
    mine = torch.where(torch.from_numpy(c960)[:, None, None, None], obs960, obs)
    theirs = np.where(c960[:, None, None, None], want["obs960"], want["obs"])
    np.testing.assert_array_equal(mine.view(torch.int16).numpy(),
                                  theirs.view(np.int16), err_msg=where)
    np.testing.assert_array_equal(_pair(chess.ChessEnv().position_hash(tst)),
                                  np.asarray(want["hash"]), err_msg=where)


def assert_rows_round_trip(env, st):
    rows = env.arena_rows(st)
    assert [r.dtype for r in rows] == [torch.int8, torch.int32, torch.int32]
    assert rows[2].shape[1] == 146
    back = env.from_arena_rows(*rows)
    for f in FIELDS:
        assert torch.equal(getattr(back, f), getattr(st, f)), f


def playout_starts():
    """(port state, JAX state, Chess960 lane flags) of the 64 lanes:
    standard starts, Chess960 0, 333 and 959 (each env's own ``init`` on
    both sides), and ``PLAYOUT_FENS`` (carried across: the FEN readers are
    compared in ``tests/test_torch_chess_fen.py``)."""
    groups, jgroups, c960 = [], [], []
    for number, n in ((None, 32), (0, 8), (333, 8), (959, 8)):
        jenv, env = envs(chess960_position=number)
        groups.append(env.init(n, device="cpu"))
        jgroups.append(stack([jenv.init()] * n))
        c960 += [number is not None] * n
    fens = chess_fen.state_from_fen(chess.ChessEnv(), list(PLAYOUT_FENS), device="cpu")
    groups.append(fens)
    jgroups.append(to_jax(fens))
    c960 += [False] * len(PLAYOUT_FENS)
    return (cat_states(groups),
            jax.tree_util.tree_map(lambda *xs: jnp.concatenate(xs), *jgroups),
            np.array(c960))


def choose(rng, legal, last, side, shuffle):
    """A legal action a lane: on ``shuffle`` lanes, half the time the move
    that takes back the mover's last move (``last[(lane, side)]``), where
    legal; else uniform.  0 on lanes with no legal move (terminal: step
    ignores them)."""
    acts = np.zeros(len(legal), np.int64)
    for b, row in enumerate(legal):
        moves = np.flatnonzero(row)
        if not len(moves):
            continue
        undo = last.get((b, side[b]))
        if shuffle[b] and undo is not None and row[undo] and rng.rand() < 0.5:
            acts[b] = undo
        else:
            acts[b] = rng.choice(moves)
    return acts


def _undo_action(board, action):
    """The action moving the piece of ``action`` back, or None (pawns,
    promotions and castling cannot be taken back)."""
    frm, mt = divmod(int(action), 73)
    p = int(board[frm // 8, frm % 8])
    if p < 0 or p % 6 == chess_tables.PAWN or mt >= 64:
        return None
    dr, dc = chess_tables.move_delta(mt)
    to = frm + 8 * dr + dc
    target = int(board[to // 8, to % 8])
    if target >= 0 and target // 6 == p // 6:  # castling (KxR)
        return None
    return encode_move(to, frm)


def test_playouts_match_jax(jax_fns):
    jstep, jprobe = jax_fns
    env = chess.ChessEnv()
    rng = np.random.RandomState(0)
    tst, jst, c960 = playout_starts()
    assert_state_equal(tst, jst, "start")
    shuffle = np.arange(B) % 4 == 1
    seen = dict(checks=0, ep_captures=0, castlings=0, promotions=0)
    last = {}
    for ply in range(512):
        assert_probe_equal(tst, jprobe(jst), c960, where=f"ply {ply}")
        if ply % 64 == 0:
            assert_rows_round_trip(env, tst)
        legal = env.legal_mask(tst).numpy()
        side = tst.to_play.numpy()
        acts = choose(rng, legal, last, side, shuffle)
        board = tst.board.numpy()
        live = ~tst.terminal.numpy()
        for b in np.flatnonzero(live):
            frm, mt = divmod(int(acts[b]), 73)
            p = int(board[b, frm // 8, frm % 8])
            dr, dc = chess_tables.move_delta(mt, p // 6)
            to = frm + 8 * dr + dc
            target = int(board[b, to // 8, to % 8])
            seen["castlings"] += p % 6 == chess_tables.KING and target >= 0 \
                and target // 6 == p // 6
            seen["ep_captures"] += p % 6 == chess_tables.PAWN and dc != 0 \
                and to == int(tst.ep_square[b])
            seen["promotions"] += p % 6 == chess_tables.PAWN and to // 8 in (0, 7)
            last[(b, side[b])] = _undo_action(board[b], acts[b])
        tst = env.step(tst, torch.from_numpy(acts))
        jst = jstep(jst, jnp.asarray(acts, jnp.int32))
        assert_state_equal(tst, jst, f"ply {ply}")
        seen["checks"] += int((tst.in_check & ~tst.terminal).sum())
        if bool(tst.terminal.all()):
            break
    assert_probe_equal(tst, jprobe(jst), c960, where="end")
    assert ply > 400  # the random lanes ran long
    assert_rows_round_trip(env, tst)
    assert bool(tst.terminal.all())
    moves_left = env._legal_bits(tst.board, tst.to_play, tst.castling,
                                 tst.rook_start, tst.king_start, tst.ep_square)[0]
    ended = dict(
        checkmates=int((tst.winner >= 0).sum()),
        stalemates=int(((moves_left == 0).all(1) & ~tst.in_check).sum()),
        repetitions=int((tst.rep_count >= 3).sum()),
        fifty_moves=int((tst.halfmove >= 100).sum()),
        ply_cap=int((tst.move_count >= 512).sum()),
        insufficient=int(chess._insufficient_material(tst.board).sum()))
    for key, n in {**seen, **ended}.items():
        assert n > 0, (key, seen, ended)


def test_repetition_ring_boundary_matches_jax(jax_fns):
    """The 16-slot ring's documented bound: an 8-ply knight cycle repeats
    the start at plies 0, 8 and 16, and ply 16 overwrites ply 0's slot, so
    the threefold is missed, on both packages alike."""
    jstep, _ = jax_fns
    jenv, env = envs()
    cycle = [("g1", "f3"), ("g8", "f6"), ("f3", "g5"), ("f6", "g4"),
             ("g5", "h3"), ("g4", "h6"), ("h3", "g1"), ("h6", "g8")]
    tst, jst = env.init(B, device="cpu"), stack([jenv.init()] * B)
    for frm, to in cycle * 3:
        a = encode_move(chess_fen.square_from_alg(frm), chess_fen.square_from_alg(to))
        acts = np.full(B, a, np.int32)
        tst, jst = env.step(tst, torch.from_numpy(acts)), jstep(jst, jnp.asarray(acts))
        assert_state_equal(tst, jst, f"{frm}{to}")
    assert not bool(tst.terminal.any()) and int(tst.rep_count[0]) == 2


@pytest.mark.parametrize("number", [0, 333, 518, 959])
def test_chess960_starts_match_jax(number):
    """The start position, its castling files and its legal moves; 518 is
    the standard arrangement."""
    jenv, env = envs(chess960_position=number)
    st = env.init(2, device="cpu")
    assert_state_equal(st, stack([jenv.init()] * 2), str(number))
    assert chess.chess960_back_rank(number) == jchess.chess960_back_rank(number)
    if number == 518:
        assert torch.equal(st.board, chess.ChessEnv().init(2, device="cpu").board)


def test_registry_creates_chess():
    env = registry.create_game("chess", 8, max_moves=100)
    assert isinstance(env, chess.ChessEnv) and env.num_actions == 4672
    assert env.observation_shape == (18, 8, 8) and env.max_moves == 100
    assert registry.create_game(GameType.CHESS).game_type == GameType.CHESS
    assert registry.create_game("chess", chess960_position=7).chess960_position == 7
