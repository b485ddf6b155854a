"""The port's chess FEN and SAN against the JAX package's ``chess_fen``,
exactly, and perft against the published totals.

FEN positions (those of ``tests/test_chess.py`` and more: en-passant
pins, the en-passant capture of a checking pawn, castling through and out
of attack, promotions, stalemate, mate, insufficient material and the
50-move clock) through both packages' ``state_from_fen``: every field, the
legal mask, the 18 planes bit for bit and ``position_hash`` (tolerance 0);
FEN strings both ways; SAN of every kind of move from both packages, and
the port's SAN parsed back.  The JAX functions run op by op (no compiled
step: the JAX SAN steps one state at a time)."""
import jax
import numpy as np
import pytest
import torch

from alphazero_tpu.games import chess_fen as jfen
from alphazero_tpu.games import chess_tables as jtables
from alphazero_tpu_torch.games import chess, chess_fen, chess_tables
from alphazero_tpu_torch.games.chess_tables import encode_move
from test_torch_chess import (
    KIWIPETE, POS3, POS4, POS5, POS6, START, assert_rows_round_trip,
    assert_state_equal, envs, one_torch_thread,  # noqa: F401 (autouse)
)
from test_torch_core_gomoku import _pair

FENS = (START, KIWIPETE, POS3, POS4, POS5, POS6,
        "8/8/8/KPp4r/8/8/8/7k w - c6 0 1",
        "8/8/8/K2pP2r/8/8/8/7k w - d6 0 1",
        "8/8/2b5/3pP3/8/5K2/8/7k w - d6 0 1",
        "8/8/8/3pP3/4K3/8/8/7k w - d6 0 1",
        "5r2/8/8/8/8/8/8/R3K2R w KQ - 0 1",
        "4r3/8/8/8/8/8/8/R3K2R w KQ - 0 1",
        "r3k2r/pppppppp/8/8/8/8/PPPPPPPP/R3K2R b KQkq - 0 1",
        "1r2k3/P7/8/8/8/8/8/4K3 w - - 0 1",
        "k7/2Q5/1K6/8/8/8/8/8 b - - 0 1",
        "rnb1kbnr/pppp1ppp/8/4p3/6Pq/5P2/PPPPP2P/RNBQKBNR w KQkq - 1 3",
        "k7/8/8/8/8/8/8/K7 w - - 0 1",
        "kb6/8/8/8/8/8/8/KN6 w - - 0 1",
        "k7/8/8/8/8/8/8/K6R w - - 100 80",
        "4r3/8/8/8/8/8/4B3/4K3 w - - 0 1")


def test_fen_positions_match_jax():
    """Each FEN through both ``state_from_fen``s: every field (check, mate,
    stalemate and the draws by material or clock among them), the
    observation and the hash; the FEN strings back from both."""
    jenv, env = envs()
    tst = chess_fen.state_from_fen(env, list(FENS), device="cpu")
    assert chess_fen.fen_from_state(tst) == list(FENS)
    for i, fen in enumerate(FENS):
        js = jfen.state_from_fen(jenv, fen)
        one = tst.map(lambda x: x[i:i + 1])
        assert_state_equal(one, jax.tree_util.tree_map(lambda x: x[None], js), fen)
        np.testing.assert_array_equal(
            env.observation(one)[0].view(torch.int16).numpy(),
            np.asarray(jenv.observation(js)).view(np.int16), err_msg=fen)
        np.testing.assert_array_equal(_pair(env.position_hash(one))[0],
                                      np.asarray(jenv.position_hash(js)))
        assert jfen.fen_from_state(js) == fen
    # stalemate, mate, K v K, KB v KN, the 50-move clock
    assert int(tst.terminal.sum()) == 5
    assert_rows_round_trip(env, tst)


def test_fen_cases_of_the_jax_tests():
    """Legal moves and outcomes the JAX tests pin, on the port."""
    env = chess.ChessEnv()
    sq = chess_fen.square_from_alg

    def fen(f):
        return chess_fen.state_from_fen(env, f, device="cpu")

    # Castling through attack: the rook on f8 forbids O-O, not O-O-O.
    legal = env.legal_mask(fen("5r2/8/8/8/8/8/8/R3K2R w KQ - 0 1"))[0]
    assert not legal[encode_move(sq("e1"), sq("h1"))]
    assert legal[encode_move(sq("e1"), sq("a1"))]
    # The en-passant capture that would bare the king along the rank.
    s = fen("8/8/8/KPp4r/8/8/8/7k w - c6 0 1")
    assert not env.legal_mask(s)[0, encode_move(sq("b5"), sq("c6"))]
    # A pinned bishop cannot move; promotion to queen and to knight.
    s = fen("4r3/8/8/8/8/8/4B3/4K3 w - - 0 1")
    assert not env.legal_mask(s)[0].view(64, 73)[sq("e2")].any()
    s = fen("8/P6k/8/8/8/8/8/K7 w - - 0 1")
    q = encode_move(sq("a7"), sq("a8"))
    n = encode_move(sq("a7"), sq("a8"), chess_tables.KNIGHT)
    s2 = env.step(s.map(lambda x: x.expand((2,) + x.shape[1:])), torch.tensor([q, n]))
    assert s2.board[:, 7, 0].tolist() == [4, 1]
    # Fool's mate: black wins.
    s = fen("rnbqkbnr/pppp1ppp/8/4p3/6P1/5P2/PPPPP2P/RNBQKBNR b KQkq - 0 2")
    s = env.step(s, torch.tensor([encode_move(sq("d8"), sq("h4"))]))
    assert bool(s.terminal[0]) and int(s.winner[0]) == 1


def perft(env, st, depth):
    for d in range(depth):
        legal = env.legal_mask(st)
        if d == depth - 1:
            return int(legal.sum())
        b, a = torch.nonzero(legal, as_tuple=True)
        st = env.step(st.map(lambda x: x[b]), a)


@pytest.mark.parametrize("fen,depth,want", [
    (START, 3, 8_902), (KIWIPETE, 3, 97_862), (POS3, 3, 2_812),
    (POS4, 3, 9_467), (POS5, 3, 62_379), (POS6, 3, 89_890)])
def test_perft_published_totals(fen, depth, want):
    env = chess.ChessEnv()
    assert perft(env, chess_fen.state_from_fen(env, fen, device="cpu"), depth) == want


@pytest.mark.parametrize("number", [0, 100, 333, 518, 959])
def test_chess960_castling_matches_jax(number):
    """``tests/test_chess960_perft.py``'s castling-ready starts (only kings,
    rooks and pawns: KxR castling both ways at move 1) with the Chess960
    rook and king files: the legal moves equal JAX's, castling among them,
    and each castle lands king and rook on their files."""
    import jax.numpy as jnp
    from test_chess960_perft import castling_ready_fen

    fen, king_file, ks, qs = castling_ready_fen(number)
    jenv, env = envs()
    js = jfen.state_from_fen(jenv, fen).replace(
        rook_start=jnp.asarray([[ks, qs], [ks, qs]], jnp.int32),
        king_start=jnp.asarray([king_file, king_file], jnp.int32))
    jlegal, jcheck = jenv._legal_mask_impl(js)
    st = chess_fen.state_from_fen(env, fen, device="cpu")
    st.rook_start = torch.tensor([[[ks, qs], [ks, qs]]], dtype=torch.int32)
    st.king_start = torch.tensor([[king_file, king_file]], dtype=torch.int32)
    bits, check = env._legal_bits(st.board, st.to_play, st.castling, st.rook_start,
                                  st.king_start, st.ep_square)
    legal = chess.legal_bits_to_mask(bits)[0]
    np.testing.assert_array_equal(legal.numpy(), np.asarray(jlegal))
    assert bool(check[0]) == bool(jcheck)
    st.legal = bits
    castles = [(side, encode_move(king_file, rook))
               for side, rook in enumerate((ks, qs))
               if legal[encode_move(king_file, rook)]]
    assert castles  # the other rook may stand on a landing square
    for side, a in castles:
        row = env.step(st, torch.tensor([a])).board[0, 0].tolist()
        king, rook = (6, 5) if side == 0 else (2, 3)
        assert row[king] == chess_tables.KING and row[rook] == chess_tables.ROOK
        assert sum(p >= 0 for p in row) == 3


SAN_FENS = (KIWIPETE, POS4, "k7/8/8/8/8/8/8/K2R3R w - - 0 1",
            "1k6/8/8/8/R7/8/8/R6K w - - 0 1",
            "rnbqkbnr/pppp1ppp/8/4p3/6P1/5P2/PPPPP2P/RNBQKBNR b KQkq - 0 2",
            "4k3/8/8/3pP3/8/8/8/4K3 w - d6 0 40", "1r5k/P7/8/8/8/8/8/7K w - - 0 1")


def test_san_matches_jax():
    """The SAN of every legal action of positions with castling, en
    passant, promotions (capturing too), file and rank disambiguation,
    check and mate, from both packages (JAX's for a spread of them: each
    takes a step op by op); every one parsed back by the port."""
    jenv, env = envs()
    tst = chess_fen.state_from_fen(env, list(SAN_FENS), device="cpu")
    kinds, every = set(), set()
    for i, fen in enumerate(SAN_FENS):
        js = jfen.state_from_fen(jenv, fen)
        actions = np.flatnonzero(env.legal_mask(tst)[i].numpy()).tolist()
        sans = [chess_fen.action_to_san(env, tst, a, lane=i) for a in actions]
        every.update(sans)
        for a, san in zip(actions, sans):
            assert chess_fen.san_to_action(env, tst, san, lane=i) == a
        # JAX's SAN of the first action of each kind met here, and of every
        # seventh action.
        for k, (a, san) in enumerate(zip(actions, sans)):
            kind = ("O-O" in san, "=" in san, "x" in san, san[-1] in "+#",
                    san[0] in "NBRQK" and len(san.rstrip("+#").replace("x", "")) > 3)
            if kind in kinds and k % 7:
                continue
            kinds.add(kind)
            assert san == jfen.action_to_san(jenv, js, a), (fen, a)
    assert {"O-O", "dxe6", "a8=N", "axb8=Q+", "Rdf1", "R1a3", "Qh4#"} <= every
    s = chess_fen.state_from_fen(env, START, device="cpu")
    assert chess_fen.san_to_action(env, s, "Ngf3") == chess_fen.san_to_action(env, s, "Nf3+")
    assert chess_fen.san_to_action(env, s, "e4!?") == encode_move(12, 28)
    with pytest.raises(ValueError):
        chess_fen.san_to_action(env, s, "Qh5")
    c = chess_fen.state_from_fen(env, SAN_FENS[0], device="cpu")
    assert chess_fen.action_to_san(env, c, chess_fen.san_to_action(env, c, "0-0")) == "O-O"


def test_tables_and_encoding_match_jax():
    for key, value in jtables.TABLES.items():
        np.testing.assert_array_equal(chess_tables.TABLES[key], value, err_msg=key)
    rng = np.random.RandomState(1)
    for _ in range(300):
        frm, to = (int(x) for x in rng.randint(64, size=2))
        for promo in (None, chess_tables.KNIGHT, chess_tables.ROOK):
            try:
                want = jtables.encode_move(frm, to, promo)
            except (ValueError, ZeroDivisionError, KeyError):
                continue
            assert chess_tables.encode_move(frm, to, promo) == want
    assert chess_tables.decode_action(1234) == jtables.decode_action(1234)
    for sq in range(64):
        assert chess_fen.alg_from_square(sq) == jfen.alg_from_square(sq)
        assert chess_fen.square_from_alg(jfen.alg_from_square(sq)) == sq
