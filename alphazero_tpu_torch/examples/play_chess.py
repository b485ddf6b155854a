"""Play chess against the engine in the terminal (counterpart of
``examples/play_chess.py``).  Moves in coordinate form: e2e4, a7a8n (the
promotion letter n/b/r; queen by default); 'new' starts a new game,
'quit' ends.

    python -m alphazero_tpu_torch.examples.play_chess [--simulations 200] \\
        [--model path/to/bundle] [--chess960 N] [--device cuda]
"""
import argparse

from alphazero_tpu_torch.examples._loop import read_move


def parse_move(text):
    from alphazero_tpu_torch.games import chess_tables as T
    from alphazero_tpu_torch.games.chess_fen import square_from_alg

    text = text.strip().lower()
    if len(text) not in (4, 5):
        return None
    try:
        frm = square_from_alg(text[:2])
        to = square_from_alg(text[2:4])
    except (ValueError, IndexError):
        return None
    promo = None
    if len(text) == 5:
        if text[4] not in "nbrq":
            return None
        promo = {"n": T.KNIGHT, "b": T.BISHOP, "r": T.ROOK}.get(text[4])
    try:
        return T.encode_move(frm, to, promo)
    except (ValueError, KeyError):
        return None


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--simulations", type=int, default=200)
    p.add_argument("--model", default=None)
    p.add_argument("--chess960", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)

    from alphazero_tpu_torch.cli import GameSession

    variant = {}
    if args.chess960 is not None:
        variant["chess960_position"] = args.chess960
    sess = GameSession("chess", 8, args.model, args.simulations, device=args.device,
                       **variant)
    print(sess.show())
    while not sess.info()["terminal"]:
        raw = read_move("your move (e.g. e2e4): ", sess)
        if raw is None:
            break
        move = parse_move(raw)
        if move is None or not sess.play(move):
            print("illegal — try again")
            continue
        print(sess.show())
        if sess.info()["terminal"]:
            break
        action, info = sess.ai_move()
        frm = action // 73
        print(f"engine action {action} (from sq {frm}) v={info['value']:+.2f}")
        print(sess.show())
    print("result:", sess.info())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
