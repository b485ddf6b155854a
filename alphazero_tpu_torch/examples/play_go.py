"""Play Go against the engine in the terminal (counterpart of
``examples/play_go.py``, a terminal UI instead of tkinter).

    python -m alphazero_tpu_torch.examples.play_go [--board-size 9] \\
        [--simulations 200] [--model path/to/bundle] [--device cuda]

Moves as 'D4' or 'row col', or 'pass'; 'new' starts a new game, 'quit'
ends.
"""
import argparse

from alphazero_tpu_torch.examples._loop import read_move
from alphazero_tpu_torch.examples.play_gomoku import _name, parse_move


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--board-size", type=int, default=9)
    p.add_argument("--simulations", type=int, default=200)
    p.add_argument("--model", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)

    from alphazero_tpu_torch.cli import GameSession

    sess = GameSession("go", args.board_size, args.model, args.simulations,
                       device=args.device)
    n = args.board_size
    print(sess.show())
    while not sess.info()["terminal"]:
        raw = read_move("your move (e.g. D4, or 'pass'): ", sess)
        if raw is None:
            break
        move = n * n if raw.lower() == "pass" else parse_move(raw, n)
        if move is None or not sess.play(move):
            print("illegal — try again")
            continue
        print(sess.show())
        if sess.info()["terminal"]:
            break
        action, info = sess.ai_move()
        print("engine:", "pass" if action == n * n else _name(action, n),
              f"(v={info['value']:+.2f})")
        print(sess.show())
    print("result:", sess.info())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
