"""Play Gomoku against the engine in the terminal (counterpart of
``examples/play_gomoku.py``; the reference ships tkinter/matplotlib GUIs,
this is the dependency-free terminal equivalent on the CLI session).

    python -m alphazero_tpu_torch.examples.play_gomoku [--board-size 9] \\
        [--simulations 200] [--model path/to/bundle] [--device cuda]

Moves as 'H8' or 'row col'; 'new' starts a new game, 'quit' ends.
"""
import argparse

from alphazero_tpu_torch.examples._loop import read_move


def parse_move(text: str, n: int):
    """Accept 'H8' style or 'row col' numbers."""
    text = text.strip()
    if not text:
        return None
    if text[0].isalpha():
        col = ord(text[0].upper()) - ord("A")
        try:
            row = int(text[1:]) - 1
        except ValueError:
            return None
        if 0 <= row < n and 0 <= col < n:
            return row * n + col
        return None
    parts = text.split()
    if len(parts) == 2:
        try:
            row, col = int(parts[0]) - 1, int(parts[1]) - 1
        except ValueError:
            return None
        if 0 <= row < n and 0 <= col < n:
            return row * n + col
    return None


def _name(action: int, n: int) -> str:
    return f"{chr(ord('A') + action % n)}{action // n + 1}"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--board-size", type=int, default=9)
    p.add_argument("--simulations", type=int, default=200)
    p.add_argument("--model", default=None)
    p.add_argument("--play-white", action="store_true",
                   help="let the engine open")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)

    from alphazero_tpu_torch.cli import GameSession

    sess = GameSession("gomoku", args.board_size, args.model, args.simulations,
                       device=args.device)
    n = args.board_size
    print(sess.show())
    if args.play_white:
        action, info = sess.ai_move()
        print(f"engine: {_name(action, n)} (v={info['value']:+.2f})")
        print(sess.show())

    while not sess.info()["terminal"]:
        raw = read_move("your move (e.g. H8): ", sess)
        if raw is None:
            break
        move = parse_move(raw, n)
        if move is None or not sess.play(move):
            print("illegal — try again")
            continue
        print(sess.show())
        if sess.info()["terminal"]:
            break
        action, info = sess.ai_move()
        print(f"engine: {_name(action, n)} (v={info['value']:+.2f}, {info['time_s']}s)")
        print(sess.show())

    winner = sess.info()["winner"]
    if not sess.info()["terminal"]:
        print("game left unfinished")
    else:
        print("game over:",
              "draw" if winner < 0 else ("black wins" if winner == 0 else "white wins"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
