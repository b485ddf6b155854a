"""Interactive CLI (counterpart of ``alphazero_tpu/cli.py``): commands new /
play / aimove / undo / show / info / setoption / save / load / benchmark /
quit, driving the batched engine with one lane.

Run:  python -m alphazero_tpu_torch.cli [--game gomoku] [--board-size 15]
      [--model models_zoo/flagship_gomoku15] [--device cuda]

``--device`` takes the place of the JAX CLI's platform selection
(``utils/platform.apply_env_platform``).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


class GameSession:
    """One interactive game on ``device``: env + state (a batch of one) +
    history (undo) + engine."""

    def __init__(self, game="gomoku", board_size=15, model_path=None,
                 simulations=200, device="cuda", seed=None, **variant):
        from alphazero_tpu_torch.core import registry
        from alphazero_tpu_torch.models.stub import make_uniform_eval_fn

        self.game = game
        self.device = torch.device(device)
        self.env = registry.create_game(game, board_size, **variant)
        self.options = {"simulations": simulations, "temperature": 0.0}
        if model_path:
            from alphazero_tpu_torch.models.io import inference_eval_fn, load_model

            model, _ = load_model(model_path, self.env.observation_shape,
                                  device=self.device)
            # BN-folded bf16 inference path for a ResNet bundle.
            self.eval_fn = inference_eval_fn(model)
        else:
            self.eval_fn = make_uniform_eval_fn(self.env.num_actions,
                                                value_noise=0.1)
        self._engines = {}
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(time.time()) % 2**31 if seed is None else seed)
        self.new_game()

    def new_game(self):
        self.state = self.env.init(1, device=self.device)
        self.history = [self.state]
        self.actions = []
        self._reset_engines()

    def _reset_engines(self):
        for eng in self._engines.values():
            if hasattr(eng, "reset"):
                eng.reset()

    def _engine(self, sims: int):
        """Per-simulation-count search engine.  Match surfaces carry the
        tree across moves (``production.MATCH_TREE_REUSE``): the session
        re-roots it through every played move, the engine's own and the
        human's alike."""
        if sims not in self._engines:
            from alphazero_tpu_torch import production
            from alphazero_tpu_torch.mcts.search import (
                HostReuseSearch, MCTSConfig, make_host_search,
            )

            cfg = MCTSConfig(
                num_simulations=sims,
                dirichlet_epsilon=0.0,
                tree_reuse=production.MATCH_TREE_REUSE,
                reuse_budget=production.MATCH_REUSE_BUDGET,
                wave_size=min(16, sims),
            )
            if cfg.tree_reuse:
                eng = HostReuseSearch(self.env, self.eval_fn, cfg)
            else:
                eng = make_host_search(self.env, self.eval_fn, cfg)
            self._engines[sims] = eng
        return self._engines[sims]

    def legal_actions(self):
        return np.nonzero(self.env.legal_mask(self.state)[0].cpu().numpy())[0]

    def play(self, action: int) -> bool:
        legal = self.env.legal_mask(self.state)[0].cpu().numpy()
        if action < 0 or action >= len(legal) or not legal[action]:
            return False
        acts = torch.tensor([action], dtype=torch.int32, device=self.device)
        self.state = self.env.step(self.state, acts)
        self.history.append(self.state)
        self.actions.append(int(action))
        # Carry any kept search tree through the played move (the engine's
        # own and the opponent's alike).
        for eng in self._engines.values():
            if hasattr(eng, "advance"):
                eng.advance(acts, self.state, self.generator)
        return True

    def ai_move(self):
        """Run search and play the chosen action.  Returns (action, info)."""
        from alphazero_tpu_torch.mcts.search import select_action

        eng = self._engine(int(self.options["simulations"]))
        t0 = time.perf_counter()
        out = eng(self.state, self.generator)
        counts = out.visit_counts
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        think = time.perf_counter() - t0
        action = int(select_action(self.generator, counts,
                                   float(self.options["temperature"]))[0])
        self.play(action)
        return action, {
            "value": float(out.root_value[0]),
            "visits": int(counts.sum()),
            "time_s": round(think, 2),
        }

    def cells(self):
        """Structured board for GUI clients: flat row-major list.

        gomoku/go: -1 empty, 0 black, 1 white.  chess: -1 empty, 0-5 white
        PNBRQK, 6-11 black (row 0 = rank 1).
        """
        return [int(v) for v in self.state.board[0].reshape(-1).tolist()]

    def move_from_squares(self, from_sq: int, to_sq: int, promo=None):
        """Resolve a (from, to[, promo]) chess click pair to a legal action
        index, or None.  Tries the promotion encoding, then the plain one
        (the GUI sends its promotion choice with every move), then the KxR
        castling encoding (king clicked two squares sideways)."""
        from alphazero_tpu_torch.games.chess_tables import encode_move

        legal = self.env.legal_mask(self.state)[0].cpu().numpy()
        promo_code = {None: None, "": None, "q": None, "n": 1, "b": 2,
                      "r": 3}.get(promo, None)
        candidates = []
        for code in ([promo_code, None] if promo_code is not None
                     else [None]):
            try:
                candidates.append(encode_move(int(from_sq), int(to_sq), code))
            except (ValueError, KeyError, ZeroDivisionError):
                pass
        fr, fc = divmod(int(from_sq), 8)
        tr, tc = divmod(int(to_sq), 8)
        if fr == tr and abs(fc - tc) == 2:
            rook_c = 7 if tc > fc else 0
            try:
                candidates.append(
                    encode_move(int(from_sq), fr * 8 + rook_c, None))
            except (ValueError, KeyError, ZeroDivisionError):
                pass
        for a in candidates:
            if a is not None and 0 <= a < len(legal) and legal[a]:
                return int(a)
        return None

    def undo(self) -> bool:
        if len(self.history) <= 1:
            return False
        self.history.pop()
        self.actions.pop()
        self.state = self.history[-1]
        # Kept trees are rooted below the undone move: drop them.
        self._reset_engines()
        return True

    def save_game(self, path: str):
        """Save the current game as a GameRecord JSON."""
        from alphazero_tpu_torch.selfplay.game_record import GameRecord

        rec = GameRecord(game_type=self.env.game_type,
                         board_size=self.env.board_size)
        for a in self.actions:
            rec.add_move(a, [], 0.0)
        rec.set_result(int(self.env.result(self.state)[0]))
        rec.save(path)

    def load_game(self, path: str) -> bool:
        """Load a GameRecord JSON and replay its moves into this session.
        The record must be for the same game type; returns False on a
        mismatch or an illegal recorded move."""
        from alphazero_tpu_torch.selfplay.game_record import GameRecord

        rec = GameRecord.load(path)
        if int(rec.game_type) != int(self.env.game_type):
            return False
        saved = (self.state, self.history, self.actions)
        self.new_game()
        for m in rec.moves:
            if not self.play(int(m.action)):
                self.state, self.history, self.actions = saved
                return False
        return True

    def show(self) -> str:
        from alphazero_tpu_torch.utils.render import render

        return render(self.env, self.state)

    def info(self) -> dict:
        s, env = self.state, self.env
        return {
            "game": self.game,
            "to_play": int(env.to_play(s)[0]),
            "move_count": int(s.move_count[0]),
            "terminal": bool(env.terminal_flag(s)[0]),
            "winner": int(env.winner(s)[0]),
            "legal_moves": len(self.legal_actions()),
        }


HELP = """commands:
  new                     start a new game
  play <action>           make a move (flat action index)
  aimove                  let the engine move
  undo                    undo last move
  show                    print the board
  info                    print game status as JSON
  setoption <name> <val>  set engine option (simulations, temperature)
  save <path>             save the game as a GameRecord JSON
  load <path>             load a saved game (replays its moves)
  benchmark               time one engine move
  quit                    exit
"""


def repl(session: GameSession):
    print(HELP)
    print(session.show())
    while True:
        try:
            line = input("az> ").strip()
        except EOFError:
            break
        if not line:
            continue
        cmd, *rest = line.split()
        if cmd == "quit":
            break
        elif cmd == "new":
            session.new_game()
            print(session.show())
        elif cmd == "play":
            if not rest or not session.play(int(rest[0])):
                print("illegal move")
            else:
                print(session.show())
        elif cmd == "aimove":
            action, info = session.ai_move()
            print(f"engine plays {action} ({info})")
            print(session.show())
        elif cmd == "undo":
            print("ok" if session.undo() else "nothing to undo")
        elif cmd == "show":
            print(session.show())
        elif cmd == "info":
            print(json.dumps(session.info()))
        elif cmd == "setoption" and len(rest) == 2:
            session.options[rest[0]] = float(rest[1])
            print("ok")
        elif cmd == "save" and rest:
            try:
                session.save_game(rest[0])
                print("ok")
            except OSError as e:
                print(f"save failed: {e}")
        elif cmd == "load" and rest:
            try:
                ok = session.load_game(rest[0])
            except (OSError, ValueError, KeyError) as e:
                print(f"load failed: {e}")
            else:
                print(session.show() if ok else "load failed: bad record")
        elif cmd == "benchmark":
            t0 = time.perf_counter()
            action, info = session.ai_move()
            session.undo()
            print(json.dumps({"move_time_s": round(time.perf_counter() - t0,
                                                   2), **info}))
        else:
            print(HELP)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--game", default="gomoku",
                   choices=["gomoku", "go", "chess"])
    p.add_argument("--board-size", type=int, default=15)
    p.add_argument("--model", default=None)
    p.add_argument("--simulations", type=int, default=200)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)
    session = GameSession(args.game, args.board_size, args.model,
                          args.simulations, device=args.device)
    repl(session)


if __name__ == "__main__":
    main()
