"""Round-robin tournament CLI (counterpart of
``alphazero_tpu/scripts/tournament.py``, the same flags plus ``--device``):
every pair of the model bundles in a directory (and, on request or where
there is at most one bundle, the uniform player "random"), with the
sequential Elo table and the joint Bradley-Terry fit; writes the results to
``--output`` and prints one JSON line.

    python -m alphazero_tpu_torch.scripts.tournament --models-dir runs/zoo
"""
from __future__ import annotations

import argparse
import glob
import itertools
import json
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--game", default="gomoku",
                   choices=["gomoku", "go", "chess"])
    p.add_argument("--board-size", type=int, default=15)
    p.add_argument("--models-dir", required=True,
                   help="directory of model bundles (*.msgpack)")
    p.add_argument("--games-per-pair", type=int, default=16)
    p.add_argument("--simulations", type=int, default=100)
    p.add_argument("--include-random", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", default="tournament_results.json")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch

    from alphazero_tpu_torch.core import registry
    from alphazero_tpu_torch.elo.bradley_terry import fit_bradley_terry
    from alphazero_tpu_torch.elo.tracker import EloTracker
    from alphazero_tpu_torch.eval.arena import ArenaConfig, play_match_host
    from alphazero_tpu_torch.mcts.search import MCTSConfig
    from alphazero_tpu_torch.scripts.evaluate import default_max_moves, load_eval_fn

    device = torch.device(args.device)
    env = registry.create_game(args.game, args.board_size)
    paths = sorted(glob.glob(os.path.join(args.models_dir, "*.msgpack")))
    players = {os.path.basename(p): p for p in paths}
    if args.include_random or not players:
        players["random"] = None
    if len(players) < 2:
        raise SystemExit("need at least 2 players")

    eval_fns = {name: load_eval_fn(path, env, device)
                for name, path in players.items()}
    config = ArenaConfig(
        mcts=MCTSConfig(num_simulations=args.simulations, dirichlet_epsilon=0.0,
                        wave_size=min(16, args.simulations)),
        max_moves=default_max_moves(args.game, env.board_size),
        temperature=0.1,
        opening_random_moves=6,
    )

    tracker = EloTracker()
    results = []
    gen = torch.Generator(device=device).manual_seed(args.seed)
    for na, nb in itertools.combinations(sorted(players), 2):
        res = play_match_host(env, eval_fns[na], eval_fns[nb], gen, config,
                              args.games_per_pair, device=device)
        wa, wb, dr = int(res.wins_a), int(res.wins_b), int(res.draws)
        tracker.add_series(na, nb, wa, wb, dr)
        results.append({"a": na, "b": nb, "wins_a": wa, "wins_b": wb,
                        "draws": dr})
        print(f"{na} vs {nb}: +{wa} -{wb} ={dr}")

    table = [{"player": name, "elo": round(r, 1),
              "games": tracker.games_played[name]}
             for name, r in tracker.leaderboard()]
    # The joint fit over the whole table is independent of the pairing
    # order, which the sequential K=32 ladder is not; both are reported.
    bt = fit_bradley_terry([(r["a"], r["b"], r["wins_a"], r["wins_b"], r["draws"])
                            for r in results])
    bt_table = [{"player": k, "bt_elo": round(v, 1)}
                for k, v in sorted(bt.items(), key=lambda kv: -kv[1])]

    with open(args.output, "w") as f:
        json.dump({"results": results, "elo": table, "bt": bt_table}, f, indent=2)
    print(json.dumps({"elo": table, "bt": bt_table}))


if __name__ == "__main__":
    main()
