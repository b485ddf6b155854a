"""Arena A/Bs of a trained Gomoku 15x15 bundle (counterpart of
``tools/ab_arena.py``):

  python -m alphazero_tpu_torch.tools.ab_arena int8   -- the production
      int8 executor (``production.INT8_RESIDUAL``, ``INT8_HEADS``, the
      ``AB_PCT`` percentile, rollout calibration) against the BN-folded
      bf16 net at fixed simulations, the colours swapped between the two
      halves of the lanes.
  python -m alphazero_tpu_torch.tools.ab_arena reuse  -- tree reuse
      (``reuse_budget="fixed"``) against a fresh tree every move, at equal
      simulations a move, each side its own search
      (``eval/arena.play_match_sides``).

The int8 A/B plays both nets in one batched search (``play_match_host``,
or ``play_match`` with ``AB_HOST=0``); the evaluator of the side to move
gets exactly its own lanes' rows (``eval/arena.make_mover_eval_fn``
splits a wave's B*W rows at ``half * W``), which the JAX arena does only
at W=1.  The record (the JAX tool's keys) is printed and appended to the
JSON list in ``--output``; a second line gives the Elo difference at -+2
standard errors.

Env knobs: AB_GAMES (256), AB_SIMS (200), AB_MODEL (default
``models_zoo/flagship_gomoku15`` of the checkout), AB_SEED (0), AB_WAVE
(16), AB_PCT (``production.INT8_CALIB_PERCENTILE``), AB_OPENING (6),
AB_HOST (1).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time

from alphazero_tpu_torch.tools import _common


def load_net(device):
    from alphazero_tpu_torch.core import registry
    from alphazero_tpu_torch.models.io import load_model

    env = registry.create_game("gomoku", 15)
    path = os.environ.get("AB_MODEL", os.path.join(_common.ROOT, "models_zoo",
                                                   "flagship_gomoku15"))
    model, _ = load_model(path, env.observation_shape, device=device)
    return env, model


def calib_obs(env, model, device):
    """Mid-game calibration observations from the production rollout
    (``models/quant.make_rollout_calib_fn`` at ``production.py``'s shape,
    the folded net's policy): the A/B measures the executor the
    ``Pipeline`` ships."""
    from alphazero_tpu_torch import production
    from alphazero_tpu_torch.models.quant import make_rollout_calib_fn
    from alphazero_tpu_torch.models.resnet import make_inference_eval_fn

    fn = make_rollout_calib_fn(
        env, make_inference_eval_fn(model), n=production.CALIB_GAMES,
        plies=production.CALIB_PLIES, every=production.CALIB_EVERY, device=device)
    return fn(None, _common.generator(device, 7))


def wave() -> int:
    return int(os.environ.get("AB_WAVE", "16"))


def opening() -> int:
    return int(os.environ.get("AB_OPENING", "6"))


def int8_side(env, model, device):
    """The production executor (``INT8_RESIDUAL``, ``INT8_HEADS``, the
    ``AB_PCT`` percentile, rollout calibration) and its name in the record."""
    from alphazero_tpu_torch import production
    from alphazero_tpu_torch.models.quant import make_int8_eval_fn

    pct = float(os.environ.get("AB_PCT", str(production.INT8_CALIB_PERCENTILE)))
    eval_int8 = make_int8_eval_fn(model, calib_obs=calib_obs(env, model, device),
                                  chunk=None, residual=production.INT8_RESIDUAL,
                                  heads=production.INT8_HEADS, calib_percentile=pct)
    return eval_int8, ("int8_trunk_p%s" % pct if pct else "int8_trunk")


def host_match(env, eval_a, eval_b, games, sims, seed, device):
    """Both nets in one batched search (``play_match_host``, or
    ``play_match`` with ``AB_HOST=0``), the colours swapped between the two
    halves of the lanes."""
    from alphazero_tpu_torch.eval import arena
    from alphazero_tpu_torch.mcts.search import MCTSConfig

    cfg = arena.ArenaConfig(
        mcts=MCTSConfig(num_simulations=sims, dirichlet_epsilon=0.0,
                        wave_size=wave()),
        max_moves=225, opening_random_moves=opening())
    play = (arena.play_match_host if os.environ.get("AB_HOST", "1") == "1"
            else arena.play_match)
    return play(env, eval_a, eval_b, _common.generator(device, seed), cfg, games,
                device=device)


def run_int8_ab(env, model, games, sims, seed, device):
    from alphazero_tpu_torch.models.resnet import make_inference_eval_fn

    eval_int8, a_name = int8_side(env, model, device)
    res = host_match(env, eval_int8, make_inference_eval_fn(model), games, sims,
                     seed, device)
    return {"a": a_name, "b": "bf16_folded", "wins_a": int(res.wins_a),
            "wins_b": int(res.wins_b), "draws": int(res.draws)}


def run_reuse_ab(env, model, games, sims, seed, device):
    """A keeps its tree across every move (re-rooted through both players'
    actions), B searches a fresh tree every turn; equal simulations a move,
    mirrored random openings, two colour-swapped halves."""
    from alphazero_tpu_torch.eval.arena import play_match_sides
    from alphazero_tpu_torch.mcts.search import MCTSConfig
    from alphazero_tpu_torch.models.resnet import make_inference_eval_fn

    eval_fn = make_inference_eval_fn(model)
    cfg_on = MCTSConfig(num_simulations=sims, dirichlet_epsilon=0.0,
                        tree_reuse=True, reuse_budget="fixed", wave_size=wave())
    cfg_off = MCTSConfig(num_simulations=sims, dirichlet_epsilon=0.0,
                         wave_size=wave())
    res = play_match_sides(env, (eval_fn, cfg_on), (eval_fn, cfg_off),
                           _common.generator(device, seed), games, max_moves=225,
                           opening_random_moves=opening(), device=device)
    return {"a": "reuse_fixed", "b": "fresh_tree", "wins_a": int(res.wins_a),
            "wins_b": int(res.wins_b), "draws": int(res.draws)}


def finish(rec: dict, mode: str, sims: int, wall_s: float) -> dict:
    """Adds the score, the Elo delta and the size to a match's record and
    prints it, then the Elo delta's -+2 standard-error interval."""
    n = rec["wins_a"] + rec["wins_b"] + rec["draws"]
    score = (rec["wins_a"] + 0.5 * rec["draws"]) / max(n, 1)
    elo = _common.elo_from_score(score)
    rec.update({
        "mode": mode, "games": n, "sims": sims, "wave": wave(),
        "score_a": round(score, 4),
        "elo_delta_a": round(elo, 1) if math.isfinite(elo) else str(elo),
        "wall_s": round(wall_s, 1),
    })
    print(json.dumps(rec))
    lo, hi = _common.elo_interval(rec["wins_a"], rec["wins_b"], rec["draws"])
    print(json.dumps({"elo_delta_a_2sigma": [round(lo, 1) if math.isfinite(lo) else str(lo),
                                             round(hi, 1) if math.isfinite(hi) else str(hi)]}))
    return rec


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("mode", nargs="?", default="int8", choices=["int8", "reuse"])
    _common.add_args(p, "ab_results.json")
    args = p.parse_args(argv)
    games = int(os.environ.get("AB_GAMES", "256"))
    sims = int(os.environ.get("AB_SIMS", "200"))
    seed = int(os.environ.get("AB_SEED", "0"))
    out = _common.check_output(args.output)

    import torch

    dev = torch.device(args.device)
    env, model = load_net(dev)
    t0 = time.time()
    run = run_int8_ab if args.mode == "int8" else run_reuse_ab
    rec = run(env, model, games, sims, seed, dev)

    finish(rec, args.mode, sims, time.time() - t0)
    _common.append_json(out, rec)
    return rec


if __name__ == "__main__":
    main()
