"""Self-play throughput benchmark of the PyTorch/CUDA port (counterpart of
``bench.py``, section by section).

Measures moves/s on one card for Gomoku 15x15 with 800-simulation MCTS,
B=1024 games, W=16 walkers a wave, a freshly initialised 6x64 SE-ResNet
(seed 0) run by the production int8 executor (``production.py``).

Three regimes, each timed from the same start states every rep:
  * opening -- the first ``BENCH_MOVES`` moves from the empty board; its
    median is ``value``;
  * midgame -- the same searched moves from positions advanced 40 plies by
    policy sampling, reported as ``midgame``;
  * sustained -- recycled self-play from the midgame positions (finished
    lanes restart at once), reported as ``sustained`` and
    ``sustained_games_per_min``; skipped under tree reuse, as in bench.py.

Prints ONE JSON line on stdout with bench.py's keys in the same mode; the
per-regime summary, the card's name and power limit (``nvidia-smi``) and
notes go to stderr.  Knobs are bench.py's ``BENCH_*`` environment
variables with its defaults, plus ``BENCH_DEVICE`` (default ``cuda``; the
tests set ``cpu``).  Without a card and without ``BENCH_DEVICE=cpu`` it
exits non-zero with "no CUDA device".

    python3 bench_gpu.py                            # the defaults, on the card
    BENCH_MODE=midgame BENCH_INT8=0 python3 bench_gpu.py
    BENCH_DEVICE=cpu BENCH_BATCH=8 BENCH_SIMS=16 BENCH_MOVES=2 \\
        BENCH_REPS=1 BENCH_MAX_REPS=1 BENCH_BOARD=7 python3 bench_gpu.py

``compile=`` on stderr is the warm-up move before rep 0: on a cold
``build/kernels/`` it includes the kernels' first-use ``nvcc`` build.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

BASELINE_MOVES_PER_S = 40.0
REF_MEASURED_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "tools", "parity", "reference_baseline.json",
)
MODES = ("both", "opening", "midgame", "sustained")


def repeat_until_stable(one_rep, min_reps: int, max_reps: int,
                        stable_pct: float) -> list:
    """bench.py's repetition rule: call ``one_rep(rep)`` (a tuple whose
    first item is moves/s) for rep 0, 1, ... until at least ``min_reps``
    have run and the last two moves/s agree within ``stable_pct`` percent
    of the larger, or ``max_reps`` have run.  Returns every rep's tuple.
    A pair needs two reps: bench.py's loop reads ``reps[-2]`` after one rep
    and raises at ``BENCH_REPS=1``; here one rep stops only at
    ``max_reps``."""
    out = []
    for rep in range(max_reps):
        out.append(one_rep(rep))
        if len(out) >= max(min_reps, 2):
            a, b = out[-2][0], out[-1][0]
            if abs(a - b) / max(a, b) * 100.0 <= stable_pct:
                break
    return out


def median(values):
    """bench.py's median: the upper middle of the sorted values."""
    return sorted(values)[len(values) // 2]


def advance_midgame(env, eval_fn, states, device, plies: int = 40):
    """Advance every game ``plies`` policy-sampled moves (the midgame
    regime's start): the evaluator's masked softmax over legal moves, one
    categorical draw a lane from a generator seeded ``1000 + ply``, drawn
    as bench.py's ``categorical(log(p + 1e-9))`` is."""
    import torch

    from alphazero_tpu_torch.mcts.search import masked_softmax

    with torch.no_grad():
        for i in range(plies):
            gen = torch.Generator(device=device).manual_seed(1000 + i)
            logits, _ = eval_fn(env.observation(states), env.to_play(states))
            probs = masked_softmax(logits.float(), env.legal_mask(states))
            acts = torch.multinomial(probs + 1e-9, 1, generator=gen)[:, 0]
            states = env.step(states, acts.to(torch.int32))
    _sync(device)
    return states


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main() -> int:
    batch = int(os.environ.get("BENCH_BATCH", "1024"))
    sims = int(os.environ.get("BENCH_SIMS", "800"))
    moves = int(os.environ.get("BENCH_MOVES", "16"))
    reuse = os.environ.get("BENCH_REUSE", "0") == "1"
    # W virtual-loss descents a wave sharing one evaluation (MCTSConfig.wave_size).
    wave = int(os.environ.get("BENCH_WAVE", "16"))
    game = os.environ.get("BENCH_GAME", "gomoku")
    board = int(os.environ.get("BENCH_BOARD", "15"))
    # "both" (default) | "opening" | "midgame" | "sustained"
    mode = os.environ.get("BENCH_MODE", "both")
    device = os.environ.get("BENCH_DEVICE", "cuda")
    if mode not in MODES or (mode == "sustained" and reuse):
        # bench.py fails on these with a KeyError after the timed runs.
        raise ValueError(f"BENCH_MODE={mode!r} (reuse={reuse}): nothing to report")

    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("bench_gpu: no CUDA device (set BENCH_DEVICE=cpu to run on the CPU)",
              file=sys.stderr)
        return 2

    from alphazero_tpu_torch.core import registry
    from alphazero_tpu_torch.mcts.search import MCTSConfig
    from alphazero_tpu_torch.models.resnet import (
        AZResNet, ResNetConfig, make_inference_eval_fn,
    )
    from alphazero_tpu_torch.selfplay.actor import SelfPlayConfig, make_host_actor

    env = registry.create_game(game, board)
    # flax's initial distributions from seed 0; the zero policy and last
    # value kernels give uniform priors and value 0, as JAX's init does.
    model = AZResNet(env.num_actions, ResNetConfig(), env.observation_shape,
                     generator=torch.Generator().manual_seed(0)).to(dev).eval()

    def generator(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    if os.environ.get("BENCH_EVAL", "") == "stub":
        # Engine-only decomposition: uniform evaluator, no NN.
        from alphazero_tpu_torch.models.stub import make_uniform_eval_fn

        eval_fn = make_uniform_eval_fn(env.num_actions, value_noise=0.1)
    elif os.environ.get("BENCH_INT8", "1") == "1":
        # The int8 trunk of models/quant.py at production.py's knobs, the one
        # executor configuration shared with the training Pipeline.
        from alphazero_tpu_torch import production
        from alphazero_tpu_torch.models.quant import (
            make_int8_eval_fn,
            make_rollout_calib_fn,
        )

        # Mid-game rollout calibration (the production regime).
        calib = make_rollout_calib_fn(
            env, make_inference_eval_fn(model),
            n=production.CALIB_GAMES, plies=production.CALIB_PLIES,
            every=production.CALIB_EVERY, device=dev,
        )(None, generator(7))
        # BENCH_CHUNK: positions an int8 chunk (0 = the batch in one piece).
        chunk = int(os.environ.get("BENCH_CHUNK",
                                   str(production.INT8_CHUNK)))
        # BENCH_CHUNK_MODE: bench.py's "unroll" or "map" chunk loop; both are
        # one Python loop in eager PyTorch (models/quant._chunked_int8_eval).
        cmode = os.environ.get("BENCH_CHUNK_MODE", "unroll")
        if cmode == "map":
            print("# BENCH_CHUNK_MODE=map runs the same eager chunk loop as "
                  "unroll", file=sys.stderr)
        pct = float(os.environ.get(
            "BENCH_PCT", str(production.INT8_CALIB_PERCENTILE)))
        if os.environ.get("BENCH_QP_ARGS", "0") == "1":
            # The quantised params as an argument of the evaluator, at
            # make_int8_eval_params' residual and heads, as bench.py passes
            # them; the actor takes no params, so the step closes over them.
            from alphazero_tpu_torch.models.quant import make_int8_eval_params

            print("# BENCH_QP_ARGS=1: the actor closes over the quantised "
                  "params; eager PyTorch runs the same code as for params "
                  "bound in the evaluator", file=sys.stderr)
            param_eval, qp = make_int8_eval_params(
                model, calib_obs=calib, chunk=chunk or None,
                chunk_mode=cmode, calib_percentile=pct)

            def eval_fn(obs, to_play=None, _f=param_eval, _p=qp):
                return _f(_p, obs, to_play)
        else:
            # BENCH_RESIDUAL: "int8" (only the s8 activation carried between
            # blocks) or "bf16"; BENCH_HEADS: "int8" or "bf16" head convs.
            resid = os.environ.get("BENCH_RESIDUAL",
                                   production.INT8_RESIDUAL)
            heads = os.environ.get("BENCH_HEADS", production.INT8_HEADS)
            eval_fn = make_int8_eval_fn(model, calib_obs=calib,
                                        chunk=chunk or None, chunk_mode=cmode,
                                        residual=resid, heads=heads,
                                        calib_percentile=pct)
    else:
        # BN-folded bf16 inference (models/resnet.fold_batch_norm).
        eval_fn = make_inference_eval_fn(model)

    # Tree reuse with the "topup" budget: each move runs only enough fresh
    # simulations that every lane's root reaches `sims` visits.
    config = SelfPlayConfig(
        mcts=MCTSConfig(num_simulations=sims, tree_reuse=reuse,
                        reuse_budget="topup", wave_size=wave),
        max_moves=moves,
    )

    def build_step(cfg_):
        return make_host_actor(env, eval_fn, cfg_, batch, device=dev)

    step, init_states = build_step(config)
    # Continuous (recycled) self-play for the "sustained" regime: finished
    # lanes restart at once, the production generation mode.  Never built
    # under reuse (the actor refuses recycle with tree reuse).
    recycle_cfg = SelfPlayConfig(mcts=config.mcts, max_moves=moves, recycle=True)

    # Each regime times `moves` searched moves from the SAME start states at
    # least BENCH_REPS times (rep 0 after a one-move warm-up), until the last
    # two reps agree within BENCH_STABLE_PCT or BENCH_MAX_REPS have run, and
    # reports the median with every rep's number.
    min_reps = int(os.environ.get("BENCH_REPS", "3"))
    max_reps = int(os.environ.get("BENCH_MAX_REPS", "6"))
    stable_pct = float(os.environ.get("BENCH_STABLE_PCT", "3.0"))

    def one_rep(stepf, states, rep):
        """Time `moves` searched moves from `states`, fresh tree state each
        rep (step.reset) so every rep does the same work."""
        stepf.reset()
        done_moves = 0
        done_games = 0
        fresh_sims = 0
        st = states
        _sync(dev)
        t0 = time.perf_counter()
        for i in range(moves):
            st, rec = stepf(st, generator(1000 * rep + 2 + i))
            done_moves += int(rec.active.sum())
            done_games += int((rec.ended_winner != -2).sum())
            fresh_sims += getattr(
                getattr(stepf, "search", None), "last_fresh_sims", sims
            )
        _sync(dev)
        elapsed = time.perf_counter() - t0
        return (done_moves / elapsed, done_games / elapsed * 60.0,
                fresh_sims / max(1, moves), elapsed)

    def timed_run(stepf, states):
        """Median-of-reps throughput.  Returns (moves_per_s median,
        games_per_min median, fresh_sims_per_move, total_elapsed,
        compile_s, rep_values)."""
        stepf.reset()
        _sync(dev)
        t0 = time.perf_counter()
        stepf(states, generator(1))
        _sync(dev)
        compile_s = time.perf_counter() - t0

        runs = repeat_until_stable(lambda rep: one_rep(stepf, states, rep),
                                   min_reps, max_reps, stable_pct)
        reps = [r[0] for r in runs]
        return (median(reps), median([r[1] for r in runs]), runs[-1][2],
                sum(r[3] for r in runs), compile_s, reps)

    results = {}
    if mode in ("both", "opening"):
        results["opening"] = timed_run(step, init_states)
    if mode in ("both", "midgame", "sustained"):
        mid_states = advance_midgame(env, eval_fn, env.init(batch, device=dev), dev)
    if mode in ("both", "midgame"):
        results["midgame"] = timed_run(step, mid_states)
    if mode in ("both", "sustained") and not reuse:
        # Guarded as in bench.py: the sustained regime must never cost the
        # primary record.
        try:
            sustained_step, _ = build_step(recycle_cfg)
            results["sustained"] = timed_run(sustained_step, mid_states)
        except Exception as e:  # pragma: no cover - defensive
            print(f"# sustained regime failed: {e!r}", file=sys.stderr)

    primary = "opening" if "opening" in results else mode
    mps, _gpm, fresh, elapsed, compile_s, rep_values = results[primary]
    suffix = "" if primary == "opening" else f"_{primary}"
    result = {
        "metric": (
            f"selfplay_moves_per_s_per_chip_{game}{board}_{sims}sims{suffix}"
        ),
        "value": round(mps, 2),
        "unit": "moves/s",
        "vs_baseline": round(mps / BASELINE_MOVES_PER_S, 2),
        "reps": [round(r, 1) for r in rep_values],
    }
    if "midgame" in results and primary == "opening":
        mid = results["midgame"][0]
        result["midgame"] = round(mid, 2)
        result["midgame_vs_baseline"] = round(mid / BASELINE_MOVES_PER_S, 2)
        result["midgame_reps"] = [round(r, 1) for r in results["midgame"][5]]
    if "sustained" in results:
        # Continuous self-play from midgame start states, and the
        # completed-games rate.
        sus = results["sustained"]
        result["sustained"] = round(sus[0], 2)
        result["sustained_games_per_min"] = round(sus[1], 1)
        result["sustained_reps"] = [round(r, 1) for r in sus[5]]
    if os.path.exists(REF_MEASURED_PATH):
        with open(REF_MEASURED_PATH) as f:
            ref = json.load(f)
        ref_mps = float(ref.get("moves_per_s", 0) or 0)
        if ref_mps > 0:
            result["reference_measured_moves_per_s"] = ref_mps
            result["vs_reference_measured"] = round(mps / ref_mps, 2)
            if "midgame" in result:
                result["midgame_vs_reference_measured"] = round(
                    result["midgame"] / ref_mps, 2
                )
    if dev.type == "cuda":
        print(f"# card: {_card_line()}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    for name, (m, gpm, fr, el, co, reps_list) in results.items():
        print(
            f"# {name}: median {m:.1f} moves/s over "
            f"{len(reps_list)} reps {[round(r, 1) for r in reps_list]} "
            f"games/min={gpm:.1f} batch={batch} sims={sims} "
            f"timed_moves={moves}/rep reuse={reuse} wave={wave} "
            f"fresh_sims/move={fr:.0f} "
            f"total_elapsed={el:.1f}s compile={co:.1f}s",
            file=sys.stderr,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
