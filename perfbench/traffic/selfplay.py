"""Self-play traffic: a closed loop of B lanes, each one game, played by
the program's host actor (``make_host_actor``'s ``step``) with recycling:
a lane whose game ends restarts at once from the empty board.

Parameters (the mix's JSON file): ``lanes`` (B), ``opening_plies`` (every
game is first advanced this many policy-sampled plies: the program's
evaluator's masked softmax over legal moves, one draw a lane from a
generator seeded from the run's seed), ``check_steps`` (the window steps
whose searches are replayed), ``search_lanes`` and ``env_lanes`` (how many
lanes, drawn from the seed, the check replays), ``trace_from_step`` and
``trace_seconds`` (the whole steps a traced run profiles).

Set-up: the configuration's net with seeded weights, its executor, the
opening plies and a warm-up step of one wave (``num_simulations`` cut to
``wave_size``) by a second actor on the same lanes, whose result is
dropped: it evaluates the same shapes a full step does (B root rows, B x W
rows a wave) and runs every kernel of the search, the env and the move
choice.  The window is made of whole steps: from the first timed step to
the end of the step during which ``--seconds`` ran out.
``selfplay_moves_per_s`` is the moves the lanes played in the window over
the window's seconds.

A traced run profiles whole steps from ``trace_from_step`` on.  The
profiler's per-launch cost stretches a traced step's wall time (about
twice on the int8 cell), so the traced window's length is taken as its
steps times the mean wall time of the run's untraced window steps: the
idle share and the whole step's share of the peak are read against the
step's own pace, not the profiler's.
"""
from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from perfbench import compare, yardstick
from perfbench.reference import go as ref_go
from perfbench.reference import gomoku as ref_gomoku
from perfbench.trace import LaunchLog, Tracer, mark
from perfbench.weights import make as make_weights, net_shapes


class Evaluator:
    """The program's evaluator as the actor calls it, counting positions;
    inside a traced step each call is bracketed by marker kernels, and inside a recorded
    step the sampled lanes' rows are copied out (root call, then W rows a
    lane a wave)."""

    def __init__(self, fn, lanes, W: int, device):
        self.fn = fn
        self.positions = 0
        self.traced = False
        self.rows = None
        lanes_t = torch.tensor(lanes, dtype=torch.int64, device=device)
        self.root_idx = lanes_t
        self.wave_idx = (lanes_t[:, None] * W
                         + torch.arange(W, device=device)).reshape(-1)

    def __call__(self, obs, to_play=None):
        self.positions += obs.shape[0]
        if self.traced:
            mark()
        out = self.fn(obs, to_play)
        if self.traced:
            mark()
        if self.rows is not None:
            idx = self.wave_idx if self.rows else self.root_idx
            self.rows.append(tuple(x.index_select(0, idx)
                                   for x in (obs, out[0], out[1])))
        return out


def _reference_env(game: dict):
    opts = game.get("options", {})
    if game["name"] == "gomoku":
        if any(opts.get(k) for k in ("use_renju", "use_omok",
                                     "use_pro_long_opening")):
            raise ValueError("the plain Gomoku is freestyle only")
        return ref_gomoku.Gomoku(game["board_size"])
    if game["name"] == "go":
        if not opts.get("chinese_rules", True):
            raise ValueError("the plain Go scores by area only")
        return ref_go.Go(game["board_size"], opts.get("komi", 7.5),
                         opts.get("history_len", 16))
    raise ValueError(f"no plain env for {game['name']!r}")


def _executor(env, model, ex: dict, gen, device):
    from alphazero_tpu_torch.models.quant import (
        make_int8_eval_fn, make_rollout_calib_fn,
    )
    from alphazero_tpu_torch.models.resnet import make_inference_eval_fn

    if ex["kind"] == "folded":
        return make_inference_eval_fn(model)
    if ex["kind"] == "int8":
        calib = make_rollout_calib_fn(
            env, make_inference_eval_fn(model), n=ex["calib_games"],
            plies=ex["calib_plies"], every=ex["calib_every"],
            device=device)(None, gen)
        return make_int8_eval_fn(
            model, calib_obs=calib, chunk=ex["chunk"], chunk_mode="unroll",
            residual=ex["residual"], heads=ex["heads"],
            calib_percentile=ex["calib_percentile"])
    raise ValueError(f"unknown executor {ex['kind']!r}")


def paced_window(step_s, traced) -> float:
    """The traced steps' length at the pace of the untraced ones: their
    number times the mean wall time of the steps not traced."""
    untraced = [t for t, tr in zip(step_s, traced) if not tr]
    return sum(traced) * sum(untraced) / len(untraced)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(ctx) -> dict:
    from alphazero_tpu_torch.core import registry
    from alphazero_tpu_torch.mcts.search import MCTSConfig, masked_softmax
    from alphazero_tpu_torch.models.resnet import AZResNet, ResNetConfig
    from alphazero_tpu_torch.selfplay.actor import SelfPlayConfig, make_host_actor

    marks = [("start", time.perf_counter())]  # set-up's phases, for info
    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    game, net, sc, ex = cfg["game"], cfg["net"], cfg["search"], cfg["executor"]
    B, W = int(mix["lanes"]), int(sc["wave_size"])
    env = registry.create_game(game["name"], game["board_size"],
                               **game.get("options", {}))
    plain_env = _reference_env(game)
    A = env.num_actions

    rng = np.random.default_rng(ctx.seed_for("lanes"))
    search_lanes = sorted(int(x) for x in rng.choice(B, mix["search_lanes"], replace=False))
    env_lanes = sorted(set(search_lanes) | {int(x) for x in rng.choice(
        B, min(B, mix["env_lanes"]), replace=False)})

    # --- the net, its weights from the seed, the executor ---
    with torch.device(dev):
        model = AZResNet(A, ResNetConfig(**net), env.observation_shape).eval()
    weights = make_weights(net_shapes(model), ctx.seed_for("weights"), dev)
    missing, unexpected = model.load_state_dict(weights, strict=False)
    if unexpected or any(not k.endswith("num_batches_tracked") for k in missing):
        raise RuntimeError(f"weights do not fit the net: {missing} {unexpected}")
    plain_weights = {k: v.detach().cpu().clone() for k, v in weights.items()}
    del weights
    marks.append(("weights", time.perf_counter()))
    eval_fn = _executor(env, model, ex, ctx.gen("calibration"), dev)
    del model
    marks.append(("executor", time.perf_counter()))

    evaluator = Evaluator(eval_fn, search_lanes, W, dev)
    mcts = MCTSConfig(**{k: v for k, v in sc.items()})
    sp = cfg["selfplay"]
    actor_cfg = SelfPlayConfig(mcts=mcts, temperature=sp["temperature"],
                               final_temperature=sp["final_temperature"],
                               temperature_drop_move=sp["temperature_drop_move"],
                               recycle=True)
    step, states = make_host_actor(env, evaluator, actor_cfg, B, device=dev)

    moves, kinds, ended = [], [], []
    with torch.no_grad():
        for ply in range(int(mix["opening_plies"])):
            logits, _ = eval_fn(env.observation(states), env.to_play(states))
            probs = masked_softmax(logits.float(), env.legal_mask(states))
            # A finished game draws from all moves; its step is a no-op.
            probs = torch.where(env.terminal_flag(states)[:, None], 1.0, probs)
            act = torch.multinomial(probs, 1, generator=ctx.gen(f"open/{ply}"))[:, 0]
            act = act.to(torch.int32)
            states = env.step(states, act)
            moves.append(act)
            kinds.append("open")
            ended.append(None)
    marks.append(("openings", time.perf_counter()))
    warm_cfg = dataclasses.replace(
        actor_cfg, mcts=dataclasses.replace(mcts, num_simulations=W))
    warm_step, _ = make_host_actor(env, evaluator, warm_cfg, B, device=dev)
    warm_step(states, ctx.gen("step/warmup"))
    del warm_step
    _sync(dev)
    marks.append(("warmup", time.perf_counter()))
    setup_s = marks[-1][1] - ctx.t_start
    setup_phase_s = {name: t - marks[i][1]
                     for i, (name, t) in enumerate(marks[1:])}
    setup_phase_s["process"] = marks[0][1] - ctx.t_start
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    # --- the window ---
    check_steps = set(int(k) for k in mix["check_steps"])
    trace_from = int(mix["trace_from_step"])
    tracer = Tracer(dev) if ctx.trace else None
    launches = LaunchLog()
    traced_steps = traced_positions = 0
    trace_t0 = None
    recorded = []
    active = []
    step_s, traced = [], []
    t0 = last = time.perf_counter()
    k = 0
    while True:
        tracing = tracer is not None and k >= trace_from and tracer.window_s is None
        if tracing and trace_t0 is None:
            tracer.start()
            patch = launches.patched()
            patch.__enter__()
            evaluator.traced = True
            trace_t0 = last = time.perf_counter()  # the profiler's start is no step's
        p0 = evaluator.positions
        seed = ctx.seed_for(f"step/{k}")
        if k in check_steps:
            evaluator.rows = []
        states, rec = step(states, torch.Generator(device=dev).manual_seed(seed))
        if k in check_steps:
            rows = evaluator.rows
            evaluator.rows = None
            lanes_t = evaluator.root_idx
            recorded.append(dict(
                row=len(moves), seed=seed, rows=rows,
                counts=step.last_search.visit_counts.index_select(0, lanes_t)))
        moves.append(rec.action)
        kinds.append("step")
        ended.append(rec.ended_winner)
        active.append(rec.active)
        _sync(dev)
        now = time.perf_counter()
        step_s.append(now - last)
        last = now
        traced.append(tracing)
        k += 1
        if tracing:
            traced_steps += 1
            traced_positions += evaluator.positions - p0
            if now - trace_t0 >= float(mix["trace_seconds"]):
                evaluator.traced = False
                patch.__exit__(None, None, None)
                tracer.stop()
                last = time.perf_counter()  # nor is its stop
        trace_done = tracer is None or tracer.window_s is not None
        if now - t0 >= ctx.seconds and trace_done:
            break
    window_s = now - t0
    window_moves = int(torch.stack(active).sum())
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)

    out = {"memory_peak_bytes": memory_peak,
           "e2e": {"selfplay_moves_per_s": window_moves / window_s,
                   "setup_s": setup_s},
           "info": {"window_s": window_s, "steps": k, "moves": window_moves,
                    "step_s": step_s, "setup_phase_s": setup_phase_s}}
    if tracer is not None:
        summary = tracer.summary()
        summary.update(
            window_s=paced_window(step_s, traced),
            steps=traced_steps, positions=traced_positions,
            macs_per_position=yardstick.resnet_macs(
                net, *env.observation_shape, A),
            precision=ex["precision"], launches=launches)
        out["summary"] = summary
        out["device"] = {"busy_s": summary["busy_s"],
                         "window_s": summary["window_s"]}
        out["breakdown"] = {"device_ops": [[n, v] for n, v in summary["device_ops"]],
                            "idle_gaps": [[n, v] for n, v in summary["idle_gaps"]]}
        out["info"].update(
            traced_steps=traced_steps, traced_wall_s=tracer.window_s,
            untraced_step_s=summary["window_s"] / traced_steps,
            trace_events=summary["events"], trace_read_s=summary["read_s"],
            markers=summary["markers"], s8_launches=len(launches.s8_mm),
            gather_launches=len(launches.gather))

    # --- the check, with the program's state freed ---
    final_idx = torch.tensor(env_lanes, device=dev)
    final = {"board": states.board.index_select(0, final_idx).cpu().numpy(),
             "to_play": states.to_play.index_select(0, final_idx).cpu().numpy(),
             "move_count": states.move_count.index_select(0, final_idx).cpu().numpy()}
    move_log = torch.stack(moves).cpu().numpy()
    ended_log = np.stack([e.cpu().numpy() if e is not None
                          else np.full(B, -2, np.int32) for e in ended])
    steps = []
    for r in recorded:
        root = r["rows"][0]
        waves = r["rows"][1:]
        steps.append(compare.StepRecord(
            row=r["row"], lanes=search_lanes,
            root_obs=root[0].cpu(), root_logits=root[1].float().cpu(),
            root_value=root[2].float().cpu(),
            wave_obs=[w[0].cpu() for w in waves],
            wave_logits=[w[1].float().cpu() for w in waves],
            wave_value=[w[2].float().cpu() for w in waves],
            counts=r["counts"].cpu(), seed=r["seed"]))
    del step, evaluator, eval_fn, states, rec, recorded, moves, ended, active
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    temperature = {"before": sp["temperature"], "after": sp["final_temperature"],
                   "drop_move": sp["temperature_drop_move"]}
    t_check = time.perf_counter()
    outcome = compare.check(plain_env, sc, temperature, move_log, kinds, ended_log,
                            env_lanes, final, steps, plain_weights,
                            int(net["num_blocks"]), B, dev, log=ctx.log)
    outcome.info["check_s"] = time.perf_counter() - t_check
    out["attempted"] = window_moves
    out["outcome"] = outcome
    out["plain_weights"] = plain_weights
    return out
