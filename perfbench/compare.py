"""What decides ``correct``: the program's self-play held against the plain
reference (``perfbench/reference``), once the window has closed.

* env: every sampled lane's game is replayed by the plain env from the
  empty board, move by move, from the moves the program played (the
  opening plies and every window step): each move must be
  legal, each game end and winner must be the program's, and the final
  position must be the program's.
* search: at the recorded steps, each sampled lane's search is replayed
  (``reference/search.py``) from the plain env's own position; its root
  visit counts and its chosen move must be the program's.
* executor: every row the replays reproduced (observation equal to the one
  the program evaluated) goes through the plain float32 net; the widest
  and the mean total-variation distance between the program's and the
  reference's move distributions over legal moves, and the widest and the
  mean value gap, are read, and those the cell's ``limits`` name are
  compared.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from perfbench.reference import net as ref_net
from perfbench.reference import search as ref_search


@dataclasses.dataclass
class StepRecord:
    """One recorded actor step: the sampled search lanes, the program's
    evaluator rows of those lanes (root, then W a wave), its root visit
    counts and the generator seed of the step."""

    row: int  # index into the move log
    lanes: List[int]
    root_obs: torch.Tensor  # [S, C, H, W]
    root_logits: torch.Tensor  # [S, A]
    root_value: torch.Tensor  # [S]
    wave_obs: List[torch.Tensor]  # waves x [S * W, C, H, W]
    wave_logits: List[torch.Tensor]
    wave_value: List[torch.Tensor]
    counts: torch.Tensor  # [S, A]
    seed: int


def lane_record(rec: StepRecord, i: int, W: int) -> ref_search.LaneRecord:
    rows = slice(i * W, i * W + W)
    return ref_search.LaneRecord(
        root_obs=rec.root_obs[i].float().numpy(),
        root_logits=rec.root_logits[i].float().numpy(),
        root_value=float(rec.root_value[i]),
        wave_obs=[o[rows].float().numpy() for o in rec.wave_obs],
        wave_logits=[o[rows].float().numpy() for o in rec.wave_logits],
        wave_value=[o[rows].float().numpy() for o in rec.wave_value],
    )


def _masked_probs(logits: torch.Tensor, legal: torch.Tensor) -> torch.Tensor:
    x = torch.where(legal, logits.double(), float("-inf"))
    return torch.softmax(x, dim=-1).nan_to_num(0.0)


def gaps(prog_logits, prog_value, ref_logits, ref_value, legal) -> dict:
    """The widest and the mean total-variation distance of the move
    distributions over legal moves, and the widest and the mean value gap,
    over the rows."""
    live = legal.any(dim=1)
    tv = 0.5 * (_masked_probs(prog_logits, legal)
                - _masked_probs(ref_logits, legal)).abs().sum(dim=1)
    tv = tv[live]
    vg = (prog_value.double() - ref_value.double()).abs()
    return {"policy_tv_max": float(tv.max()), "policy_tv_mean": float(tv.mean()),
            "value_gap_max": float(vg.max()), "value_gap_mean": float(vg.mean())}


@dataclasses.dataclass
class Outcome:
    numbers: Dict[str, float]
    failed: int
    info: Dict[str, float]
    rows: dict  # the reproduced rows: obs, legal, program logits and values


def check(env, search_cfg: dict, temperature: dict, moves: np.ndarray,
          kinds: List[str], ended: np.ndarray, env_lanes: List[int],
          final: dict, steps: List[StepRecord], weights: dict,
          num_blocks: int, batch: int, device, log=print) -> Outcome:
    """``moves`` int [T, B] every move the program played, ``kinds[t]``
    "open" (a policy-sampled opening ply) or "step" (an actor step, with
    ``ended[t]`` its recorded game ends, -2 none); ``final`` the program's
    last position of each of ``env_lanes`` (``board``, ``to_play``,
    ``move_count``)."""
    W = int(search_cfg["wave_size"])
    A = env.num_actions
    by_row = {r.row: r for r in steps}
    states = {lane: env.init() for lane in env_lanes}
    broken = {}  # lane -> what went wrong first
    snaps = {}
    env_bad = 0
    for t in range(moves.shape[0]):
        if t in by_row:
            snaps[t] = {lane: states[lane] for lane in by_row[t].lanes}
        for lane in env_lanes:
            if lane in broken:
                continue
            s, a = states[lane], int(moves[t, lane])
            live = not s.terminal
            if live and not env.is_legal(s, a):
                broken[lane] = f"move {t}: illegal action {a}"
                env_bad += 1
                continue
            s2 = env.step(s, a) if live else s
            if kinds[t] == "step":
                want = s2.winner if (live and s2.terminal) else -2
                if int(ended[t, lane]) != want:
                    broken[lane] = (f"move {t}: game end {int(ended[t, lane])}"
                                    f", the rules give {want}")
                    env_bad += 1
                    continue
                if s2.terminal:
                    s2 = env.init()
            states[lane] = s2
    for i, lane in enumerate(env_lanes):
        if lane in broken:
            continue
        if not env.same_position(states[lane], final["board"][i],
                                 int(final["to_play"][i]),
                                 int(final["move_count"][i])):
            broken[lane] = "final position differs"
            env_bad += 1
    for lane, why in list(broken.items())[:5]:
        log(f"# env: lane {lane}: {why}")

    visit_bad = move_bad = 0
    near_ties = 0
    obs_rows, legal_rows, lg_rows, v_rows = [], [], [], []
    for rec in steps:
        g = torch.Generator(device=device).manual_seed(rec.seed)
        alpha = float(search_cfg["dirichlet_alpha"])
        gamma = torch._standard_gamma(
            torch.full((batch, A), alpha, device=device), generator=g)
        u = torch.rand((batch, A), generator=g, device=device)
        counts_ref = torch.zeros((batch, A), dtype=torch.int32, device=device)
        temp = torch.ones(batch, device=device)
        replayed = []
        for i, lane in enumerate(rec.lanes):
            if lane in broken:
                visit_bad += 1
                continue
            root = snaps[rec.row][lane]
            priors = ref_search.Priors(batch, W, A, min(int(search_cfg["max_children"]), A),
                                       lane, gamma,
                                       float(search_cfg["dirichlet_epsilon"]), device)
            lr = lane_record(rec, i, W)
            try:
                rp = ref_search.replay(env, search_cfg, root, lr, priors)
            except ref_search.ReplayError as e:
                log(f"# search: step {rec.row} lane {lane}: {e}")
                visit_bad += 1
                continue
            near_ties += rp.near_ties
            if not np.array_equal(rp.counts, rec.counts[i].numpy()):
                diff = int(np.abs(rp.counts - rec.counts[i].numpy()).sum())
                log(f"# search: step {rec.row} lane {lane}: root visits differ "
                    f"by {diff}")
                visit_bad += 1
                continue
            counts_ref[lane] = torch.from_numpy(rp.counts).to(device, torch.int32)
            drop = root.move_count < int(temperature["drop_move"])
            temp[lane] = float(temperature["before"] if drop else temperature["after"])
            replayed.append((i, lane))
            obs_rows.append(torch.from_numpy(lr.root_obs)[None])
            obs_rows.extend(torch.from_numpy(o) for o in lr.wave_obs)
            legal_rows.append(torch.from_numpy(np.stack(rp.legal_rows)))
            lg_rows.append(torch.cat([rec.root_logits[i][None]]
                                     + [o[i * W:i * W + W] for o in rec.wave_logits]))
            v_rows.append(torch.cat([rec.root_value[i][None]]
                                    + [o[i * W:i * W + W] for o in rec.wave_value]))
        chosen = ref_search.select(counts_ref, u, temp).cpu()
        for i, lane in replayed:
            if int(chosen[lane]) != int(moves[rec.row, lane]):
                log(f"# search: step {rec.row} lane {lane}: the program played "
                    f"{int(moves[rec.row, lane])}, the visits choose {int(chosen[lane])}")
                move_bad += 1

    numbers = {"env_mismatch": float(env_bad),
               "search_visit_mismatch": float(visit_bad),
               "search_move_mismatch": float(move_bad)}
    rows = {}
    if obs_rows:
        obs = torch.cat(obs_rows)
        legal = torch.cat(legal_rows)
        prog_logits = torch.cat(lg_rows).float()
        prog_value = torch.cat(v_rows).float()
        w = {k: v.to(device) for k, v in weights.items()}
        ref_logits, ref_value = ref_net.forward_blocks(w, obs.to(device), num_blocks)
        numbers.update(gaps(prog_logits, prog_value, ref_logits, ref_value, legal))
        rows = dict(obs=obs, legal=legal, logits=prog_logits, value=prog_value,
                    ref_logits=ref_logits, ref_value=ref_value)
    else:
        numbers.update(dict.fromkeys(("policy_tv_max", "policy_tv_mean",
                                      "value_gap_max", "value_gap_mean"),
                                     float("inf")))
    failed = env_bad + visit_bad + move_bad
    info = {"env_lanes": len(env_lanes), "search_lanes": sum(len(r.lanes) for r in steps),
            "rows_compared": sum(len(x) for x in v_rows), "near_ties": near_ties}
    return Outcome(numbers=numbers, failed=failed, info=info, rows=rows)
