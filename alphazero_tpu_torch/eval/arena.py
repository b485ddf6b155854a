"""Arena: batched model-against-model evaluation (counterpart of
``alphazero_tpu/eval/arena.py``).

Both sides play inside one batched search: the colour assignment is a
batch axis (the first half of the lanes has A as black, the rest A as
white), and the evaluator of the side to move at the root evaluates every
leaf of its search.  Moves are driven from Python, one host search a move;
the mover is known on the host, so routing is a Python branch.

Routing is per lane.  The search evaluates a lane's leaves in rows that
lie together (``lane * W + walker``), so ``make_mover_eval_fn`` splits its
rows at ``half * W``.  The JAX version splits them at ``half`` rows, which
is right only where each lane has one row (the roots, and W=1).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from alphazero_tpu_torch.core.types import cat_states
from alphazero_tpu_torch.mcts.search import (
    EvalFn, HostReuseSearch, MCTSConfig, make_host_search, search, select_action,
)


def make_matchup_eval_fn(eval_a: EvalFn, eval_b: EvalFn,
                         a_is_black: torch.Tensor) -> EvalFn:
    """Route each leaf to A or B by the side to move at the LEAF;
    ``a_is_black``: bool [B] a lane, repeated over a lane's rows.  Runs both
    nets on every leaf; the arena's own path is ``make_mover_eval_fn``."""

    def eval_fn(obs, to_play):
        la, va = eval_a(obs, to_play)
        lb, vb = eval_b(obs, to_play)
        black = a_is_black.repeat_interleave(obs.shape[0] // a_is_black.shape[0])
        use_a = black == (to_play == 0)
        return (torch.where(use_a[:, None], la.float(), lb.float()),
                torch.where(use_a, va.float(), vb.float()))

    return eval_fn


def make_mover_eval_fn(eval_a: EvalFn, eval_b: EvalFn, half: int,
                       black_to_move: bool, num_games: int) -> EvalFn:
    """The evaluator of the side to move at the root, at one net's cost:
    with black to move the first ``half`` of the ``num_games`` lanes search
    with A and the rest with B, and the other way round with white to move.
    The evaluator gets each lane's rows together, in lane order.  Both
    nets' outputs are cast to f32 (they may differ in dtype)."""

    def as_f32(e):
        def f(o, t):
            logits, value = e(o, t)
            return logits.float(), value.float()
        return f

    first, second = (as_f32(eval_a), as_f32(eval_b)) if black_to_move else (
        as_f32(eval_b), as_f32(eval_a))

    def eval_fn(obs, to_play):
        rows = obs.shape[0]
        h = half * (rows // num_games)
        if h >= rows:
            return first(obs, to_play)
        l1, v1 = first(obs[:h], to_play[:h])
        l2, v2 = second(obs[h:], to_play[h:])
        return torch.cat([l1, l2]), torch.cat([v1, v2])

    return eval_fn


@dataclasses.dataclass(frozen=True)
class ArenaConfig:
    mcts: MCTSConfig = MCTSConfig(num_simulations=200, dirichlet_epsilon=0.0)
    max_moves: int = 226
    temperature: float = 0.1  # the reference's evaluate.py plays at T=0.1
    # Random opening plies before the search begins, mirrored across the
    # colour-swap pairing (each opening is played from both colours): deep
    # searches are near-deterministic at T=0.1, and without them a match of
    # many games replays one game.
    opening_random_moves: int = 0


class ArenaResult(NamedTuple):
    wins_a: torch.Tensor  # i32 scalar
    wins_b: torch.Tensor
    draws: torch.Tensor
    a_is_black: torch.Tensor  # bool [B]
    winner: torch.Tensor  # i32 [B]: -1 draw or unfinished, 0 black, 1 white
    # The port's addition: every lane's final state (boards, move counts).
    states: object = None


def _tally(winner: torch.Tensor, a_is_black: torch.Tensor, states=None) -> ArenaResult:
    a_won = (winner == 0) == a_is_black
    decided = winner >= 0
    return ArenaResult((decided & a_won).sum().to(torch.int32),
                       (decided & ~a_won).sum().to(torch.int32),
                       (~decided).sum().to(torch.int32), a_is_black, winner, states)


def _opening_actions(env, states, generator, count: int) -> torch.Tensor:
    """One legal action drawn uniformly for each of the first ``count``
    lanes (the pairs; the caller mirrors them), i32 [count]."""
    legal = env.legal_mask(states)[:count]
    weights = (legal | ~legal.any(-1, keepdim=True)).float()
    return torch.multinomial(weights, 1, generator=generator)[:, 0].to(torch.int32)


def _lanes(B: int, device):
    half = (B + 1) // 2
    return half, torch.arange(B, device=device) < half


def play_match(env, eval_a: EvalFn, eval_b: EvalFn,
               generator: torch.Generator | None, config: ArenaConfig,
               num_games: int, device="cuda") -> ArenaResult:
    """``num_games`` games, the first half with A as black, ``max_moves``
    plies in strict alternation (JAX ``play_match``: no opening plies and no
    early exit)."""
    B = num_games
    half, a_is_black = _lanes(B, device)
    states = env.init(B, device=device)
    for t in range(config.max_moves):
        eval_fn = make_mover_eval_fn(eval_a, eval_b, half, t % 2 == 0, B)
        out = search(env, eval_fn, states, config.mcts, generator)
        action = select_action(generator, out.visit_counts, config.temperature)
        states = env.step(states, action)
    return _tally(env.winner(states), a_is_black, states)


def play_match_host(env, eval_a: EvalFn, eval_b: EvalFn,
                    generator: torch.Generator | None, config: ArenaConfig,
                    num_games: int, device="cuda") -> ArenaResult:
    """``play_match`` with ``config.opening_random_moves`` mirrored opening
    plies (lane i and lane half + i replay one opening) and an exit once
    every game has ended, checked every 16 plies (one host read)."""
    B = num_games
    half, a_is_black = _lanes(B, device)
    states = env.init(B, device=device)
    k = config.opening_random_moves
    for _ in range(k):
        acts = _opening_actions(env, states, generator, half)
        states = env.step(states, torch.cat([acts, acts[:B - half]]))
    for t in range(config.max_moves - k):
        eval_fn = make_mover_eval_fn(eval_a, eval_b, half, (t + k) % 2 == 0, B)
        out = search(env, eval_fn, states, config.mcts, generator)
        action = select_action(generator, out.visit_counts, config.temperature)
        states = env.step(states, action)
        if (t + 1) % 16 == 0 and bool(env.terminal_flag(states).all()):
            break
    return _tally(env.winner(states), a_is_black, states)


def play_match_sides(env, side_a, side_b, generator: torch.Generator | None,
                     num_games: int, max_moves: int = 226,
                     temperature: float = 0.1, opening_random_moves: int = 0,
                     device="cuda") -> ArenaResult:
    """A match where each side brings its own search: an ``(eval_fn,
    MCTSConfig)`` pair (a ``HostReuseSearch`` where the config asks for
    tree reuse), or any callable ``(states, generator) -> SearchOutput``.
    The anchor pool needs this: an anchor's simulation count is part of it.

    Two half-matches of ``ceil(num_games / 2)`` lanes each, A black in the
    first and white in the second, from the same openings; on each ply one
    side searches for all lanes.  Every played move is passed to both sides
    (``advance``), so a reused tree follows the opponent's moves too.  Each
    side is reset at the start of a half."""

    def as_search(side):
        if isinstance(side, tuple):
            eval_fn, cfg = side
            if cfg.tree_reuse:
                return HostReuseSearch(env, eval_fn, cfg)
            return make_host_search(env, eval_fn, cfg)
        return side

    sa, sb = as_search(side_a), as_search(side_b)
    B = (num_games + 1) // 2
    k = opening_random_moves
    opening = env.init(B, device=device)
    for _ in range(k):
        opening = env.step(opening, _opening_actions(env, opening, generator, B))

    finals = []
    for a_black in (True, False):
        for side in (sa, sb):
            if hasattr(side, "reset"):
                side.reset()
        states = opening
        for t in range(max_moves - k):
            mover_is_a = ((t + k) % 2 == 0) == a_black
            mover, other = (sa, sb) if mover_is_a else (sb, sa)
            out = mover(states, generator)
            action = select_action(generator, out.visit_counts, temperature)
            states = env.step(states, action)
            for side in (mover, other):
                if hasattr(side, "advance"):
                    side.advance(action, states, generator)
            if (t + 1) % 16 == 0 and bool(env.terminal_flag(states).all()):
                break
        finals.append(states)
    states = cat_states(finals)
    a_is_black = torch.arange(2 * B, device=device) < B
    return _tally(env.winner(states), a_is_black, states)
