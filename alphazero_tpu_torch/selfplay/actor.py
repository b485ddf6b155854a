"""Batched self-play actor (counterpart of ``alphazero_tpu/selfplay/actor.py``).

B games are one batch axis: every move is a batched wave search over all
lanes followed by one lockstep env step.  With ``recycle`` a lane whose game
ends restarts at once from a fresh game, and ``MoveRecord.ended_winner``
keeps the segment boundary for ``value_targets_recycled``.  With
``MCTSConfig.tree_reuse`` each lane's tree is kept between moves and
re-rooted on the played action (``HostReuseSearch``).

``play_games``/``move_once`` are the JAX package's scanned actor: exactly
``max_moves`` moves, each a fresh ``search`` whose ``action_weights`` are
the recorded policy, with no early stop and no tree reuse.
``make_host_actor`` is the host-driven actor the pipeline runs by default.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from alphazero_tpu_torch.core.types import stack_states, where_lanes
from alphazero_tpu_torch.mcts.search import (
    EvalFn, HostReuseSearch, MCTSConfig, check_config, make_host_search,
    search, select_action,
)


@dataclasses.dataclass(frozen=True)
class SelfPlayConfig:
    """Temperature ``temperature`` until move ``temperature_drop_move``, then
    ``final_temperature``; ``recycle`` restarts finished lanes."""

    mcts: MCTSConfig = MCTSConfig()
    max_moves: int = 226
    temperature: float = 1.0
    final_temperature: float = 0.0
    temperature_drop_move: int = 30
    recycle: bool = False


class MoveRecord(NamedTuple):
    action: torch.Tensor  # i32 [B]
    policy: torch.Tensor  # f32 [B, A] normalized root visit distribution
    root_value: torch.Tensor  # f32 [B]
    to_play: torch.Tensor  # i32 [B] player who chose the move
    active: torch.Tensor  # bool [B] game was live when the move was made
    ended_winner: torch.Tensor  # i32 [B] winner if the game ENDED on this
    #   move (-1 draw, 0/1 win), else -2
    states: Any  # pre-move env states (None unless record_states)


class SelfPlayOutput(NamedTuple):
    states: Any  # final env states
    actions: torch.Tensor  # i32 [T, B]
    policies: torch.Tensor  # f32 [T, B, A]
    root_values: torch.Tensor  # f32 [T, B]
    to_play: torch.Tensor  # i32 [T, B]
    active: torch.Tensor  # bool [T, B]
    ended_winner: torch.Tensor  # i32 [T, B] (-2 none)
    winner: torch.Tensor  # i32 [B] -1 draw/unfinished, 0, 1
    length: torch.Tensor  # i32 [B] moves actually played
    move_states: Any  # pre-move env states per move (None unless recorded)


def _step_and_record(env, states, action, policy, root_value, active,
                     config: SelfPlayConfig, record_states: bool):
    """Apply the chosen actions, detect segment ends, optionally recycle
    finished lanes into fresh games."""
    new_states = env.step(states, action)
    done = env.terminal_flag(new_states)
    ended = active & done
    ended_winner = torch.where(ended, env.winner(new_states), -2).to(torch.int32)
    record = MoveRecord(
        action=action,
        policy=policy,
        root_value=root_value,
        to_play=env.to_play(states),
        active=active,
        ended_winner=ended_winner,
        states=states if record_states else None,
    )
    if config.recycle:
        if config.mcts.tree_reuse:
            raise ValueError("recycle is incompatible with tree_reuse")
        fresh = env.init(action.shape[0], device=action.device)
        new_states = where_lanes(done, fresh, new_states)
    return new_states, record


def _temperature(states, config: SelfPlayConfig) -> torch.Tensor:
    return torch.where(states.move_count < config.temperature_drop_move,
                       config.temperature, config.final_temperature).float()


@torch.no_grad()
def move_once(env, eval_fn: EvalFn, states, generator: torch.Generator | None,
              config: SelfPlayConfig, record_states: bool = False):
    """One move for every lane: search -> temperature select -> step.
    Returns ``(new_states, MoveRecord)``; the policy is the search's
    ``action_weights``."""
    out = search(env, eval_fn, states, config.mcts, generator)
    action = select_action(generator, out.visit_counts,
                           _temperature(states, config))
    active = ~env.terminal_flag(states)
    return _step_and_record(env, states, action, out.action_weights,
                            out.root_value, active, config, record_states)


def play_games(env, eval_fn: EvalFn, generator: torch.Generator | None,
               config: SelfPlayConfig, batch_size: int, initial_states=None,
               record_states: bool = False, device="cuda") -> SelfPlayOutput:
    """Play ``config.max_moves`` moves of ``batch_size`` games from
    ``initial_states`` (default: fresh games on ``device``); lanes whose
    game ended step as no-ops (or restart, with ``recycle``)."""
    check_config(config.mcts)
    states = (initial_states if initial_states is not None
              else env.init(batch_size, device=device))
    records = []
    for _ in range(config.max_moves):
        states, rec = move_once(env, eval_fn, states, generator, config,
                                record_states)
        records.append(rec)
    return stack_records(env, states, records)


def stack_records(env, final_states, records) -> SelfPlayOutput:
    """The ``SelfPlayOutput`` of a host-driven move loop: its per-move
    ``MoveRecord``s stacked along a leading T axis, and the final states."""
    active = torch.stack([r.active for r in records])
    recorded = records[0].states is not None
    return SelfPlayOutput(
        states=final_states,
        actions=torch.stack([r.action for r in records]),
        policies=torch.stack([r.policy for r in records]),
        root_values=torch.stack([r.root_value for r in records]),
        to_play=torch.stack([r.to_play for r in records]),
        active=active,
        ended_winner=torch.stack([r.ended_winner for r in records]),
        winner=env.winner(final_states),
        length=active.sum(0).to(torch.int32),
        move_states=stack_states([r.states for r in records]) if recorded else None,
    )


def value_targets(output: SelfPlayOutput) -> torch.Tensor:
    """z targets [T, B]: the final result from the perspective of the player
    to move at each recorded position (one game per lane, no recycling)."""
    winner = output.winner[None, :]
    won = torch.where(winner == output.to_play, 1.0, -1.0)
    return torch.where(winner < 0, 0.0, won).float()


def value_targets_recycled(output: SelfPlayOutput):
    """(z [T, B], valid [T, B]) for recycled self-play: each move's result is
    the winner of the segment it belongs to, found by carrying
    ``ended_winner`` backward in time; moves of segments unfinished within
    the window are masked out."""
    ew = output.ended_winner
    w_seq = torch.empty_like(ew)
    carry = torch.full_like(ew[0], -2)
    for t in range(ew.shape[0] - 1, -1, -1):
        carry = torch.where(ew[t] != -2, ew[t], carry)
        w_seq[t] = carry
    won = torch.where(w_seq == output.to_play, 1.0, -1.0)
    z = torch.where(w_seq < 0, 0.0, won).float()
    valid = output.active & (w_seq != -2)
    return z, valid


def make_host_actor(env, eval_fn: EvalFn, config: SelfPlayConfig,
                    batch_size: int, device="cuda", record_states: bool = False):
    """Returns ``(step, init_states)``; ``step(states, generator=None)``
    yields ``(new_states, MoveRecord)`` for one move of every lane.  The
    last move's ``SearchOutput`` stays readable as ``step.last_search``.

    With ``config.mcts.tree_reuse`` the search keeps each game's tree
    between moves (``step.search``, a ``HostReuseSearch``, told each played
    action): call ``step.reset()`` before feeding ``step`` root states
    unrelated to the previous move's games."""
    reuse = config.mcts.tree_reuse
    if reuse:
        run_search = HostReuseSearch(env, eval_fn, config.mcts)
    else:
        run_search = make_host_search(env, eval_fn, config.mcts)

    @torch.no_grad()
    def step(states, generator: torch.Generator | None = None):
        out = run_search(states, generator)
        action = select_action(generator, out.visit_counts,
                               _temperature(states, config))
        active = ~env.terminal_flag(states)
        counts = out.visit_counts
        policy = counts / counts.sum(-1, keepdim=True).clamp(min=1)
        step.last_search = out
        new_states, record = _step_and_record(
            env, states, action, policy.float(), out.root_value, active,
            config, record_states)
        if reuse:
            run_search.notify_action(record.action)
        return new_states, record

    step.last_search = None
    step.reset = run_search.reset if reuse else (lambda: None)
    step.search = run_search
    return step, env.init(batch_size, device=device)
