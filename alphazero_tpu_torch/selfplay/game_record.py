"""Game records: JSON serialization of finished games (counterpart of
``alphazero_tpu/selfplay/game_record.py``, same schema): ``game_type,
board_size, use_variant_rules, moves[{action, policy[], value,
thinking_time_ms}], result, timestamp``.  Stored policies are
full-action-space visit distributions.

``records_to_training_arrays`` replays records through the env into
training arrays.  ``to_json_bytes`` uses the native encoder
(``native/azrecord.cpp``) where it builds, else ``json``: both write the
same bytes.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import time
from typing import List, Optional

import numpy as np
import torch

from alphazero_tpu_torch.core.types import GameResult, GameType, stack_states


@dataclasses.dataclass
class MoveData:
    action: int
    policy: List[float]
    value: float
    thinking_time_ms: int = 0

    def to_json(self):
        return {
            "action": int(self.action),
            "policy": [float(p) for p in self.policy],
            "value": float(self.value),
            "thinking_time_ms": int(self.thinking_time_ms),
        }

    @classmethod
    def from_json(cls, d):
        return cls(
            action=int(d["action"]),
            policy=[float(p) for p in d.get("policy", [])],
            value=float(d.get("value", 0.0)),
            thinking_time_ms=int(d.get("thinking_time_ms", 0)),
        )


@dataclasses.dataclass
class GameRecord:
    game_type: GameType
    board_size: int
    use_variant_rules: bool = False
    moves: List[MoveData] = dataclasses.field(default_factory=list)
    result: GameResult = GameResult.ONGOING
    timestamp: Optional[str] = None

    def add_move(self, action, policy, value, thinking_time_ms=0):
        self.moves.append(
            MoveData(int(action), list(np.asarray(policy, dtype=float)),
                     float(value), int(thinking_time_ms))
        )

    def set_result(self, result: GameResult):
        self.result = GameResult(result)

    def to_json(self) -> dict:
        return {
            "game_type": int(self.game_type),
            "board_size": int(self.board_size),
            "use_variant_rules": bool(self.use_variant_rules),
            "moves": [m.to_json() for m in self.moves],
            "result": int(self.result),
            "timestamp": self.timestamp or time.strftime("%Y-%m-%dT%H:%M:%S"),
        }

    @classmethod
    def from_json(cls, d: dict) -> "GameRecord":
        rec = cls(
            game_type=GameType(d["game_type"]),
            board_size=int(d["board_size"]),
            use_variant_rules=bool(d.get("use_variant_rules", False)),
            result=GameResult(d.get("result", 0)),
            timestamp=d.get("timestamp"),
        )
        rec.moves = [MoveData.from_json(m) for m in d.get("moves", [])]
        return rec

    def to_json_bytes(self) -> bytes:
        """``json.dumps(self.to_json()).encode()``, written by the native
        encoder where it is available."""
        from alphazero_tpu_torch.native import get_azrecord

        mod = get_azrecord()
        if mod is None:
            return json.dumps(self.to_json()).encode()
        moves = self.moves
        lens = [len(m.policy) for m in moves]
        offsets = np.zeros(len(moves) + 1, np.int64)
        np.cumsum(lens, out=offsets[1:])
        policies = np.fromiter((p for m in moves for p in m.policy),
                               np.float64, count=int(offsets[-1]))
        return mod.encode_game(
            int(self.game_type), int(self.board_size),
            bool(self.use_variant_rules),
            np.array([int(m.action) for m in moves], np.int64), policies,
            offsets, np.array([float(m.value) for m in moves], np.float64),
            np.array([int(m.thinking_time_ms) for m in moves], np.int64),
            int(self.result),
            self.timestamp or time.strftime("%Y-%m-%dT%H:%M:%S"))

    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            f.write(self.to_json_bytes())

    @classmethod
    def load(cls, path: str) -> "GameRecord":
        with open(path) as f:
            return cls.from_json(json.load(f))


def records_from_selfplay(env, output, max_games: Optional[int] = None,
                          use_variant_rules: bool = False,
                          think_ms=None) -> List[GameRecord]:
    """Convert a SelfPlayOutput (selfplay/actor.py) into GameRecords, one per
    lane (its first game when lanes were not recycled).  ``think_ms`` is an
    optional [T] array of per-move wall times."""
    actions = output.actions.cpu().numpy()  # [T, B]
    policies = output.policies.cpu().numpy()
    values = output.root_values.cpu().numpy()
    active = output.active.cpu().numpy()
    winner = output.winner.cpu().numpy()
    T, B = actions.shape
    n_games = B if max_games is None else min(B, max_games)
    tms = (np.zeros(T, np.int32) if think_ms is None
           else np.asarray(think_ms, np.int32))

    records = []
    for b in range(n_games):
        rec = GameRecord(game_type=env.game_type, board_size=env.board_size,
                         use_variant_rules=use_variant_rules)
        for t in range(T):
            if not active[t, b]:
                break
            rec.add_move(actions[t, b], policies[t, b], values[t, b],
                         thinking_time_ms=tms[t])
        if winner[b] == 0:
            rec.set_result(GameResult.WIN_PLAYER1)
        elif winner[b] == 1:
            rec.set_result(GameResult.WIN_PLAYER2)
        else:
            rec.set_result(GameResult.DRAW)
        records.append(rec)
    return records


def records_to_training_arrays(env, records: List[GameRecord], device="cuda"):
    """Replay saved GameRecords through the env to regenerate the states
    (the reference's ``Dataset::extractExamples``: each record replayed
    from a fresh state, the value target the final result from the side to
    move).

    Returns ``(states, policy, z, mask)`` with leading dims [T, G]: the
    pre-move states, full-action-space policy targets, +-1/0 value targets
    and a validity mask.  A stored policy that is not full-action-space (or
    sums to 0) becomes a one-hot of the played action."""
    G = len(records)
    if G == 0:
        raise ValueError("no records to ingest")
    lens = [len(r.moves) for r in records]
    T = max(lens)
    A = env.num_actions

    actions = np.zeros((T, G), np.int32)
    policies = np.zeros((T, G, A), np.float32)
    winner = np.full((G,), -1, np.int32)
    for g, rec in enumerate(records):
        if rec.result == GameResult.WIN_PLAYER1:
            winner[g] = 0
        elif rec.result == GameResult.WIN_PLAYER2:
            winner[g] = 1
        for t, m in enumerate(rec.moves):
            actions[t, g] = m.action
            pol = np.asarray(m.policy, np.float32)
            if pol.shape[0] == A and pol.sum() > 0:
                policies[t, g] = pol / pol.sum()
            else:
                policies[t, g, m.action] = 1.0

    states = env.init(G, device=device)
    per_move = []
    for t in range(T):
        per_move.append(states)
        states = env.step(states, torch.from_numpy(actions[t]).to(device))
    states_t = stack_states(per_move)
    w = torch.from_numpy(winner).to(device)[None, :]
    tp = torch.stack([env.to_play(s) for s in per_move])
    z = torch.where(w < 0, 0.0, torch.where(w == tp, 1.0, -1.0)).float()
    mask = torch.from_numpy(np.arange(T)[:, None] < np.asarray(lens)[None, :])
    return states_t, torch.from_numpy(policies).to(device), z, mask.to(device)


def load_records_dir(games_dir: str) -> List[GameRecord]:
    """Every ``*.json`` GameRecord in a directory, in name order."""
    paths = sorted(glob.glob(os.path.join(games_dir, "*.json")))
    return [GameRecord.load(p) for p in paths]
