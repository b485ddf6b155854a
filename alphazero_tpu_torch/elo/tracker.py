"""Elo rating tracker (a copy of ``alphazero_tpu/elo/tracker.py``: the port
keeps its own; the JSON file format is the same, so a tracker saved by
either package loads in the other).

Mirrors the reference ``EloTracker`` (``include/alphazero/elo/elo_tracker.h:56-173``,
``src/elo/elo_tracker.cpp``) and the Python ``EloRating``/
``calculate_elo_change`` (``python/alphazero/utils/elo.py:26-43``): expected
score, K=32 updates, initial 1500, match history, JSON persistence.
Host-side Python — rating bookkeeping is not a device workload.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

INITIAL_RATING = 1500.0
DEFAULT_K = 32.0


def expected_score(rating_a: float, rating_b: float) -> float:
    return 1.0 / (1.0 + 10.0 ** ((rating_b - rating_a) / 400.0))


def elo_change(rating_a: float, rating_b: float, score_a: float,
               k: float = DEFAULT_K) -> float:
    """Rating delta for player A given actual score (1 win, 0.5 draw, 0)."""
    return k * (score_a - expected_score(rating_a, rating_b))


@dataclasses.dataclass
class MatchResult:
    player_a: str
    player_b: str
    score_a: float  # 1.0 / 0.5 / 0.0
    rating_a_before: float
    rating_b_before: float
    timestamp: str = ""


class EloTracker:
    def __init__(self, k: float = DEFAULT_K,
                 initial_rating: float = INITIAL_RATING):
        self.k = k
        self.initial_rating = initial_rating
        self.ratings: Dict[str, float] = {}
        self.games_played: Dict[str, int] = {}
        self.history: List[MatchResult] = []

    def get_rating(self, player: str) -> float:
        return self.ratings.get(player, self.initial_rating)

    def add_player(self, player: str, rating: Optional[float] = None):
        self.ratings.setdefault(
            player, self.initial_rating if rating is None else rating
        )
        self.games_played.setdefault(player, 0)

    def add_match_result(self, player_a: str, player_b: str, score_a: float):
        """score_a: 1.0 win for A, 0.5 draw, 0.0 loss."""
        self.add_player(player_a)
        self.add_player(player_b)
        ra, rb = self.ratings[player_a], self.ratings[player_b]
        delta = elo_change(ra, rb, score_a, self.k)
        self.ratings[player_a] = ra + delta
        self.ratings[player_b] = rb - delta
        self.games_played[player_a] += 1
        self.games_played[player_b] += 1
        self.history.append(
            MatchResult(player_a, player_b, score_a, ra, rb,
                        time.strftime("%Y-%m-%dT%H:%M:%S"))
        )

    def add_series(self, player_a: str, player_b: str, wins_a: int,
                   wins_b: int, draws: int):
        for _ in range(wins_a):
            self.add_match_result(player_a, player_b, 1.0)
        for _ in range(wins_b):
            self.add_match_result(player_a, player_b, 0.0)
        for _ in range(draws):
            self.add_match_result(player_a, player_b, 0.5)

    def leaderboard(self) -> List[tuple]:
        return sorted(self.ratings.items(), key=lambda kv: -kv[1])

    # ---- persistence (elo_tracker.h:101-125) ----------------------------

    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(
                {
                    "k": self.k,
                    "initial_rating": self.initial_rating,
                    "ratings": self.ratings,
                    "games_played": self.games_played,
                    "history": [dataclasses.asdict(m) for m in self.history],
                },
                f,
                indent=2,
            )

    @classmethod
    def load(cls, path: str) -> "EloTracker":
        with open(path) as f:
            d = json.load(f)
        t = cls(k=d.get("k", DEFAULT_K),
                initial_rating=d.get("initial_rating", INITIAL_RATING))
        t.ratings = dict(d.get("ratings", {}))
        t.games_played = dict(d.get("games_played", {}))
        t.history = [MatchResult(**m) for m in d.get("history", [])]
        return t
