"""Plotting utilities: training curves, Elo history, board heatmaps
(counterpart of ``alphazero_tpu/utils/visualization.py``).

Each figure is drawn with matplotlib's Agg backend exactly as the JAX
package draws it, from data that a small numpy helper computes:
``training_curves``, ``elo_trajectories`` and ``heat_grid``.  matplotlib is
imported only when a figure is drawn; without it the plot functions raise
the ``ImportError`` that the JAX package's would.  Every plot function
returns the save path.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from alphazero_tpu_torch.elo.tracker import elo_change

CURVES = (("loss", "Total loss"), ("policy_loss", "Policy loss"),
          ("value_loss", "Value loss"))


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(plt, fig, out_path: str) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def training_curves(history: List[Dict]) -> Tuple[List, Dict[str, List]]:
    """(iterations, {loss key: values}) of the history entries that have a
    loss (pipeline ``history.json`` entries)."""
    hist = [h for h in history if "loss" in h]
    return ([h["iteration"] for h in hist],
            {key: [h[key] for h in hist] for key, _ in CURVES})


def elo_trajectories(tracker) -> Tuple[Dict[str, List[int]], Dict[str, List[float]]]:
    """(match indices, ratings) a player: an ``EloTracker``'s history
    replayed with ``elo_change``, each player starting from its rating
    before its first match."""
    ratings: Dict[str, List[float]] = {}
    xs: Dict[str, List[int]] = {}
    current: Dict[str, float] = {}
    for i, m in enumerate(tracker.history):
        for name, before in ((m.player_a, m.rating_a_before),
                             (m.player_b, m.rating_b_before)):
            current.setdefault(name, before)
        d = elo_change(current[m.player_a], current[m.player_b], m.score_a,
                       tracker.k)
        current[m.player_a] += d
        current[m.player_b] -= d
        for name in (m.player_a, m.player_b):
            ratings.setdefault(name, []).append(current[name])
            xs.setdefault(name, []).append(i)
    return xs, ratings


def heat_grid(board: np.ndarray, weights: np.ndarray):
    """(n x n heat grid from the first n*n weights, black stones (r, c),
    white stones (r, c)) of a board whose cells hold 0 black, 1 white."""
    board = np.asarray(board)
    n = board.shape[0]
    grid = np.asarray(weights, dtype=float)[: n * n].reshape(n, n)
    black = [(r, c) for r in range(n) for c in range(n) if board[r, c] == 0]
    white = [(r, c) for r in range(n) for c in range(n) if board[r, c] == 1]
    return grid, black, white


def plot_training_history(history: List[Dict], out_path: str) -> str:
    """Loss / policy / value curves from pipeline history entries."""
    plt = _plt()
    its, curves = training_curves(history)
    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    for ax, (key, title) in zip(axes, CURVES):
        ax.plot(its, curves[key])
        ax.set_title(title)
        ax.set_xlabel("iteration")
        ax.grid(alpha=0.3)
    fig.tight_layout()
    return _save(plt, fig, out_path)


def plot_elo_history(tracker, out_path: str,
                     players: Optional[Sequence[str]] = None) -> str:
    """Per-player rating trajectories from an EloTracker's match history."""
    plt = _plt()
    xs, ratings = elo_trajectories(tracker)
    fig, ax = plt.subplots(figsize=(8, 5))
    for name in (players or ratings):
        if name in ratings:
            ax.plot(xs[name], ratings[name], label=name)
    ax.set_xlabel("match")
    ax.set_ylabel("Elo")
    ax.legend()
    ax.grid(alpha=0.3)
    return _save(plt, fig, out_path)


def plot_board_heatmap(board: np.ndarray, weights: np.ndarray,
                       out_path: str, title: str = "policy") -> str:
    """Board with a per-cell heat overlay (e.g. visit distribution)."""
    plt = _plt()
    grid, black, white = heat_grid(board, weights)
    fig, ax = plt.subplots(figsize=(6, 6))
    im = ax.imshow(grid, cmap="viridis", origin="lower")
    # The stones in the JAX package's order: row by row, each cell once.
    stones = sorted([(rc, 0) for rc in black] + [(rc, 1) for rc in white])
    for (r, c), colour in stones:
        if colour == 0:
            ax.plot(c, r, "o", color="black", markersize=12)
        else:
            ax.plot(c, r, "o", color="white", markersize=12,
                    markeredgecolor="black")
    ax.set_title(title)
    fig.colorbar(im)
    return _save(plt, fig, out_path)
