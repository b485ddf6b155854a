"""Fuzz the port's Renju ``forbidden_map`` against the reference-semantics
oracle (counterpart of ``tools/fuzz_renju.py``: the same boards from the
same seed, the same classes).

``tests/renju_oracle.py`` is a NumPy transliteration of the reference
engine's ``is_black_renju_forbidden`` chain.  The sweep draws random
non-terminal mid-game boards and compares every empty cell's verdict:

  class FIVE  -- cells where black's stone makes an exact five: the port
                 applies Renju's five precedence (a five is never
                 forbidden); the reference does not check fives in its
                 forbidden chain.  A deliberate divergence.
  class OTHER -- anything else, classed by the oracle's deciding stage.

All boards go through ``forbidden_map`` in one batch on ``--device``.

    python -m alphazero_tpu_torch.tools.fuzz_renju [n_boards] [board_size] [seed]
        [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from alphazero_tpu_torch.tools import _common


def random_board(rng, bs, max_stones):
    """Alternate random stones; a placement that makes five in a row is
    taken back, so the position is non-terminal."""
    board = np.zeros((bs, bs), np.int8)
    player = 1
    stones = rng.integers(6, max_stones + 1)
    tries = 0
    placed = 0
    while placed < stones and tries < 10 * max_stones:
        tries += 1
        x, y = rng.integers(0, bs, 2)
        if board[x, y]:
            continue
        board[x, y] = player
        if has_five(board, player):
            board[x, y] = 0
            continue
        player = 3 - player
        placed += 1
    return board


def _shift(m, dx, dy):
    """``m`` moved by (-dx, -dy) with the wrapped cells cleared."""
    m = np.roll(np.roll(m, -dx, 0), -dy, 1)
    if dx:
        m[-dx:, :] = False
    if dy > 0:
        m[:, -dy:] = False
    elif dy < 0:
        m[:, :(-dy)] = False
    return m


def has_five(board, player):
    """True if ``player`` has five in a row on ``board``."""
    for dx, dy in ((0, 1), (1, 0), (1, 1), (1, -1)):
        m = board == player
        run = m.copy()
        for _ in range(4):
            run = run & np.roll(np.roll(m, -dx, 0), -dy, 1)
            if dx:
                run[-dx:, :] = False
            if dy > 0:
                run[:, -dy:] = False
            elif dy < 0:
                run[:, :(-dy)] = False
            m = _shift(m, dx, dy)
        if run.any():
            return True
    return False


def _oracle():
    tests = os.path.join(_common.ROOT, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    from renju_oracle import RenjuOracle

    return RenjuOracle


def compare_board(board, ours_forbidden, ours_five):
    """(n_cells, five_divergence, other_divergence_list) of one board, the
    port's verdicts given as [N, N] bool arrays."""
    oracle = _oracle()(board)
    bs = board.shape[0]
    n = five_div = 0
    others = []
    for x in range(bs):
        for y in range(bs):
            if board[x, y]:
                continue
            n += 1
            a = x * bs + y
            ref = oracle.is_black_renju_forbidden(a)
            # The env's effective rule: forbidden and not five.
            eff = bool(ours_forbidden[x, y]) and not bool(ours_five[x, y])
            if eff == ref:
                continue
            if bool(ours_five[x, y]) and ref:
                five_div += 1
                continue
            if oracle.renju_is_overline(a):
                stage = "overline"
            elif oracle.renju_double_four_or_more(a):
                # Do the reference's fours pass through the action?  Its
                # four count is board-global.
                oracle.extra_black.add(a)
                thru = _fours_through_action(oracle, a)
                oracle.extra_black.discard(a)
                stage = "d4-through" if thru >= 2 else "d4-global"
            else:
                stage = "double-three"
            others.append((x, y, ref, bool(ours_forbidden[x, y]), stage))
    return n, five_div, others


def _fours_through_action(oracle, action):
    """The oracle's four shapes whose black set holds ``action``."""
    found = []
    bs = oracle.bs
    for x in range(bs):
        for y in range(bs):
            for dx, dy in ((0, 1), (1, 0), (1, 1), (-1, 1)):
                line = []
                xx, yy = x, y
                for _ in range(7):
                    if not oracle.in_bounds(xx, yy):
                        break
                    line.append((xx, yy))
                    xx += dx
                    yy += dy
                for w in (5, 6, 7):
                    if len(line) < w:
                        break
                    for s in range(len(line) - w + 1):
                        seg = line[s:s + w]
                        if oracle.renju_is_four_shape(seg):
                            blk = oracle.positions_of_black(seg)
                            if action not in blk:
                                continue
                            if not any(len(blk & f) >= 3 for f in found):
                                found.append(blk)
    return len(found)


def sweep(n_boards: int, bs: int, seed: int, device="cuda") -> dict:
    """The sweep's counts: cells, five-precedence divergences, the other
    divergences by (stage, side), and up to three boards with them."""
    import torch

    from alphazero_tpu_torch.games.gomoku import GomokuEnv

    rng = np.random.default_rng(seed)
    boards = np.stack([random_board(rng, bs, max_stones=min(2 * bs * bs // 3, 40))
                       for _ in range(n_boards)])
    env = GomokuEnv(board_size=bs, use_renju=True)
    b = torch.as_tensor(boards, device=device)
    forbidden, five = env.forbidden_map(b == 1, b == 2)
    forbidden, five = forbidden.cpu().numpy(), five.cpu().numpy()
    total = fives = 0
    all_others = []
    for i, board in enumerate(boards):
        n, f, others = compare_board(board, forbidden[i], five[i])
        total += n
        fives += f
        if others:
            all_others.append((board, others))
        if (i + 1) % 100 == 0:
            print(f"{i+1}/{n_boards} boards, {total} cells, five-precedence {fives}, "
                  f"other {sum(len(o[1]) for o in all_others)}", flush=True)
    by_stage = {}
    for _, others in all_others:
        for *_, ref, _f, stage in others:
            key = (stage, "ref-forbids" if ref else "ours-forbids")
            by_stage[key] = by_stage.get(key, 0) + 1
    return {"boards": n_boards, "cells": total, "five": fives,
            "other": sum(len(o[1]) for o in all_others), "by_stage": by_stage,
            "examples": all_others[:3]}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("n_boards", nargs="?", type=int, default=500)
    p.add_argument("board_size", nargs="?", type=int, default=9)
    p.add_argument("seed", nargs="?", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)
    res = sweep(args.n_boards, args.board_size, args.seed, args.device)
    print(f"\nDONE: {res['boards']} boards, {res['cells']} cells compared")
    print(f"five-precedence divergences (deliberate): {res['five']}")
    print(f"OTHER divergences: {res['other']}")
    for key, cnt in sorted(res["by_stage"].items()):
        print(f"  {key}: {cnt}")
    for board, others in res["examples"]:
        print("-" * 40)
        print(board)
        for x, y, ref, ours_f, stage in others:
            print(f"  cell ({x},{y}): ref={ref} ours={ours_f} stage={stage}")
    return res


if __name__ == "__main__":
    main()
