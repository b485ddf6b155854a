"""Tiny versions of the cells, for runs on the CPU."""
import time

import torch

from perfbench import harness

CELLS = {"gomoku": "gomoku15-6x64.selfplay", "go": "go9-6x64.selfplay"}
BOARD = {"gomoku": 7, "go": 5}
LIMITS = {"gomoku": {"policy_tv_max": 0.05, "value_gap_max": 0.05},
          "go": {"policy_tv_max": 0.05}}


# The control's size: at 2 blocks of 32 channels the control read wider
# gaps than the program on each of seeds 1000-1007 on the CPU (Gomoku: the
# program's policy distance 0.0065 and value gap 0.0193 at most, the
# control's 0.0106 and 0.0299 at least; Go: 0.0012 against 0.0019), and
# these limits lie between.  At 1 x 16 the two overlap.
CONTROL_NET = {"num_blocks": 2, "channels": 32}
CONTROL_LIMITS = {"gomoku": {"policy_tv_max": 0.0085, "value_gap_max": 0.025},
                  "go": {"policy_tv_max": 0.0016}}


def overrides(game: str, lanes: int = 8, control: bool = False) -> dict:
    # The program's tiny nets read gaps under 0.01 (policy total variation
    # and value); the limits at this size sit well above.
    limits = CONTROL_LIMITS if control else LIMITS
    net = {"num_blocks": 1, "channels": 16, "policy_channels": 4,
           "value_channels": 4, "value_hidden": 16}
    if control:
        net.update(CONTROL_NET)
    return {"cell": {"limits": dict(limits[game])},
            "config": {"game": {"board_size": BOARD[game]},
                       "net": net,
                       "search": {"num_simulations": 32, "wave_size": 4},
                       "executor": {"calib_games": 8, "calib_plies": 4},
                       "control": {"calib_games": 8, "calib_plies": 4}},
            "mix": {"lanes": lanes, "opening_plies": 4, "search_lanes": 3,
                    "env_lanes": lanes}}


def cell(game: str, **kw):
    return harness.find_cell(CELLS[game], overrides=overrides(game, **kw))


def run(game: str, seed: int = 9876543210123, seconds: float = 0.5, **kw):
    c = cell(game, **kw)
    return harness.run(c, seed, seconds, False, torch.device("cpu"),
                       time.perf_counter(), log=lambda m: None)
