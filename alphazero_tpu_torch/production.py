"""The production inference-executor configuration (counterpart of
``alphazero_tpu/production.py``, same names and values).

One place for the executor knobs that the self-play script, the profiling
scripts and the on-card smoke run share:

  * inference "int8": the s8 trunk of ``models/quant.py`` with percentile
    (clipping) calibration;
  * calibration: mid-game rollout observations
    (``models/quant.make_rollout_calib_fn``), abs-percentile 99.99;
  * residual "int8" (only the s8 activation is carried between blocks),
    heads "bf16", leaf batches evaluated in chunks of 512;
  * tree reuse with the "fixed" budget for match and interactive play;
    training self-play keeps fresh trees.

The values are the JAX package's decision record (strength A/Bs at 800
simulations); nothing here was re-tuned for the card.
"""

# Actor/deployment inference path: "int8" | "folded" | "raw".
INFERENCE = "int8"

# int8 executor knobs (models/quant.py).
INT8_CALIB_PERCENTILE = 99.99
INT8_RESIDUAL = "int8"
INT8_HEADS = "bf16"
INT8_CHUNK = 512

# Calibration-rollout shape (models/quant.make_rollout_calib_fn).
CALIB_GAMES = 256
CALIB_PLIES = 12
CALIB_EVERY = 4

# Match/interactive play (arena, CLI, REST): carry the search tree across
# moves.
MATCH_TREE_REUSE = True
MATCH_REUSE_BUDGET = "fixed"


def executor_config() -> dict:
    """The executor knobs as one comparable dict."""
    return {
        "inference": INFERENCE,
        "int8_calib_percentile": INT8_CALIB_PERCENTILE,
        "int8_residual": INT8_RESIDUAL,
        "int8_heads": INT8_HEADS,
        "int8_chunk": INT8_CHUNK,
        "calib_games": CALIB_GAMES,
        "calib_plies": CALIB_PLIES,
        "calib_every": CALIB_EVERY,
    }
