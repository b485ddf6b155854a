"""Readings that the limits of ``correct`` are set from, for the
nested-bottleneck cell, on the card.

    python3 perfbench/control_nbt.py --workload go19-b18c384nbt.selfplay \\
        --seeds 11 12 13 ... [--seconds 12]

``control.py`` run from a fresh copy whose ``control_outputs`` is rebound
to the plain nbt reference (``reference/nbt.py``) at the configuration's
``plain_int`` bits: one JSON line a seed, the program's numbers and the
control's on the same rows, each with its verdict under the cell's
committed limits.  ``--seconds`` has to cover the cell's check steps (0
and 1), whole steps of several seconds each.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_outputs(cell, rows: dict, weights: dict, seed: int, device):
    """(logits, value) of the nbt reference at ``bits``-bit trunk convs on
    ``rows['obs']``."""
    from perfbench.reference import nbt as ref_nbt

    spec = cell.config["control"]
    if spec["kind"] != "plain_int":
        raise ValueError(f"unknown control {spec['kind']!r}")
    w = {k: v.to(device) for k, v in weights.items()}
    return ref_nbt.forward_blocks(w, rows["obs"].to(device),
                                  int(cell.config["net"]["num_blocks"]),
                                  bits=int(spec["bits"]))


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT))
    from perfbench import harness

    nbt = harness.load_module(harness.HERE / "traffic" / "selfplay_nbt.py")
    control = nbt.fresh_copy("control")
    control.control_outputs = control_outputs
    return control.main(argv)


if __name__ == "__main__":
    sys.exit(main())
