"""Whole step: twice the net's multiply-adds a position
(``yardstick.resnet_macs``) times the positions evaluated in the traced
steps, over the traced steps' length at the pace of the run's untraced
steps and the peak of the precision the configuration states for its
convolutions."""
from perfbench import yardstick


def read(s):
    if not s["positions"] or not s["window_s"]:
        return None
    ops = 2.0 * s["macs_per_position"] * s["positions"]
    return 100.0 * ops / s["window_s"] / yardstick.PEAK_OPS[s["precision"]]
