"""Executor layer: device time of the kernels launched inside the
evaluator's calls (the union of their intervals) per position evaluated,
over the traced steps."""


def read(s):
    if not s["positions"] or not s["range_busy_s"]:
        return None
    return s["range_busy_s"] / s["positions"] * 1e6
