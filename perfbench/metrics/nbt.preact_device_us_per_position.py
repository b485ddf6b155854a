"""Executor layer: device time of the activities launched inside the
nested-bottleneck trunk's ``eval.nbt.preact`` spans (each pre-activation
norm and Mish, the residual add before each, and the Mish after each
folded conv) per position evaluated, over the traced steps.  Nothing where
the run recorded no nbt spans."""


def read(s):
    j = s.get("nbt")
    if not j or not j["preact_s"] or not s["positions"]:
        return None
    return j["preact_s"] / s["positions"] * 1e6
