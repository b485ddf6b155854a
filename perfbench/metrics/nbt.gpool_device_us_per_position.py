"""Executor layer: device time of the activities launched inside the
nested-bottleneck trunk's ``eval.nbt.gpool`` spans (the global pooling,
its dense layer and the broadcast add) per position evaluated, over the
traced steps.  Nothing where the run recorded no nbt spans."""


def read(s):
    j = s.get("nbt")
    if not j or not j["gpool_s"] or not s["positions"]:
        return None
    return j["gpool_s"] / s["positions"] * 1e6
