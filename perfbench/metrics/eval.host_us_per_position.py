"""Executor layer: host wall time of the ``eval`` spans (the evaluator's
calls, enqueue and any wait) per position evaluated, over the untraced
window steps.  Nothing where the run recorded no spans."""


def read(s):
    j = s.get("spans")
    if not j or not j["host_positions"]:
        return None
    return j["host_eval_s"] / j["host_positions"] * 1e6
