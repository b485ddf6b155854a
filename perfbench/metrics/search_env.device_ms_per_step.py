"""Actor, search and env layers: device time outside the evaluator's calls
(busy time less the evaluator's) per traced step."""


def read(s):
    if not s["steps"] or not s["busy_s"]:
        return None
    return (s["busy_s"] - s["range_busy_s"]) / s["steps"] * 1e3
