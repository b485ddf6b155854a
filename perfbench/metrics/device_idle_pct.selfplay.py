"""Device layer: the share of the traced steps in which no device
activity ran: one less the union of all activity intervals over the traced
steps' length at the pace of the run's untraced steps (the profiler's own
cost left out)."""


def read(s):
    if not s["window_s"] or not s["busy_s"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
