"""Executor layer: device activities (kernels, copies, fills) launched
inside ``eval`` spans, markers left out, per position evaluated, over the
traced steps.  Nothing where the run recorded no spans
or traced no device activity."""


def read(s):
    j = s.get("spans")
    if not j or not j["traced_positions"] or not j["activities"]:
        return None
    return j["eval_launches"] / j["traced_positions"]
