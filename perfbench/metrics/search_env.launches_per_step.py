"""Actor, search and env layers: device activities launched inside
``actor.step`` and outside ``eval`` spans, per traced step.  Nothing where
the run recorded no spans."""


def read(s):
    j = s.get("spans")
    if not j or not j["traced_steps"] or not j["activities"]:
        return None
    return j["outside_eval_launches"] / j["traced_steps"]
