"""Actor, search and env layers: ``actor.step`` wall time less its ``eval``
spans and its ``host_sync`` spans outside them, per untraced window step:
the host's own time in the layers around the evaluator.  Nothing where the
run recorded no spans."""


def read(s):
    j = s.get("spans")
    if not j or not j["host_steps"]:
        return None
    own = j["host_step_s"] - j["host_eval_s"] - j["host_sync_s"]
    return own / j["host_steps"] * 1e3
