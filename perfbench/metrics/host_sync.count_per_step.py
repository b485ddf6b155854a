"""Actor, search and env layers: the program's blocking host reads (the
``host_sync.*`` counters) per recorded window step.  Nothing where the run
recorded no spans."""


def read(s):
    j = s.get("spans")
    if not j or not j["steps"]:
        return None
    return j["syncs"] / j["steps"]
