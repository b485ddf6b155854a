"""Search layer: the share of the rows the search evaluates that become
new nodes (``search.new_nodes`` over ``search.rows``); duplicate walkers
and terminal leaves are evaluated and then dropped.  Nothing where the run
recorded no spans."""


def read(s):
    j = s.get("spans")
    if not j or not j["rows"]:
        return None
    return 100.0 * j["new_nodes"] / j["rows"]
