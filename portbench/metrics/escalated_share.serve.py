"""The share of the window's submitted live queries that the server escalated
to the rendition scan (EscalatingMatchServer.stats)."""


def read(run):
    s = run.records.get("stats")
    return s["escalated"] / s["submitted"] if s and s["submitted"] else None
