"""Front door (``api/session.py``): host milliseconds a query spends in
the program's ``submit`` span (``MatchSession.submit``: candidates,
order, packing, retiring trivial queries), over the window up to the
profiler's start. Moves ``qps``: the closed loop submits on the thread
that drives the card."""
from portbench import program_spans


def read(ctx):
    d = program_spans.delta(ctx)
    if d is None or d.get("submit", {"n": 0})["n"] <= 0:
        return None
    return 1e3 * d["submit"]["s"] / d["submit"]["n"]
