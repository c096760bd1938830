"""Scheduler (``core/vectorized.py``): stack overflows exported to host
segments in the window (``scheduler_stats()["wedge_exports"]``) per query
answered in it. Moves ``latency_p95_ms``: an exported query leaves the
device stacks for the host megastep."""


def read(ctx):
    if ctx.completed == 0:
        return None
    n = ctx.counters1["wedge_exports"] - ctx.counters0["wedge_exports"]
    return n / ctx.completed
