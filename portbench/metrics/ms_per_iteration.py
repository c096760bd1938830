"""Scheduler (``core/vectorized.py``): window wall time over the
megastep loop iterations it ran (``scheduler_stats()["loop_iterations"]``,
one Eq. 2 refine each). Moves ``qps``."""


def read(ctx):
    n = ctx.counters1["loop_iterations"] - ctx.counters0["loop_iterations"]
    return 1e3 * ctx.window_s / n if n > 0 else None
