"""Device programs (``core/engine_step.py``, ``core/vectorized.py``):
host milliseconds blocked in the program's ``*.readback`` spans (each
megastep loop condition, each digest's copy to the host) per megastep
loop iteration, over the window up to the profiler's start: how long the
host waits on the card, against ``ms_per_iteration``'s whole. Moves
``qps``."""
from portbench import program_spans


def read(ctx):
    d = program_spans.delta(ctx)
    n = ctx.counters1["loop_iterations"] - ctx.counters0["loop_iterations"]
    if d is None or n <= 0:
        return None
    s = sum(v["s"] for k, v in d.items()
            if k == "readback" or k.endswith(".readback"))
    return 1e3 * s / n
