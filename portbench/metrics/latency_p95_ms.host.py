"""Scheduler: the 95th percentile of submit to completion over the
window's queries, as the end-to-end ``latency_p95_ms`` defines it (one
still running at the close counts at its age then), read in the traced
run. It stands for that tail in a cell where the tail spreads too widely
from run to run to hold a bound: how the scheduler shares its waves
among slots sets it. Moves ``qps``."""
from portbench import stats


def read(ctx):
    return stats.p95_ms(stats.latencies_s(ctx.jobs, ctx.t0, ctx.t1))
