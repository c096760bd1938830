"""Delta store (``patterns/store.py``): dead-end prunes over prunes plus
rows created in the window (``scheduler_stats()`` ``deadend_prunes`` and
``rows_created``). Moves ``qps``: a pruned row is work not done."""


def read(ctx):
    p = ctx.counters1["deadend_prunes"] - ctx.counters0["deadend_prunes"]
    r = ctx.counters1["rows_created"] - ctx.counters0["rows_created"]
    return 100.0 * p / (p + r) if p + r > 0 else None
