"""Device: the share of the profiled part in which no operation ran on
the program's stream. Moves ``qps``: an idle card waits on the host."""


def read(ctx):
    if ctx.profile is None or ctx.profile.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.profile.busy_s / ctx.profile.window_s)
