"""Device programs (``core/engine_step.py``): device kernels on the
program's stream in the profiled part of the window over the megastep
loop iterations in it. Moves ``qps``: the loop is issued op by op from
the host."""


def read(ctx):
    if ctx.profile is None or ctx.profile_iterations <= 0:
        return None
    return ctx.profile.n_kernels / ctx.profile_iterations
