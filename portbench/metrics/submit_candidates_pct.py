"""Front door (``core/candidates.py``): the share of the program's
``submit`` seconds spent in ``submit.candidates`` (the LDF, NLF and CFL
filters), over the window up to the profiler's start. Moves ``qps``."""
from portbench import program_spans


def read(ctx):
    d = program_spans.delta(ctx)
    if d is None or program_spans.seconds(d, "submit") <= 0:
        return None
    return (100.0 * program_spans.seconds(d, "submit.candidates")
            / program_spans.seconds(d, "submit"))
