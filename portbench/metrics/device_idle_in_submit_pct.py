"""Front door (``api/session.py``): the share of the profiled part in
which nothing ran on the program's stream while the harness's thread was
inside the program's ``submit`` span (``repro_torch.submit`` and the
ranges under it, in the run's exported trace): the card idle while the
program submits. Part of ``device_idle_pct``. Moves ``qps``."""
from portbench import program_spans


def read(ctx):
    if ctx.profile is None:
        return None
    idle = program_spans.traced_idle(ctx.cell.name)
    if idle is None or "submit" not in idle.by_span or idle.window_s <= 0:
        return None
    return 100.0 * idle.under("submit") / idle.window_s
