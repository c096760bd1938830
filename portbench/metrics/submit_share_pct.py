"""Front door (``serving/query_server.py``, ``api/session.py``): the
share of the window the host spent inside ``submit_async`` (the
harness's own span around each call). Moves ``qps``."""


def read(ctx):
    return 100.0 * ctx.submit_s / ctx.window_s
