"""Kernels (``kernels/bitmap_refine.py``, dense layout): the dense refine
kernel's share of its roofline over the profiled part. The least time
of a call is its least bytes (``peaks.dense_refine_bytes``: candidate
rows read and output rows written once, each distinct adjacency row its
positions name read once) over the card's published HBM bandwidth; the
share is the calls' least time over their profiled device time. The
kernel's operations (one AND a word a position) are far below the
card's integer rate, so bytes bound it. The calls are counted where
``engine_step`` calls ``refine_bitmap_rows``; where the profiled launches
outnumber them (the kernel called from elsewhere), nothing is read.
Moves ``qps``."""
import sys

from portbench.peaks import hbm_bytes_per_s


def read(ctx):
    if ctx.profile is None:
        return None
    calls, nbytes = ctx.dense_refine
    n, seconds = ctx.profile.kernels_matching("refine_rows_kernel")
    peak = hbm_bytes_per_s(ctx.device_kind)
    if calls == 0 or n == 0 or seconds <= 0 or peak is None:
        return None
    if n != calls:
        # the bytes are counted at one call site (``refine_count``): a
        # launch from anywhere else has no count, so no share is read
        print(f"[portbench] refine_bitmap_rows_roofline: {n} dense refine "
              f"kernels profiled against {calls} calls counted; not read",
              file=sys.stderr, flush=True)
        return None
    return 100.0 * (nbytes / peak) / seconds
