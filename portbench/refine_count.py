"""The benchmark's own count of what each dense refine call moves.

While armed, :class:`RefineCounter` wraps ``engine_step``'s reference to
``refine_bitmap_rows`` (the dense Eq. 2 kernel's entry) and, after each
call, counts the distinct adjacency rows the call's active positions
name. The count runs on a stream of its own, after the call's inputs are
ready and without a read back to the host, so the program's stream and
its timing see none of it; the trace reduction reads the program's
stream only.
The counts are read once the profiled range has ended.
"""
from __future__ import annotations

import torch

from .peaks import dense_refine_bytes


class RefineCounter:
    def __init__(self, engine_step):
        self.mod = engine_step
        self.orig = engine_step.refine_bitmap_rows
        self.stream = torch.cuda.Stream()
        self.armed = False
        self.calls: list[tuple[int, int, int, torch.Tensor]] = []

    def __enter__(self):
        self.mod.refine_bitmap_rows = self._dense
        return self

    def __exit__(self, *exc):
        self.mod.refine_bitmap_rows = self.orig
        return False

    def _dense(self, adj, cand, frontier, active, *args, **kwargs):
        out = self.orig(adj, cand, frontier, active, *args, **kwargs)
        if self.armed and frontier.is_cuda:
            main = torch.cuda.current_stream(frontier.device)
            self.stream.wait_stream(main)
            with torch.cuda.stream(self.stream):
                v = adj.shape[0]
                idx = torch.where((active != 0) & (frontier >= 0)
                                  & (frontier < v), frontier, v)
                seen = torch.zeros(v + 1, dtype=torch.int32,
                                   device=frontier.device)
                seen.index_fill_(0, idx.reshape(-1).long(), 1)
                distinct = seen[:v].sum()
            frontier.record_stream(self.stream)
            active.record_stream(self.stream)
            f, n_pos = frontier.shape
            self.calls.append((f, cand.shape[1], n_pos, distinct))
        return out

    def total_bytes(self) -> tuple[int, int]:
        """``(calls, bytes)`` of the armed calls (waits for the
        counting stream)."""
        self.stream.synchronize()
        total = sum(dense_refine_bytes(f, w, p, int(d))
                    for f, w, p, d in self.calls)
        return len(self.calls), total
