"""Spans and counters of the served path.

A :class:`Spans` table (each :class:`~repro_torch.core.vectorized.
WaveScheduler` owns one, ``scheduler.spans``) keeps, for each span name,
how often the span ran, its total seconds and its self seconds (the
total less the time its child spans cover), and plain counters. A
span's name is its dotted path: ``span("candidates")`` opened while
``"submit"`` is open is recorded as ``"submit.candidates"``, so the name
says where it ran.

Every span reads the host clock (``time.perf_counter``). While a
``torch.profiler`` records, a span also opens a profiler range named
``repro_torch.<path>``, with the query id as its ``qid`` argument where
one is given (recorded when the profiler records inputs), so the span
lies in the trace on the device activity's clock, nested under the range
open around it. The range is recorded as an op, not as a user
annotation: the profiler copies a user annotation onto the device
timeline around the kernels launched inside it, where a reduction of the
trace would take the copy for device work. No record of a single span
is kept: while a profiler runs, its own buffer holds them.

The scheduler's statistics carry the table as ``scheduler_stats()
["spans"]`` (:meth:`Spans.snapshot`), so the server's ``/slo`` report
does too; it is the port's only record of the phases' seconds, where
the reference's statistics keep nine ``*_time_s`` and readback keys.
"""
from __future__ import annotations

import contextlib
import time

import torch

PREFIX = "repro_torch."

_profiling = torch._C._autograd._profiler_enabled
_RecordFunctionFast = torch._C._profiler._RecordFunctionFast

__all__ = ["PREFIX", "Spans", "maybe"]


class Spans:
    """Per-name ``[count, seconds, self seconds]`` and counters.

    ``counters`` starts with ``"iterations"`` (expansion iterations, one
    Eq. 2 refine pass each), which the scheduler also exposes as
    ``timing``."""

    def __init__(self, clock=time.perf_counter):
        self.clock = clock
        self.totals: dict[str, list] = {}
        self.counters: dict[str, int] = {"iterations": 0}
        self._open: list[_Span] = []

    def span(self, name: str, qid: int | None = None) -> "_Span":
        return _Span(self, name, qid)

    def count(self, name: str, k: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + k

    def snapshot(self) -> dict:
        """``{path: {"n", "s", "self_s"}}``, JSON-safe."""
        return {k: {"n": n, "s": s, "self_s": self_s}
                for k, (n, s, self_s) in self.totals.items()}


class _Span:
    __slots__ = ("table", "name", "qid", "path", "child_s", "range", "t0")

    def __init__(self, table: Spans, name: str, qid: int | None):
        self.table, self.name, self.qid = table, name, qid

    def __enter__(self) -> "_Span":
        t = self.table
        self.path = (t._open[-1].path + "." + self.name if t._open
                     else self.name)
        self.child_s = 0.0
        self.range = None
        if _profiling():
            self.range = (_RecordFunctionFast(PREFIX + self.path)
                          if self.qid is None else
                          _RecordFunctionFast(PREFIX + self.path, (),
                                              {"qid": _arg(self.qid)}))
            self.range.__enter__()
        t._open.append(self)
        self.t0 = t.clock()
        return self

    def __exit__(self, *exc) -> bool:
        t = self.table
        dt = t.clock() - self.t0
        t._open.pop()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        if t._open:
            t._open[-1].child_s += dt
        rec = t.totals.get(self.path)
        if rec is None:
            t.totals[self.path] = [1, dt, dt - self.child_s]
        else:
            rec[0] += 1
            rec[1] += dt
            rec[2] += dt - self.child_s
        return False


def _arg(qid):
    """A query id as the profiler records an argument: an int, or its
    text."""
    return qid if type(qid) is int else str(qid)


def maybe(spans: Spans | None, name: str):
    """``spans.span(name)``, or a context that does nothing where the
    caller passed no table."""
    return contextlib.nullcontext() if spans is None else spans.span(name)
