"""Reduction of a ``torch.profiler`` trace of part of the window.

The harness marks the profiled part with a ``portbench.profiled``
range and each call into the port with ``step`` or ``submit_async``.
From the raw events (``prof.profiler.kineto_results.events()``) this
module takes:

* the device activity on the program's stream (kernels, copies,
  sets): busy seconds as the union of their intervals, kernel counts
  and seconds by name;
* the idle gaps between them, each split by what the host thread was
  doing: the harness span around it and the outermost ``aten::`` op, or
  ``python`` where no op ran (``step/aten::index_put_``,
  ``submit_async/python``).

Events are read through the methods ``name``, ``device_type``,
``start_ns``, ``end_ns``, ``device_resource_id`` and ``start_thread_id``
only, so the reduction is tested on the CPU with stand-in events.
"""
from __future__ import annotations

import collections
import dataclasses
import re

import numpy as np

WINDOW = "portbench.profiled"
SPANS = ("step", "submit_async")


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    n_kernels: int
    kernel_s: dict[str, float]       # seconds by kernel name
    kernel_n: dict[str, int]         # launches by kernel name
    idle_gaps: list[tuple[str, float]]

    def kernels_matching(self, pattern: str) -> tuple[int, float]:
        """Launches and seconds of kernels whose name contains
        ``pattern`` as a whole identifier."""
        rx = re.compile(rf"(?<![A-Za-z0-9_]){re.escape(pattern)}"
                        r"(?![A-Za-z0-9_])")
        n = s = 0
        for name, t in self.kernel_s.items():
            if rx.search(name):
                n += self.kernel_n[name]
                s += t
        return n, s

    def device_ops(self, top: int = 10) -> list[list]:
        return [[clean(k), v] for k, v in sorted(
            self.kernel_s.items(), key=lambda kv: -kv[1])[:top]]


def clean(name: str, width: int = 64) -> str:
    return re.sub(r"[^A-Za-z0-9_.:\-/]", "_", name)[:width]


def _is_device(ev, device_types) -> bool:
    return ev.device_type() in device_types


def _union(iv: np.ndarray) -> np.ndarray:
    """Disjoint sorted intervals covering the rows of ``iv`` [n, 2]."""
    if iv.size == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    out = []
    s, e = iv[0]
    for a, b in iv[1:]:
        if a > e:
            out.append((s, e))
            s, e = a, b
        elif b > e:
            e = b
    out.append((s, e))
    return np.array(out, dtype=np.int64)


def _outermost(iv: list[tuple[int, int, str]]) -> list[tuple[int, int, str]]:
    out, end = [], -1
    for a, b, name in sorted(iv, key=lambda t: (t[0], -t[1])):
        if a >= end:
            out.append((a, b, name))
            end = b
    return out


def reduce_events(events, device_types, top: int = 10) -> Summary:
    """The summary of the profiled range of ``events``.

    ``device_types`` are the device-type values of device activity.
    Only the stream with the most device events counts: the program
    issues all its work on one stream, and the harness's own counting
    (``refine_count``) runs on another."""
    events = list(events)
    # the harness's ranges also appear on the device timeline, spanning
    # the kernels launched inside them: those copies are not activity
    marks = [e for e in events if e.name() == WINDOW
             and not _is_device(e, device_types)]
    if not marks:
        raise ValueError(f"no {WINDOW!r} range in the trace")
    events = [e for e in events if not (_is_device(e, device_types) and (
        e.name() == WINDOW or e.name() in SPANS))]
    w0, w1 = marks[0].start_ns(), marks[0].end_ns()
    thread = marks[0].start_thread_id()
    streams = collections.Counter(e.device_resource_id() for e in events
                                  if _is_device(e, device_types))
    main = streams.most_common(1)[0][0] if streams else None
    dev, names = [], []
    spans, ops = [], []
    for e in events:
        if _is_device(e, device_types):
            if e.device_resource_id() != main:
                continue
            a, b = max(e.start_ns(), w0), min(e.end_ns(), w1)
            if b <= a:
                continue
            dev.append((a, b))
            names.append(e.name())
        elif e.start_thread_id() == thread:
            a, b, name = e.start_ns(), e.end_ns(), e.name()
            if b <= w0 or a >= w1:
                continue
            if name in SPANS:
                spans.append((a, b, name))
            elif name.startswith("aten::"):
                ops.append((a, b, name))
    kernel_s: dict[str, float] = collections.defaultdict(float)
    kernel_n: dict[str, int] = collections.defaultdict(int)
    n_kernels = 0
    for (a, b), name in zip(dev, names):
        kernel_s[name] += (b - a) * 1e-9
        kernel_n[name] += 1
        if not name.startswith(("Memcpy", "Memset")):
            n_kernels += 1
    busy = _union(np.array(dev, dtype=np.int64).reshape(-1, 2))
    busy_ns = int((busy[:, 1] - busy[:, 0]).sum())
    # idle gaps: the window less the busy intervals
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]])
    gaps = edges.reshape(-1, 2)
    gaps = gaps[gaps[:, 1] > gaps[:, 0]]
    spans = _outermost(spans)
    ops = _outermost(ops)
    sp_a = np.array([s[0] for s in spans], np.int64)
    op_a = np.array([o[0] for o in ops], np.int64)
    op_b = np.array([o[1] for o in ops], np.int64)
    by: dict[str, float] = collections.defaultdict(float)

    def span_of(t: int) -> str:
        i = int(np.searchsorted(sp_a, t, side="right")) - 1
        if i >= 0 and spans[i][1] > t:
            return spans[i][2]
        return "harness"

    for g0, g1 in gaps.tolist():
        covered = 0
        i = max(int(np.searchsorted(op_b, g0, side="right")), 0)
        while i < len(ops) and op_a[i] < g1:
            a, b = max(op_a[i], g0), min(op_b[i], g1)
            if b > a:
                by[f"{span_of((a + b) // 2)}/{ops[i][2]}"] += (b - a) * 1e-9
                covered += b - a
            i += 1
        if g1 - g0 > covered:
            by[f"{span_of((g0 + g1) // 2)}/python"] += (
                g1 - g0 - covered) * 1e-9
    idle = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return Summary(window_s=(w1 - w0) * 1e-9, busy_s=busy_ns * 1e-9,
                   n_kernels=n_kernels, kernel_s=dict(kernel_s),
                   kernel_n=dict(kernel_n),
                   idle_gaps=[(clean(k), v) for k, v in idle])
