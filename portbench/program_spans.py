"""The program's own spans, as the per-layer readers see them.

The port keeps one span table per scheduler (``repro_torch.core.spans``):
``scheduler_stats()["spans"]`` is ``{path: {"n", "s", "self_s"}}``, and
while a profiler records, each span is also a ``repro_torch.<path>``
range on the host thread that ran it (an op range, which the profiler
does not copy onto the device timeline). Two readings:

* :func:`delta`: the table's change between the window's two snapshots
  (``Context.counters0`` and ``counters1``);
* :func:`idle_by_span`: the profiled part's idle time on the program's
  stream, split by the innermost program range open on the harness's
  thread at each instant (``"none"`` where none was), from the trace
  the harness exports for a traced run
  (``portbench/.runs/trace-<cell>-<seed>.json.gz``, Chrome trace
  format). The window, the device activity and the program's stream are
  taken as ``trace.py`` takes them, so the values sum to the profiled
  part's idle time.

A program without spans (an older commit) has neither; the readers then
read nothing.
"""
from __future__ import annotations

import collections
import dataclasses
import gzip
import json
import sys
from pathlib import Path

import numpy as np

from .trace import SPANS, WINDOW, _union

ROOT = Path(__file__).resolve().parent.parent
PREFIX = "repro_torch."         # repro_torch.core.spans.PREFIX
# the Chrome categories of device activity; the profiler's copies of
# user annotations on the device timeline are "gpu_user_annotation",
# of which the reduction drops the harness's own (``trace.py``)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation")
_ZERO = {"n": 0, "s": 0.0, "self_s": 0.0}


def delta(ctx) -> dict | None:
    """``{path: {"n", "s", "self_s"}}`` of the spans run in the window up
    to the profiler's start, or None where the program keeps no table."""
    a, b = ctx.counters0.get("spans"), ctx.counters1.get("spans")
    if a is None or b is None:
        return None
    return {k: {f: v[f] - a.get(k, _ZERO)[f] for f in _ZERO}
            for k, v in b.items()}


def seconds(d: dict, name: str) -> float:
    return d.get(name, _ZERO)["s"]


@dataclasses.dataclass
class Idle:
    window_s: float
    busy_s: float
    by_span: dict[str, float]   # every program range seen, and "none"

    def under(self, name: str) -> float:
        """Idle seconds inside ``name`` and the ranges under it."""
        return sum(v for k, v in self.by_span.items()
                   if k == name or k.startswith(name + "."))


def _ns(us) -> int:
    return int(round(float(us) * 1000))


def _innermost(ranges: list[tuple[int, int, str]]
               ) -> list[tuple[int, int, str]]:
    """Disjoint ``(start, end, name)`` pieces of the nested ``ranges``,
    each named by the innermost range open over it."""
    out: list[tuple[int, int, str]] = []
    stack: list[tuple[int, str]] = []        # (end, name), outermost first
    cur = None

    def close_until(t):
        nonlocal cur
        while stack and stack[-1][0] <= t:
            end, name = stack.pop()
            if end > cur:
                out.append((cur, end, name))
                cur = end

    for a, b, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        if cur is None:
            cur = a
        close_until(a)
        if stack and a > cur:
            out.append((cur, a, stack[-1][1]))
        cur = max(cur, a)
        stack.append((min(b, stack[-1][0]) if stack else b, name))
    if stack:
        close_until(stack[0][0])
    return out


def idle_by_span(events: list[dict]) -> Idle:
    """The reduction of the Chrome trace events ``events``."""
    xs = [e for e in events if e.get("ph") == "X"]
    marks = [e for e in xs if e.get("name") == WINDOW
             and e.get("cat") != "gpu_user_annotation"]
    if not marks:
        raise ValueError(f"no {WINDOW!r} range in the trace")
    w0 = _ns(marks[0]["ts"])
    w1 = w0 + _ns(marks[0]["dur"])
    host = (marks[0]["pid"], marks[0]["tid"])
    # device activity as ``trace.reduce_events`` takes it: every device
    # event but the copies of the harness's own ranges
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS
           and not (e.get("cat") == "gpu_user_annotation"
                    and (e.get("name") == WINDOW or e.get("name") in SPANS))]
    streams = collections.Counter((e["pid"], e["tid"]) for e in dev)
    main = streams.most_common(1)[0][0] if streams else None
    busy = []
    for e in dev:
        if (e["pid"], e["tid"]) != main:
            continue
        a = _ns(e["ts"])
        a, b = max(a, w0), min(a + _ns(e["dur"]), w1)
        if b > a:
            busy.append((a, b))
    busy = _union(np.array(busy, dtype=np.int64).reshape(-1, 2)).tolist()
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    ranges = []
    for e in xs:
        name = e.get("name", "")
        if ((e["pid"], e["tid"]) != host or not name.startswith(PREFIX)
                or e.get("cat") == "gpu_user_annotation"):
            continue
        a = _ns(e["ts"])
        a, b = max(a, w0), min(a + _ns(e["dur"]), w1)
        if b > a:
            ranges.append((a, b, name[len(PREFIX):]))
    by: dict[str, float] = {name: 0.0 for _, _, name in ranges}
    by["none"] = 0.0
    pieces = _innermost(ranges)
    i = 0
    for g0, g1 in gaps:
        covered = 0
        while i < len(pieces) and pieces[i][1] <= g0:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < g1:
            a, b = max(pieces[j][0], g0), min(pieces[j][1], g1)
            if b > a:
                by[pieces[j][2]] += (b - a) * 1e-9
                covered += b - a
            j += 1
        by["none"] += (g1 - g0 - covered) * 1e-9
    busy_ns = sum(b - a for a, b in busy)
    return Idle(window_s=(w1 - w0) * 1e-9, busy_s=busy_ns * 1e-9,
                by_span=by)


def run_seed(argv: list[str]) -> str | None:
    """The ``--seed`` of the harness's command line, or None."""
    for i, arg in enumerate(argv):
        if arg == "--seed" and i + 1 < len(argv):
            return argv[i + 1]
        if arg.startswith("--seed="):
            return arg.split("=", 1)[1]
    return None


def traced_idle(cell: str) -> Idle | None:
    """:func:`idle_by_span` of the trace this run exported (the seed
    read from the command line), or None where there is none or it
    cannot be read (said on standard error)."""
    seed = run_seed(sys.argv[1:])
    if seed is None:
        return None
    path = ROOT / "portbench" / ".runs" / f"trace-{cell}-{seed}.json.gz"
    if not path.is_file():
        return None
    try:
        with gzip.open(path, "rt") as f:
            events = json.load(f)["traceEvents"]
        return idle_by_span(events)
    except (OSError, ValueError, KeyError, TypeError) as exc:
        print(f"[portbench] {path.name}: not read ({exc})", file=sys.stderr,
              flush=True)
        return None
