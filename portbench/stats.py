"""The end-to-end arithmetic over one window's timeline.

Each query the window saw is a :class:`Job` with host-clock times:
``t_submit`` (before ``submit_async``), ``t_first`` (the first poll at
which its handle held an embedding batch, or its completion if it found
none) and ``t_done`` (the first poll at which it was done). Times of
events that had not happened are ``None``.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Job:
    index: int                 # position in the run's query pool
    t_submit: float
    t_first: float | None = None
    t_done: float | None = None
    handle: object = None


def window_jobs(jobs: list[Job], t0: float, t1: float) -> list[Job]:
    """The window's queries: those completed in ``(t0, t1]`` and those
    submitted by ``t1`` and still running at ``t1``."""
    return [j for j in jobs if j.t_submit <= t1 and (
        (j.t_done is not None and t0 < j.t_done <= t1)
        or j.t_done is None or j.t_done > t1)]


def qps(jobs: list[Job], t0: float, t1: float) -> float:
    """Queries completed in the window over its seconds."""
    n = sum(1 for j in jobs if j.t_done is not None and t0 < j.t_done <= t1)
    return n / (t1 - t0)


def latencies_s(jobs: list[Job], t0: float, t1: float) -> np.ndarray:
    """Submit to completion of every query of the window; one still
    running at ``t1`` counts at its age then."""
    return np.array([(j.t_done if j.t_done is not None and j.t_done <= t1
                      else t1) - j.t_submit
                     for j in window_jobs(jobs, t0, t1)], float)


def ttfes_s(jobs: list[Job], t0: float, t1: float) -> np.ndarray:
    """Submit to first embedding of the same queries; one with no
    embedding yet at ``t1`` counts at its age then."""
    return np.array([(j.t_first if j.t_first is not None and j.t_first <= t1
                      else t1) - j.t_submit
                     for j in window_jobs(jobs, t0, t1)], float)


def p95_ms(values_s: np.ndarray) -> float | None:
    """95th percentile (numpy's linear interpolation) in ms."""
    if values_s.size == 0:
        return None
    return float(np.percentile(values_s, 95) * 1e3)
