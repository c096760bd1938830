"""The end-to-end arithmetic on synthetic timelines."""
import numpy as np
import pytest

from portbench import stats
from portbench.stats import Job


def timeline():
    return [
        Job(0, t_submit=0.0, t_first=1.0, t_done=2.0),     # before window
        Job(1, t_submit=5.0, t_first=11.0, t_done=12.0),   # ends in it
        Job(2, t_submit=10.5, t_first=11.5, t_done=14.0),
        Job(3, t_submit=12.0, t_first=13.0, t_done=25.0),  # ends after
        Job(4, t_submit=14.0, t_first=None, t_done=None),  # still running
        Job(5, t_submit=16.0, t_first=17.0, t_done=None),
        Job(6, t_submit=19.0, t_first=19.5, t_done=19.5),  # none found
        Job(7, t_submit=21.0, t_first=None, t_done=None),  # after window
    ]


def test_window_jobs_keep_completed_and_running():
    got = [j.index for j in stats.window_jobs(timeline(), 10.0, 20.0)]
    assert got == [1, 2, 3, 4, 5, 6]


def test_qps_counts_completions_in_the_window_only():
    assert stats.qps(timeline(), 10.0, 20.0) == pytest.approx(3 / 10.0)


def test_a_query_still_running_counts_at_its_age():
    lat = stats.latencies_s(timeline(), 10.0, 20.0)
    assert lat.tolist() == [7.0, 3.5, 8.0, 6.0, 4.0, 0.5]
    ttfe = stats.ttfes_s(timeline(), 10.0, 20.0)
    assert ttfe.tolist() == [6.0, 1.0, 1.0, 6.0, 1.0, 0.5]


def test_p95_is_numpys_linear_percentile_in_ms():
    v = np.arange(1, 101, dtype=float)
    assert stats.p95_ms(v) == pytest.approx(np.percentile(v, 95) * 1e3)
    assert stats.p95_ms(np.array([])) is None
