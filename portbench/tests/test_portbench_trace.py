"""The trace reduction on stand-in profiler events."""
import pytest

from portbench.trace import WINDOW, reduce_events

CPU, CUDA = 0, 1


class Ev:
    def __init__(self, name, a, b, dev=CPU, stream=0, thread=1):
        self._n, self._a, self._b = name, a, b
        self._d, self._s, self._t = dev, stream, thread

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b

    def device_type(self):
        return self._d

    def device_resource_id(self):
        return self._s

    def start_thread_id(self):
        return self._t


def events():
    return [
        Ev(WINDOW, 0, 1000),
        Ev(WINDOW, 100, 900, dev=CUDA, stream=7),      # device-side copy
        Ev("step", 0, 700),
        Ev("step", 50, 650, dev=CUDA, stream=7),       # device-side copy
        Ev("aten::index_put_", 100, 300),
        Ev("aten::add", 150, 200),                     # nested: not outermost
        Ev("submit_async", 700, 1000),
        Ev("k_a", 200, 400, dev=CUDA, stream=7),
        Ev("k_b", 350, 500, dev=CUDA, stream=7),
        Ev("Memcpy DtoH", 600, 650, dev=CUDA, stream=7),
        Ev("k_a", 900, 1100, dev=CUDA, stream=7),      # clipped at 1000
        Ev("count", 0, 1000, dev=CUDA, stream=9),      # another stream
        Ev("aten::mul", 0, 1000, thread=2),            # another thread
    ]


def test_busy_kernels_and_idle_gaps():
    s = reduce_events(events(), {CUDA})
    assert s.window_s == pytest.approx(1000e-9)
    # busy: [200, 500) + [600, 650) + [900, 1000)
    assert s.busy_s == pytest.approx(450e-9)
    assert s.n_kernels == 3                        # k_a twice, k_b; no copy
    assert s.kernels_matching("k_a") == (2, pytest.approx(300e-9))
    gaps = dict(s.idle_gaps)
    # [0, 200): 100-200 in index_put_, 0-100 python, in "step"
    assert gaps["step/aten::index_put_"] == pytest.approx(100e-9)
    assert gaps["step/python"] == pytest.approx(100e-9 + 100e-9)
    # [500, 600) in step; [650, 900) goes to the span at its middle
    assert gaps["submit_async/python"] == pytest.approx(250e-9)
    assert sum(gaps.values()) == pytest.approx(550e-9)


def test_a_trace_without_the_window_range_is_refused():
    with pytest.raises(ValueError):
        reduce_events([e for e in events() if e.name() != WINDOW], {CUDA})
