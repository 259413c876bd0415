"""benchmarks/trace_report.py's reduction on hand-made planes."""

import os
import sys
from types import SimpleNamespace as NS

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmarks import trace_report  # noqa: E402


def _ev(name, start_ns, dur_ns):
    return NS(name=name, start_ns=start_ns, duration_ns=dur_ns)


def _planes():
    gpu = NS(name="/device:GPU:0", lines=[
        NS(name="Stream #13(Compute)", events=[
            _ev("sort", 0, 400), _ev("kpe_extract", 500, 200)]),
        # overlaps the first stream's sort: counted once in busy
        NS(name="Stream #14(Compute)", events=[_ev("fusion", 300, 200)]),
        # derived lines repeat the streams' time and are skipped
        NS(name="XLA Ops", events=[_ev("sort", 0, 400)]),
    ])
    host = NS(name="/host:CPU", lines=[
        NS(name="python", events=[_ev("dispatch", 0, 5000)])])
    return [host, gpu]


def test_reduce_planes_busy_window_and_totals():
    r = trace_report.reduce_planes(_planes(), steps=2)
    assert r["lines"] == ["/device:GPU:0 Stream #13(Compute)",
                          "/device:GPU:0 Stream #14(Compute)"]
    # busy: [0, 500) and [500, 700) -> 700 ns of a 700 ns window
    assert r["window_ms"] == pytest.approx(700e-6)
    assert r["busy_ms"] == pytest.approx(700e-6)
    assert r["idle_share"] == pytest.approx(0.0)
    assert r["busy_ms_per_step"] == pytest.approx(350e-6)
    assert [k["name"] for k in r["kernels"]] == ["sort", "kpe_extract",
                                                 "fusion"]
    assert r["kernels"][0]["share_of_event_time"] == pytest.approx(0.5)
    assert r["kernels"][0]["ms_per_step"] == pytest.approx(200e-6)


def test_reduce_planes_idle_gap():
    gpu = NS(name="/device:GPU:0", lines=[NS(name="Stream #7", events=[
        _ev("a", 0, 100), _ev("b", 400, 100)])])
    r = trace_report.reduce_planes([gpu], top=1)
    assert r["idle_share"] == pytest.approx(0.6)
    assert [k["name"] for k in r["kernels"]] == ["a"]


def test_reduce_planes_refuses_a_trace_without_device_events():
    with pytest.raises(ValueError):
        trace_report.reduce_planes(_planes()[:1])


def test_newest_xplane_needs_a_trace(tmp_path):
    with pytest.raises(FileNotFoundError):
        trace_report.newest_xplane(str(tmp_path))
