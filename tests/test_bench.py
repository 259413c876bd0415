"""bench.py's measurement loop at a tiny size on the CPU."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402


@pytest.mark.parametrize("ingest", [False, True])
def test_measure_tiny(monkeypatch, ingest):
    monkeypatch.setattr(bench, "H", 64)
    monkeypatch.setattr(bench, "W", 96)
    monkeypatch.setattr(bench, "BATCH", 8)
    r = bench._measure(ingest=ingest, steps=2)
    assert r["steps"] == 2 and r["window_s"] > 0
    assert r["fps"] == pytest.approx(2 * 8 / r["window_s"])
    assert r["step_ms"]["min"] <= r["step_ms"]["median"] <= r["step_ms"]["max"]


def test_main_requires_gpu(capsys):
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code != 0
    assert "frames/sec" not in capsys.readouterr().out
