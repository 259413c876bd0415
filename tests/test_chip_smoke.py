"""chip_smoke.py's phases at a tiny size on the CPU.

``main()`` always requires a GPU; the phase functions take their sizes
and the CLI's ``--cpu`` flag as arguments, so the same checks run here
in the Pallas interpreter and the XLA CPU backend.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def test_main_requires_gpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code != 0
    assert '"ok"' not in capsys.readouterr().out


def test_phase_cli_spec_tiny(tmp_path):
    r = chip_smoke.phase_cli_spec(tmp_path, n_frames=40, frame_hw=(120, 160),
                                  cli_args=("--cpu",))
    assert r["maps"] >= 1 and r["frames"] == 41


def test_phase_cli_session_tiny(tmp_path):
    r = chip_smoke.phase_cli_session(
        tmp_path, n_frames=80, frame_hw=(120, 160), cli_args=("--cpu",),
        min_painted=0.85)
    assert r["agreement"] >= 0.999


def test_phase_streaming_tiny():
    r = chip_smoke.phase_streaming(frame_hw=(64, 96), batch=8, steps=3)
    assert r["matched"] == 1.0 and r["flags"] == 0


def test_phase_kernels_tiny():
    (r,) = chip_smoke.phase_kernels(sizes=((24, 32),), batch=4, reps=1)
    assert r["size"] == "32x24"
    assert set(r["extract_ms"]) == {"triton", "xla"}


def test_run_phase_reports_the_paths_it_traced(capsys):
    """A phase's line names the paths its calls took, not a guess."""
    chip_smoke.run_phase(
        "3 streaming step", "96x64 x 2 batches of 8",
        lambda: chip_smoke.phase_streaming(frame_hw=(64, 96), batch=8,
                                           steps=2),
        lambda r: f"matched {r['matched']:.0%}")
    out = capsys.readouterr().out
    assert "path extract=xla for 1 shape(s) [8x64x96]" in out
    assert "matched 100%" in out


def test_phase_matchers():
    assert chip_smoke.phase_matchers() == {"xcorr_pairs": 3,
                                           "pyramid_pairs": 2}
