#!/usr/bin/env python
"""Device time from a ``jax.profiler`` trace: idle share and per-kernel
totals.

Reads the newest ``*.xplane.pb`` under a trace directory (as
``utils.profiling.device_trace`` writes it) and reduces the events on the
GPU planes' stream lines (``/device:GPU:<n>``, lines named ``Stream
...``; the derived ``XLA Ops``/``XLA Modules`` lines would count the same
time twice):

- window: first event start to last event end on the device;
- busy: the union of the event intervals over all streams; idle share =
  1 - busy / window;
- per event name: calls and summed time, largest first.

Usage: python benchmarks/trace_report.py <trace-dir> [--steps N] [--top 15]
Prints one JSON line.  Needs no device: the trace is read from disk.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _stream_lines(planes):
    """(plane name, line) of every GPU stream line."""
    for plane in planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if line.name.startswith("Stream"):
                yield plane.name, line


def reduce_planes(planes, steps: int | None = None, top: int = 15) -> dict:
    """Reduce profile planes (``jax.profiler.ProfileData(...).planes``,
    or objects with the same ``name``/``lines``/``events`` fields) to
    the device's window, busy time, idle share and per-name totals;
    with ``steps`` the times are also given per step."""
    intervals, totals, lines = [], {}, []
    for plane_name, line in _stream_lines(planes):
        lines.append(f"{plane_name} {line.name}")
        for ev in line.events:
            start, dur = float(ev.start_ns), float(ev.duration_ns)
            intervals.append((start, start + dur))
            calls, ns = totals.get(ev.name, (0, 0.0))
            totals[ev.name] = (calls + 1, ns + dur)
    if not intervals:
        raise ValueError("no events on a GPU stream line in this trace")
    intervals.sort()
    busy, cur_lo, cur_hi = 0.0, *intervals[0]
    for lo, hi in intervals[1:]:
        if lo > cur_hi:
            busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    busy += cur_hi - cur_lo
    window = max(hi for _, hi in intervals) - intervals[0][0]
    summed = sum(ns for _, ns in totals.values())
    per = (1.0 / steps) if steps else None
    kernels = [
        {"name": name, "calls": calls, "ms": ns / 1e6,
         "share_of_event_time": ns / summed,
         **({"ms_per_step": ns / 1e6 * per} if per else {})}
        for name, (calls, ns) in sorted(totals.items(),
                                        key=lambda kv: -kv[1][1])[:top]
    ]
    out = {
        "lines": lines,
        "window_ms": window / 1e6,
        "busy_ms": busy / 1e6,
        "idle_share": 1.0 - busy / window if window else 0.0,
        "event_ms": summed / 1e6,
        "kernels": kernels,
    }
    if per:
        out["busy_ms_per_step"] = busy / 1e6 * per
    return out


def newest_xplane(trace_dir: str) -> Path:
    found = sorted(Path(trace_dir).rglob("*.xplane.pb"),
                   key=lambda p: p.stat().st_mtime)
    if not found:
        raise FileNotFoundError(f"no *.xplane.pb under {trace_dir}")
    return found[-1]


def summarize(trace_dir: str, steps: int | None = None,
              top: int = 15) -> dict:
    """``reduce_planes`` of the newest trace under ``trace_dir``."""
    from jax.profiler import ProfileData

    path = newest_xplane(trace_dir)
    out = reduce_planes(ProfileData.from_file(str(path)).planes, steps, top)
    return {"trace": str(path), **out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace_dir")
    ap.add_argument("--steps", type=int, default=None,
                    help="steps in the traced window, for per-step times")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    print(json.dumps(summarize(args.trace_dir, args.steps, args.top)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
