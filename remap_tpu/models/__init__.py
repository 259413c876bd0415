"""Model families: alignment engines the pipeline can run on.

The reference has exactly one alignment algorithm (grid keypoint voting,
kpm.hpp).  This framework offers a family per content/scale regime,
all sharing the pipeline's feed/stitch/foreground/clean stages:

- ``grid_vote``  — reference-parity keypoint voting (default; bit-exact
  against the NumPy spec / C++ semantics).
- ``xcorr``      — dense FFT cross-correlation over the one-hot palette
  channels; robust on keypoint-poor content, FFT-bound.
- ``pyramid``    — coarse-to-fine xcorr for high-res captures
  (BASELINE.json config 5: 640x480 over a device mesh).

``get_matcher(name)`` returns a ``(prev_frames, curr_frames) ->
(offsets, ok)`` batch matcher; pipeline.collect threads it through the
streaming passes.
"""

from __future__ import annotations

from typing import Callable

from remap_tpu.models import pyramid as pyramid_model
from remap_tpu.models import xcorr as xcorr_model

FAMILIES = ("grid_vote", "xcorr", "pyramid")


def get_matcher(name: str, cfg) -> Callable:
    if name == "xcorr":
        return xcorr_model.make_matcher(cfg)
    if name == "pyramid":
        return pyramid_model.make_matcher(cfg)
    raise ValueError(
        f"unknown matcher family {name!r}; grid_vote is built into the "
        "collect step, others: {FAMILIES}"
    )
