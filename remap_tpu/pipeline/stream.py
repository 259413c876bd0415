"""Streaming stitcher: the long-session serving interface.

Incremental form of pipeline.collect for continuous operation
(BASELINE.json config 4: 100k-frame sessions): callers push frame
batches; each batch runs the jitted match step (extraction + tables +
cross-batch-carry matching) immediately, frames/medians land in the
packed host store, and ``finish()`` segments positions and scatter-blits
the fragments.  Peak device memory is O(batch); host memory is the packed
store (2 bytes/pixel for frame+median — ~3.7 GB per 100k NES frames).

The fully device-resident single-window variant (atlas carried in device
memory across batches, no host store) is ``parallel.sharded.
make_streaming_step`` — used by bench.py and appropriate when fragment
breaks are known not to occur mid-window.

Typical serving loop::

    stitcher = StreamingStitcher(cfg)
    for batch in frame_batches:          # [B, H, W] uint8
        offsets, matched = stitcher.push(batch)
    fragments = stitcher.finish()        # list of pipeline.state.Fragment
"""

from __future__ import annotations

from typing import List, Tuple

import jax.numpy as jnp
import numpy as np

from remap_tpu.config import PipelineConfig
from remap_tpu.core.regions import make_layout
from remap_tpu.pipeline import collect as collect_mod
from remap_tpu.pipeline.state import Fragment


class StreamingStitcher:
    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg
        h, w = cfg.screen_height, cfg.screen_width
        self.h, self.w = h, w
        self.layout = make_layout(
            w, h, cfg.grid_width, cfg.grid_height, cfg.grid_overlap
        )
        self._step = collect_mod.make_collect_step(self.layout, cfg)
        self._carry = (
            collect_mod._empty_carry(self.layout, cfg.region_capacity),
            jnp.zeros((1, h, w), jnp.uint8),
        )
        self.store = collect_mod.new_store(h, w, cfg)
        self.frame_no = 0
        self._offsets: List[np.ndarray] = []
        self._matched: List[np.ndarray] = []
        self.overflow_frames = 0
        #: frames where the vote-radius exactness bound tripped (only
        #: possible with cfg.vote_radius > 0); join limits held, so a
        #: re-run with vote_radius=0 alone recovers exact offsets
        self.range_overflow_frames = 0
        #: running max per-region keypoint count (capacity re-run hint)
        self.needed_capacity = 0

    def push(self, batch: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Process one [B, H, W] uint8 batch (B = cfg.frame_batch, except
        possibly the last); returns (offsets [B, 2], matched [B])."""
        n_real = len(batch)
        b = self.cfg.frame_batch
        if n_real < b:
            batch = np.concatenate(
                [batch, np.repeat(batch[-1:], b - n_real, axis=0)]
            )
        median, scalars, self._carry = self._step(
            jnp.asarray(batch), self._carry
        )
        off, ok, tovf, jovf, rovf, kpn = collect_mod.split_step_scalars(
            np.asarray(scalars)[:n_real]
        )
        # true max per-region keypoint count seen so far: consumers that
        # hit table overflow can re-run at exactly this capacity
        self.needed_capacity = max(
            self.needed_capacity, int(kpn.max(initial=0))
        )
        off = off.copy()
        ok = ok.copy()
        if self.frame_no == 0:
            ok[0] = False
        off[~ok] = 0
        # range overflow counts as overflow for the public counter: callers
        # checking only overflow_frames must never silently accept inexact
        # offsets (the separate counter remains as the cheap-recovery hint —
        # re-running with vote_radius=0 alone recovers those frames)
        ovf = tovf | jovf | rovf
        self.overflow_frames += int(ovf.sum())
        self.range_overflow_frames += int(rovf.sum())
        # the step's medians arrive packed (collect packs on device
        # before the d2h download); frames pack here — they never
        # came back from the device
        self.store.put_packed_batch(
            list(range(self.frame_no, self.frame_no + n_real)),
            collect_mod.pack_nibbles_batch(np.asarray(batch[:n_real])),
            np.asarray(median)[:n_real] if self.cfg.store_medians else None,
        )
        self.frame_no += n_real
        self._offsets.append(off)
        self._matched.append(ok)
        return off, ok

    def finish(self) -> List[Fragment]:
        if not self._offsets:
            return []
        offsets = np.concatenate(self._offsets)
        matched = np.concatenate(self._matched)
        segments = collect_mod.segment_positions(offsets, matched)
        return collect_mod.blit_pass(segments, self.store, self.cfg)
