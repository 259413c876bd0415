"""Action-window scan stage (aws.hpp:98-156).

Frames stream through the device in batches: one small program advances
the persistent equality heatmap for the whole batch and flags which frames
actually changed it; the host labels only the changed states
(ops.aws.best_contour_jit — the heatmap stabilizes within a handful of
frames, so labeling is rare) and runs the tiny growth/stagnation
acceptance machine over the per-frame scalars:

- a changed (color-0) winning contour that grew resets stagnation and
  updates the tracked window (aws.hpp:129-139),
- the window is accepted once ``area > screen/3``, bbox height > 2H/5 and
  width > 2W/3 (inclusive-coordinate differences, i.e. real size minus 1),
- the scan stops after ``stagnation_limit`` stagnant frames once a window
  is accepted (aws.hpp:118-144).
"""

from __future__ import annotations

import itertools
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from remap_tpu.config import PipelineConfig
from remap_tpu.core.geometry import Rect
from remap_tpu.ops import aws as aws_ops
from remap_tpu.spec.aws import WindowInfo


def scan(
    frames: Iterable[np.ndarray],
    cfg: PipelineConfig,
) -> Optional[WindowInfo]:
    """The scan upload is overlapped and bounded like collect's feed
    (aws.hpp:98-156): frames upload packed (2 px/byte,
    straight off the native reader when the source is a feed), a worker
    thread prefetches batch n+1 while the device scans batch n, and the
    host state machine drains one batch behind the dispatch — at most
    one extra batch is read past the early stop."""
    from remap_tpu.pipeline.collect import _unpack_jit
    from remap_tpu.pipeline.state import pack_nibbles_batch

    feed = frames if hasattr(frames, "read_packed_batch") else None
    if feed is not None:
        if len(feed) == 0:
            return None
        h, w = feed.out_dims
        it = None
    else:
        it = iter(frames)
        first = next(it, None)
        if first is None:
            return None
        h, w = first.shape
    robust = cfg.discovery == "robust"

    min_area = (w * h) // cfg.aws_min_area_divisor
    min_height = cfg.aws_min_height_num * h // cfg.aws_min_height_den
    min_width = cfg.aws_min_width_num * w // cfg.aws_min_width_den

    # parity: binary always-static heatmap; robust: per-pixel change
    # event counts (debounced — see config.discovery)
    if robust:
        carry = jnp.zeros((h, w), jnp.int32)
    else:
        carry = jnp.ones((h, w), jnp.uint8)
    b = cfg.frame_batch

    if feed is not None:
        first_packed = feed.read_packed_batch(0, 1)
        if first_packed.shape[0] == 0:
            return None
        prev = _unpack_jit(jnp.asarray(first_packed), w)[0]
    else:
        prev = jnp.asarray(first)

    def produce():
        """(packed [b, h, ceil(w/2)] uint8, n_real) batches from frame 1,
        read + packed off the scan thread."""
        if feed is not None:
            start = 1
            while True:
                pk = feed.read_packed_batch(start, b)
                n_real = pk.shape[0]
                if n_real == 0:
                    return
                if n_real < b:
                    pk = np.concatenate(
                        [pk, np.repeat(pk[-1:], b - n_real, axis=0)]
                    )
                yield pk, n_real
                start += n_real
        else:
            while True:
                batch = list(itertools.islice(it, b))
                if not batch:
                    return
                n_real = len(batch)
                padded = batch + [batch[-1]] * (b - n_real)
                yield pack_nibbles_batch(np.stack(padded)), n_real

    result: Optional[Rect] = None
    area = 0
    stagnation = 0
    #: best-contour scalars of the latest labeled heatmap state
    last: Optional[Tuple] = None
    done = False

    def drain(heatmaps, changed, n_real) -> None:
        """Host acceptance machine over one scanned batch's flags."""
        nonlocal result, area, stagnation, last, done
        changed_np = np.asarray(changed)[:n_real]
        for i in range(n_real):
            if stagnation > cfg.aws_stagnation_limit:
                done = True
                return
            if changed_np[i] or last is None:
                fn = (
                    aws_ops.robust_best_contour_jit
                    if robust
                    else aws_ops.best_contour_jit
                )
                last = np.asarray(fn(heatmaps[i]))
            color, carea, cbbox = last[0], last[1], last[2:]
            if color == 0 and carea > area:
                stagnation = 0
                area = int(carea)
                if robust:
                    # true pixel bbox — no cdt::limits running-max quirk
                    window = Rect(
                        left=int(cbbox[0]),
                        top=int(cbbox[1]),
                        right=int(cbbox[2]),
                        bottom=int(cbbox[3]),
                    )
                    width_q = window.right - window.left
                else:
                    # cbbox[0] is the quirky enclosure lower_ (ops.aws:
                    # sentinel w = unset/SIZE_MAX); width wraps unsigned
                    # like the reference's (aws.hpp:110-139,
                    # cdt.hpp:192-195)
                    left_q = int(cbbox[0])
                    if left_q >= w:
                        left_q = 2**64 - 1
                    window = Rect(
                        left=left_q,
                        top=int(cbbox[1]),
                        right=int(cbbox[2]),
                        bottom=int(cbbox[3]),
                    )
                    width_q = (window.right - left_q) % 2**64
                if result is not None or (
                    area > min_area
                    and window.height > min_height
                    and width_q > min_width
                ):
                    result = window
            if result is not None:
                stagnation += 1

    pool = ThreadPoolExecutor(max_workers=1)
    try:
        gen = produce()
        fut = pool.submit(next, gen, None)
        pending: deque = deque()
        while not done:
            item = fut.result()
            if item is None:
                break
            fut = pool.submit(next, gen, None)
            packed, n_real = item
            imgs = _unpack_jit(jnp.asarray(packed), w)
            if robust:
                heatmaps, changed, carry = aws_ops.robust_scan_batch(
                    prev, imgs, carry, cfg.aws_change_tolerance
                )
            else:
                heatmaps, changed = aws_ops.scan_batch(prev, imgs, carry)
                carry = heatmaps[n_real - 1]
            prev = imgs[n_real - 1]
            pending.append((heatmaps, changed, n_real))
            # drain one batch BEHIND the dispatch: the device scans
            # batch n+1 while the host labels batch n
            if len(pending) > 1:
                drain(*pending.popleft())
        while not done and pending:
            drain(*pending.popleft())
    finally:
        pool.shutdown(wait=False)

    if result is None:
        return None
    return WindowInfo(raw_bounds=result)
