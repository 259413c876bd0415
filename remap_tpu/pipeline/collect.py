"""Batched frame collection (device form of frc.hpp).

The reference's hot loop is serial: extract frame t, match against frame
t-1's grid, accumulate position or break, blit (frc.hpp:55-122).  The
dependency analysis (SURVEY.md §3.3) shows the only serial part is the
*position prefix sum* — matching frame t needs only the (t-1, t) keypoint
tables.  So the device design is two passes:

1. **Pass 1 (batched)**: frames stream through the device in batches of
   ``frame_batch``; one jitted step extracts medians/weights/codes
   (ops.kpe), builds region tables (ops.tables), and matches all
   consecutive pairs — carrying one frame's tables across the batch
   boundary.  Offsets/flags come back to the host; positions and fragment
   breaks are a trivial segmented cumsum.
2. **Pass 2 (batched)**: per fragment, the exact reference canvas extent is
   replayed arithmetically (state.simulate_growth) and all frames are
   scatter-blitted in fixed-size device chunks (ops.atlas.blit_frames).

Frames + medians are stored packed on the host for the foreground pass
(state.FrameStore, replacing nic RLE storage, frc.hpp:129-135).
"""

from __future__ import annotations

import dataclasses
import functools
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from remap_tpu.config import PipelineConfig
from remap_tpu.core.regions import GridLayout, make_layout
from remap_tpu.ops import atlas as atlas_ops
from remap_tpu.ops import kpe as kpe_ops
from remap_tpu.ops import kpm as kpm_ops
from remap_tpu.ops import tables as table_ops
from remap_tpu.pipeline.state import (
    Fragment,
    FrameRef,
    FrameStore,
    pack_nibbles_batch,
    pack_nibbles_device,
    simulate_growth,
    unpack_nibbles_device,
)
from remap_tpu.utils import backend


@dataclasses.dataclass(eq=False)
class CollectResult:
    fragments: List[Fragment]
    store: FrameStore
    #: offsets[t] is the declared offset of frame t vs t-1 (offsets[0] = 0).
    offsets: np.ndarray      # [N, 2] int32
    matched: np.ndarray      # [N] bool (matched[0] = False)
    overflow_frames: int


def new_store(h: int, w: int, cfg: PipelineConfig) -> FrameStore:
    """A frame store whose device mirrors follow ``cfg.frame_store``
    (utils.backend.store_budget)."""
    return FrameStore(h, w, device_budget=backend.store_budget(
        cfg.frame_store, fallback=FrameStore.DEVICE_MIRROR_CAP))


def make_collect_step(layout: GridLayout, cfg: PipelineConfig):
    """Build the jitted pass-1 step for a fixed layout/config.

    ``carry`` holds the previous batch's last frame state: the keypoint
    tables (grid_vote) plus the raw frame (frame-based matcher families).
    """
    frame_matcher = None
    if cfg.matcher != "grid_vote":
        from remap_tpu import models

        frame_matcher = models.get_matcher(cfg.matcher, cfg)

    @jax.jit
    def step(images: jax.Array, carry):
        carry_tabs, carry_frame = carry
        dense = kpe_ops.extract_dense(images, layout)
        tabs = table_ops.build_tables(
            dense.weight, dense.codes, layout, cfg.region_capacity,
            cfg.table_mode,
        )
        if frame_matcher is None:
            prev = jax.tree.map(
                lambda c, t: jnp.concatenate([c, t[:-1]], axis=0),
                carry_tabs,
                tabs,
            )
            res = kpm_ops.match_tables(
                prev,
                tabs,
                layout,
                weight_switch=cfg.match.weight_switch,
                region_votes=cfg.match.region_votes,
                min_active_divisor=cfg.min_active_divisor,
                runner_up_divisor=cfg.runner_up_divisor,
                multiplicity=cfg.join_multiplicity,
                vote_radius=cfg.vote_radius,
            )
            offset, ok = res.offset, res.ok
            # three separate escalation signals: table capacity/quota
            # (raise capacity / switch table mode), join truncation
            # (raise multiplicity), vote-radius bound (count exactly)
            tab_ovf = tabs.overflow.any(axis=-1)
            join_ovf = res.overflow
            range_ovf = res.range_overflow
        else:
            prev_frames = jnp.concatenate([carry_frame, images[:-1]], axis=0)
            offset, ok = frame_matcher(prev_frames, images)
            tab_ovf = jnp.zeros((images.shape[0],), bool)
            join_ovf = jnp.zeros((images.shape[0],), bool)
            range_ovf = jnp.zeros((images.shape[0],), bool)
        if frame_matcher is None:
            # true per-frame keypoint maximum over regions (wcounts are
            # counted over the full region slab, not the kept rows) —
            # lets the strict loop jump the capacity ladder in ONE step
            # instead of blind doubling
            kp_need = tabs.wcounts.sum(axis=-1).max(axis=-1)
        else:
            kp_need = jnp.zeros((images.shape[0],), jnp.int32)
        new_carry = (
            jax.tree.map(lambda t: t[-1:], tabs),
            images[-1:],
        )
        # medians download PACKED (2 px/byte): the host stores them
        # packed anyway.  All per-frame scalars stack into ONE [B, 7]
        # int32 array so the drain pays a single device-to-host copy
        # per batch instead of six.
        scalars = jnp.concatenate(
            [
                offset.astype(jnp.int32),
                ok.astype(jnp.int32)[:, None],
                tab_ovf.astype(jnp.int32)[:, None],
                join_ovf.astype(jnp.int32)[:, None],
                range_ovf.astype(jnp.int32)[:, None],
                kp_need.astype(jnp.int32)[:, None],
            ],
            axis=1,
        )
        return pack_nibbles_device(dense.median), scalars, new_carry

    return step


def split_step_scalars(scalars: np.ndarray):
    """(offsets, ok, tab_ovf, join_ovf, range_ovf, kp_need) from the
    stacked [B, 7] int32 the collect step returns."""
    return (
        scalars[:, 0:2],
        scalars[:, 2] > 0,
        scalars[:, 3] > 0,
        scalars[:, 4] > 0,
        scalars[:, 5] > 0,
        scalars[:, 6],
    )


def _empty_carry(layout: GridLayout, capacity: int) -> table_ops.RegionTables:
    r = layout.region_count
    return table_ops.RegionTables(
        codes=jnp.zeros((1, r, capacity, 4), jnp.uint32),
        pos=jnp.zeros((1, r, capacity, 2), jnp.int32),
        valid=jnp.zeros((1, r, capacity), bool),
        wcounts=jnp.zeros((1, r, 3), jnp.int32),
        overflow=jnp.zeros((1, r), bool),
    )


def match_pass(
    frames: Iterable[np.ndarray],
    layout: GridLayout,
    cfg: PipelineConfig,
    store: Optional[FrameStore] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray,
           int]:
    """Pass 1: per-frame match offsets/flags (and fill the frame store).

    Returns (offsets, matched, table_flags, join_flags, range_flags,
    kp_need) — per-frame boolean arrays for three separate escalation
    signals: table capacity or sort2-quota overflow of frame t's tables
    (raise capacity / switch table mode), join truncation that could
    alter the (t-1, t) declaration (raise multiplicity), and the
    vote-radius exactness bound on that declaration (count exactly with
    vote_radius=0).  Keeping them apart — and per frame — lets the
    strict loop escalate only the limit that actually tripped, and only
    for the pairs it actually flagged.  ``kp_need`` is the clip's true
    maximum per-region keypoint count (0 for frame-based matcher
    families), so a capacity escalation can jump straight to the size
    that provably holds every table."""
    step = make_collect_step(layout, cfg)
    b = cfg.frame_batch

    offsets: List[np.ndarray] = []
    matched: List[np.ndarray] = []
    tab_flags: List[np.ndarray] = []
    join_flags: List[np.ndarray] = []
    range_flags: List[np.ndarray] = []
    kp_need = 0
    carry = (
        _empty_carry(layout, cfg.region_capacity),
        jnp.zeros((1, layout.height, layout.width), jnp.uint8),
    )

    def drain(p) -> None:
        """Materialize one dispatched step's outputs (blocks on device).

        One fetch: the step's per-frame scalars arrive stacked
        ([B, 7] int32) so the batch costs a single copy to the host."""
        nonlocal kp_need
        num, n_real, packed, packed_dev, median, scalars = p
        off, ok, tovf, jovf, rovf, kpn = split_step_scalars(
            np.asarray(scalars)[:n_real]
        )
        offsets.append(off)
        matched.append(ok)
        tab_flags.append(tovf)
        join_flags.append(jovf)
        range_flags.append(rovf)
        kp_need = max(kp_need, int(kpn.max(initial=0)))
        if store is not None:
            meds = (
                np.asarray(median)[:n_real] if cfg.store_medians else None
            )
            store.put_packed_batch(
                list(range(num, num + n_real)),
                np.asarray(packed[:n_real]),
                meds,
                device_packed=packed_dev[:n_real],
                # the packed device median is already on device — donate it
                # so the foreground pass reads it there (frame_store)
                device_packed_medians=(
                    median[:n_real] if cfg.store_medians else None
                ),
            )

    feed = frames if hasattr(frames, "read_packed_batch") else None
    it = None if feed is not None else iter(frames)
    batch: List[np.ndarray] = []
    number = 0
    done = False
    # Double buffering: the feed prefetches batch n+1 (native reader,
    # off the GIL) while the device computes batch n, and device
    # outputs drain one batch late so dispatch n+1 precedes the
    # blocking fetch of n's results.
    pool = ThreadPoolExecutor(max_workers=1) if feed is not None else None
    fut = pool.submit(feed.read_packed_batch, 0, b) if pool else None
    pending: deque = deque()
    depth = max(1, cfg.collect_drain_depth)
    try:
        while not done:
            if feed is not None:
                # native/packed fast path: the feed reads, crops and
                # packs batches off the GIL (native/feed.cpp); nothing
                # unpacks on the host
                packed = fut.result()
                n_real = len(packed)
                if n_real == 0:
                    break
                done = n_real < b
                if not done:
                    fut = pool.submit(
                        feed.read_packed_batch, number + n_real, b
                    )
                if n_real < b:
                    packed = np.concatenate(
                        [packed, np.repeat(packed[-1:], b - n_real, axis=0)]
                    )
                w_full = layout.width
            else:
                batch.clear()
                while len(batch) < b:
                    try:
                        batch.append(next(it))
                    except StopIteration:
                        done = True
                        break
                if not batch:
                    break
                n_real = len(batch)
                stacked = np.stack(batch + [batch[-1]] * (b - n_real))
                packed = pack_nibbles_batch(stacked)
                w_full = stacked.shape[-1]
            # ship packed (2 px/byte), unpack on device; the device copy
            # is donated to the store's device mirror so pass 2 /
            # foreground never re-upload frames
            packed_dev = jnp.asarray(packed)
            images = _unpack_jit(packed_dev, w_full)
            median, scalars, carry = step(images, carry)
            pending.append((
                number, n_real, packed, packed_dev, median, scalars,
            ))
            # k-deep dispatch chain: keep up to `depth` batches in flight
            # so the blocking fetch of batch n happens after batch
            # n+depth's dispatch
            if len(pending) >= depth:
                drain(pending.popleft())
            number += n_real
        while pending:
            drain(pending.popleft())
    finally:
        if pool is not None:
            pool.shutdown(wait=False)

    if not offsets:
        z = np.zeros((0,), bool)
        return np.zeros((0, 2), np.int32), z, z, z, z, 0
    off = np.concatenate(offsets)
    ok = np.concatenate(matched)
    # frame 0 never matches anything (frc.hpp:83-95)
    ok[0] = False
    off[0] = 0
    off[~ok] = 0
    return (
        off, ok,
        np.concatenate(tab_flags),
        np.concatenate(join_flags),
        np.concatenate(range_flags),
        kp_need,
    )


def make_pair_step(layout: GridLayout, cfg: PipelineConfig):
    """Jitted re-match of arbitrary (prev, curr) frame pairs.

    Used by the strict escalation loop: the two-pass design makes every
    (t-1, t) declaration depend only on frames t-1 and t, so an
    escalated retry needs to recompute exactly the flagged pairs — not
    replay the whole clip (the reference's serial loop has no such
    choice, frc.hpp:55-122)."""

    @jax.jit
    def pair_step(prev_images: jax.Array, curr_images: jax.Array):
        dp = kpe_ops.extract_dense(prev_images, layout)
        dc = kpe_ops.extract_dense(curr_images, layout)
        tp = table_ops.build_tables(
            dp.weight, dp.codes, layout, cfg.region_capacity,
            cfg.table_mode,
        )
        tc = table_ops.build_tables(
            dc.weight, dc.codes, layout, cfg.region_capacity,
            cfg.table_mode,
        )
        res = kpm_ops.match_tables(
            tp,
            tc,
            layout,
            weight_switch=cfg.match.weight_switch,
            region_votes=cfg.match.region_votes,
            min_active_divisor=cfg.min_active_divisor,
            runner_up_divisor=cfg.runner_up_divisor,
            multiplicity=cfg.join_multiplicity,
            vote_radius=cfg.vote_radius,
        )
        tab = tp.overflow.any(axis=-1) | tc.overflow.any(axis=-1)
        kp_need = jnp.maximum(
            tp.wcounts.sum(axis=-1).max(axis=-1),
            tc.wcounts.sum(axis=-1).max(axis=-1),
        )
        return (
            res.offset, res.ok, tab, res.overflow, res.range_overflow,
            kp_need,
        )

    return pair_step


def repair_pairs(
    pair_idx: List[int],
    store: FrameStore,
    layout: GridLayout,
    cfg: PipelineConfig,
    offsets: np.ndarray,
    matched: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Re-match the pairs (t-1, t) for every t in ``pair_idx`` under
    ``cfg``, writing the new declarations into ``offsets``/``matched``
    in place.  Frames come from the store's device mirror when collect ran
    on this device.  Returns per-pair (tab, join, range) flag arrays
    aligned with ``pair_idx`` plus the pairs' true max per-region
    keypoint count (for count-guided capacity jumps)."""
    step = make_pair_step(layout, cfg)
    b = cfg.frame_batch
    tabs = np.zeros(len(pair_idx), bool)
    joins = np.zeros(len(pair_idx), bool)
    ranges = np.zeros(len(pair_idx), bool)
    kp_need = 0
    for i in range(0, len(pair_idx), b):
        chunk = list(pair_idx[i : i + b])
        n_real = len(chunk)
        pad = chunk + [chunk[-1]] * (b - n_real)
        prev_imgs = _unpack_jit(
            store.device_packed_batch([t - 1 for t in pad]), store.width
        )
        curr_imgs = _unpack_jit(
            store.device_packed_batch(pad), store.width
        )
        off, ok, tab, jov, rov, kpn = step(prev_imgs, curr_imgs)
        off = np.asarray(off)[:n_real]
        ok = np.asarray(ok)[:n_real]
        for k, t in enumerate(chunk):
            matched[t] = ok[k]
            offsets[t] = off[k] if ok[k] else 0
        tabs[i : i + n_real] = np.asarray(tab)[:n_real]
        joins[i : i + n_real] = np.asarray(jov)[:n_real]
        ranges[i : i + n_real] = np.asarray(rov)[:n_real]
        kp_need = max(
            kp_need, int(np.asarray(kpn)[:n_real].max(initial=0))
        )
    return tabs, joins, ranges, kp_need


def segment_positions(
    offsets: np.ndarray, matched: np.ndarray
) -> List[Tuple[List[int], List[Tuple[int, int]]]]:
    """Fragment segmentation + per-frame positions (frc.hpp:109-115):
    a match failure starts a new fragment at (0, 0)."""
    segments: List[Tuple[List[int], List[Tuple[int, int]]]] = []
    pos = (0, 0)
    for t in range(len(offsets)):
        if not matched[t]:
            segments.append(([], []))
            pos = (0, 0)
        else:
            pos = (pos[0] + int(offsets[t, 0]), pos[1] + int(offsets[t, 1]))
        segments[-1][0].append(t)
        segments[-1][1].append(pos)
    return segments


@functools.partial(jax.jit, static_argnames=("width",))
def _unpack_jit(packed, width):
    return unpack_nibbles_device(packed, width)


@functools.partial(jax.jit, static_argnames=("b", "h", "w"))
def _novote_mask(n_real, b, h, w):
    """[b, h, w] uint8 blit mask: 1 (no vote) past the first ``n_real``
    frames."""
    return jnp.broadcast_to(
        (jnp.arange(b) >= n_real)[:, None, None].astype(jnp.uint8),
        (b, h, w),
    )


def blit_pass(
    segments: List[Tuple[List[int], List[Tuple[int, int]]]],
    store: FrameStore,
    cfg: PipelineConfig,
) -> List[Fragment]:
    """Pass 2: build each fragment's canvas with chunked device blits
    (ops.atlas.blit_frames, one scatter-add per chunk)."""
    fh, fw = store.height, store.width
    b = cfg.frame_batch
    fragments: List[Fragment] = []

    for numbers, positions in segments:
        zero, (cw, ch) = simulate_growth(positions, fw, fh)
        dots = jnp.zeros((ch, cw, atlas_ops.DEPTH), jnp.uint16)
        # blit in fixed chunks; dummy frames vote nowhere
        for i in range(0, len(numbers), b):
            chunk_nos = numbers[i : i + b]
            chunk_pos = positions[i : i + b]
            n_real = len(chunk_nos)
            # frames come from the store's device mirror when collect
            # ran on this device (uploaded packed otherwise); the mask
            # is a device broadcast of one scalar
            packed = store.device_packed_batch(chunk_nos)
            if n_real < b:
                packed = jnp.concatenate(
                    [packed,
                     jnp.zeros((b - n_real,) + packed.shape[1:],
                               jnp.uint8)]
                )
            imgs = _unpack_jit(packed, fw)
            apos = np.array(
                [(px - zero[0], py - zero[1]) for px, py in chunk_pos]
                + [(0, 0)] * (b - n_real),
                np.int32,
            )
            dots = atlas_ops.blit_frames(
                imgs,
                jnp.asarray(apos),
                atlas_h=ch,
                atlas_w=cw,
                masks=_novote_mask(n_real, b, fh, fw),
                dots=dots,
            )
        # the canvas stays device-resident: splice/foreground/clean
        # consume it there, and the host copy (checkpoints, tests)
        # materializes lazily on first .dots access
        frag = Fragment(
            dots_dev=dots,
            zero=zero,
            frames=[
                FrameRef(number=no, position=p)
                for no, p in zip(numbers, positions)
            ],
            store=store,
        )
        frag.normalize()
        fragments.append(frag)
    return fragments


def collect(
    frames: Iterable[np.ndarray],
    cfg: PipelineConfig,
    layout: Optional[GridLayout] = None,
    strict: bool = True,
) -> CollectResult:
    """Full collect stage: returns normalized fragments (frc.hpp:74-80).

    With ``strict`` (default), a pass that hits table-capacity or
    join-multiplicity overflow re-runs with escalated limits until the
    results are provably exhaustive (fast defaults, guaranteed-exact
    results).  Capacity escalation jumps straight to the measured
    keypoint maximum; join escalation walks multiplicity 4x then dense;
    only flagged pairs re-match when they are a minority."""
    if hasattr(frames, "read_packed_batch"):
        if len(frames) == 0:
            return CollectResult([], FrameStore(0, 0),
                                 np.zeros((0, 2), np.int32),
                                 np.zeros((0,), bool), 0)
        h, w = frames.out_dims
        source = frames
    else:
        frames = iter(frames)
        first = next(frames, None)
        if first is None:
            return CollectResult([], FrameStore(0, 0),
                                 np.zeros((0, 2), np.int32),
                                 np.zeros((0,), bool), 0)
        h, w = first.shape

        def chain(first=first, rest=frames):
            yield first
            yield from rest

        source = chain()
    if layout is None:
        layout = make_layout(
            w, h, cfg.grid_width, cfg.grid_height, cfg.grid_overlap
        )
    store = new_store(h, w, cfg)

    offsets, matched, tabf, joinf, rangef, kp_need = match_pass(
        source, layout, cfg, store
    )

    # Per-PAIR flags: the (t-1, t) declaration is suspect if either
    # endpoint's tables overflowed or the pair's join/radius bound
    # tripped.  Pair 0 (frame 0 vs nothing) is exempt — its declaration
    # is forced to no-match regardless (frc.hpp:83-95).
    n = len(offsets)
    ptab = tabf.copy()
    if n:
        ptab[1:] |= tabf[:-1]
        ptab[0] = joinf[0] = rangef[0] = False
    pjoin, prange = joinf, rangef

    ecfg = cfg
    while strict and (ptab.any() or pjoin.any() or prange.any()):
        # Escalate ONLY the limit that tripped, and re-match ONLY the
        # flagged pairs: the stability bounds prove every unflagged
        # declaration equals its exhaustive recomputation, so a full
        # clip replay (round 2's strict loop) is provably redundant.
        if ptab.any():
            if (
                table_ops.resolve_table_mode(ecfg.table_mode)
                == "sort2"
            ):
                # sort2's chunk-quota flag is density-based — capacity
                # escalation can NEVER clear it (HUD/border rows pack
                # solid keypoint runs).  Switch to the quota-free top_k
                # selection first, with everything else unchanged.
                ecfg = dataclasses.replace(ecfg, table_mode="topk")
            elif ecfg.region_capacity >= 1 << 14:
                break  # give up: caller sees overflow_frames > 0
            else:
                # count-guided jump: the pass already measured the true
                # max per-region keypoint count, so go straight to the
                # power of two that provably holds every table (blind
                # doubling paid one full replay per level — 3 extra
                # replays on busy 4k-keypoint content)
                new_cap = max(ecfg.region_capacity * 2, 256)
                while new_cap < min(kp_need, 1 << 14):
                    new_cap *= 2
                ecfg = dataclasses.replace(
                    ecfg,
                    region_capacity=min(new_cap, 1 << 14),
                    vote_radius=0,
                )
        elif pjoin.any():
            # 4x multiplicity, then the exhaustive dense join (0); the
            # table capacity stays put — doubling it here would quadruple
            # the dense endpoint's quadratic cost for no benefit
            if ecfg.join_multiplicity == 0:
                break  # dense is exact; overflow here is impossible
            next_mult = 0 if ecfg.join_multiplicity >= 16 else (
                ecfg.join_multiplicity * 4
            )
            capacity = ecfg.region_capacity
            # bound the retry batch by the join working set: the rolled
            # join scales with batch x capacity x multiplicity, the dense
            # endpoint with batch x regions x capacity^2 — size the batch
            # to a ~2 GB live set instead of OOMing
            if next_mult == 0:
                per_frame = layout.region_count * capacity * capacity * 4
            else:
                per_frame = (
                    layout.region_count * 2 * capacity * 4 * next_mult * 8
                )
            batch = max(1, min(ecfg.frame_batch, (2 << 30) // per_frame))
            ecfg = dataclasses.replace(
                ecfg,
                join_multiplicity=next_mult,
                frame_batch=batch,
                vote_radius=0,   # escalated retries always count exactly
            )
        else:
            # only the vote-histogram radius tripped: the join limits
            # held, so retry with exact full-range counting alone —
            # capacity/multiplicity/batch stay put
            ecfg = dataclasses.replace(ecfg, vote_radius=0)
        pairs = np.flatnonzero(ptab | pjoin | prange).tolist()
        if len(pairs) > n // 2:
            # majority flagged: a full replay extracts each frame once
            # where pair repair extracts both endpoints per pair
            replay = (store.image(i) for i in range(len(store)))
            offsets, matched, tabf, joinf, rangef, kp_need = match_pass(
                replay, layout, ecfg, None
            )
            ptab = tabf.copy()
            ptab[1:] |= tabf[:-1]
            ptab[0] = joinf[0] = rangef[0] = False
            pjoin, prange = joinf, rangef
        else:
            rtab, rjoin, rrange, kp_need = repair_pairs(
                pairs, store, layout, ecfg, offsets, matched
            )
            ptab[:] = pjoin[:] = prange[:] = False
            ptab[pairs] = rtab
            pjoin[pairs] = rjoin
            prange[pairs] = rrange

    segments = segment_positions(offsets, matched)
    fragments = blit_pass(segments, store, cfg)
    return CollectResult(
        fragments=fragments,
        store=store,
        offsets=offsets,
        matched=matched,
        overflow_frames=int((ptab | pjoin | prange).sum()),
    )
