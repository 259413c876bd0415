"""Sharded end-to-end pipeline step (the framework's "training step").

One jitted function takes a batch of clips ``[C, T, H, W]`` and produces
per-clip match offsets, fragment-break flags, accumulated positions and a
streaming stitch atlas — the full align+stitch hot path (SURVEY.md §3.3)
as a single XLA program, shardable over a ``('data', 'space')`` mesh:

- clips shard over ``data`` (batch-DP; BASELINE.json config 3),
- frame/atlas rows shard over ``space`` (spatial parallelism for high-res
  captures; XLA inserts halo collective-permutes for window sums and
  collectives for the region-table reductions — config 5).

Positions come from a segmented prefix sum inside the program
(``lax.associative_scan`` with a reset monoid), so no host round-trip is
needed between matching and blitting.  The streaming atlas is a fixed
window anchored at the running minimum position (long-session stitching
re-anchors per chunk on the host; pipeline.collect does the exact-canvas
version).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from remap_tpu.config import PipelineConfig
from remap_tpu.core.regions import GridLayout
from remap_tpu.ops import atlas as atlas_ops
from remap_tpu.ops import kpe as kpe_ops
from remap_tpu.ops import kpm as kpm_ops
from remap_tpu.ops import tables as table_ops


class StepResult(NamedTuple):
    offsets: jax.Array    # [C, T] int32x2 — offset vs previous frame
    matched: jax.Array    # [C, T] bool
    positions: jax.Array  # [C, T, 2] int32 — segmented cumsum of offsets
    atlas: jax.Array      # [C, AH, AW, 16] uint16 streaming stitch window


def segmented_positions(offsets: jax.Array, matched: jax.Array) -> jax.Array:
    """Positions with reset-to-zero at fragment breaks (frc.hpp:109-115),
    as an associative scan: combine((p1,r1),(p2,r2)) = (p2 if r2 else
    p1+p2, r1|r2)."""
    resets = ~matched  # frame 0 is a break by construction
    deltas = jnp.where(matched[..., None], offsets, 0)

    def combine(a, b):
        pa, ra = a
        pb, rb = b
        return jnp.where(rb[..., None], pb, pa + pb), ra | rb

    pos, _ = jax.lax.associative_scan(combine, (deltas, resets), axis=1)
    return pos


def make_pipeline_step(
    layout: GridLayout,
    cfg: PipelineConfig,
    atlas_pad: int = 64,
    kernels: bool | None = None,
):
    """Build the jittable [C, T, H, W] -> StepResult function.

    The alignment engine follows ``cfg.matcher``: ``grid_vote`` runs the
    reference-parity extract/tables/vote path; ``xcorr``/``pyramid`` run
    the dense-correlation families on consecutive frame pairs (the
    stitch/positions plumbing is identical).  All three therefore shard
    the same way over a ``('data', 'space')`` mesh — BASELINE.json
    config 5 names "pyramid coarse-to-fine correlation" for the 640x480
    case, and this is the sharded entry point for it.  ``kernels``
    chooses the Triton extraction kernel or its XLA form (utils.backend).
    """
    h, w = layout.height, layout.width
    ah, aw = h + 2 * atlas_pad, w + 2 * atlas_pad

    pair_match = None
    if cfg.matcher != "grid_vote":
        from remap_tpu import models

        pair_match = models.get_matcher(cfg.matcher, cfg)

    def step(images: jax.Array) -> StepResult:
        c, t = images.shape[:2]

        if pair_match is None:
            dense = jax.vmap(
                lambda im: kpe_ops.extract_dense(im, layout, kernels)
            )(images)
            tabs = jax.vmap(
                lambda wgt, cod: table_ops.build_tables(
                    wgt, cod, layout, cfg.region_capacity, cfg.table_mode
                )
            )(dense.weight, dense.codes)

            prev = jax.tree.map(lambda a: a[:, :-1], tabs)
            curr = jax.tree.map(lambda a: a[:, 1:], tabs)
            res = jax.vmap(
                lambda p, cr: kpm_ops.match_tables(
                    p,
                    cr,
                    layout,
                    weight_switch=cfg.match.weight_switch,
                    region_votes=cfg.match.region_votes,
                    min_active_divisor=cfg.min_active_divisor,
                    runner_up_divisor=cfg.runner_up_divisor,
                    multiplicity=cfg.join_multiplicity,
                    vote_radius=cfg.vote_radius,
                )
            )(prev, curr)
            pair_offsets, pair_ok = res.offset, res.ok
        else:
            off, ok = pair_match(
                images[:, :-1].reshape(c * (t - 1), h, w),
                images[:, 1:].reshape(c * (t - 1), h, w),
            )
            pair_offsets = off.reshape(c, t - 1, 2)
            pair_ok = ok.reshape(c, t - 1)

        offsets = jnp.concatenate(
            [jnp.zeros((c, 1, 2), jnp.int32), pair_offsets], axis=1
        )
        matched = jnp.concatenate(
            [jnp.zeros((c, 1), bool), pair_ok], axis=1
        )
        positions = segmented_positions(offsets, matched)

        # Streaming stitch: anchor at the window center, clamp strays.
        anchored = jnp.clip(
            positions + atlas_pad, 0, jnp.array([aw - w, ah - h], jnp.int32)
        )
        atlas = jax.vmap(
            lambda frames, pos: atlas_ops.blit_frames(
                frames, pos, atlas_h=ah, atlas_w=aw
            )
        )(images, anchored)
        return StepResult(
            offsets=offsets, matched=matched, positions=positions, atlas=atlas
        )

    return step


class StreamFlags(NamedTuple):
    """Per-frame, per-cause exactness flags from the streaming step.

    Each cause names its cheapest recovery (the same ladder
    pipeline.collect walks): ``table`` — a region table hit its keep
    quota (re-run that frame with the other table mode / higher
    capacity); ``join`` — the sort-merge join's multiplicity limit
    truncated vote counts (raise ``join_multiplicity``); ``range`` — the
    vote-radius exactness bound tripped (re-run with ``vote_radius=0``).
    ``np.asarray(flags).any()`` is the conservative any-cause bit."""

    table: jax.Array  # [T] bool
    join: jax.Array   # [T] bool
    range: jax.Array  # [T] bool

    @property
    def combined(self) -> jax.Array:
        return self.table | self.join | self.range


class StreamState(NamedTuple):
    """Device-resident state carried across streaming batches."""

    dots: jax.Array       # [AH, AW, 16] uint16 stitch window
    carry: object         # RegionTables of the previous batch's last frame
    position: jax.Array   # [2] int32 running position
    started: jax.Array    # [] bool — false before the first frame
    anchor: jax.Array     # [2] int32 stream coords of the atlas origin


def _shift_atlas(dots: jax.Array, delta: jax.Array) -> jax.Array:
    """out[y, x] = dots[y + dy, x + dx], zero-filled at the edges.

    The on-device re-anchor: when the camera drifts toward the stitch
    window's edge, the resident atlas slides under it (a device-memory
    copy, no host round-trip) instead of clamping positions."""
    hh, ww, _ = dots.shape
    dy, dx = delta[1], delta[0]
    yi = jnp.arange(hh)
    xi = jnp.arange(ww)
    out = jnp.roll(dots, -dy, axis=0)
    out = jnp.where(((yi + dy >= 0) & (yi + dy < hh))[:, None, None], out, 0)
    out = jnp.roll(out, -dx, axis=1)
    out = jnp.where(((xi + dx >= 0) & (xi + dx < ww))[None, :, None], out, 0)
    return out


def make_streaming_step(layout: GridLayout, cfg: PipelineConfig,
                        atlas_pad: int = 128):
    """Production streaming primitive: one batch of frames in, offsets out,
    atlas + matcher state stay on device.

    This is the 100k-frame "long session" path (BASELINE.json config 4):
    host feeds fixed-size frame batches; the device extracts, matches
    (including across the batch boundary via the carried last-frame
    tables), accumulates positions with fragment-break resets, and blits
    into the resident stitch window.  Only the per-frame offsets/flags
    return to the host.

    The stitch window follows the camera: when a batch's positions leave
    the resident window, the atlas is shifted in-device (``_shift_atlas``)
    and the anchor updated, so arbitrarily long drifts stitch exactly.
    Only when one batch's position span exceeds the window itself (e.g. a
    long drift plus a mid-batch fragment-break reset to (0,0)) do
    positions clamp — and then the returned ``strayed`` flag fires so the
    host can seal the window and restart (pipeline.stream does the
    host-store variant of that recovery).  The device decides where the
    Triton extraction kernel runs (utils.backend).
    """
    h, w = layout.height, layout.width
    ah, aw = h + 2 * atlas_pad, w + 2 * atlas_pad

    def init_state() -> StreamState:
        r = layout.region_count
        k = cfg.region_capacity
        carry = table_ops.RegionTables(
            codes=jnp.zeros((1, r, k, 4), jnp.uint32),
            pos=jnp.zeros((1, r, k, 2), jnp.int32),
            valid=jnp.zeros((1, r, k), bool),
            wcounts=jnp.zeros((1, r, 3), jnp.int32),
            overflow=jnp.zeros((1, r), bool),
        )
        return StreamState(
            dots=jnp.zeros((ah, aw, atlas_ops.DEPTH), jnp.uint16),
            carry=carry,
            position=jnp.zeros((2,), jnp.int32),
            started=jnp.zeros((), bool),
            anchor=jnp.full((2,), -atlas_pad, jnp.int32),
        )

    def step(images: jax.Array, state: StreamState):
        t = images.shape[0]
        dense = kpe_ops.extract_dense(images, layout)
        tabs = table_ops.build_tables(
            dense.weight, dense.codes, layout, cfg.region_capacity,
            cfg.table_mode,
        )
        prev = jax.tree.map(
            lambda c, a: jnp.concatenate([c, a[:-1]], axis=0),
            state.carry, tabs,
        )
        res = kpm_ops.match_tables(
            prev, tabs, layout,
            weight_switch=cfg.match.weight_switch,
            region_votes=cfg.match.region_votes,
            min_active_divisor=cfg.min_active_divisor,
            runner_up_divisor=cfg.runner_up_divisor,
            multiplicity=cfg.join_multiplicity,
            vote_radius=cfg.vote_radius,
        )
        # the very first frame of the stream never matches
        matched = res.ok & (state.started | (jnp.arange(t) > 0))
        offsets = jnp.where(matched[:, None], res.offset, 0)
        # per-cause exactness flags, mirroring pipeline.collect's
        # escalation ladder: each cause has a distinct cheapest recovery
        # (table -> sort2/topk re-run, join -> higher multiplicity,
        # range -> vote_radius=0).  `np.asarray(flags).any()` still gives
        # the conservative any-cause bit older callers checked.
        overflow = StreamFlags(
            table=tabs.overflow.any(axis=-1),
            join=res.overflow,
            range=res.range_overflow,
        )

        # positions: segmented cumsum with resets at breaks
        # (frc.hpp:109-115), seeded with the carried running position for
        # frames before the batch's first break.
        seg = segmented_positions(offsets[None], matched[None])[0]
        before_break = (jnp.cumsum(~matched) == 0)[:, None]
        pos = seg + jnp.where(before_break, state.position[None], 0)

        # Re-anchor the resident window under the batch's position span.
        limit = jnp.array([aw - w, ah - h], jnp.int32)
        lo = pos.min(axis=0)
        hi = pos.max(axis=0)
        rel_lo = lo - state.anchor
        rel_hi = hi - state.anchor
        fits = hi - lo <= limit
        strayed = jnp.any(~fits)
        out_of_window = (rel_lo < 0) | (rel_hi > limit)
        # center the span in the window on each violated axis
        centered = (rel_lo + rel_hi - limit) // 2
        delta = jnp.where(out_of_window & fits, centered, 0)
        anchor = state.anchor + delta
        dots0 = jax.lax.cond(
            jnp.any(delta != 0),
            lambda d: _shift_atlas(d, delta),
            lambda d: d,
            state.dots,
        )
        anchored = jnp.clip(pos - anchor, 0, limit)

        dots = atlas_ops.blit_frames(
            images, anchored, atlas_h=ah, atlas_w=aw, dots=dots0,
        )

        new_state = StreamState(
            dots=dots,
            carry=jax.tree.map(lambda a: a[-1:], tabs),
            position=pos[-1],
            started=jnp.ones((), bool),
            anchor=anchor,
        )
        return offsets, matched, overflow, strayed, new_state

    return init_state, step


def make_sharded_step(
    mesh: Mesh,
    layout: GridLayout,
    cfg: PipelineConfig,
    atlas_pad: int = 64,
):
    """jit the pipeline step over a ('data', 'space') mesh.

    Works for every matcher family (``cfg.matcher``): clips shard over
    ``data`` for all of them; ``space`` shards frame/atlas rows — the
    grid_vote window sums get halo collective-permutes, while the
    correlation families' FFTs make XLA gather the sharded axis (dense
    correlation is global by nature; shard ``data`` first for them).
    The XLA extraction runs: a Pallas call is opaque to the SPMD
    partitioner.
    """
    step = make_pipeline_step(layout, cfg, atlas_pad, kernels=False)
    in_s = NamedSharding(mesh, P("data", None, "space", None))
    out_s = StepResult(
        offsets=NamedSharding(mesh, P("data")),
        matched=NamedSharding(mesh, P("data")),
        positions=NamedSharding(mesh, P("data")),
        atlas=NamedSharding(mesh, P("data", "space", None, None)),
    )
    return jax.jit(step, in_shardings=in_s, out_shardings=out_s)
