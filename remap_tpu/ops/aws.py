"""Action-window scan device kernels (aws.hpp).

Per batch of frames: the persistent {0,1} heatmap is advanced by a
*cumulative logical AND* over consecutive-frame equality masks — an
associative scan, so a whole batch of heatmap states materializes in one
dispatch (replacing the serial AVX2 AND loop, aws.hpp:37-60).  Each
heatmap state is then connected-component labeled (ops.cc) and reduced to
the reference's per-frame observables: the winning contour's color, area
and bbox, where "winning" = minimal ``area * color`` with ties broken by
first discovery (= smallest component label, which ops.cc makes the
row-major first pixel — exactly aws.hpp:62-69 + cte's seed order).

The cheap stagnation/acceptance state machine (aws.hpp:110-149) stays on
the host over these per-frame scalars.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from remap_tpu.ops import cc


def heatmap_scan(
    prev_frame: jax.Array,   # [H, W] uint8 — frame before this batch
    frames: jax.Array,       # [B, H, W] uint8
    heatmap: jax.Array,      # [H, W] uint8 carry
) -> jax.Array:
    """[B, H, W] heatmap states after ANDing each consecutive equality."""
    shifted = jnp.concatenate([prev_frame[None], frames[:-1]], axis=0)
    eq = (shifted == frames).astype(jnp.uint8)
    cum = jax.lax.associative_scan(jnp.minimum, eq, axis=0)
    return cum * heatmap[None]


def best_contour(heatmap: jax.Array) -> Tuple[jax.Array, ...]:
    """(color, area, bbox) of the minimal area*color contour."""
    h, w = heatmap.shape
    big = h * w
    labels = cc.label_components(heatmap)
    area, _ = cc.component_stats(labels, heatmap)
    interior = labels < big

    score = jnp.where(
        interior, area * heatmap.astype(jnp.int32), jnp.int32(2**30)
    )
    min_score = score.min()
    # tie-break: smallest label = first row-major discovery
    cand = jnp.where(score == min_score, labels, big)
    best_label = cand.min()

    mask = labels == best_label
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    right = jnp.where(mask, xs, -1).max()
    top = jnp.where(mask, ys, h).min()
    bottom = jnp.where(mask, ys, -1).max()

    # left = the reference enclosure's quirky lower_ (cdt.hpp:183-190,
    # derivation in spec.cte.quirky_fill_lefts).  For one component the
    # row-major running-max rule collapses per row: an endpoint can only
    # be non-maximal against PRIOR rows (within a row endpoints ascend),
    # so lower_ = min over rows of (row's min endpoint x, kept iff <= the
    # exclusive running max of prior rows' max endpoint x, init 0).
    # Sentinel w = unset (SIZE_MAX); the host tracker maps it to the
    # unsigned-wrap width semantics of aws.hpp:110-139.
    shift_l = jnp.pad(mask, ((0, 0), (1, 0)))[:, :w]
    shift_r = jnp.pad(mask, ((0, 0), (0, 1)))[:, 1:]
    ep = mask & (~shift_l | ~shift_r)
    row_min = jnp.where(ep, xs, w).min(axis=1)
    row_max = jnp.where(ep, xs, -1).max(axis=1)
    running = jax.lax.cummax(row_max)
    prior = jnp.concatenate([jnp.zeros((1,), running.dtype), running[:-1]])
    prior = jnp.maximum(prior, 0)
    left = jnp.where(row_min <= prior, row_min, w).min()

    color = heatmap.reshape(-1)[best_label].astype(jnp.int32)
    best_area = area.reshape(-1)[best_label]
    return color, best_area, jnp.stack([left, top, right, bottom])


@jax.jit
def scan_batch(
    prev_frame: jax.Array, frames: jax.Array, heatmap: jax.Array
):
    """Batched heatmap advance + per-frame change flags.

    Contour labeling is NOT fused here: the heatmap only ever loses ones,
    so it stabilizes within a handful of frames and the host only labels
    the few changed states (best_contour_jit per changed frame keeps each
    compiled program small — the fused scan-of-cond-of-while variant was
    a single huge XLA program whose compiles dwarfed its runtime)."""
    heatmaps = heatmap_scan(prev_frame, frames, heatmap)
    shifted = jnp.concatenate([heatmap[None], heatmaps[:-1]], axis=0)
    changed = jnp.any(heatmaps != shifted, axis=(1, 2))
    return heatmaps, changed


@jax.jit
def best_contour_jit(heatmap: jax.Array) -> jax.Array:
    """[6] int32: (color, area, left, top, right, bottom) — one fetch."""
    color, area, bbox = best_contour(heatmap)
    return jnp.concatenate([color[None], area[None], bbox])


# --------------------------------------------------------------------------
# Robust discovery mode (cfg.discovery == "robust"): a deliberate,
# documented divergence from the reference for captures where parity mode
# emits nothing (PARITY.md: top-HUD tie latch, chrome-speck starvation).
# --------------------------------------------------------------------------

def counted_heatmap_scan(
    prev_frame: jax.Array,   # [H, W] uint8 — frame before this batch
    frames: jax.Array,       # [B, H, W] uint8
    counts: jax.Array,       # [H, W] int32 carry — change events so far
    tolerance: int,
):
    """Debounced heatmap: a pixel is "changing" only after more than
    ``tolerance`` change events.  A transient glitch (speck) contributes
    exactly two events (appear + disappear) and never marks at the
    default tolerance 2; real action pixels change constantly.  Returns
    ([B, H, W] per-frame heatmap states, [H, W] new counts carry)."""
    shifted = jnp.concatenate([prev_frame[None], frames[:-1]], axis=0)
    ev = (shifted != frames).astype(jnp.int32)
    cum = counts[None] + jnp.cumsum(ev, axis=0)
    heatmaps = (cum <= tolerance).astype(jnp.uint8)
    return heatmaps, cum[-1]


@jax.jit
def robust_scan_batch(
    prev_frame: jax.Array, frames: jax.Array, counts: jax.Array,
    tolerance: int = 2,
):
    """Batched debounced heatmap advance + per-frame change flags."""
    heatmaps, new_counts = counted_heatmap_scan(
        prev_frame, frames, counts, tolerance
    )
    first_prev = (counts <= tolerance).astype(jnp.uint8)
    shifted = jnp.concatenate([first_prev[None], heatmaps[:-1]], axis=0)
    changed = jnp.any(heatmaps != shifted, axis=(1, 2))
    return heatmaps, changed, new_counts


def robust_best_contour(heatmap: jax.Array) -> Tuple[jax.Array, ...]:
    """(color, area, bbox) of the LARGEST changed (color-0) contour.

    Parity mode's pick is min ``area * color`` with first-discovery ties
    (aws.hpp:62-69) — every changed contour scores 0, so a tiny live
    HUD digit above the play area latches forever.  Robust mode keeps
    the growth/stagnation machine but feeds it the largest changed
    contour (the play area by construction); the bbox is the TRUE pixel
    bbox (no cdt::limits running-max quirk)."""
    h, w = heatmap.shape
    big = h * w
    labels = cc.label_components(heatmap)
    area, _ = cc.component_stats(labels, heatmap)
    interior = labels < big

    is_zero = interior & (heatmap == 0)
    zarea = jnp.where(is_zero, area, 0)
    best_area = zarea.max()
    # ties -> smallest label (first row-major discovery), like parity
    cand = jnp.where(zarea == best_area, labels, big)
    best_label = cand.min()
    have = best_area > 0

    mask = labels == best_label
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    left = jnp.where(mask, xs, w).min()
    right = jnp.where(mask, xs, -1).max()
    top = jnp.where(mask, ys, h).min()
    bottom = jnp.where(mask, ys, -1).max()

    color = jnp.where(have, 0, 1).astype(jnp.int32)
    return (
        color,
        jnp.where(have, best_area, 0),
        jnp.stack([left, top, right, bottom]),
    )


@jax.jit
def robust_best_contour_jit(heatmap: jax.Array) -> jax.Array:
    """[6] int32: (color, area, left, top, right, bottom) — one fetch."""
    color, area, bbox = robust_best_contour(heatmap)
    return jnp.concatenate([color[None], area[None], bbox])
