"""Contour-level motion detection (device form of the reference's mod.hpp).

The reference ships an (unused — no include site) contour motion detector
(mod.hpp:15-245): given two outline matrices (per-pixel contour id, color,
edge flags) and a global camera adjustment, it

1. marks contours whose aligned cells changed color or edge flags
   (mod.hpp:125-142),
2. for every marked contour's edge cell, searches a window around the
   aligned previous position for cells with identical edge flags + color,
   voting the displacement (mod.hpp:191-208),
3. declares a contour moving when its best displacement is nonzero and
   outvotes half the contour's perimeter (mod.hpp:214-237).

This is the clean batched equivalent: edge flags from shifted compares,
window search as a static shift loop, votes via per-contour segment sums.
(The reference's pointer-arithmetic boundary behavior is unspecified dead
code; boundaries here simply clip the window.)
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from remap_tpu.ops import cc


def edge_flags(image: jax.Array) -> jax.Array:
    """[H, W] uint8 edge bitmask: 1=left 2=right 4=top 8=bottom set when
    the neighbour differs or lies outside the interior (ctr.hpp:64-70,
    cte.hpp:119-147)."""
    h, w = image.shape
    img = image.astype(jnp.int32)
    pad = jnp.pad(img, 1, constant_values=-1)

    def nb(dy, dx):
        return pad[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    interior = jnp.zeros((h, w), bool).at[1:-1, 1:-1].set(True)
    out = (
        (nb(0, -1) != img).astype(jnp.uint8)
        | ((nb(0, 1) != img).astype(jnp.uint8) << 1)
        | ((nb(-1, 0) != img).astype(jnp.uint8) << 2)
        | ((nb(1, 0) != img).astype(jnp.uint8) << 3)
    )
    # border-adjacent neighbours count as edges (horizon, cte.hpp:149-166)
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    out = out | jnp.where(xs == 1, 1, 0).astype(jnp.uint8)
    out = out | jnp.where(xs == w - 2, 2, 0).astype(jnp.uint8)
    out = out | jnp.where(ys == 1, 4, 0).astype(jnp.uint8)
    out = out | jnp.where(ys == h - 2, 8, 0).astype(jnp.uint8)
    return jnp.where(interior, out, jnp.uint8(0))


class MotionResult(NamedTuple):
    offset: jax.Array    # [L, 2] int32 best displacement per label slot
    moving: jax.Array    # [L] bool
    votes: jax.Array     # [L] int32 winning vote count


@functools.partial(jax.jit, static_argnames=("half",))
def detect(
    prev_image: jax.Array,    # [H, W] uint8
    curr_image: jax.Array,
    adjustment: jax.Array,    # [2] int32 global (dx, dy) camera motion
    half: int = 4,
) -> MotionResult:
    """Per-contour motion of ``curr`` vs ``prev`` (label slots are the
    flat-index component labels of ops.cc on curr)."""
    h, w = curr_image.shape
    big = h * w

    labels = cc.label_components(curr_image)
    safe = jnp.clip(labels.reshape(-1), 0, big - 1)
    interior = labels.reshape(-1) < big

    e_curr = edge_flags(curr_image)
    e_prev = edge_flags(prev_image)

    def shift_prev(arr, dx, dy, fill):
        """prev sampled at curr position + adjustment + (dx, dy)."""
        sx = adjustment[0] + dx
        sy = adjustment[1] + dy
        pad = jnp.pad(
            arr.astype(jnp.int32),
            ((half + 64, half + 64), (half + 64, half + 64)),
            constant_values=fill,
        )
        sx = jnp.clip(sx, -(half + 64), half + 64)
        sy = jnp.clip(sy, -(half + 64), half + 64)
        return jax.lax.dynamic_slice(
            pad, (half + 64 + sy, half + 64 + sx), (h, w)
        )

    pcol = shift_prev(prev_image, 0, 0, -1)
    pedge = shift_prev(e_prev, 0, 0, -1)
    changed = (pcol != curr_image.astype(jnp.int32)) | (
        pedge != e_curr.astype(jnp.int32)
    )
    marked = (
        jax.ops.segment_max(
            jnp.where(interior & changed.reshape(-1), 1, 0),
            safe,
            num_segments=big,
        )
        > 0
    )

    is_edge_cell = (e_curr > 0).reshape(-1) & interior & marked[safe]
    perimeter = jax.ops.segment_sum(
        jnp.where((e_curr > 0).reshape(-1) & interior, 1, 0),
        safe,
        num_segments=big,
    )

    win = 2 * half + 1
    best_votes = jnp.zeros((big,), jnp.int32)
    best_off = jnp.zeros((big, 2), jnp.int32)
    # static window loop: vote (dx, dy) where prev at +adj+(dx,dy) matches
    for dy in range(-half, half + 1):
        for dx in range(-half, half + 1):
            pcol_d = shift_prev(prev_image, dx, dy, -1)
            pedge_d = shift_prev(e_prev, dx, dy, -1)
            match = (
                is_edge_cell
                & (pcol_d == curr_image.astype(jnp.int32)).reshape(-1)
                & (pedge_d == e_curr.astype(jnp.int32)).reshape(-1)
            )
            votes = jax.ops.segment_sum(
                jnp.where(match, 1, 0), safe, num_segments=big
            ).astype(jnp.int32)
            # prev matches at curr + (dx, dy), so the contour's forward
            # motion since the previous frame is -(dx, dy)
            off = jnp.array([-dx, -dy], jnp.int32)
            better = votes > best_votes
            best_off = jnp.where(better[:, None], off[None, :], best_off)
            best_votes = jnp.where(better, votes, best_votes)

    moving = (
        (best_votes > perimeter // 2)
        & ((best_off != 0).any(axis=-1))
    )
    return MotionResult(offset=best_off, moving=moving, votes=best_votes)
