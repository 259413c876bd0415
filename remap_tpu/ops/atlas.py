"""Fragment atlas device kernels (fgm.hpp).

The reference grows a per-fragment canvas of 16-bin vote histograms and
blits frames one at a time (fgm.hpp:71-113,176-233).  Here the canvas is a
static padded [Ha, Wa, 16] uint16 array; a whole batch of frames is
blitted in one scatter-add of its votes (positions are known up front
from the batched matcher, so no growth logic is needed — the extent is
computed on the host and padded to a bucket size to bound recompiles).

Vote counts wrap at 65535 exactly like the C++ ``++uint16`` (fgm.hpp:12-15).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

DEPTH = 16  # fgm.hpp:12


@functools.partial(jax.jit, static_argnames=("atlas_h", "atlas_w"))
def blit_frames(
    frames: jax.Array,          # [F, H, W] uint8
    positions: jax.Array,       # [F, 2] int32 (x, y) atlas coords, in-bounds
    atlas_h: int,
    atlas_w: int,
    masks: Optional[jax.Array] = None,   # [F, H, W] uint8; vote where == 0
    dots: Optional[jax.Array] = None,    # [Ha, Wa, 16] uint16 to accumulate
) -> jax.Array:
    """Scatter color votes of all frames into an atlas (fgm.hpp:71-97).

    One int32 scatter-add of the whole batch: pixel (y, x) of frame i
    adds 1 at ``[pos_y + y, pos_x + x, color]``.  Pixels that do not vote
    (masked, or a value past the palette) index past the canvas and are
    dropped.  The counts join the canvas modulo 2^16 (fgm.hpp:12-15)."""
    _, h, w = frames.shape
    if dots is None:
        dots = jnp.zeros((atlas_h, atlas_w, DEPTH), dtype=jnp.uint16)
    size = atlas_h * atlas_w * DEPTH
    ys = positions[:, 1, None, None] + jnp.arange(h)[None, :, None]
    xs = positions[:, 0, None, None] + jnp.arange(w)[None, None, :]
    color = frames.astype(jnp.int32)
    votes = color < DEPTH
    if masks is not None:
        votes &= masks == 0
    idx = jnp.where(votes, (ys * atlas_w + xs) * DEPTH + color, size)
    counts = jnp.zeros(size, jnp.int32).at[idx.reshape(-1)].add(
        1, mode="drop")
    total = dots.astype(jnp.int32) + counts.reshape(atlas_h, atlas_w, DEPTH)
    return (total & 0xFFFF).astype(jnp.uint16)


@jax.jit
def blend(dots: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """(image, mask): argmax color per pixel, mask = any votes
    (fgm.hpp:115-135; first-max wins like std::max_element)."""
    image = jnp.argmax(dots, axis=-1).astype(jnp.uint8)
    mask = (dots.max(axis=-1) > 0).astype(jnp.uint8)
    return image * mask, mask


@jax.jit
def add_fragment(
    dots: jax.Array, other: jax.Array, pos: jax.Array
) -> jax.Array:
    """Histogram-add a whole fragment canvas at pos (fgm.hpp:99-113)."""
    h, w, _ = other.shape
    cur = jax.lax.dynamic_slice(dots, (pos[1], pos[0], 0), (h, w, DEPTH))
    return jax.lax.dynamic_update_slice(dots, cur + other, (pos[1], pos[0], 0))


@jax.jit
def margins(dots: jax.Array) -> jax.Array:
    """[left, top, right, bottom] empty-margin counts (fgm.hpp:145-153).

    All-empty canvases return [W, H, W, H] like the reference.
    """
    h, w, _ = dots.shape
    nonempty = dots.max(axis=-1) > 0
    cols = nonempty.any(axis=0)
    rows = nonempty.any(axis=1)
    any_at_all = cols.any()

    first_col = jnp.argmax(cols)
    last_col = w - 1 - jnp.argmax(cols[::-1])
    first_row = jnp.argmax(rows)
    last_row = h - 1 - jnp.argmax(rows[::-1])

    res = jnp.stack(
        [first_col, first_row, w - 1 - last_col, h - 1 - last_row]
    ).astype(jnp.int32)
    return jnp.where(any_at_all, res, jnp.array([w, h, w, h], jnp.int32))
