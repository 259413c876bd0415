"""Connected-component labeling on device (device form of cte.hpp).

The reference BFS-flood-fills equal-valued 4-connected components bounded
by a 1-px horizon border (cte.hpp:103-147).  The device formulation is
iterative **min-label propagation with pointer jumping**: every interior
pixel starts labeled with its own flat index; each step takes the min label
over equal-valued 4-neighbours, then short-circuits chains by gathering
``label[label]`` (path halving).  The fixpoint assigns every component the
flat index of its *row-major first pixel* — exactly the reference's
discovery order (cte.hpp:65-79), which downstream tie-breaks rely on
(aws.hpp:62-69 picks the first minimal-score contour).

Border pixels keep the sentinel label (they are never part of a component,
cte.hpp:149-166).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def _neighbor_min(labels: jax.Array, image: jax.Array, big: int) -> jax.Array:
    """Min label over same-valued 4-neighbours (without crossing values)."""

    def shifted(arr, dy, dx, fill):
        return jnp.roll(arr, (dy, dx), axis=(-2, -1))

    out = labels
    for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        nl = shifted(labels, dy, dx, big)
        nv = shifted(image, dy, dx, 0)
        same = nv == image
        # roll wraps; wrapped pixels are border (sentinel) or masked by the
        # border sentinel itself, so they never propagate a real label.
        out = jnp.minimum(out, jnp.where(same, nl, big))
    return out


@jax.jit
def label_components(image: jax.Array) -> jax.Array:
    """[H, W] -> int32 labels; interior pixels get their component's
    row-major-first flat index, border pixels get H*W (sentinel).

    The propagate+jump loop runs to the fixpoint (labels are monotone
    decreasing and bounded, so termination is guaranteed; path halving
    makes the iteration count ~log of the component diameter).
    """
    h, w = image.shape
    big = h * w

    iota = jnp.arange(big, dtype=jnp.int32).reshape(h, w)
    # horizon = 1-px frame EXCEPT the bottom, which is 2 px: cte::
    # clear_outline horizons the last two rows (cte.hpp:155-165; verified
    # against the compiled reference, tests/differential/)
    interior = jnp.zeros((h, w), bool).at[1:-2, 1:-1].set(True)
    labels = jnp.where(interior, iota, big)

    # Sentinel-value border: give border pixels an impossible image value so
    # equal-value propagation never crosses the horizon (cte.hpp:149-166).
    img = jnp.where(interior, image.astype(jnp.int32), -1)

    def body(state):
        labels, _ = state
        # several cheap propagation sweeps (rolls) per expensive pointer
        # jump (the jump is a full-image gather, ~14ns/element here)
        nxt = labels
        for _ in range(4):
            nxt = jnp.minimum(
                nxt, jnp.where(interior, _neighbor_min(nxt, img, big), big)
            )
        # pointer jumping: label <- label[label] (clamped for sentinel)
        flat = nxt.reshape(-1)
        jumped = flat[jnp.clip(flat, 0, big - 1)]
        jumped = jnp.where(flat == big, big, jumped).reshape(h, w)
        changed = jnp.any(jumped != labels)
        return jumped, changed

    def cond(state):
        return state[1]

    labels, _ = jax.lax.while_loop(
        cond, body, (labels, jnp.asarray(True))
    )
    return labels


@jax.jit
def component_stats(
    labels: jax.Array, image: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """Per-pixel component statistics.

    Returns (area, color) where area[y, x] = size of the component of
    (y, x) (0 on the border) and color is the image value.  Areas come from
    a segment count over flat labels.
    """
    h, w = labels.shape
    big = h * w
    flat = labels.reshape(-1)
    counts = jax.ops.segment_sum(
        jnp.where(flat < big, 1, 0),
        jnp.clip(flat, 0, big - 1),
        num_segments=big,
    )
    area = jnp.where(flat < big, counts[jnp.clip(flat, 0, big - 1)], 0)
    return area.reshape(h, w), image


def _quirky_parts(labels: jax.Array):
    """Per-frame pieces shared by both quirky-left paths: endpoint mask,
    per-label true left / existence, and the case-B flag (see
    :func:`quirky_fill_left`)."""
    h, w = labels.shape
    big = h * w
    flat = labels.reshape(-1)
    safe = jnp.clip(flat, 0, big - 1)

    def shifted_lab(dx):
        rolled = jnp.roll(labels, -dx, axis=1)
        xs_ = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
        ok = (xs_ + dx >= 0) & (xs_ + dx < w)
        return jnp.where(ok, rolled, big + 1)

    diff_l = labels != shifted_lab(-1)
    diff_r = labels != shifted_lab(1)
    ep = ((diff_l | diff_r) & (labels < big)).reshape(-1)
    xs = (jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)).reshape(-1)

    true_left = jax.ops.segment_min(
        jnp.where(ep, xs, w), safe, num_segments=big
    )
    exists = (
        jax.ops.segment_sum(jnp.where(ep, 1, 0), safe, num_segments=big) > 0
    )
    cnt_min = jax.ops.segment_sum(
        jnp.where(ep & (xs == true_left[safe]), 1, 0),
        safe,
        num_segments=big,
    )
    first_x = jnp.arange(big, dtype=jnp.int32) % w
    case_b = exists & (true_left == first_x) & (cnt_min == 1)
    return ep, xs, flat, true_left, exists, jnp.any(case_b)


def _quirky_fast(true_left, exists, w):
    return jnp.where(exists, true_left, w)


def _quirky_sorted(ep, xs, flat, w):
    """Sort endpoints by (label, position); segmented exclusive cummax
    of x; segment-min over the non-running-max values."""
    big = flat.shape[0]
    pos = jnp.arange(big, dtype=jnp.int32)
    key = jnp.where(ep, flat, big)              # non-endpoints sort last
    sl, _, sx = jax.lax.sort((key, pos, xs), num_keys=2)
    starts = jnp.concatenate([jnp.ones((1,), bool), sl[1:] != sl[:-1]])
    seg = jnp.cumsum(starts.astype(jnp.int32)) - 1
    comb = seg * (w + 1) + sx
    incl = jax.lax.cummax(comb) - seg * (w + 1)
    prior = jnp.concatenate([jnp.zeros((1,), incl.dtype), incl[:-1]])
    prior = jnp.where(starts, 0, prior)         # upper_ init (unsigned 0)
    include = (sl < big) & (sx <= prior)
    return jax.ops.segment_min(
        jnp.where(include, sx, w),
        jnp.clip(sl, 0, big - 1),
        num_segments=big,
    )


def quirky_fill_left(labels: jax.Array) -> jax.Array:
    """The reference enclosure's ``lower_`` per component — its quirky
    bbox-left (cdt.hpp:183-190 via ctr.hpp:96-109; full derivation in
    spec.cte.quirky_fill_lefts): the minimum over run-endpoint xs that
    are NOT strict running maxima in row-major endpoint order.

    Returns [H*W] int32 indexed by label: the quirky left, or ``w``
    when unset (= the reference's SIZE_MAX — downstream fills clamp to
    an empty span).

    The quirky left differs from the true minimum iff the minimum x
    occurs ONLY at the component's first endpoint ("case B").  That
    first endpoint's x is free: labels are the component's first pixel's
    flat index, and the first pixel is the top row's leftmost — so
    first_x = label mod w.  A cheap detector (two segment ops) gates the
    exact sort-based evaluation behind ``lax.cond``, so the common
    no-case-B frame pays no sort.  Batched callers must use
    :func:`quirky_fill_left_batch` — under vmap, ``cond`` lowers to
    ``select`` and BOTH branches would run for every frame.
    """
    w = labels.shape[1]
    ep, xs, flat, true_left, exists, case_b = _quirky_parts(labels)
    return jax.lax.cond(
        case_b,
        lambda _: _quirky_sorted(ep, xs, flat, w),
        lambda _: _quirky_fast(true_left, exists, w),
        None,
    )


def quirky_fill_left_batch(labels: jax.Array) -> jax.Array:
    """Batched :func:`quirky_fill_left` ([B, H, W] -> [B, H*W]) with the
    case-B detector hoisted OVER the batch: the whole batch takes the
    sorted path only when some frame needs it, so the common case pays
    two segment ops per frame and no sort."""
    w = labels.shape[2]
    ep, xs, flat, true_left, exists, case_b = jax.vmap(_quirky_parts)(labels)
    return jax.lax.cond(
        jnp.any(case_b),
        lambda _: jax.vmap(_quirky_sorted, in_axes=(0, 0, 0, None))(
            ep, xs, flat, w
        ),
        lambda _: jax.vmap(_quirky_fast, in_axes=(0, 0, None))(
            true_left, exists, w
        ),
        None,
    )
