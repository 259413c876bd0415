"""Dense 2D cross-correlation alignment scoring (FFT matcher family).

The reference has no correlation matcher — its alignment is keypoint
voting (kpm.hpp).  This module is the dense alternative named by the
project north star ("dense 2D pixel cross-correlation for alignment
scoring … tiled correlation GEMMs"): the count-of-agreement score

    S[d] = #{x : curr(x) == prev(x + d)}

over all shifts |d| <= R in one batched FFT correlation of the 16 one-hot
palette channels (exact integer counts — one-hots are 0/1 floats and
counts << 2^24).  The peak gives the offset; acceptance requires the peak
to dominate the best score outside its immediate neighbourhood and to
cover a minimum fraction of the frame.

Unlike the grid-vote matcher this scores *every* pixel, so it is robust on
keypoint-poor (smooth) content; semantics intentionally differ from the
reference (use ``matcher="grid_vote"`` for reference parity).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


class XCorrResult(NamedTuple):
    offset: jax.Array   # [B, 2] int32 (dx, dy)
    ok: jax.Array       # [B] bool
    score: jax.Array    # [B] float32 peak agreement count


def _pad_dim(n: int, r: int) -> int:
    """FFT-friendly padded size >= n + 2r (multiples of 128)."""
    target = n + 2 * r
    return ((target + 127) // 128) * 128


def correlation_scores(
    prev: jax.Array,   # [B, H, W] uint8 palette codes
    curr: jax.Array,
    radius: int,
) -> jax.Array:
    """[B, 2R+1, 2R+1] float32 agreement counts for shifts in [-R, R]^2.

    score[dy + R, dx + R] = #{x : curr(x) == prev(x + d)}.
    """
    b, h, w = prev.shape
    ph, pw = _pad_dim(h, radius), _pad_dim(w, radius)

    def channel_corr(c, acc):
        a = jnp.zeros((b, ph, pw), jnp.float32)
        a = a.at[:, :h, :w].set((prev == c).astype(jnp.float32))
        bb = jnp.zeros((b, ph, pw), jnp.float32)
        bb = bb.at[:, :h, :w].set((curr == c).astype(jnp.float32))
        fa = jnp.fft.rfft2(a)
        fb = jnp.fft.rfft2(bb)
        corr = jnp.fft.irfft2(fa * jnp.conj(fb), s=(ph, pw))
        return acc + corr

    corr = jax.lax.fori_loop(
        0, 16, channel_corr, jnp.zeros((b, ph, pw), jnp.float32)
    )
    # corr[(d) mod (ph, pw)] = sum_x prev(x + d) curr(x); roll the window
    # so index 0 maps to d = -R
    win = jnp.roll(corr, (radius, radius), axis=(1, 2))[
        :, : 2 * radius + 1, : 2 * radius + 1
    ]
    return win


def correlation_scores_direct(
    prev: jax.Array, curr: jax.Array, radius: int
) -> jax.Array:
    """Same scores as :func:`correlation_scores` by direct shifted
    comparison — cheaper than FFTs for small radii (the pyramid fine
    pass): (2R+1)^2 static rolls with border masking."""
    b, h, w = prev.shape
    n = 2 * radius + 1
    rows = []
    for dy in range(-radius, radius + 1):
        cols = []
        for dx in range(-radius, radius + 1):
            # prev sampled at x + d; out-of-bounds contributes nothing
            shifted = jnp.roll(prev, (-dy, -dx), axis=(1, 2))
            eq = (shifted == curr).astype(jnp.float32)
            y0, y1 = max(0, -dy), h - max(0, dy)
            x0, x1 = max(0, -dx), w - max(0, dx)
            cols.append(eq[:, y0:y1, x0:x1].sum(axis=(1, 2)))
        rows.append(jnp.stack(cols, axis=-1))
    return jnp.stack(rows, axis=-2)  # [B, 2R+1, 2R+1]


class CanvasMatch(NamedTuple):
    offset: jax.Array    # [2] int32 (dx, dy) — head coords of other's origin
    count: jax.Array     # [] int32 agreement pixels at the peak
    overlap: jax.Array   # [] int32 overlap pixels at the peak
    ok: jax.Array        # [] bool


def _canvas_planes(
    a_img, a_mask, b_img, b_mask, ny: int, nx: int
):
    """Zero-pad both masked canvases onto a common [ny, nx] plane and
    return (agreement, overlap) full-plane correlation surfaces.

    agreement[d] = #{x : both masks on and codes equal at shift d} where a
    pixel of ``b`` at coord c is compared against ``a`` at coord c + d;
    overlap[d] counts mask intersection alone.  Exact integers (one-hot
    floats, counts << 2^24).
    """
    ha, wa = a_img.shape
    hb, wb = b_img.shape

    def plane(on, h, w):
        p = jnp.zeros((ny, nx), jnp.float32)
        return p.at[:h, :w].set(on.astype(jnp.float32))

    def corr(pa, pb):
        return jnp.fft.irfft2(
            jnp.fft.rfft2(pa) * jnp.conj(jnp.fft.rfft2(pb)), s=(ny, nx)
        )

    def channel(c, acc):
        return acc + corr(
            plane((a_img == c) & (a_mask != 0), ha, wa),
            plane((b_img == c) & (b_mask != 0), hb, wb),
        )

    agreement = jax.lax.fori_loop(
        0, 16, channel, jnp.zeros((ny, nx), jnp.float32)
    )
    overlap = corr(
        plane(a_mask != 0, ha, wa), plane(b_mask != 0, hb, wb)
    )
    return agreement, overlap


def _fft_dim(n: int) -> int:
    return ((n + 127) // 128) * 128


def _direct_rescore(a_img, a_mask, b_img, b_mask, cands):
    """Exact (agreement, overlap) int32 counts for candidate shifts.

    Both canvases land on a common [HA+HB, WA+WB] grid; candidate d
    compares ``a`` at c + d against ``b`` at c.  jnp.roll wrap-around is
    harmless: for any valid shift the wrapped rows/cols fall outside b's
    mask footprint (grid height >= ha + hb).  This is the exactness
    backstop for the f32 FFT surfaces, whose roundoff on large canvases
    can exceed 0.5 and shift an argmax or flip the ratio test.
    """
    ha, wa = a_img.shape
    hb, wb = b_img.shape
    gh, gw = ha + hb, wa + wb
    pa = jnp.zeros((gh, gw), jnp.uint8).at[:ha, :wa].set(a_img * a_mask)
    pam = jnp.zeros((gh, gw), bool).at[:ha, :wa].set(a_mask != 0)
    pb = jnp.zeros((gh, gw), jnp.uint8).at[:hb, :wb].set(b_img * b_mask)
    pbm = jnp.zeros((gh, gw), bool).at[:hb, :wb].set(b_mask != 0)

    def score_at(d):
        sa = jnp.roll(pa, (-d[1], -d[0]), axis=(0, 1))
        sam = jnp.roll(pam, (-d[1], -d[0]), axis=(0, 1))
        both = sam & pbm
        agr = jnp.sum((sa == pb) & both, dtype=jnp.int32)
        ovl = jnp.sum(both, dtype=jnp.int32)
        return agr, ovl

    return jax.lax.map(score_at, cands)


@functools.partial(jax.jit, static_argnames=("min_overlap", "ratio"))
def match_canvases(
    a_img: jax.Array,   # [HA, WA] uint8 palette codes (head fragment)
    a_mask: jax.Array,  # [HA, WA] uint8 nonzero where covered
    b_img: jax.Array,   # [HB, WB] uint8 (other fragment)
    b_mask: jax.Array,
    min_overlap: int = 1024,
    ratio: float = 0.85,
) -> CanvasMatch:
    """Masked-agreement alignment of two different-size fragment canvases.

    The xcorr/pyramid families' splice-stage matcher (the reference's
    splice is keypoint-cellular only, fgs.hpp:119-140; this is the dense
    dense alternative): every offset of the full correlation plane is
    scored by exact agreement counts, the peak maximises agreement among
    offsets with at least ``min_overlap`` covered pixels, and acceptance
    requires agreement >= ratio * overlap there.
    """
    ha, wa = a_img.shape
    hb, wb = b_img.shape
    ny, nx = _fft_dim(ha + hb), _fft_dim(wa + wb)
    agreement, overlap = _canvas_planes(a_img, a_mask, b_img, b_mask, ny, nx)

    agr = jnp.round(agreement)
    ovl = jnp.round(overlap)
    score = jnp.where(ovl >= min_overlap, agr, -1.0)
    # FFT surfaces select candidates only; the winner and its near-ties
    # are rescored by exact direct comparison (f32 roundoff on large
    # canvases can exceed 0.5 — enough to shift the argmax or flip the
    # ratio/min_overlap acceptance)
    k = 8
    _, flat_idx = jax.lax.top_k(score.reshape(-1), k)
    iy, ix = flat_idx // nx, flat_idx % nx
    # index -> signed shift: d in [-(len_b - 1), len_a - 1]
    dx = ((ix + wb - 1) % nx) - (wb - 1)
    dy = ((iy + hb - 1) % ny) - (hb - 1)
    cands = jnp.stack([dx, dy], axis=-1).astype(jnp.int32)
    agrs, ovls = _direct_rescore(a_img, a_mask, b_img, b_mask, cands)
    exact = jnp.where(ovls >= min_overlap, agrs, -1)
    best = jnp.argmax(exact)
    peak_agr, peak_ovl = agrs[best], ovls[best]
    ok = (peak_ovl >= min_overlap) & (
        peak_agr.astype(jnp.float32)
        >= jnp.float32(ratio) * peak_ovl.astype(jnp.float32)
    )
    return CanvasMatch(
        offset=cands[best],
        count=peak_agr,
        overlap=peak_ovl,
        ok=ok,
    )


@functools.partial(
    jax.jit, static_argnames=("factor", "min_overlap", "ratio")
)
def match_canvases_pyramid(
    a_img: jax.Array,
    a_mask: jax.Array,
    b_img: jax.Array,
    b_mask: jax.Array,
    factor: int = 4,
    min_overlap: int = 1024,
    ratio: float = 0.85,
) -> CanvasMatch:
    """Coarse-to-fine canvas alignment: the coarse level decimates both
    canvases by ``factor`` (stride subsampling — palette codes can't
    average) and scans the full plane; the fine level rescores the
    (2*factor+1)^2 full-resolution offsets around the upscaled coarse
    peak by direct masked comparison on a common grid."""
    ha, wa = a_img.shape
    hb, wb = b_img.shape
    coarse = match_canvases(
        a_img[::factor, ::factor],
        a_mask[::factor, ::factor],
        b_img[::factor, ::factor],
        b_mask[::factor, ::factor],
        min_overlap=max(1, min_overlap // (factor * factor)),
        ratio=ratio,
    )
    base = coarse.offset * factor

    r = factor + 2
    cand = jnp.stack(
        [
            base + jnp.array([ddx, ddy], jnp.int32)
            for ddy in range(-r, r + 1)
            for ddx in range(-r, r + 1)
        ]
    )
    agrs, ovls = _direct_rescore(a_img, a_mask, b_img, b_mask, cand)
    score = jnp.where(ovls >= min_overlap, agrs, -1)
    best = jnp.argmax(score)
    peak_agr, peak_ovl = agrs[best], ovls[best]
    ok = (peak_ovl >= min_overlap) & (
        peak_agr.astype(jnp.float32)
        >= jnp.float32(ratio) * peak_ovl.astype(jnp.float32)
    )
    return CanvasMatch(
        offset=cand[best], count=peak_agr, overlap=peak_ovl, ok=ok
    )


@functools.partial(
    jax.jit,
    static_argnames=("radius", "min_ratio", "min_cover", "exclude", "method"),
)
def match_xcorr(
    prev: jax.Array,
    curr: jax.Array,
    radius: int = 48,
    min_ratio: float = 1.10,
    min_cover: float = 0.20,
    exclude: int = 2,
    method: str = "fft",
) -> XCorrResult:
    """Peak-pick + dominance acceptance over the correlation window."""
    b, h, w = prev.shape
    if method == "direct":
        win = correlation_scores_direct(prev, curr, radius)
    else:
        win = correlation_scores(prev, curr, radius)
    n = 2 * radius + 1
    flat = win.reshape(b, -1)
    peak_idx = jnp.argmax(flat, axis=-1)
    peak = jnp.take_along_axis(flat, peak_idx[:, None], axis=-1)[:, 0]
    py = peak_idx // n
    px = peak_idx % n

    ys = jax.lax.broadcasted_iota(jnp.int32, (n, n), 0)[None]
    xs = jax.lax.broadcasted_iota(jnp.int32, (n, n), 1)[None]
    near = (jnp.abs(ys - py[:, None, None]) <= exclude) & (
        jnp.abs(xs - px[:, None, None]) <= exclude
    )
    runner = jnp.max(jnp.where(near, -jnp.inf, win), axis=(1, 2))

    # rounded counts (FFT floats are within epsilon of the true integers)
    peak_count = jnp.round(peak)
    offset = jnp.stack([px - radius, py - radius], axis=-1).astype(jnp.int32)
    ok = (peak_count >= min_cover * h * w) & (
        peak >= runner * jnp.float32(min_ratio)
    )
    return XCorrResult(offset=offset, ok=ok, score=peak)
