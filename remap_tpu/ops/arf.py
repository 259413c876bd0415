"""Artifact filter device kernels (arf.hpp).

1. **Pattern heatmaps** (arf.hpp:143-186): along each row (and each
   column), every 15-pixel window of consecutively *valid* (mask != 0)
   pixels is a pattern; its global frequency becomes the heat at the
   window's center.  Device form: nibble-pack each window into 2 uint32
   words by shifted ORs, validate runs with a sliding all-valid test, sort
   (key1, key2, position) over the whole image, run-length count, and
   scatter counts back to center positions.
2. **Combine** (arf.hpp:188-212): ``1/sqrt((h+v)/2)`` float32; count 0
   gives +inf, so untagged pixels take the rare path.
3. **Select** (arf.hpp:255-307): rare pixels (heat > 0.25) take the argmax
   over a Gaussian depthwise convolution of the vote histograms restricted
   to colors present at the center; others take the plain argmax.
   Processed region: rows [margin, H-margin), cols [margin, W-margin-1)
   (the last processed column of each row is skipped — reference quirk);
   everything else outputs color 0.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


def _window_keys(image: jax.Array, mask: jax.Array, size: int):
    """Per-position packed keys + validity of the size-window ENDING here,
    along the last axis."""
    h, w = image.shape
    img = image.astype(jnp.uint32)
    # key words: nibbles 0..7 -> k1, 8..14 -> k2 (oldest pixel first)
    k1 = jnp.zeros((h, w), jnp.uint32)
    k2 = jnp.zeros((h, w), jnp.uint32)
    run_ok = jnp.ones((h, w), bool)
    for j in range(size):
        # pixel at offset -(size-1)+j within the window
        shift = size - 1 - j
        shifted = jnp.pad(img, ((0, 0), (shift, 0)))[:, :w]
        vshift = jnp.pad(mask != 0, ((0, 0), (shift, 0)))[:, :w]
        if j < 8:
            k1 = k1 | (shifted << (4 * j))
        else:
            k2 = k2 | (shifted << (4 * (j - 8)))
        run_ok = run_ok & vshift
    # windows must fit: x >= size-1
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    run_ok = run_ok & (xs >= size - 1)
    return k1, k2, run_ok


def _heat_axis(image: jax.Array, mask: jax.Array, size: int) -> jax.Array:
    """Pattern-frequency heat along the last axis (uint32 counts)."""
    h, w = image.shape
    n = h * w
    k1, k2, ok = _window_keys(image, mask, size)
    sent = jnp.uint32(0xFFFFFFFF)
    f1 = jnp.where(ok, k1, sent).reshape(-1)
    f2 = jnp.where(ok, k2, sent).reshape(-1)
    pos = jnp.arange(n, dtype=jnp.int32)

    s1, s2, spos = jax.lax.sort((f1, f2, pos), num_keys=2)
    iota = jnp.arange(n, dtype=jnp.int32)
    neq = (s1[1:] != s1[:-1]) | (s2[1:] != s2[:-1])
    is_start = jnp.concatenate([jnp.ones((1,), bool), neq])
    run_id = jnp.cumsum(is_start) - 1
    start_pos = jnp.where(is_start, iota, n)
    suffix_min = jnp.flip(jax.lax.cummin(jnp.flip(start_pos)))
    next_start = jnp.concatenate([suffix_min[1:], jnp.full((1,), n, jnp.int32)])
    run_start = jax.lax.cummax(jnp.where(is_start, iota, 0))
    run_len = next_start[run_start] - run_start

    valid = ~((s1 == sent) & (s2 == sent))
    counts = jnp.where(valid, run_len, 0).astype(jnp.uint32)
    out = jnp.zeros((n,), jnp.uint32).at[spos].set(counts)
    # window center: size//2 positions before the window end
    half = size // 2
    out2 = jnp.pad(out.reshape(h, w), ((0, 0), (0, half)))[:, half:]
    return out2


@functools.partial(jax.jit, static_argnames=("size",))
def heatmap(
    image: jax.Array, mask: jax.Array, size: int = 15
) -> jax.Array:
    """Combined rare-pattern heat: 1/sqrt((h+v)/2) (arf.hpp:188-229)."""
    hor = _heat_axis(image, mask, size)
    ver = _heat_axis(image.T, mask.T, size).T
    s = (hor.astype(jnp.float32) + ver.astype(jnp.float32)) / jnp.float32(2.0)
    return jnp.float32(1.0) / jnp.sqrt(s)


def gauss_kernel_np(dev: float) -> np.ndarray:
    """The reference's f32 kernel, bit-exact (single definition:
    spec.arf.gauss_kernel — powf emulation, see its docstring)."""
    from remap_tpu.spec import arf as spec_arf

    return spec_arf.gauss_kernel(dev)


class SelectResult(NamedTuple):
    image: jax.Array     # [H, W] uint8 picked colors
    #: [H, W] bool — rare-path pixels whose top-2 blurred scores are too
    #: close for the separable f32 blur to provably decide the canonical
    #: argmax (the reference binary's exact f32 blur); the host
    #: re-selects exactly via :func:`canonical_rare_picks`.
    unstable: jax.Array


#: Provable bound on the device f32 separable blur's relative error vs
#: the CANONICAL routine (spec.arf.rare_picks: the reference binary's
#: f32 direct convolution, exact order).  Both evaluate nonnegative
#: sums of the same real window x kernel products, so they differ by
#: (a) f32 rounding/reassociation: <= ~27 ulp per formulation, and
#: (b) the separable factor's quantization vs the true f32 kernel
#: entries (g[dy]*g[dx] != kernel[dy,dx] by <= ~3 ulp relative).
#: Total < ~60 ulp ~ 7e-6 of the top score; 1e-5 covers it (FMA fusion
#: only shrinks the device-side error).
_BLUR_REL_ERR = 1e-5


def _g1d(dev: float) -> np.ndarray:
    """Separable 1-D factor of the Gaussian kernel: g[dy]*g[dx] equals
    gauss_kernel_np(dev)[dy, dx] exactly in real arithmetic."""
    kernel = gauss_kernel_np(dev)
    margin = kernel.shape[0] // 2
    return (kernel[margin, :] / np.sqrt(kernel[margin, margin])).astype(
        np.float32
    )


@functools.partial(jax.jit, static_argnames=("dev", "threshold"))
def select(
    dots: jax.Array,      # [H, W, 16] uint16
    heat: jax.Array,      # [H, W] float32
    dev: float = 2.0,
    threshold: float = 0.25,
) -> SelectResult:
    """Conditional Gaussian-vote color selection (arf.hpp:255-307).

    Decision-stability contract: every pixel whose pick could differ from
    the canonical evaluation (remap_tpu.spec.arf.select — the reference
    binary's exact f32 blur) is flagged ``unstable``; all unflagged picks
    provably equal the canonical ones, so ``pick + host rescore of
    flagged`` is bit-exact on every backend.
    """
    h, w, depth = dots.shape
    g1d = _g1d(dev)
    size = g1d.shape[0]
    margin = size // 2

    dots_f = dots.astype(jnp.float32)
    # The 2D Gaussian a*exp(-(dx^2+dy^2)/d) is separable; blur via two
    # passes of static shifted adds.  (A depthwise conv_general_dilated
    # with feature_group_count=16 once silently produced zeros on an
    # accelerator backend; shifted adds are backend-proof and cheap for a
    # 13-tap kernel.)  Rolled wraparound only corrupts
    # the margin ring, which is excluded from the processed region below.
    # Truncated-window quirk (arf.hpp:282-287, see spec.arf.rare_picks):
    # the reference's blur row loop admits only 2*margin rows — the
    # bottom kernel row (dy = +margin) is never accumulated — so the
    # vertical pass here sums dy in [-margin, margin) only.
    rowpass = sum(
        jnp.float32(g1d[margin + t]) * jnp.roll(dots_f, -t, axis=1)
        for t in range(-margin, margin + 1)
    )
    conv = sum(
        jnp.float32(g1d[margin + t]) * jnp.roll(rowpass, -t, axis=0)
        for t in range(-margin, margin)
    )                                                  # [H, W, 16]

    present = dots > 0
    scores = jnp.where(present, conv, 0.0)
    blurred_pick = jnp.argmax(scores, axis=-1).astype(jnp.uint8)
    plain_pick = jnp.argmax(dots, axis=-1).astype(jnp.uint8)
    rare = heat > threshold
    pick = jnp.where(rare, blurred_pick, plain_pick)

    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    processed = (
        (ys >= margin)
        & (ys < h - margin)
        & (xs >= margin)
        & (xs < w - margin - 1)   # last column skipped (arf.hpp:278)
    )
    # knife-edge detection: if top1 - top2 <= err*top1 the f32 argmax is
    # not provably the canonical one (ties included: spec breaks ties by
    # lowest color index, as argmax does, but f32 may order them apart).
    # Pixels with no votes at all (top1 == 0 — e.g. the canvas's empty
    # growth margins, which are always "rare": heat = 1/sqrt(0) = inf)
    # pick color 0 deterministically and are NOT knife edges.
    top2 = jax.lax.top_k(scores, 2)[0]
    unstable = (
        rare
        & processed
        & (top2[..., 0] > 0)
        & (top2[..., 0] - top2[..., 1]
           <= jnp.float32(_BLUR_REL_ERR) * top2[..., 0])
    )
    return SelectResult(
        image=jnp.where(processed, pick, jnp.uint8(0)),
        unstable=unstable,
    )


def canonical_rare_picks(
    dots: np.ndarray,     # [H, W, 16] uint16 (host)
    ys: np.ndarray,
    xs: np.ndarray,
    dev: float = 2.0,
) -> np.ndarray:
    """Canonical rare-path color picks for the given interior pixels —
    the exact oracle the device's stability bound certifies against.
    Delegates to spec.arf.rare_picks so a SINGLE routine (the reference
    binary's f32 blur, exact kernel bits and summation order) defines
    the semantics everywhere.  Cheap: only knife-edge pixels ever need
    it."""
    from remap_tpu.spec import arf as spec_arf

    return spec_arf.rare_picks(dots, ys, xs, dev)


def filter_fragment(
    dots: jax.Array,
    blend_image: jax.Array,
    blend_mask: jax.Array,
    size: int = 15,
    dev: float = 2.0,
    threshold: float = 0.25,
) -> np.ndarray:
    """arf::filter minus the final margin crop (arf.hpp:314-328).

    Device select + exact host re-selection of the (rare) pixels the
    stability bound flags — the result is the canonical image bit-exactly
    on every backend."""
    res = filter_fragment_dispatch(
        dots, blend_image, blend_mask, size, dev, threshold
    )
    return filter_fragment_finalize(dots, res, dev)


def filter_fragment_dispatch(
    dots: jax.Array,
    blend_image: jax.Array,
    blend_mask: jax.Array,
    size: int = 15,
    dev: float = 2.0,
    threshold: float = 0.25,
):
    """The device half of :func:`filter_fragment` (async — no fetch).

    Split out so fragment-axis parallelism (parallel.fragments,
    mpb.hpp:82's thread pool on a mesh) can dispatch every fragment's
    chain to its device before the first blocking fetch."""
    heat = heatmap(blend_image, blend_mask, size)
    return select(dots, heat, dev, threshold)


@functools.partial(jax.jit, static_argnames=("size",))
def _gather_windows(dots: jax.Array, ys: jax.Array, xs: jax.Array,
                    size: int) -> jax.Array:
    """[K, size-1, size, 16] blur windows at interior pixels (ys, xs) —
    rows dy in [-margin, margin) (the truncated bottom row, see
    spec.arf.rare_picks), cols dx in [-margin, margin]."""
    margin = size // 2

    def one(y, x):
        return jax.lax.dynamic_slice(
            dots,
            (y - margin, x - margin, 0),
            (size - 1, size, dots.shape[2]),
        )

    return jax.vmap(one)(ys, xs)


def filter_fragment_finalize(dots, res, dev: float = 2.0) -> np.ndarray:
    """The host half: fetch + exact re-selection of flagged pixels.

    Only the flagged pixels' blur windows come to the host: a session
    -scale dot atlas is ~0.5 GB (4100^2 x 16 u16), while the windows
    of a handful of knife-edge pixels are ~5 KB each.
    K is padded to a power-of-two bucket so repeat flag counts reuse
    one compiled gather."""
    out = np.asarray(res.image)
    unstable = np.asarray(res.unstable)
    if unstable.any():
        from remap_tpu.spec import arf as spec_arf

        ys, xs = np.nonzero(unstable)
        kernel = spec_arf.gauss_kernel(dev)
        size = int(kernel.shape[0])
        k = len(ys)
        cap = max(64, 1 << (k - 1).bit_length())
        ys_p = np.concatenate([ys, np.full(cap - k, ys[0])]).astype(np.int32)
        xs_p = np.concatenate([xs, np.full(cap - k, xs[0])]).astype(np.int32)
        win = np.asarray(_gather_windows(
            dots, jnp.asarray(ys_p), jnp.asarray(xs_p), size
        ))[:k]
        out = out.copy()
        out[ys, xs] = spec_arf.rare_picks_from_windows(win, dev)
    return out
