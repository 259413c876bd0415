"""Batched keypoint + median extraction (device kernel for kpe.hpp).

Where the reference streams one frame at a time through an AVX2 register
pipeline (kpe.hpp:111-306), here a whole batch of frames is processed in
one fused XLA dispatch:

- one-hot 16-channel expansion of the luminance-ordered image,
- separable 3x3 / 5x5 box sums (shifted adds — static slices, fully fusible),
- histogram "median from the top" via a monotone count->=half trick
  (``p = sum_v [cnt_ge(v) >= half] - 1``, exactly kpe.hpp:326-340),
- keypoint weights (kpe.hpp:308-324),
- descriptor codes as 4 uint32 words of packed nibbles (25-pixel patch +
  weight; canonical packing from spec.kpe.pack_code).

Everything is elementwise work on [B, H, W(, C)] arrays with static
shapes; XLA fuses the whole thing into a couple of kernels.  On a GPU the
Triton kernel of ops/pallas/extract.py replaces it (utils.backend).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from remap_tpu.core import palette
from remap_tpu.core.regions import GridLayout
from remap_tpu.utils import backend

HALF3 = 4   # kpe.hpp:313
HALF5 = 12  # kpe.hpp:317
KH = 2


class DenseExtract(NamedTuple):
    median: jax.Array   # [B, H, W] uint8 native codes (0 outside bounds)
    weight: jax.Array   # [B, H, W] uint8 in {0,1,2} (0 outside bounds)
    codes: jax.Array    # [B, H, W, 4] uint32 (garbage outside bounds)


def _shift2d(x: jax.Array, dy: int, dx: int, k: int) -> jax.Array:
    """x padded by k then sliced at offset (k+dy, k+dx): out[y] = x[y+dy]."""
    b, h, w = x.shape[:3]
    pad = [(0, 0), (k, k), (k, k)] + [(0, 0)] * (x.ndim - 3)
    xp = jnp.pad(x, pad)
    return jax.lax.slice(
        xp,
        (0, k + dy, k + dx) + (0,) * (x.ndim - 3),
        (b, k + dy + h, k + dx + w) + x.shape[3:],
    )


@functools.partial(jax.jit, static_argnames=("height", "width"))
def _extract_dense(images: jax.Array, height: int, width: int) -> DenseExtract:
    del height, width  # shapes are carried by the array; kept for cache keys
    backend.record("extract", images.shape, backend.XLA)
    nat_to_ord = jnp.asarray(palette.NATIVE_TO_ORDERED)
    ord_to_nat = jnp.asarray(palette.ORDERED_TO_NATIVE)

    ordered = nat_to_ord[images]                       # [B,H,W] uint8

    onehot = (
        ordered[..., None] == jnp.arange(16, dtype=jnp.uint8)
    ).astype(jnp.int8)                                 # [B,H,W,16]

    # Separable box sums; counts fit in int8 (max 25).
    def box(o: jax.Array, k: int) -> jax.Array:
        half = k // 2
        row = sum(
            _shift2d(o, 0, dx, half) for dx in range(-half, half + 1)
        )
        return sum(
            _shift2d(row, dy, 0, half) for dy in range(-half, half + 1)
        )

    h3 = box(onehot, 3)
    h5 = box(onehot, 5)

    # cnt_ge[v] = count of window pixels >= v; p = #true(cnt_ge >= half) - 1.
    def med(h: jax.Array, half: int) -> jax.Array:
        cge = jnp.cumsum(h[..., ::-1].astype(jnp.int8), axis=-1)[..., ::-1]
        ok = cge >= half
        return ok.sum(axis=-1).astype(jnp.uint8) - 1   # cnt_ge[0] >= half

    p3 = med(h3, HALF3)
    p5 = med(h5, HALF5)

    p1 = ordered
    median = ord_to_nat[p3]
    is_kp = (p1 != p3) & (p3 != p5)
    weight = jnp.where(
        is_kp, jnp.where(p1 != p5, jnp.uint8(2), jnp.uint8(1)), jnp.uint8(0)
    )

    # Packed descriptor codes: nibble k of the 5x5 patch -> word k//8,
    # bit 4*(k%8); weight nibble is nibble 25 (spec.kpe.pack_code).
    img32 = images.astype(jnp.uint32)
    words = []
    for widx in range(4):
        acc = jnp.zeros_like(img32)
        for slot in range(8):
            k = widx * 8 + slot
            if k >= 25:
                break
            dy, dx = k // 5 - KH, k % 5 - KH
            acc = acc | (_shift2d(img32, dy, dx, KH) << (4 * slot))
        words.append(acc)
    words[3] = words[3] | (weight.astype(jnp.uint32) << 4)
    codes = jnp.stack(words, axis=-1)                  # [B,H,W,4]

    return DenseExtract(median=median, weight=weight, codes=codes)


def extract_dense(
    images: jax.Array,
    layout: GridLayout,
    kernels: bool | None = None,
) -> DenseExtract:
    """Run the dense kernel and zero the outside-bounds median/weight.

    Processed bounds: x in [kh, W-kh), y in [kh, H-kh-2) (core.regions).
    ``kernels`` picks the Triton kernel (ops.pallas.extract, bit-equal)
    or the XLA form; None lets the device decide (utils.backend).  The
    choice is made while tracing, from static shapes.
    """
    b, h, w = images.shape
    if backend.extract_path(b, h, w, kernels) == backend.TRITON:
        from remap_tpu.ops.pallas import extract as pext

        res = pext.extract_dense_raw(images)
    else:
        res = _extract_dense(images, height=h, width=w)
    x_lo, x_hi = layout.x_proc
    y_lo, y_hi = layout.y_proc

    bounds = np.zeros((h, w), dtype=np.uint8)
    bounds[y_lo:y_hi, x_lo:x_hi] = 1
    bmask = jnp.asarray(bounds)
    return DenseExtract(
        median=res.median * bmask,
        weight=res.weight * bmask,
        codes=res.codes,
    )
