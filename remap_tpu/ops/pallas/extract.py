"""Triton kernel: fused keypoint/median extraction (kpe.hpp's core).

The XLA form (``ops.kpe._extract_dense``) expands every frame into a
[B, H, W, 16] one-hot, two box-sum planes and a reversed cumsum, each a
round trip through device memory.  Here one program owns a TH x TW tile
of one frame and keeps everything in registers: it reads the 25
neighbours of each pixel (the 5x5 window, kpe.hpp:16-17) with masked
loads, so the 2-pixel halo comes from the neighbouring tiles' bytes in
L1/L2, and writes only the outputs — median, weight and four code words,
18 bytes per pixel.

- Palette lookups (native <-> luminance-ordered code) are 16-entry
  nibble tables packed into two int32 words each, so a lookup is a
  select, a shift and a mask.
- The 3x3 and 5x5 rank histograms ride as 16 8-bit counters packed four
  per int32 (a window holds at most 25 pixels), so each neighbour costs
  four selects and adds.
- The median-from-the-top walk (kpe.hpp:326-340) is straight-line code
  over the 16 ranks.

Pixels outside the frame contribute no count and read as colour 0 in
the code words, exactly as the XLA form's zero padding of the one-hot
planes and the image: the outputs are bit-equal to it everywhere, not
only inside the processed bounds.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from remap_tpu.core import palette
from remap_tpu.ops.kpe import DenseExtract
from remap_tpu.utils import backend

HALF3 = 4   # kpe.hpp:313
HALF5 = 12  # kpe.hpp:317
KH = 2      # the 5x5 window reaches 2 px

#: tile of one program: 256 pixels over 4 warps, 2 per thread (the
#: fastest of nine tiles from 4x128 to 32x64 timed on an H100 at 256x240
#: and 388x312; larger tiles hold more live counters per thread)
TILE = (8, 32)
NUM_WARPS = 4


def pack_table(table: np.ndarray) -> tuple[int, int]:
    """16 nibbles -> (entries 0-7, entries 8-15) as signed int32 words."""
    words = []
    for half in (table[:8], table[8:]):
        v = sum(int(x) << (4 * i) for i, x in enumerate(half))
        words.append(v - (1 << 32) if v >= 1 << 31 else v)
    return words[0], words[1]


def _lookup(lo: int, hi: int, v: jax.Array) -> jax.Array:
    """table[v] for v in [0, 16) from its packed words (int32)."""
    word = jnp.where(v < 8, jnp.int32(lo), jnp.int32(hi))
    return (word >> ((v & 7) * 4)) & 15


def _kernel(img_ref, med_ref, wgt_ref, codes_ref, *, n, h, w, th, tw,
            tabs):
    n2o_lo, n2o_hi, o2n_lo, o2n_hi = tabs
    b = pl.program_id(0)
    ys = pl.program_id(1) * th + jax.lax.broadcasted_iota(
        jnp.int32, (th, tw), 0)
    xs = pl.program_id(2) * tw + jax.lax.broadcasted_iota(
        jnp.int32, (th, tw), 1)
    base = b * (h * w)

    zero = jnp.zeros((th, tw), jnp.int32)
    h3 = [zero] * 4          # ranks 4j..4j+3 as 8-bit counters
    h5 = [zero] * 4
    words = [jnp.zeros((th, tw), jnp.uint32)] * 4
    p1 = zero
    for k in range(25):
        dy, dx = k // 5 - KH, k % 5 - KH
        y, x = ys + dy, xs + dx
        ok = (y >= 0) & (y < h) & (x >= 0) & (x < w)
        off = base + jnp.clip(y, 0, h - 1) * w + jnp.clip(x, 0, w - 1)
        v = plgpu.load(img_ref.at[off], mask=ok, other=0).astype(jnp.int32)
        o = _lookup(n2o_lo, n2o_hi, v)
        inc = jnp.where(ok, jnp.int32(1) << ((o & 3) * 8), 0)
        j = o >> 2
        for q in range(4):
            add = jnp.where(j == q, inc, 0)
            h5[q] = h5[q] + add
            if abs(dy) <= 1 and abs(dx) <= 1:
                h3[q] = h3[q] + add
        if dy == 0 and dx == 0:
            p1 = o
        words[k // 8] = words[k // 8] | (
            v.astype(jnp.uint32) << (4 * (k % 8)))

    # cnt_ge(r) >= half holds exactly for r <= median rank, so the
    # number of such ranks is rank + 1 (kpe.hpp:326-340)
    acc3, acc5, c3, c5 = zero, zero, zero, zero
    for r in range(15, -1, -1):
        q, sh = r >> 2, (r & 3) * 8
        acc3 = acc3 + ((h3[q] >> sh) & 255)
        acc5 = acc5 + ((h5[q] >> sh) & 255)
        c3 = c3 + jnp.where(acc3 >= HALF3, 1, 0)
        c5 = c5 + jnp.where(acc5 >= HALF5, 1, 0)
    p3 = c3 - 1
    p5 = c5 - 1

    median = _lookup(o2n_lo, o2n_hi, p3)
    weight = jnp.where(
        (p1 != p3) & (p3 != p5), jnp.where(p1 != p5, 2, 1), 0
    )
    words[3] = words[3] | (weight.astype(jnp.uint32) << 4)

    # lanes past the frame edge point past the array's end: masked off
    # on the GPU, dropped by the interpreter's scatter, never aliasing
    # a real pixel
    inside = (ys < h) & (xs < w)
    pix = jnp.where(inside, base + ys * w + xs, n)
    plgpu.store(med_ref.at[pix], median.astype(jnp.uint8), mask=inside)
    plgpu.store(wgt_ref.at[pix], weight.astype(jnp.uint8), mask=inside)
    for k in range(4):
        plgpu.store(codes_ref.at[pix * 4 + k], words[k], mask=inside)


@functools.partial(
    jax.jit, static_argnames=("tabs", "tile", "num_warps", "interpret"))
def _extract(images, tabs, tile, num_warps, interpret):
    b, h, w = images.shape
    backend.record("extract", (b, h, w), backend.TRITON)
    th, tw = tile
    grid = (b, pl.cdiv(h, th), pl.cdiv(w, tw))
    n = b * h * w
    median, weight, codes = pl.pallas_call(
        functools.partial(_kernel, n=n, h=h, w=w, th=th, tw=tw, tabs=tabs),
        grid=grid,
        out_shape=(
            jax.ShapeDtypeStruct((n,), jnp.uint8),
            jax.ShapeDtypeStruct((n,), jnp.uint8),
            jax.ShapeDtypeStruct((n * 4,), jnp.uint32),
        ),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="kpe_extract",
    )(images.reshape(n))
    return DenseExtract(
        median=median.reshape(b, h, w),
        weight=weight.reshape(b, h, w),
        codes=codes.reshape(b, h, w, 4),
    )


def extract_dense_raw(images: jax.Array, tile=TILE,
                      num_warps: int = NUM_WARPS) -> DenseExtract:
    """[B, H, W] uint8 -> unmasked dense extraction, bit-equal to
    ``ops.kpe._extract_dense`` (compiled on a GPU, interpreted
    elsewhere)."""
    tabs = pack_table(palette.NATIVE_TO_ORDERED) + pack_table(
        palette.ORDERED_TO_NATIVE)
    return _extract(images, tabs=tabs, tile=tuple(tile),
                    num_warps=num_warps, interpret=backend.interpret())
