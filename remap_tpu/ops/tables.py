"""Fixed-capacity per-region keypoint tables (device form of kpr.hpp).

The reference stores keypoints in per-region hash maps code -> point list
(kpr.hpp:93-156).  On the device we need static shapes: each grid region
becomes a table of up to ``capacity`` keypoints (codes as 4 uint32 words, positions,
validity), selected from the region's rectangle in row-major order.  Weight
counts are *uncapped* (they feed the active/weight-switch logic,
kpm.hpp:188-197/213-223); an overflow flag reports when a region had more
keypoints than capacity so callers can re-run with a bigger table.

Region rectangles come from core.regions.GridLayout (overlap bands are
cartesian products of contiguous x/y spans, so each region is one static
slice).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from remap_tpu.core.regions import GridLayout


class RegionTables(NamedTuple):
    codes: jax.Array     # [B, R, K, 4] uint32
    pos: jax.Array       # [B, R, K, 2] int32 — (x, y) frame coords
    valid: jax.Array     # [B, R, K] bool
    wcounts: jax.Array   # [B, R, 3] int32 — full counts per weight (0,1,2)
    overflow: jax.Array  # [B, R] bool


def _region_table(
    weight_slab: jax.Array,  # [B, rh, rw] uint8
    codes_slab: jax.Array,   # [B, rh, rw, 4] uint32
    x_lo: int,
    y_lo: int,
    capacity: int,
    mode: str = "topk",
):
    b, rh, rw = weight_slab.shape
    n = rh * rw
    wflat = weight_slab.reshape(b, n)
    cflat = codes_slab.reshape(b, n, 4)
    if n < capacity:  # tiny regions: pad up to the table size
        pad = capacity - n
        wflat = jnp.pad(wflat, ((0, 0), (0, pad)))
        cflat = jnp.pad(cflat, ((0, 0), (0, pad), (0, 0)))
        n = capacity

    # Row-major top-K compaction.  Two formulations with identical
    # results: "topk" (top_k keys + one payload gather) fuses better
    # inside the full pipeline step; "sort" (one 5-operand sort, zero
    # gathers) is faster standalone.  Positions and validity derive from
    # the selection keys either way.
    if mode == "sort":
        idx = jnp.arange(n, dtype=jnp.int32)[None].repeat(b, axis=0)
        sent = jnp.int32(1 << 30)
        key = jnp.where(wflat > 0, idx, sent)
        skey, c0, c1, c2, c3 = jax.lax.sort(
            (key, cflat[..., 0], cflat[..., 1], cflat[..., 2],
             cflat[..., 3]),
            num_keys=1,
            dimension=1,
        )
        skey = skey[:, :capacity]
        codes = jnp.stack(
            [c0[:, :capacity], c1[:, :capacity], c2[:, :capacity],
             c3[:, :capacity]],
            axis=-1,
        )
        valid = skey < sent
        sel = jnp.where(valid, skey, 0)
    else:
        idx = jnp.arange(n, dtype=jnp.int32)
        key = jnp.where(wflat > 0, jnp.int32(1 << 30) - idx, -idx)
        vals, sel = jax.lax.top_k(key, capacity)      # [B, K]
        valid = vals > (1 << 29)
        codes = jnp.take_along_axis(cflat, sel[..., None], axis=1)
        sel = jnp.where(valid, sel, 0)

    xs = (sel % rw).astype(jnp.int32) + x_lo
    ys = (sel // rw).astype(jnp.int32) + y_lo
    pos = jnp.stack([xs, ys], axis=-1)

    w1 = (wflat == 1).sum(axis=1).astype(jnp.int32)
    w2 = (wflat == 2).sum(axis=1).astype(jnp.int32)
    wcounts = jnp.stack([jnp.zeros_like(w1), w1, w2], axis=-1)
    overflow = (w1 + w2) > capacity
    return codes, pos, valid, wcounts, overflow


#: "sort2" level-1 chunk length and per-chunk keep quota.  A chunk with
#: more than QUOTA keypoints trips the table overflow flag (exactness
#: bound; the densest 512-px chunk measured on the bench clips holds 69).
SORT2_CHUNK = 512
SORT2_QUOTA = 128


def _region_table_sort2(
    weight_slab: jax.Array,  # [B, rh, rw] uint8
    codes_slab: jax.Array,   # [B, rh, rw, 4] uint32
    x_lo: int,
    y_lo: int,
    capacity: int,
):
    """Two-level row-major selection: sort cheap uint16 *local* keys
    within 512-px chunks (level 1), then merge the per-chunk survivors'
    global keys (level 2).  ~2x faster than the flat top_k at VGA scale
    (level 1 touches 16-bit keys over tiny spans; level 2 sorts only
    quota*chunks elements), and bit-identical to it whenever no chunk
    exceeds SORT2_QUOTA keypoints — denser chunks trip the overflow flag
    and ride the escalation path (strict callers re-run)."""
    b, rh, rw = weight_slab.shape
    n = rh * rw
    wflat = weight_slab.reshape(b, n)
    cflat = codes_slab.reshape(b, n, 4)
    s = SORT2_CHUNK
    pad = (-n) % s
    flags = jnp.pad(wflat > 0, ((0, 0), (0, pad))).reshape(b, -1, s)
    nch = flags.shape[1]

    lio = jnp.arange(s, dtype=jnp.uint16)
    lk = jnp.where(flags, lio, jnp.uint16(0x7FFF))
    kept = jax.lax.sort(lk, dimension=2)[:, :, :SORT2_QUOTA]
    cio = jnp.arange(nch, dtype=jnp.uint32)[None, :, None]
    sent = jnp.uint32(1) << 30
    glob = jnp.where(
        kept < 0x7FFF, cio * s + kept.astype(jnp.uint32), sent
    ).reshape(b, -1)
    if glob.shape[1] < capacity:   # tiny regions: pad up to the table
        glob = jnp.pad(
            glob, ((0, 0), (0, capacity - glob.shape[1])),
            constant_values=1 << 30,
        )
    skey = jax.lax.sort(glob, dimension=1)[:, :capacity]

    valid = skey < sent
    sel = jnp.where(valid, skey, 0).astype(jnp.int32)
    codes = jnp.take_along_axis(cflat, sel[..., None], axis=1)
    pos = jnp.stack(
        [(sel % rw) + x_lo, (sel // rw) + y_lo], axis=-1
    )
    w1 = (wflat == 1).sum(axis=1).astype(jnp.int32)
    w2 = (wflat == 2).sum(axis=1).astype(jnp.int32)
    wcounts = jnp.stack([jnp.zeros_like(w1), w1, w2], axis=-1)
    chunk_ovf = (
        flags.sum(axis=-1, dtype=jnp.int32) > SORT2_QUOTA
    ).any(axis=-1)
    overflow = ((w1 + w2) > capacity) | chunk_ovf
    return codes, pos, valid, wcounts, overflow


def resolve_table_mode(mode: str) -> str:
    """Resolve "auto": the flat top_k, exact at any chunk density and
    any shape."""
    return "topk" if mode == "auto" else mode


def build_tables(
    weight: jax.Array,   # [B, H, W] uint8
    codes: jax.Array,    # [B, H, W, 4] uint32
    layout: GridLayout,
    capacity: int,
    mode: str = "topk",
) -> RegionTables:
    """Extract all R region tables; regions stack on axis 1 in index order
    xs * grid_h + ys (kpr.hpp:68-91)."""
    mode = resolve_table_mode(mode)
    per_region = []
    for xs in range(layout.grid_w):
        for ys in range(layout.grid_h):
            x_lo, x_hi, y_lo, y_hi = layout.region_span(xs, ys)
            wslab = weight[:, y_lo:y_hi, x_lo:x_hi]
            cslab = codes[:, y_lo:y_hi, x_lo:x_hi]
            if mode == "sort2":
                per_region.append(
                    _region_table_sort2(wslab, cslab, x_lo, y_lo, capacity)
                )
            else:
                per_region.append(
                    _region_table(wslab, cslab, x_lo, y_lo, capacity, mode)
                )
    return RegionTables(
        codes=jnp.stack([r[0] for r in per_region], axis=1),
        pos=jnp.stack([r[1] for r in per_region], axis=1),
        valid=jnp.stack([r[2] for r in per_region], axis=1),
        wcounts=jnp.stack([r[3] for r in per_region], axis=1),
        overflow=jnp.stack([r[4] for r in per_region], axis=1),
    )


@functools.partial(jax.jit, static_argnames=("layout", "capacity"))
def extract_tables(
    weight: jax.Array, codes: jax.Array, layout: GridLayout, capacity: int
) -> RegionTables:
    return build_tables(weight, codes, layout, capacity)
