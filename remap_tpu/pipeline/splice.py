"""Fragment splicing stage (fgs.hpp).

Fragments are blended + keypoint-extracted with a whole-image 1x1 grid
(fgs.hpp:17/80-103, device ops), matched all-pairs with the cellular
matcher (ops.splice, cell 15x15, fgs.hpp:119-140), then a host greedy loop
merges the highest-vote pair (ties -> first in snippet order / edge
insertion order, fgs.hpp:142-163), re-extracts the merged snippet (list
front), re-matches it against the rest, and repeats until no edges remain.

Canvas merges replay fgm's step-quantized growth exactly (the merged
canvas size feeds the next extraction's processed bounds).

Matcher families: ``cfg.matcher == "grid_vote"`` (default) is the
reference-parity cellular keypoint matcher above; ``"xcorr"`` and
``"pyramid"`` instead align canvases with the dense masked-agreement
correlation (ops.correlate.match_canvases), whose peak agreement count
plays the cellular vote count's role in the greedy merge order — so the
``--matcher`` flag now selects the family in *every* stage that matches.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from remap_tpu.config import PipelineConfig
from remap_tpu.core.regions import make_layout
from remap_tpu.ops import atlas as atlas_ops
from remap_tpu.ops import correlate
from remap_tpu.ops import kpe as kpe_ops
from remap_tpu.ops import splice as splice_ops
from remap_tpu.ops import tables as table_ops
from remap_tpu.pipeline.state import Fragment, FrameRef

_BUCKET = 128


def _bucket(n: int) -> int:
    return ((n + _BUCKET - 1) // _BUCKET) * _BUCKET


@dataclasses.dataclass(eq=False)
class _Edge:
    primary: bool
    offset: Tuple[int, int]
    count: int
    other: "_Snippet"


@dataclasses.dataclass(eq=False)
class _Snippet:
    fragment: Fragment
    mask_bucket: np.ndarray          # [HB, WB] uint8 zero-padded blend mask
    dims: Tuple[int, int]            # (w, h) true canvas dims
    codes: np.ndarray                # [K, 4] uint32
    pos: np.ndarray                  # [K, 2] int32
    valid: np.ndarray                # [K] bool
    edges: List[_Edge] = dataclasses.field(default_factory=list)
    image_bucket: Optional[np.ndarray] = None   # correlation families only


#: Snippet extraction canvas-shape bucket: merged canvases take arbitrary
#: step-quantized sizes, and a per-size compiled program made a cold
#: multi-fragment splice pay one compile per merge level.  The
#: canvas pads (bottom/right, zero dots) to multiples of this and the
#: extraction masks weights to the TRUE canvas's processed interior —
#: bit-identical to exact-canvas extraction, because every interior
#: keypoint's 3x3/5x5 windows lie fully inside the true canvas (the pad
#: is never read where a weight survives).
_SHAPE_BUCKET = 256


def _shape_bucket(n: int) -> int:
    return ((n + _SHAPE_BUCKET - 1) // _SHAPE_BUCKET) * _SHAPE_BUCKET


@functools.partial(jax.jit, static_argnames=("hb", "wb"))
def _pad_canvas_jit(dots, hb, wb):
    h, w = dots.shape[:2]
    return jnp.pad(dots, ((0, hb - h), (0, wb - w), (0, 0)))


@functools.partial(
    jax.jit, static_argnames=("gt", "gb", "gl", "gr")
)
def _merge_canvas_jit(ldots, rdots, gt, gb, gl, gr, ay, ax):
    """Step-quantized growth + histogram add on device (fgm.hpp:99-113
    blit semantics, uint16 wrap).  Growths are static (they set the
    output shape); the blit position is traced, so every merge at the
    same (shapes, growth) signature reuses one program."""
    dots = jnp.pad(ldots, ((gt, gb), (gl, gr), (0, 0)))
    start = (ay, ax, jnp.int32(0))
    view = jax.lax.dynamic_slice(dots, start, rdots.shape)
    return jax.lax.dynamic_update_slice(dots, view + rdots, start)


@functools.partial(jax.jit, static_argnames=("kh", "grid_vote"))
def _snippet_device(dots_padded, ch, cw, kh, grid_vote):
    """One program per canvas-shape bucket: blend (+ masked dense
    extract for grid_vote).  ``ch``/``cw`` are TRACED true dims."""
    image, mask = atlas_ops.blend(dots_padded)
    if not grid_vote:
        return image, mask, None, None, None
    hb2, wb2 = image.shape
    layout = make_layout(wb2, hb2, 1, 1, 0)
    dense = kpe_ops.extract_dense(image[None], layout)
    ys = jax.lax.broadcasted_iota(jnp.int32, (hb2, wb2), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (hb2, wb2), 1)
    # the true canvas's processed interior (core.regions: x in
    # [kh, W-kh), y in [kh, H-kh-2) incl. the reference's bottom quirk)
    tmask = (
        (ys >= kh) & (ys < ch - kh - 2) & (xs >= kh) & (xs < cw - kh)
    )
    w8 = dense.weight[0] * tmask.astype(jnp.uint8)
    total = (w8 > 0).sum()
    return image, mask, w8, dense.codes[0], total


def _snippet_dispatch(frag: Fragment, cfg: PipelineConfig, device=None):
    """Device half of snippet extraction (async, no fetch): blend (+
    dense keypoint extract for grid_vote) on ``device``."""
    import jax as _jax

    ch, cw = frag.shape
    hb2, wb2 = _shape_bucket(ch), _shape_bucket(cw)
    dots = (
        frag.device_dots()
        if device is None
        else jax.device_put(frag.device_dots(), device)
    )
    if (hb2, wb2) != (ch, cw):
        # pad on device (no session-scale canvas upload); shape buckets
        # bound the compiles
        dots = _pad_canvas_jit(dots, hb2, wb2)
    image, mask, w8, codes, total_dev = _snippet_device(
        dots,
        jnp.int32(ch),
        jnp.int32(cw),
        kh=cfg.kernel_half,
        grid_vote=cfg.matcher == "grid_vote",
    )
    return frag, image, mask, (w8, codes), total_dev


def _snippet_finalize(pend, cfg: PipelineConfig) -> _Snippet:
    frag, image, mask, dense_pack, total_dev = pend
    ch, cw = frag.shape
    hb, wb = _bucket(ch), _bucket(cw)
    mask_np = np.zeros((hb, wb), np.uint8)
    mask_np[:ch, :cw] = np.asarray(mask)[:ch, :cw]

    if total_dev is None:
        # correlation families match blended canvases directly — no
        # keypoint tables needed
        image_np = np.zeros((hb, wb), np.uint8)
        image_np[:ch, :cw] = np.asarray(image)[:ch, :cw]
        return _Snippet(
            fragment=frag,
            mask_bucket=mask_np,
            dims=(cw, ch),
            codes=np.zeros((0, 4), np.uint32),
            pos=np.zeros((0, 2), np.int32),
            valid=np.zeros((0,), bool),
            image_bucket=image_np,
        )

    # the reference keeps EVERY keypoint of the blended canvas in its
    # hash-map region (fgs.hpp:80-103); a fixed-capacity table that
    # silently truncates makes the 0.66 cell-ratio validation reject
    # merges the reference accepts (found by the compiled-reference e2e
    # differential on a teleport clip).  Size the table to the true
    # keypoint count, in x4 buckets to bound recompiles.
    w8, codes = dense_pack
    total = int(np.asarray(total_dev))
    cap = cfg.splice_capacity
    while cap < total:
        cap *= 4
    hb2, wb2 = w8.shape
    layout = make_layout(wb2, hb2, 1, 1, 0)
    # positions computed over the shape-bucketed slab equal true-canvas
    # coords (the pad is bottom/right) and row-major selection order is
    # width-invariant, so these tables are bit-identical to exact-canvas
    # extraction (tests/test_ops_splice.py::test_bucketed_snippet_...)
    tabs = table_ops.extract_tables(w8[None], codes[None], layout, cap)
    assert not bool(np.asarray(tabs.overflow).any()), (
        "splice table overflow despite count-sized capacity"
    )

    return _Snippet(
        fragment=frag,
        mask_bucket=mask_np,
        dims=(cw, ch),
        codes=np.asarray(tabs.codes[0, 0]),
        pos=np.asarray(tabs.pos[0, 0]),
        valid=np.asarray(tabs.valid[0, 0]),
    )


def _extract_snippet(frag: Fragment, cfg: PipelineConfig) -> _Snippet:
    return _snippet_finalize(_snippet_dispatch(frag, cfg), cfg)


def _extract_snippets(
    fragments: List[Fragment], cfg: PipelineConfig
) -> List[_Snippet]:
    """Initial snippet extraction across devices — the reference's
    parallel transform (fgs.hpp:91-103) as round-robin device placement:
    every fragment's blend + dense extract dispatches before the first
    blocking fetch, so N devices extract N snippets concurrently.  (The
    greedy loop's merged-snippet re-extraction is inherently one at a
    time and stays on the default device.)"""
    import jax

    devs = jax.local_devices()
    if len(devs) == 1 or len(fragments) == 1:
        return [_extract_snippet(f, cfg) for f in fragments]
    pending = [
        _snippet_dispatch(f, cfg, devs[i % len(devs)])
        for i, f in enumerate(fragments)
    ]
    return [_snippet_finalize(p, cfg) for p in pending]


def _canon_dim(n: int) -> int:
    """Power-of-two mask-bucket dims (floor 128).

    Rounding the pad-state dims to powers of two makes the matcher's
    compile signature CANONICAL: any session at a given canvas scale
    hits the same (capacity, bucket, multiplicity) triple, so the
    persistent compile cache (utils.runtime.setup_cache) serves the
    ~110 s session-scale pair-match compile (benchmarks/
    fgs_match_probe.py) from disk on every later session.  The 128-
    granular rolling max it replaces produced per-session exact sizes
    the cache never saw twice."""
    return max(_BUCKET, 1 << (int(n) - 1).bit_length())


class _PadState:
    """Clip-wide compile-shape canonicalization for the splice matchers.

    The cellular matcher compiles per (table capacity, mask bucket,
    multiplicity) signature; a cold multi-fragment map used to pay one
    compile per pair combination.  Padding every pair to the
    ROLLING MAXIMUM capacity and power-of-two mask bucket over live
    snippets is semantics-invariant — extra table rows are invalid
    (sentinel codes), the mask bucket enters only as zero padding and
    key strides, and the validation spans use the true dims — so the
    whole greedy stage reuses ONE program per multiplicity until a
    merged snippet exceeds the previous maximum (at most one new shape
    per DOUBLING, and the shapes recur across sessions — see
    :func:`_canon_dim`)."""

    def __init__(self) -> None:
        self.cap = 0
        self.hb = 0
        self.wb = 0

    def update(self, snippets: List["_Snippet"]) -> None:
        for s in snippets:
            self.cap = max(self.cap, s.codes.shape[0])
            self.hb = max(self.hb, _canon_dim(s.mask_bucket.shape[0]))
            self.wb = max(self.wb, _canon_dim(s.mask_bucket.shape[1]))

    def mask(self, s: "_Snippet") -> np.ndarray:
        m = s.mask_bucket
        if m.shape == (self.hb, self.wb):
            return m
        return np.pad(
            m, ((0, self.hb - m.shape[0]), (0, self.wb - m.shape[1]))
        )

    def image(self, s: "_Snippet") -> np.ndarray:
        im = s.image_bucket
        if im.shape == (self.hb, self.wb):
            return im
        return np.pad(
            im, ((0, self.hb - im.shape[0]), (0, self.wb - im.shape[1]))
        )


def _needed_multiplicity(head: _Snippet, other: _Snippet) -> int:
    """Host-side replica of the join's ``needed_multiplicity``: the max,
    over valid curr (= ``other``) rows, of how many valid prev (=
    ``head``) rows share its code quadruple.  Knowing it BEFORE the
    first device match lets the cellular matcher start at a sufficient
    multiplicity instead of discovering it by overflowing — at session
    scale each discarded ladder level was a ~110 s remote XLA compile
    and the whole fgs wall was exactly two of them
    (benchmarks/fgs_match_probe.py: compile 105-120 s/level, exec
    0.03-0.22 s).  A numpy unique over ~1M code rows costs ~0.1 s."""
    pc = head.codes[head.valid]
    cc = other.codes[other.valid]
    if pc.shape[0] == 0 or cc.shape[0] == 0:
        return 0
    void = np.dtype((np.void, pc.dtype.itemsize * 4))
    pv = np.ascontiguousarray(pc).view(void).ravel()
    cv = np.ascontiguousarray(cc).view(void).ravel()
    uniq, counts = np.unique(pv, return_counts=True)
    present = np.isin(uniq, cv)
    return int(counts[present].max()) if present.any() else 0


def _match(
    head: _Snippet, other: _Snippet, cfg: PipelineConfig,
    pad: Optional[_PadState] = None,
) -> Optional[Tuple[Tuple[int, int], int]]:
    if pad is None:
        pad = _PadState()
        pad.update([head, other])
    if cfg.matcher != "grid_vote":
        # dense correlation families (bucketed canvases bound recompiles;
        # zero padding is masked out, so offsets are exact)
        fn = (
            correlate.match_canvases
            if cfg.matcher == "xcorr"
            else correlate.match_canvases_pyramid
        )
        res = fn(
            jnp.asarray(pad.image(head)),
            jnp.asarray(pad.mask(head)),
            jnp.asarray(pad.image(other)),
            jnp.asarray(pad.mask(other)),
            min_overlap=cfg.splice_min_overlap,
            ratio=cfg.splice_xcorr_ratio,
        )
        if not bool(res.ok):
            return None
        off = tuple(int(v) for v in np.asarray(res.offset))
        return off, int(res.count)

    # pair tables pad to the clip-wide rolling max capacity (one compile
    # signature per stage, not per pair combination)
    k = pad.cap

    def padded(s):
        extra = k - s.codes.shape[0]
        if extra == 0:
            return s.codes, s.pos, s.valid
        return (
            np.pad(s.codes, ((0, extra), (0, 0))),
            np.pad(s.pos, ((0, extra), (0, 0))),
            np.pad(s.valid, (0, extra)),
        )

    h_codes, h_pos, h_valid = padded(head)
    o_codes, o_pos, o_valid = padded(other)
    mult = cfg.join_multiplicity
    est = _needed_multiplicity(head, other)
    if est > mult:
        # jump-start the ladder at the host-measured need (pow2 for
        # canonical compile signatures); the overflow retry below stays
        # as the safety net
        nm = 1 << (est - 1).bit_length()
        mult = 0 if 4 * nm >= k else nm
    while True:
        res = splice_ops.match_fragments(
            jnp.asarray(h_codes),
            jnp.asarray(h_pos),
            jnp.asarray(h_valid),
            jnp.asarray(o_codes),
            jnp.asarray(o_pos),
            jnp.asarray(o_valid),
            # pad-state (canonical pow2) mask shape, not the snippet's
            # own 128-granular bucket: the mask dims are part of the
            # compile signature (_canon_dim)
            jnp.asarray(pad.mask(head)),
            jnp.asarray(np.array(head.dims, np.int32)),
            jnp.asarray(np.array(other.dims, np.int32)),
            cell_w=cfg.splice_cell[0],
            cell_h=cfg.splice_cell[1],
            ratio=cfg.splice_cell_ratio,
            multiplicity=mult,
        )
        # blended fragments repeat tile patterns; on truncation, jump
        # the multiplicity straight to the join's own measure of the
        # maximum code repetition (rounded to a power of two to bound
        # recompiles) — one retry enumerates every pair.  The dense
        # [K, K] join is only ever used when it is CHEAPER than the
        # rolled form (tiny tables): at session-scale canvases (500k+
        # keypoints) dense was an OOM cliff that real content's tiny
        # repetition (measured max 5 on a 4096^2 tile world) never needs.
        if not bool(res.overflow) or mult == 0:
            break
        needed = int(res.needed_multiplicity)
        nm = max(2 * mult, 2)
        while nm < needed:
            nm *= 2
        if 4 * nm >= k:
            mult = 0      # dense is cheaper than rolled at this ratio
        else:
            mult = nm
    if not bool(res.ok):
        return None
    off = tuple(int(v) for v in np.asarray(res.offset))
    return off, int(res.count)


def _match_partial(
    head: _Snippet, rest: List[_Snippet], cfg: PipelineConfig,
    pad: Optional[_PadState] = None,
) -> None:
    for other in rest:
        vote = _match(head, other, cfg, pad)
        if vote is not None:
            off, count = vote
            head.edges.append(_Edge(True, off, count, other))
            other.edges.append(
                _Edge(False, (-off[0], -off[1]), count, head)
            )


def _unbind(snippet: _Snippet) -> None:
    for e in snippet.edges:
        e.other.edges = [x for x in e.other.edges if x.other is not snippet]
    snippet.edges = []


def merge_fragments(
    left: Fragment, right: Fragment, offset: Tuple[int, int],
    step: Tuple[int, int],
) -> Fragment:
    """fgm::fragment::blit(zero + offset, other) + normalize
    (fgs.hpp:165-183, fgm.hpp:99-113,190-233): histogram-add the right
    canvas into the left at ``left.zero + offset`` with step-quantized
    growth, remap the right's frame records."""
    pos = (left.zero[0] + offset[0], left.zero[1] + offset[1])
    rh, rw = right.shape
    lh, lw = left.shape

    def round_step(change: int, s: int) -> int:
        rest = change % s
        return change - rest + (s if rest else 0)

    zx, zy = left.zero
    grow_l = round_step(zx - pos[0], step[0]) if pos[0] < zx else 0
    grow_r = (
        round_step(pos[0] + rw - (zx + lw), step[0])
        if pos[0] + rw > zx + lw
        else 0
    )
    grow_t = round_step(zy - pos[1], step[1]) if pos[1] < zy else 0
    grow_b = (
        round_step(pos[1] + rh - (zy + lh), step[1])
        if pos[1] + rh > zy + lh
        else 0
    )
    zero = (zx - grow_l, zy - grow_t)
    ax, ay = pos[0] - zero[0], pos[1] - zero[1]
    # merge on device: both canvases are already (or become) device
    # resident and the grown result feeds straight into the next snippet
    # re-extraction, with no host round trip per canvas
    dots_dev = _merge_canvas_jit(
        left.device_dots(), right.device_dots(),
        grow_t, grow_b, grow_l, grow_r,
        jnp.int32(ay), jnp.int32(ax),
    )

    frames = [FrameRef(f.number, f.position) for f in left.frames]
    for f in right.frames:
        frames.append(
            FrameRef(
                f.number,
                (
                    f.position[0] - right.zero[0] + pos[0],
                    f.position[1] - right.zero[1] + pos[1],
                ),
            )
        )
    merged = Fragment(
        dots_dev=dots_dev, zero=zero, frames=frames, store=left.store
    )
    merged.normalize()
    return merged


def splice(
    fragments: List[Fragment],
    cfg: PipelineConfig,
    frame_dims: Optional[Tuple[int, int]] = None,
) -> List[Fragment]:
    """frame_dims = (width, height) — the growth step (frc fragments carry
    step = frame dims, fgm.hpp:49-52)."""
    if not fragments:
        return []
    if frame_dims is None:
        assert fragments[0].store is not None
        frame_dims = (fragments[0].store.width, fragments[0].store.height)

    snippets = _extract_snippets(fragments, cfg)
    pad = _PadState()
    pad.update(snippets)
    for i in range(len(snippets)):
        _match_partial(snippets[i], snippets[i + 1 :], cfg, pad)

    while True:
        best: Optional[Tuple[_Snippet, _Edge]] = None
        for s in snippets:
            for e in s.edges:
                if e.primary and (best is None or e.count > best[1].count):
                    best = (s, e)
        if best is None:
            break
        left, edge = best
        right = edge.other

        merged_frag = merge_fragments(
            left.fragment, right.fragment, edge.offset, frame_dims
        )
        _unbind(right)
        _unbind(left)
        snippets = [s for s in snippets if s is not left and s is not right]
        merged = _extract_snippet(merged_frag, cfg)
        snippets.insert(0, merged)
        pad.update([merged])
        _match_partial(snippets[0], snippets[1:], cfg, pad)

    return [s.fragment for s in snippets]
