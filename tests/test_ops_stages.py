"""Device aws/fde kernels + window/foreground stages vs the NumPy spec."""

import numpy as np
import jax.numpy as jnp
import pytest

from remap_tpu.config import PipelineConfig
from remap_tpu.ops import aws as jaws
from remap_tpu.ops import cc as jcc
from remap_tpu.ops import fde as jfde
from remap_tpu.pipeline import window as jwindow
from remap_tpu.spec import aws as saws
from remap_tpu.spec import cte as scte
from remap_tpu.spec import fde as sfde
from remap_tpu.utils import testing

CFG = PipelineConfig(frame_batch=16)


def test_cc_labels_match_spec():
    rng = np.random.default_rng(61)
    img = rng.integers(0, 4, size=(40, 50), dtype=np.uint8)
    jl = np.asarray(jcc.label_components(jnp.asarray(img)))
    sl = scte.label_components(img)
    # same partition: spec labels are discovery-ordered; device labels are
    # row-major-first flat indices.  Compare as partitions + root property.
    h, w = img.shape
    big = h * w
    assert (jl[0] == big).all() and (jl[:, 0] == big).all()
    for lab in np.unique(sl):
        if lab == 0:
            continue
        mask = sl == lab
        jvals = np.unique(jl[mask])
        assert len(jvals) == 1
        # device label == flat index of the component's first pixel
        ys, xs = np.nonzero(mask)
        first = ys[0] * w + xs[0]
        assert jvals[0] == first


def test_best_contour_matches_spec():
    rng = np.random.default_rng(63)
    heat = (rng.random((30, 40)) < 0.8).astype(np.uint8)
    color, area, bbox = (
        np.asarray(x) for x in jaws.best_contour(jnp.asarray(heat))
    )
    contours = scte.extract(heat).contours
    best = min(contours, key=lambda c: c.area * c.color)
    assert color == best.color
    assert area == best.area
    # bbox left = the reference enclosure's quirky lower_ (sentinel w =
    # unset), NOT the true pixel minimum (cdt.hpp:183-190)
    exp_left = best.fill_left if best.fill_left is not None else heat.shape[1]
    assert tuple(bbox) == (
        exp_left, best.bbox.top, best.bbox.right, best.bbox.bottom,
    )


def test_window_scan_matches_spec():
    clip = testing.simple_clip(
        n_frames=40,
        frame_hw=(72, 96),
        world_hw=(200, 260),
        seed=7,
        hud_rows=8,
        border=4,
        max_step=4,
    )
    swin = saws.scan(iter(clip.frames))
    jwin = jwindow.scan(iter(clip.frames), CFG)
    assert swin is not None and jwin is not None
    assert swin.raw_bounds == jwin.raw_bounds


def test_window_scan_none_for_static():
    frames = [np.full((40, 60), 7, np.uint8) for _ in range(20)]
    assert jwindow.scan(iter(frames), CFG) is None


def test_window_scan_feed_equals_iterator(tmp_path):
    """The packed/prefetched feed path of the scan (round 5: uploads
    overlap + ride packed) returns the identical window to the
    iterator path."""
    from remap_tpu.io import frames as frames_io

    clip = testing.simple_clip(
        n_frames=40, frame_hw=(72, 96), world_hw=(200, 260), seed=7,
        hud_rows=8, border=4, max_step=4,
    )
    for i, f in enumerate(clip.frames):
        f.tofile(tmp_path / f"{i:04d}")
    feed = frames_io.RawDirectoryFeed(str(tmp_path), 96, 72)
    jwin_feed = jwindow.scan(feed, CFG)
    jwin_iter = jwindow.scan(iter(clip.frames), CFG)
    assert jwin_feed is not None
    assert jwin_feed.raw_bounds == jwin_iter.raw_bounds


def test_foreground_mask_matches_spec():
    rng = np.random.default_rng(67)
    world = testing.make_world(120, 160, rng)
    bg = world[10:90, 10:130]            # 80x120 background
    frame = world[20:68, 30:94].copy()   # 48x64 at pos (20, 10) in bg
    frame[12:20, 30:38] = 3              # a sprite blob
    # a fake median: smoothed-ish (use frame itself; components of frame)
    median = frame.copy()
    pos = (20, 10)

    cres, kept = sfde.extract(bg, frame, median, pos)
    smask = sfde.foreground_mask(cres, kept, frame.shape)

    jmask = np.asarray(
        jfde.extract_batch(
            jnp.asarray(bg),
            jnp.asarray(frame[None]),
            jnp.asarray(median[None]),
            jnp.asarray(np.array([pos], np.int32)),
        )[0]
    )
    np.testing.assert_array_equal(jmask, smask)
    assert smask.sum() > 0


def test_foreground_area_limit():
    # a change covering most of the frame must be dropped (> 1/5 area)
    bg = np.zeros((60, 80), np.uint8)
    frame = np.zeros((40, 60), np.uint8)
    frame[5:35, 5:55] = 9   # huge blob, area 1500 > 480
    median = frame.copy()
    jmask = np.asarray(
        jfde.extract_batch(
            jnp.asarray(bg),
            jnp.asarray(frame[None]),
            jnp.asarray(median[None]),
            jnp.asarray(np.array([(2, 2)], np.int32)),
        )[0]
    )
    cres, kept = sfde.extract(bg, frame, median, (2, 2))
    smask = sfde.foreground_mask(cres, kept, frame.shape)
    np.testing.assert_array_equal(jmask, smask)
    # the big blob itself is dropped...
    assert jmask[20, 30] == 0


def test_window_scan_ignores_color1_winner():
    # first frames identical: heatmap all ones -> single color-1 contour
    # must NOT become a window (aws.hpp:129: only color-0 contours grow)
    rng = np.random.default_rng(71)
    base = rng.integers(0, 16, size=(40, 60), dtype=np.uint8)
    frames = [base.copy() for _ in range(6)]
    # then changes start
    for i in range(6, 20):
        f = base.copy()
        f[10:30, 10:50] = rng.integers(0, 16, size=(20, 40), dtype=np.uint8)
        frames.append(f)
    swin = __import__("remap_tpu.spec.aws", fromlist=["aws"]).scan(
        iter(frames)
    )
    jwin = jwindow.scan(iter(frames), CFG)
    assert (swin is None) == (jwin is None)
    if swin is not None:
        assert swin.raw_bounds == jwin.raw_bounds


def _reference_masks(meds, labels, changed, limit):
    """The per-frame ``fde.foreground_mask`` (checked against the spec
    by test_foreground_mask_matches_spec), vmapped over the batch: the
    reference for the sorted batch assembly."""
    import jax
    import jax.numpy as jnp

    from remap_tpu.ops import cc as cc_ops
    from remap_tpu.ops import fde as fde_ops

    labels = jnp.asarray(labels)
    qleft = cc_ops.quirky_fill_left_batch(labels)
    return np.asarray(jax.vmap(
        lambda m, c, la, q: fde_ops.foreground_mask(
            m, c, limit, labels=la, fill_left=q)
    )(jnp.asarray(meds), jnp.asarray(changed), labels, qleft))


def test_masks_from_labels_sorted_equals_original():
    """The labels-only sorted assembly (no stats kernel: bbox/changed
    derived from the sort itself) must equal the per-frame reference —
    small shapes, the >=2^16 two-key path, and random non-tile noise."""
    import jax
    import jax.numpy as jnp

    from remap_tpu.ops import cc as cc_ops
    from remap_tpu.ops import fde as fde_ops

    rng = np.random.default_rng(77)
    cases = [(24, 31, 3, 4), (17, 16, 2, 4), (40, 60, 5, 4),
             (264, 264, 24, 2)]
    for h, w, tiles, nb in cases:
        meds = []
        for _ in range(nb):
            base = rng.integers(0, 4, size=(h // tiles + 1, w // tiles + 1))
            m = np.kron(base, np.ones((tiles, tiles)))[:h, :w]
            noise = rng.random((h, w)) < 0.12
            m = np.where(noise, rng.integers(0, 4, size=(h, w)), m)
            meds.append(m.astype(np.uint8))
        meds = np.stack(meds)
        labels = np.asarray(
            jax.vmap(cc_ops.label_components)(jnp.asarray(meds))
        )
        changed = rng.random((nb, h, w)) < 0.3
        limit = (h * w) // 5
        old = _reference_masks(meds, labels, changed, limit)
        new = np.asarray(fde_ops._masks_from_labels_sorted(
            jnp.asarray(labels), jnp.asarray(changed), limit
        ))
        np.testing.assert_array_equal(old, new, err_msg=f"{h}x{w}")


def test_masks_from_labels_sorted_dense_fallback(monkeypatch):
    """Root counts past the compaction cap: the labels-only dense fill
    (sorted-order scans, no unpermutes) equals the per-frame reference."""
    import jax
    import jax.numpy as jnp

    from remap_tpu.ops import cc as cc_ops
    from remap_tpu.ops import fde as fde_ops

    rng = np.random.default_rng(13)
    meds = rng.integers(0, 8, size=(2, 20, 25), dtype=np.uint8)
    labels = np.asarray(
        jax.vmap(cc_ops.label_components)(jnp.asarray(meds))
    )
    changed = np.ones((2, 20, 25), bool)
    old = _reference_masks(meds, labels, changed, 500)
    monkeypatch.setattr(fde_ops, "_ROOT_CAP", 4)
    new = np.asarray(fde_ops._masks_from_labels_sorted(
        jnp.asarray(labels), jnp.asarray(changed), 500
    ))
    np.testing.assert_array_equal(old, new)


def test_masks_per_frame_escalation_mixed_batch(monkeypatch):
    """One poisoned frame in a clean batch rides the static dense
    subset (tier 2 of fde._escalated_fill) while the rest stay on the
    compacted path; above _DENSE_FRAMES the whole batch goes dense
    (tier 3).  All tiers equal the per-frame reference."""
    import jax
    import jax.numpy as jnp

    from remap_tpu.ops import cc as cc_ops
    from remap_tpu.ops import fde as fde_ops

    rng = np.random.default_rng(23)
    # frames 0/2/3 nearly flat (few components); frame 1 iid noise
    meds = np.zeros((4, 20, 25), np.uint8)
    meds[0, 5:9, 3:8] = 1
    meds[1] = rng.integers(0, 8, size=(20, 25))
    meds[2, 2:4, 2:4] = 3
    meds[3, 10, :] = 2
    labels = np.asarray(
        jax.vmap(cc_ops.label_components)(jnp.asarray(meds))
    )
    changed = np.ones((4, 20, 25), bool)
    old = _reference_masks(meds, labels, changed, 500)
    monkeypatch.setattr(fde_ops, "_ROOT_CAP", 16)
    over = [
        int((np.unique(labels[i][labels[i] < 20 * 25])).size) > 16
        for i in range(4)
    ]
    assert over == [False, True, False, False], over

    for variant in ("subset", "full"):
        if variant == "full":
            # force tier 3: subset capacity below the poisoned count
            monkeypatch.setattr(fde_ops, "_DENSE_FRAMES", 0)
        new_l = np.asarray(fde_ops._masks_from_labels_sorted(
            jnp.asarray(labels), jnp.asarray(changed), 500
        ))
        np.testing.assert_array_equal(old, new_l, err_msg=variant)


def test_arf_finalize_window_gather_equals_full_canvas():
    """filter_fragment_finalize re-selects flagged pixels from device
    -gathered blur windows; must equal the old full-canvas download
    path (spec.arf.rare_picks on the whole dot atlas) bit-for-bit."""
    import jax.numpy as jnp

    from remap_tpu.ops import arf as jarf
    from remap_tpu.spec import arf as sarf

    rng = np.random.default_rng(3)
    h, w = 60, 72
    dots = rng.integers(0, 50, size=(h, w, 16)).astype(np.uint16)
    image = rng.integers(0, 16, size=(h, w)).astype(np.uint8)
    margin = sarf.gauss_kernel(2.0).shape[0] // 2
    unstable = np.zeros((h, w), bool)
    ys = rng.integers(margin, h - margin, 9)
    xs = rng.integers(margin, w - margin - 1, 9)
    unstable[ys, xs] = True
    res = jarf.SelectResult(
        image=jnp.asarray(image), unstable=jnp.asarray(unstable)
    )

    new = jarf.filter_fragment_finalize(jnp.asarray(dots), res, 2.0)

    old = image.copy()
    fy, fx = np.nonzero(unstable)
    old[fy, fx] = sarf.rare_picks(dots, fy, fx, 2.0)
    np.testing.assert_array_equal(old, new)


def test_arf_finalize_no_flags_is_passthrough():
    import jax.numpy as jnp

    from remap_tpu.ops import arf as jarf

    rng = np.random.default_rng(4)
    image = rng.integers(0, 16, size=(20, 30)).astype(np.uint8)
    res = jarf.SelectResult(
        image=jnp.asarray(image),
        unstable=jnp.asarray(np.zeros((20, 30), bool)),
    )
    dots = jnp.asarray(np.zeros((20, 30, 16), np.uint16))
    np.testing.assert_array_equal(
        image, jarf.filter_fragment_finalize(dots, res, 2.0)
    )
