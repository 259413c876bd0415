"""Multi-device sharded pipeline on the 8-device fake CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from remap_tpu.config import PipelineConfig
from remap_tpu.core.regions import make_layout
from remap_tpu.parallel import mesh as mesh_lib
from remap_tpu.parallel.sharded import (
    make_pipeline_step,
    make_sharded_step,
    make_streaming_step,
    segmented_positions,
)
from remap_tpu.utils import testing

CFG = PipelineConfig(
    screen_width=96, screen_height=64, region_capacity=512, frame_batch=4
)
LAYOUT = make_layout(96, 64, 4, 2, 16)


def test_mesh_axes():
    m = mesh_lib.make_mesh(8, space=2)
    assert m.shape == {"data": 4, "space": 2}
    m1 = mesh_lib.make_mesh(8)
    assert m1.shape == {"data": 8, "space": 1}


def test_segmented_positions():
    offs = jnp.asarray(
        np.array([[[0, 0], [1, 2], [3, -1], [0, 0], [2, 2]]], np.int32)
    )
    matched = jnp.asarray(np.array([[False, True, True, False, True]]))
    pos = np.asarray(segmented_positions(offs, matched))[0]
    assert pos.tolist() == [[0, 0], [1, 2], [4, 1], [0, 0], [2, 2]]


def test_sharded_step_matches_single_device():
    # 4 clips over ('data' 4, 'space' 2); must equal the unsharded step
    rng = np.random.default_rng(91)
    clips = []
    for s in range(4):
        clip = testing.simple_clip(
            n_frames=4, frame_hw=(64, 96), world_hw=(160, 224), seed=100 + s
        )
        clips.append(np.stack(clip.frames))
    images = np.stack(clips)  # [4, 4, 64, 96]

    mesh = mesh_lib.make_mesh(8, space=2)
    sharded = make_sharded_step(mesh, LAYOUT, CFG, atlas_pad=16)
    plain = jax.jit(make_pipeline_step(LAYOUT, CFG, atlas_pad=16))

    rs = sharded(images)
    rp = plain(images)
    np.testing.assert_array_equal(np.asarray(rs.offsets), np.asarray(rp.offsets))
    np.testing.assert_array_equal(np.asarray(rs.matched), np.asarray(rp.matched))
    np.testing.assert_array_equal(np.asarray(rs.atlas), np.asarray(rp.atlas))


@pytest.mark.parametrize("family", ["xcorr", "pyramid"])
def test_sharded_step_correlation_families(family):
    """BASELINE config 5 names pyramid matching for the sharded 640x480 case:
    the sharded step must run the correlation families too, equal to the
    unsharded step (clips over 'data'; the FFTs force XLA to gather the
    'space'-sharded frame axis — correct, just not where their
    parallelism comes from)."""
    rng = np.random.default_rng(17)
    world = testing.make_world(420, 540, rng, tile=8)
    clips = []
    for s in range(4):
        x0, y0 = 40 + 60 * s, 30 + 40 * s
        path = [(x0 + 5 * i, y0 + 3 * i) for i in range(4)]
        clips.append(np.stack(testing.render_clip(world, path, (192, 256)).frames))
    images = np.stack(clips)  # [4, 4, 192, 256]

    cfg = PipelineConfig(
        screen_width=256, screen_height=192, region_capacity=512,
        frame_batch=4, matcher=family,
    )
    layout = make_layout(256, 192, 4, 2, 16)
    mesh = mesh_lib.make_mesh(8, space=2)  # data 4, space 2
    sharded = make_sharded_step(mesh, layout, cfg, atlas_pad=32)
    plain = jax.jit(make_pipeline_step(layout, cfg, atlas_pad=32))

    rs = sharded(images)
    rp = plain(images)
    np.testing.assert_array_equal(np.asarray(rs.offsets), np.asarray(rp.offsets))
    np.testing.assert_array_equal(np.asarray(rs.matched), np.asarray(rp.matched))
    np.testing.assert_array_equal(np.asarray(rs.atlas), np.asarray(rp.atlas))
    # the known camera deltas must be recovered on every clip
    offs = np.asarray(rs.offsets)
    assert np.asarray(rs.matched)[:, 1:].all()
    assert (offs[:, 1:] == np.array([5, 3], np.int32)).all()


def test_streaming_reanchors_on_long_drift():
    """A drift far past atlas_pad must stitch exactly: the resident atlas
    shifts in-device under the camera instead of clamping positions."""
    rng = np.random.default_rng(7)
    world = testing.make_world(160, 224, rng)
    # monotonic rightward drift: 24 frames x 3 px = 69 px >> 2*pad (32)
    path = [(8 + 3 * i, 40) for i in range(24)]
    clip = testing.render_clip(world, path, (64, 96))
    frames = np.stack(clip.frames)

    pad = 16
    init, step = make_streaming_step(LAYOUT, CFG, atlas_pad=pad)
    step = jax.jit(step)
    state = init()
    for i in range(0, 24, 4):
        offs, ok, ovf, strayed, state = step(
            jnp.asarray(frames[i : i + 4]), state
        )
        assert not bool(np.asarray(strayed))
        assert not bool(np.asarray(ovf).any())

    anchor = np.asarray(state.anchor)
    dots = np.asarray(state.dots)  # [AH, AW, 16]
    votes = dots.sum(axis=-1)
    covered = votes > 0
    assert covered.any()
    blend = dots.argmax(axis=-1)
    # stream coord = atlas coord + anchor; world coord = stream + path[0]
    ys, xs = np.nonzero(covered)
    wy = ys + anchor[1] + path[0][1]
    wx = xs + anchor[0] + path[0][0]
    np.testing.assert_array_equal(blend[ys, xs], world[wy, wx])
    # the window really did move: the final frame's position (69, 0)
    # could not have fit the unshifted [0, 2*pad] window
    assert anchor[0] > -pad


def test_streaming_strays_on_window_overflow():
    """A batch whose position span exceeds the window (long drift + a
    mid-batch fragment break resetting to (0,0)) must flag ``strayed``."""
    rng = np.random.default_rng(8)
    world = testing.make_world(160, 224, rng)
    path = [(8 + 3 * i, 40) for i in range(21)]
    clip = testing.render_clip(world, path, (64, 96))
    frames = list(clip.frames)
    # noise frames break the match chain -> position resets to (0, 0) in
    # the same batch as the drifted frame 20 (stream position x=60)
    frames.append(rng.integers(0, 16, (64, 96), dtype=np.uint8))
    frames.append(frames[-1].copy())
    frames.append(frames[-1].copy())
    frames = np.stack(frames)

    init, step = make_streaming_step(LAYOUT, CFG, atlas_pad=16)
    step = jax.jit(step)
    state = init()
    flags = []
    for i in range(0, 24, 4):
        offs, ok, ovf, strayed, state = step(
            jnp.asarray(frames[i : i + 4]), state
        )
        flags.append(bool(np.asarray(strayed)))
    assert not any(flags[:-1])
    assert flags[-1]


def test_streaming_equals_batch_collect():
    from remap_tpu.pipeline import collect as jcollect

    clip = testing.simple_clip(
        n_frames=12, frame_hw=(64, 96), world_hw=(160, 224), seed=31
    )
    col = jcollect.collect(clip.frames, CFG)

    init, step = make_streaming_step(LAYOUT, CFG, atlas_pad=32)
    step = jax.jit(step)
    state = init()
    offs_all = []
    ok_all = []
    for i in range(0, 12, 4):
        batch = jnp.asarray(np.stack(clip.frames[i : i + 4]))
        offs, ok, ovf, strayed, state = step(batch, state)
        assert not bool(np.asarray(ovf).any())
        offs_all.extend(tuple(int(v) for v in o) for o in np.asarray(offs))
        ok_all.extend(bool(v) for v in np.asarray(ok))
    assert offs_all == [tuple(o) for o in col.offsets]
    assert ok_all == col.matched.tolist()


def _teleport_fragments(n_frags=3, seed=5):
    """Collect a clip with random-noise breaks -> n_frags fragments."""
    from remap_tpu.pipeline import collect as collect_stage

    rng = np.random.default_rng(seed)
    world = testing.make_world(200, 280, rng)
    frames = []
    for k in range(n_frags):
        x0, y0 = 10 + 60 * k, 8 + 30 * (k % 2)
        for i in range(6):
            frames.append(
                world[y0 + 2 * i : y0 + 2 * i + 64,
                      x0 + 3 * i : x0 + 3 * i + 96]
            )
        if k + 1 < n_frags:  # noise frame forces a fragment break
            frames.append(
                rng.integers(0, 16, size=(64, 96), dtype=np.uint8)
            )
    cfg = PipelineConfig(
        screen_width=96, screen_height=64, region_capacity=768,
        frame_batch=8,
    )
    col = collect_stage.collect(iter(frames), cfg)
    assert len(col.fragments) >= n_frags
    return col.fragments, cfg


def test_fragment_axis_parallel_stages_equal_serial():
    """The reference's three std::execution::par sites (mpb.hpp:82,
    fdf.hpp:24, fgs.hpp:98) as round-robin device placement: every
    fragment-parallel stage must produce results IDENTICAL to the
    serial single-device path on the 8-device mesh."""
    from remap_tpu.parallel import fragments as frag_par
    from remap_tpu.pipeline import clean as clean_stage
    from remap_tpu.pipeline import foreground as fg_stage
    from remap_tpu.pipeline import splice as splice_stage

    fragments, cfg = _teleport_fragments()
    devs = jax.local_devices()
    assert len(devs) >= 8

    # fgs.hpp:98 — snippet extraction
    par_snips = splice_stage._extract_snippets(fragments, cfg)
    ser_snips = [splice_stage._extract_snippet(f, cfg) for f in fragments]
    for a, b in zip(par_snips, ser_snips):
        np.testing.assert_array_equal(a.mask_bucket, b.mask_bucket)
        np.testing.assert_array_equal(a.codes, b.codes)
        np.testing.assert_array_equal(a.pos, b.pos)
        np.testing.assert_array_equal(a.valid, b.valid)

    # fdf.hpp:24 + the per-fragment frame loops
    par_filtered = fg_stage.filter_fragments(fragments, cfg)
    assert len(devs) > 1  # multi path really ran
    # serial path: single-fragment calls take the single-device branch
    ser_filtered = []
    for f in fragments:
        ser_filtered.extend(fg_stage.filter_fragments([f], cfg))
    for a, b in zip(par_filtered, ser_filtered):
        np.testing.assert_array_equal(a.dots, b.dots)

    # mpb.hpp:82 — arf per fragment
    par_maps = frag_par.clean_fragments(par_filtered, cfg, devs)
    ser_maps = [clean_stage.clean_fragment(f, cfg) for f in par_filtered]
    assert len(par_maps) == len(ser_maps)
    for a, b in zip(par_maps, ser_maps):
        np.testing.assert_array_equal(a, b)
