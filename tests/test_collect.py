"""Batched collect stage vs the spec collector (bit-exact canvases)."""

import dataclasses

import numpy as np
import pytest

from remap_tpu.config import PipelineConfig
from remap_tpu.core.regions import make_layout
from remap_tpu.pipeline import collect as jcollect
from remap_tpu.pipeline.state import pack_nibbles, unpack_nibbles
from remap_tpu.spec import frc as sfrc
from remap_tpu.utils import testing

CFG = PipelineConfig(
    screen_width=96,
    screen_height=64,
    region_capacity=2048,
    frame_batch=8,
)


def compare(frames):
    layout = make_layout(96, 64, 4, 2, 16)
    jres = jcollect.collect(frames, CFG, layout)
    assert jres.overflow_frames == 0
    sfrags = sfrc.collect(frames, layout)

    assert len(jres.fragments) == len(sfrags)
    for jf, sf in zip(jres.fragments, sfrags):
        assert jf.zero == (0, 0) and sf.zero == (0, 0)
        assert jf.dots.shape == sf.dots.shape
        np.testing.assert_array_equal(jf.dots, sf.dots)
        assert [(r.number, r.position) for r in jf.frames] == [
            (r.number, r.position) for r in sf.frames
        ]
    return jres, sfrags


def test_single_fragment_clip():
    clip = testing.simple_clip(
        n_frames=20, frame_hw=(64, 96), world_hw=(160, 224), seed=41
    )
    jres, _ = compare(clip.frames)
    # offsets equal true camera deltas
    true = clip.offsets
    got = [tuple(o) for o in jres.offsets[1:]]
    assert got == true


def test_fragment_breaks():
    clip_a = testing.simple_clip(n_frames=7, seed=43)
    rng = np.random.default_rng(44)
    noise = rng.integers(0, 16, size=(64, 96), dtype=np.uint8)
    clip_b = testing.simple_clip(n_frames=6, seed=45)
    frames = clip_a.frames + [noise] + clip_b.frames
    jres, _ = compare(frames)
    assert len(jres.fragments) == 3


@pytest.mark.slow
def test_batch_boundary_invariance():
    # results must not depend on the device batch size
    clip = testing.simple_clip(
        n_frames=13, frame_hw=(64, 96), world_hw=(160, 224), seed=47
    )
    ref = None
    for batch in (4, 5, 13, 32):
        cfg = dataclasses.replace(CFG, frame_batch=batch)
        res = jcollect.collect(clip.frames, cfg)
        got = (
            [tuple(o) for o in res.offsets],
            res.matched.tolist(),
            len(res.fragments),
        )
        if ref is None:
            ref = got
        assert got == ref, batch


@pytest.mark.slow
def test_drain_depth_invariance(tmp_path):
    """Results must not depend on how many dispatched batches are kept
    in flight (collect_drain_depth) — on either the feed fast path or
    the iterator path."""
    from remap_tpu.io.frames import RawDirectoryFeed

    clip = testing.simple_clip(
        n_frames=21, frame_hw=(64, 96), world_hw=(160, 224), seed=53
    )
    d = tmp_path / "frames"
    d.mkdir()
    for i, f in enumerate(clip.frames):
        f.astype(np.uint8).tofile(str(d / str(i)))

    ref = None
    for depth in (1, 2, 8):
        cfg = dataclasses.replace(
            CFG, frame_batch=4, collect_drain_depth=depth
        )
        for source in (
            clip.frames,
            RawDirectoryFeed(str(d), 96, 64),
        ):
            res = jcollect.collect(source, cfg)
            got = (
                [tuple(o) for o in res.offsets],
                res.matched.tolist(),
                len(res.fragments),
            )
            if ref is None:
                ref = got
            assert got == ref, (depth, type(source).__name__)


def test_store_roundtrip():
    import dataclasses as _dc

    clip = testing.simple_clip(n_frames=5, seed=49)
    jres = jcollect.collect(
        clip.frames, _dc.replace(CFG, store_medians=True)
    )
    for i, f in enumerate(clip.frames):
        np.testing.assert_array_equal(jres.store.image(i), f)
    # medians: stored medians match spec extraction
    from remap_tpu.spec import kpe as skpe

    layout = make_layout(96, 64, 4, 2, 16)
    s = skpe.extract(clip.frames[2], layout)
    np.testing.assert_array_equal(jres.store.median(2), s.median)


def test_nibble_packing_odd_width():
    rng = np.random.default_rng(50)
    img = rng.integers(0, 16, size=(9, 31), dtype=np.uint8)
    np.testing.assert_array_equal(unpack_nibbles(pack_nibbles(img), 31), img)


def test_strict_retry_on_repetitive_texture():
    # heavy code repetition (tiled world) forces join-multiplicity
    # overflow at tiny limits; strict retry must converge to exact offsets
    import dataclasses as _dc

    rng = np.random.default_rng(53)
    tile = rng.integers(0, 16, size=(6, 6), dtype=np.uint8)
    world = np.tile(tile, (30, 40)).astype(np.uint8)
    # sparsely sprinkle distinct pixels so keypoints repeat but match
    ys, xs = np.nonzero(rng.random(world.shape) < 0.02)
    world[ys, xs] = rng.integers(0, 16, size=len(ys)).astype(np.uint8)

    frames = [
        world[y : y + 64, x : x + 96]
        for x, y in [(20, 20), (22, 21), (25, 23), (24, 26)]
    ]
    cfg = _dc.replace(
        CFG, region_capacity=512, join_multiplicity=1, frame_batch=4
    )
    res = jcollect.collect(frames, cfg)
    assert res.overflow_frames == 0  # retries resolved everything

    from remap_tpu.spec import frc as sfrc

    layout = make_layout(96, 64, 4, 2, 16)
    sfrags = sfrc.collect(frames, layout)
    assert len(res.fragments) == len(sfrags)
    for jf, sf in zip(res.fragments, sfrags):
        np.testing.assert_array_equal(jf.dots, sf.dots)


@pytest.mark.slow
def test_incremental_repair_matches_exhaustive():
    """The strict loop re-matches only flagged pairs; the result must
    equal a run with exhaustive limits from the start (the stability
    bounds say unflagged pairs need no retry — verify it)."""
    import dataclasses as _dc

    rng = np.random.default_rng(31)
    # distinct-texture world => most pairs never flag...
    world = rng.integers(0, 16, size=(180, 240), dtype=np.uint8)
    # ...except a repetitive-tile stripe the camera crosses mid-clip,
    # which overwhelms a multiplicity-1 join there
    tile = rng.integers(0, 16, size=(4, 4), dtype=np.uint8)
    world[:, 100:140] = np.tile(tile, (45, 10))

    path = [(10 + 6 * i, 30 + (i % 3)) for i in range(16)]
    frames = [world[y : y + 64, x : x + 96] for x, y in path]

    tight = _dc.replace(
        CFG, region_capacity=512, join_multiplicity=1, frame_batch=4,
        vote_radius=4,
    )
    res = jcollect.collect(frames, tight)
    assert res.overflow_frames == 0

    exhaustive = _dc.replace(
        CFG, region_capacity=2048, join_multiplicity=0, frame_batch=4,
        vote_radius=0,
    )
    ref = jcollect.collect(frames, exhaustive)
    np.testing.assert_array_equal(res.offsets, ref.offsets)
    np.testing.assert_array_equal(res.matched, ref.matched)
    assert len(res.fragments) == len(ref.fragments)
    for a, b in zip(res.fragments, ref.fragments):
        np.testing.assert_array_equal(a.dots, b.dots)


def test_strict_sort2_quota_escalates_to_topk():
    """HUD-like content packs solid keypoint rows (> SORT2_QUOTA per
    512-px chunk).  With explicit table_mode="sort2" the strict loop must
    switch to the quota-free top_k selection — NOT escalate capacity,
    which can never clear a density-based flag — and converge exactly."""
    import dataclasses as _dc

    rng = np.random.default_rng(11)
    world = rng.integers(0, 16, size=(128, 160), dtype=np.uint8)
    frames = []
    for x, y in [(10, 10), (12, 11), (15, 13), (14, 16)]:
        f = world[y : y + 64, x : x + 96].copy()
        # dense alternating stripe band: nearly every pixel of these rows
        # is a keypoint, far beyond the per-chunk quota
        f[8:20] = np.tile(
            np.array([[1, 9], [9, 1]], np.uint8), (6, 48)
        )
        frames.append(f)

    cfg = _dc.replace(CFG, table_mode="sort2", frame_batch=4)
    res = jcollect.collect(frames, cfg)
    assert res.overflow_frames == 0

    ref = jcollect.collect(frames, _dc.replace(CFG, table_mode="topk",
                                               frame_batch=4))
    np.testing.assert_array_equal(res.offsets, ref.offsets)
    np.testing.assert_array_equal(res.matched, ref.matched)


def test_collect_from_feed_matches_iterator(tmp_path):
    """collect() fed a RawDirectoryFeed (the packed native fast path)
    must produce exactly what the plain frame-iterator path does."""
    from remap_tpu.io import frames as fio

    rng = np.random.default_rng(21)
    world = testing.make_world(170, 220, rng)
    path = testing.make_camera_path(12, (170, 220), (64, 96), rng,
                                    max_step=3)
    frames = [world[y : y + 64, x : x + 96] for x, y in path]
    for i, f in enumerate(frames):
        (tmp_path / str(i)).write_bytes(f.tobytes())

    feed = fio.RawDirectoryFeed(str(tmp_path), 96, 64)
    ref = jcollect.collect(frames, CFG)
    got = jcollect.collect(feed, CFG)
    np.testing.assert_array_equal(got.offsets, ref.offsets)
    np.testing.assert_array_equal(got.matched, ref.matched)
    assert len(got.fragments) == len(ref.fragments)
    for a, b in zip(got.fragments, ref.fragments):
        np.testing.assert_array_equal(a.dots, b.dots)


def test_device_mirror_gather_matches_host():
    """FrameStore's HBM mirror must return exactly the host rows, fall
    back when numbers are outside the mirrored range, and disable
    itself on non-contiguous donation."""
    import jax.numpy as jnp

    from remap_tpu.pipeline.state import FrameStore, pack_nibbles_batch

    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 16, size=(7, 10, 12), dtype=np.uint8)
    packed = pack_nibbles_batch(imgs)

    store = FrameStore(10, 12)
    store.put_packed_batch([0, 1, 2], packed[:3],
                           device_packed=jnp.asarray(packed[:3]))
    store.put_packed_batch([3, 4], packed[3:5],
                           device_packed=jnp.asarray(packed[3:5]))
    store.put_packed_batch([5, 6], packed[5:7])   # host-only tail
    got = np.asarray(store.device_packed_batch([4, 0, 2]))
    np.testing.assert_array_equal(got, packed[[4, 0, 2]])
    # numbers beyond the mirrored range -> host upload fallback
    got = np.asarray(store.device_packed_batch([5, 1]))
    np.testing.assert_array_equal(got, packed[[5, 1]])

    # non-contiguous donation disables the mirror for the store
    store2 = FrameStore(10, 12)
    store2.put_packed_batch([2, 3], packed[2:4],
                            device_packed=jnp.asarray(packed[2:4]))
    assert store2._dev_parts is None
    got = np.asarray(store2.device_packed_batch([3]))
    np.testing.assert_array_equal(got, packed[[3]])


def test_median_mirror_and_store_budget():
    """The median mirror returns exactly the host rows; a zero budget
    (frame_store="host") disables both mirrors; the foreground pass is
    identical either way."""
    import jax.numpy as jnp

    from remap_tpu.config import PipelineConfig
    from remap_tpu.pipeline import foreground as fg
    from remap_tpu.pipeline.state import FrameStore, pack_nibbles_batch

    rng = np.random.default_rng(8)
    imgs = rng.integers(0, 16, size=(6, 10, 12), dtype=np.uint8)
    meds = rng.integers(0, 16, size=(6, 10, 12), dtype=np.uint8)
    packed = pack_nibbles_batch(imgs)
    pmeds = pack_nibbles_batch(meds)

    store = FrameStore(10, 12, device_budget=1 << 30)
    store.put_packed_batch(
        [0, 1, 2], packed[:3], pmeds[:3],
        device_packed=jnp.asarray(packed[:3]),
        device_packed_medians=jnp.asarray(pmeds[:3]),
    )
    store.put_packed_batch(
        [3, 4, 5], packed[3:], pmeds[3:],
        device_packed=jnp.asarray(packed[3:]),
        device_packed_medians=jnp.asarray(pmeds[3:]),
    )
    got = np.asarray(store.device_packed_medians_batch([4, 1, 5]))
    np.testing.assert_array_equal(got, pmeds[[4, 1, 5]])

    # zero budget: donations are refused, fallbacks return host rows
    s0 = FrameStore(10, 12, device_budget=0)
    s0.put_packed_batch(
        [0, 1], packed[:2], pmeds[:2],
        device_packed=jnp.asarray(packed[:2]),
        device_packed_medians=jnp.asarray(pmeds[:2]),
    )
    assert s0._dev_parts is None and s0._dev_parts_m is None
    np.testing.assert_array_equal(
        np.asarray(s0.device_packed_batch([1])), packed[[1]]
    )
    np.testing.assert_array_equal(
        np.asarray(s0.device_packed_medians_batch([0])), pmeds[[0]]
    )

    # fdf equality across residency modes on a real clip
    from remap_tpu.pipeline import collect as jcollect
    from remap_tpu.utils import testing

    clip = testing.simple_clip(n_frames=8, frame_hw=(48, 64), seed=33)
    outs = {}
    for mode in ("hbm", "host"):
        cfg = PipelineConfig(
            screen_width=64, screen_height=48, frame_batch=4,
            region_capacity=2048, store_medians=True, frame_store=mode,
        )
        col = jcollect.collect(iter(clip.frames), cfg)
        filtered = fg.filter_fragments(col.fragments, cfg)
        outs[mode] = [np.asarray(f.dots) for f in filtered]
    assert len(outs["hbm"]) == len(outs["host"])
    for a, b in zip(outs["hbm"], outs["host"]):
        np.testing.assert_array_equal(a, b)


def test_capacity_escalation_jumps_to_measured_count(monkeypatch):
    """On dense content the strict loop must reach a sufficient table
    capacity in ONE retry — the pass measures the true per-region
    keypoint maximum (tables.wcounts is counted over the full slab), so
    blind doubling's one-replay-per-level walk is provably redundant."""
    import dataclasses as _dc

    rng = np.random.default_rng(77)
    # busy noise: nearly every pixel is a keypoint => kp/region far
    # above a deliberately tiny starting capacity
    world = rng.integers(0, 16, size=(180, 240), dtype=np.uint8)
    path = [(20 + 2 * i, 30 + (i % 3)) for i in range(8)]
    frames = [world[y : y + 64, x : x + 96] for x, y in path]

    calls = []
    real = jcollect.match_pass

    def counting(frames_, layout_, cfg_, store_=None):
        calls.append(cfg_.region_capacity)
        return real(frames_, layout_, cfg_, store_)

    monkeypatch.setattr(jcollect, "match_pass", counting)

    tiny = _dc.replace(CFG, region_capacity=128, frame_batch=8)
    res = jcollect.collect(frames, tiny)
    assert res.overflow_frames == 0

    # pass 1 at 128 + exactly one capacity retry (jumped straight to a
    # power of two that holds the measured max; doubling would have
    # walked 256, 512, ... one full pass each)
    cap_passes = [c for c in calls if c != 128] or []
    assert calls[0] == 128
    assert len(calls) == 2, f"capacity ladder walked: {calls}"
    assert cap_passes and cap_passes[0] >= 1024, calls

    ref = jcollect.collect(
        frames, _dc.replace(CFG, region_capacity=8192, frame_batch=8)
    )
    np.testing.assert_array_equal(res.offsets, ref.offsets)
    np.testing.assert_array_equal(res.matched, ref.matched)
    for a, b in zip(res.fragments, ref.fragments):
        np.testing.assert_array_equal(a.dots, b.dots)
