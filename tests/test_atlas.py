"""ops.atlas.blit_frames against a plain per-frame, per-pixel loop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from remap_tpu.ops import atlas


def _blit_ref(frames, positions, atlas_h, atlas_w, masks=None, dots=None):
    """fgm.hpp:71-97 one frame at a time, uint16 counters."""
    out = (np.zeros((atlas_h, atlas_w, 16), np.uint16) if dots is None
           else np.array(dots, np.uint16))
    for i, frame in enumerate(frames):
        x, y = positions[i]
        for fy, fx in np.ndindex(frame.shape):
            c = int(frame[fy, fx])
            if c < 16 and (masks is None or masks[i, fy, fx] == 0):
                out[y + fy, x + fx, c] += np.uint16(1)
    return out


def _blit(frames, positions, atlas_h, atlas_w, masks=None, dots=None):
    return np.asarray(atlas.blit_frames(
        jnp.asarray(frames), jnp.asarray(positions), atlas_h, atlas_w,
        masks=None if masks is None else jnp.asarray(masks),
        dots=None if dots is None else jnp.asarray(dots)))


def test_blit_matches_reference_with_masks():
    rng = np.random.default_rng(0)
    f, h, w, ah, aw = 7, 12, 16, 20, 24
    frames = rng.integers(0, 16, size=(f, h, w), dtype=np.uint8)
    pos = np.stack([rng.integers(0, aw - w + 1, f),
                    rng.integers(0, ah - h + 1, f)], -1).astype(np.int32)
    masks = (rng.random((f, h, w)) < 0.2).astype(np.uint8)
    np.testing.assert_array_equal(
        _blit(frames, pos, ah, aw, masks=masks),
        _blit_ref(frames, pos, ah, aw, masks=masks))


def test_blit_accumulates_and_wraps():
    """Counts add onto the canvas and wrap at 2^16 like fgm's uint16."""
    frames = np.full((2, 8, 16), 3, np.uint8)
    pos = np.zeros((2, 2), np.int32)
    d0 = np.zeros((16, 32, 16), np.uint16)
    d0[0, 0, 3] = 65535
    d1 = _blit(frames, pos, 16, 32, dots=d0)
    d2 = _blit(frames, pos, 16, 32, dots=d1)
    assert int(d2[1, 0, 3]) == 4
    assert int(d2[0, 0, 3]) == 3     # 65535 + 4 wraps
    assert int(d2[0, 0, 2]) == 0
    assert int(d2[8, 0, 3]) == 0     # below the frames


@pytest.mark.parametrize("ah,aw,corners", [
    (9, 11, [(0, 0), (7, 4), (0, 4), (7, 0)]),    # the canvas's corners
    (5, 4, [(0, 0)] * 4),                         # frames exactly cover it
    (30, 40, [(17, 5), (18, 5), (17, 6), (36, 25)]),
])
def test_blit_placements(ah, aw, corners):
    """Frames at the canvas's edges, on one spot, and far apart, onto a
    canvas that already holds random counts."""
    rng = np.random.default_rng(ah * aw)
    frames = rng.integers(0, 16, size=(len(corners), 5, 4), dtype=np.uint8)
    pos = np.asarray(corners, np.int32)
    dots = rng.integers(0, 1 << 16, (ah, aw, 16)).astype(np.uint16)
    np.testing.assert_array_equal(
        _blit(frames, pos, ah, aw, dots=dots),
        _blit_ref(frames, pos, ah, aw, dots=dots))


def test_blit_values_past_the_palette_vote_nowhere():
    frames = np.array([[[16, 3], [255, 15]]], np.uint8)
    got = _blit(frames, np.zeros((1, 2), np.int32), 2, 2)
    assert got.sum() == 2
    assert got[0, 1, 3] == 1 and got[1, 1, 15] == 1
    assert not got[0, 0].any() and not got[1, 0].any()


def test_blit_under_vmap_equals_per_clip():
    """The pipeline step blits each clip of [C, T, H, W] under vmap."""
    rng = np.random.default_rng(5)
    c, t, h, w, ah, aw = 3, 4, 6, 8, 14, 18
    frames = rng.integers(0, 16, size=(c, t, h, w), dtype=np.uint8)
    pos = np.stack([rng.integers(0, aw - w + 1, (c, t)),
                    rng.integers(0, ah - h + 1, (c, t))], -1).astype(np.int32)
    got = np.asarray(jax.vmap(
        lambda f, p: atlas.blit_frames(f, p, atlas_h=ah, atlas_w=aw)
    )(jnp.asarray(frames), jnp.asarray(pos)))
    for i in range(c):
        np.testing.assert_array_equal(got[i],
                                      _blit_ref(frames[i], pos[i], ah, aw))
