"""The Triton extraction kernel checked in the Pallas interpreter (CPU).

Off the GPU the kernel of ``ops.pallas.extract`` runs interpreted
(``utils.backend.interpret``), so its arithmetic is checked bit for bit
against the XLA form here; the compiled kernel is compared with the same
form on the card by ``chip_smoke.py``.
"""

import numpy as np
import jax.numpy as jnp


def _extract_ref(imgs):
    from remap_tpu.ops import kpe as jkpe

    _, h, w = imgs.shape
    return jkpe._extract_dense(jnp.asarray(imgs), height=h, width=w)


def _assert_extract_equal(out, ref):
    for field in ("median", "weight", "codes"):
        got, want = np.asarray(getattr(out, field)), np.asarray(
            getattr(ref, field))
        assert got.dtype == want.dtype and got.shape == want.shape, field
        np.testing.assert_array_equal(got, want, err_msg=field)


def test_extract_banded_matches_xla():
    """Tiles that divide neither frame dimension: the masked halo loads
    at frame edges and the masked stores of partial tiles give the XLA
    outputs everywhere, borders included."""
    from remap_tpu.ops.pallas import extract as pext

    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 16, size=(2, 50, 70), dtype=np.uint8)
    out = pext.extract_dense_raw(jnp.asarray(imgs), tile=(16, 32))
    _assert_extract_equal(out, _extract_ref(imgs))


def test_extract_tile_selection():
    """One partial tile, tiles smaller than the frame, exact tiling:
    every tile shape gives the XLA outputs."""
    from remap_tpu.ops.pallas import extract as pext

    for h, w, tile in ((9, 13, (16, 64)), (33, 40, (8, 16)),
                       (24, 64, (16, 64))):
        imgs = np.random.default_rng(h * w).integers(
            0, 16, size=(3, h, w), dtype=np.uint8)
        out = pext.extract_dense_raw(jnp.asarray(imgs), tile=tile)
        _assert_extract_equal(out, _extract_ref(imgs))


def test_extract_kernel_matches_xla():
    """Through ``kpe.extract_dense`` (bounds masking included) with the
    kernel forced, on a real palette-ordered clip."""
    from remap_tpu.core.regions import make_layout
    from remap_tpu.ops import kpe as jkpe
    from remap_tpu.utils import testing

    clip = testing.simple_clip(n_frames=3, frame_hw=(48, 64), seed=3)
    imgs = jnp.asarray(np.stack(clip.frames))
    layout = make_layout(64, 48, 4, 2, 8)
    ref = jkpe.extract_dense(imgs, layout, kernels=False)
    out = jkpe.extract_dense(imgs, layout, kernels=True)
    _assert_extract_equal(out, ref)


def test_extract_kernel_follows_palette():
    """The kernel's packed lookup tables follow the active palette."""
    from remap_tpu.core import palette
    from remap_tpu.ops.pallas import extract as pext

    imgs = np.random.default_rng(5).integers(
        0, 16, size=(2, 20, 24), dtype=np.uint8)
    try:
        palette.set_palette("zx")
        out = pext.extract_dense_raw(jnp.asarray(imgs))
        ref = _extract_ref(imgs)
    finally:
        palette.set_palette("c64")
    _assert_extract_equal(out, ref)


def test_pack_table_roundtrip():
    from remap_tpu.core import palette
    from remap_tpu.ops.pallas import extract as pext

    for table in (palette.NATIVE_TO_ORDERED, palette.ORDERED_TO_NATIVE,
                  np.arange(16)[::-1]):
        lo, hi = pext.pack_table(table)
        got = np.asarray(pext._lookup(lo, hi, jnp.arange(16, dtype=jnp.int32)))
        np.testing.assert_array_equal(got, table)
