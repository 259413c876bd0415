"""Capture-wear differential vs the compiled C++ reference.

The gameplay differentials (test_ref_gameplay.py) run CLEAN simulated
playthroughs.  Real emulator dumps are not clean (main.cpp:16-52 reads
whatever the capture tool wrote): they tear across scanlines, duplicate
frames under lag, skip frames, and carry transient pixel glitches.
These tests damage the simulated sessions with the deterministic wear
model (utils.wear) and assert both pipelines still produce **byte
-identical maps** — wear pushes the matcher, foreground detector, and
artifact filter into their recovery regimes (minority-offset votes,
zero-diff pairs, doubled camera steps, one-frame foreground specks),
exactly where a semantics mismatch between our device formulation and the
reference's C++ would surface first.

The world-ground-truth check still applies: the wear model keeps
camera/frame alignment, and specks/tears are one-frame events the
pipeline is *designed* to scrub (fdf foreground masking, arf rare
-pattern filtering) — so the reconstructed map should remain an almost
-everywhere-exact copy of the sprite-free world even though every
input frame was damaged.
"""

import numpy as np
import pytest

from remap_tpu.utils import gameplay, wear

from tests.differential import ref_full
from tests.differential.test_ref_e2e import (
    _assert_maps_equal,
    _read_pngs,
    _run_ours,
    _write_clip,
)
from tests.differential.test_ref_gameplay import (
    FH,
    FW,
    _world_truth_agreement,
)

pytestmark = pytest.mark.skipif(
    not ref_full.available(),
    reason="reference checkout / g++ / AVX2 / libpng unavailable",
)


@pytest.mark.diffquick
def test_ref_wear_combined_platformer(ref_binary, tmp_path):
    """The full wear model over the pinned platformer session: tears,
    specks, lag duplicates and drops together.  Byte-equal maps, and
    the map still equals the world almost everywhere — the damage is
    scrubbed, not painted."""
    session = gameplay.play_session(seed=3, n_frames=220, frame_hw=(FH, FW))
    # specks stay inside the action window: chrome specks defeat window
    # discovery outright (see test_ref_wear_chrome_specks_* below)
    worn = wear.worn(session, seed=11, speck_region=(10, 276, 10, 376))
    assert len(worn.frames) != len(session.frames)  # wear really applied

    clip_dir = tmp_path / "worn"
    _write_clip(worn.frames, clip_dir)

    ref_out = tmp_path / "refout"
    ref_out.mkdir()
    pngs = ref_full.run_reference(ref_binary, clip_dir, ref_out)
    ref_maps = _read_pngs(pngs)

    our_maps = _run_ours(clip_dir)
    _assert_maps_equal(ref_maps, our_maps, "worn-platformer")

    agree, painted = _world_truth_agreement(our_maps, worn)
    assert agree >= 0.995, (
        f"worn-map painted pixels agree with the world on only {agree:.3%}"
    )
    assert painted >= 0.85


def test_ref_wear_tear_shmup(ref_binary, tmp_path):
    """Tearing under constant-velocity scroll — the sharpest tear check:
    every torn frame holds rows at camera y (top) and rows at y-2
    (bottom, the previous scan-out), so the per-region vote splits along
    the tear line and the declared offset is whichever half owns the
    region majority.  A single mis-track would shear the map; byte
    -equality with the binary pins the whole recovery sequence."""
    session = gameplay.play_shmup_session(
        seed=1, n_frames=280, frame_hw=(FH, FW)
    )
    rng = np.random.default_rng(13)
    worn = wear.with_specks(
        wear.with_tears(session, rng, tear_prob=0.12),
        rng,
        per_frame=8,
        region=(40, 250, 40, 350),
    )
    torn = sum(
        not np.array_equal(a, b)
        for a, b in zip(worn.frames, session.frames)
    )
    assert torn >= 30  # specks guarantee most differ; tears within

    clip_dir = tmp_path / "tear"
    _write_clip(worn.frames, clip_dir)

    ref_out = tmp_path / "refout"
    ref_out.mkdir()
    pngs = ref_full.run_reference(ref_binary, clip_dir, ref_out)
    ref_maps = _read_pngs(pngs)

    our_maps = _run_ours(clip_dir)
    _assert_maps_equal(ref_maps, our_maps, "tear-shmup")

    agree, painted = _world_truth_agreement(our_maps, worn)
    assert agree >= 0.995, (
        f"tear-map painted pixels agree with the world on only {agree:.3%}"
    )
    assert painted >= 0.80


def test_ref_wear_chrome_specks_defeat_discovery(ref_binary, tmp_path):
    """A discovered reference-behavior regime, pinned: glitch pixels on
    the static chrome (border/HUD) during window discovery re-mark the
    change heatmap every frame, so aws's best-contour bounds never
    stagnate (aws.hpp:37-96) — NO window is ever accepted and the run
    emits NOTHING.  Real captures glitch anywhere, so a user pointing
    either pipeline at such a dump gets zero maps; both pipelines must
    agree on that outcome byte-for-byte (cf. the top-HUD quirk, which
    defeats discovery through the tie-break rather than stagnation)."""
    session = gameplay.play_session(seed=3, n_frames=90, frame_hw=(FH, FW))
    rng = np.random.default_rng(17)
    worn = wear.with_specks(session, rng, per_frame=12)  # anywhere

    clip_dir = tmp_path / "chrome"
    _write_clip(worn.frames, clip_dir)

    ref_out = tmp_path / "refout"
    ref_out.mkdir()
    pngs = ref_full.run_reference(ref_binary, clip_dir, ref_out)
    assert pngs == [], "the reference accepted a window under chrome specks"

    assert _run_ours(clip_dir) == [], (
        "we accepted a window the reference rejects under chrome specks"
    )
