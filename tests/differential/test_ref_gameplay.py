"""Gameplay-session differential vs the compiled C++ reference.

The four clips in test_ref_e2e.py are geometric (iid-noise worlds,
random-walk cameras).  These tests run both pipelines on *simulated
playthroughs* (utils.gameplay) of three genres — a side-scrolling
platformer (tile-built level, physics player, dead-zone camera, animated
patrolling enemies, score/timer HUD), a top-down flip-screen adventure
(static camera + whole-window pans, warp teleports that break fragments
and force the splicer), and a vertical-scroll shooter (constant-velocity
scroll every frame, dense enemy waves + bullets moving against it) —
together spanning the camera-motion and foreground-density regimes of
the reference's real input domain (main.cpp:16-52), as close as this
environment can produce.

What makes this content HARDER than the geometric clips, and therefore
worth a dedicated oracle run:

- tiles repeat **pixel-exactly** (bounded-join stability-bound regime:
  repeats ~5-8 per region on turf/brick codes),
- whole grid regions are keypoint-sparse or empty (flat sky, flat dirt)
  — the active-region gate and per-region Borda weighting actually bind,
- the camera rests for runs of frames (offset (0,0) declarations with
  only sprite-animation differences),
- foreground sprites ANIMATE (shape changes), not just translate,
- the HUD is mostly-static-with-changing-digits, so the aws heatmap has
  fine structure inside the chrome band.

Beyond byte-equality with the binary, the maps are checked against the
*world itself* (the simulator knows ground truth): the reconstructed
map must match the visited world region almost everywhere — guarding
against both pipelines agreeing on a wrong answer.
"""

from typing import Tuple

import numpy as np
import pytest

from remap_tpu.utils import gameplay

from tests.differential import ref_full
from tests.differential.test_ref_e2e import (
    _assert_maps_equal,
    _read_pngs,
    _run_ours,
    _write_clip,
)

pytestmark = pytest.mark.skipif(
    not ref_full.available(),
    reason="reference checkout / g++ / AVX2 / libpng unavailable",
)

FW, FH = 388, 312     # the reference's fixed screen (main.cpp:199)


def _world_truth_agreement(our_maps, session) -> Tuple[float, float]:
    """Best-alignment agreement of the largest map with the world
    (gameplay.world_agreement)."""
    return gameplay.world_agreement(our_maps, session)


@pytest.mark.diffquick
def test_ref_gameplay_session(ref_binary, tmp_path):
    session = gameplay.play_session(
        seed=3, n_frames=220, frame_hw=(FH, FW)
    )
    clip_dir = tmp_path / "gameplay"
    _write_clip(session.frames, clip_dir)

    ref_out = tmp_path / "refout"
    ref_out.mkdir()
    pngs = ref_full.run_reference(ref_binary, clip_dir, ref_out)
    ref_maps = _read_pngs(pngs)

    our_maps = _run_ours(clip_dir)
    _assert_maps_equal(ref_maps, our_maps, "gameplay")

    # ground truth: the reconstructed map IS the visited world (sprites
    # scrubbed by fdf, rare patterns filtered by arf) — both pipelines
    # agreeing on a wrong map would still fail here.  Measured on this
    # session: every painted pixel equals the world (1.000 agreement,
    # 94.7% painted; the rest is the arf edge ring).
    agree, painted = _world_truth_agreement(our_maps, session)
    assert agree >= 0.999, (
        f"painted map pixels agree with the world on only {agree:.3%}"
    )
    assert painted >= 0.90, (
        f"only {painted:.1%} of the map canvas is painted"
    )


def test_ref_gameplay_topdown_flip_screen(ref_binary, tmp_path):
    """The flip-screen genre vs the binary: the one gameplay shape that
    exercises the SPLICE stage on realistic content (the platformer
    session never breaks a fragment).  The pinned seed warps once at
    frame 316 — a camera teleport across the world, a guaranteed
    grid-vote rejection (frc.hpp:109-115), a fragment break — and the
    auto-pilot's post-warp wandering overlaps rooms visited before, so
    fgs must merge the two fragments back into ONE map.  Between the
    warp and the screen flips, most frames declare offset (0,0) with
    only sprite-animation diffs, and pans are 7 px/frame axis-locked —
    none of which the geometric clips or the platformer cover."""
    session = gameplay.play_topdown_session(
        seed=2, n_frames=480, frame_hw=(FH, FW)
    )
    # the genre contract this test depends on: exactly one warp snap,
    # far enough in that both sides have real room coverage
    cam = np.array(session.camera)
    snaps = np.flatnonzero(np.abs(np.diff(cam, axis=0)).max(axis=1) > 7)
    assert list(snaps) == [316], "pinned seed geometry changed"

    clip_dir = tmp_path / "topdown"
    _write_clip(session.frames, clip_dir)

    ref_out = tmp_path / "refout"
    ref_out.mkdir()
    pngs = ref_full.run_reference(ref_binary, clip_dir, ref_out)
    ref_maps = _read_pngs(pngs)
    assert len(ref_maps) == 1, (
        "the reference no longer splices the warp-broken fragments"
    )

    our_maps = _run_ours(clip_dir)
    _assert_maps_equal(ref_maps, our_maps, "topdown")

    # ground truth vs the simulator's world.  Measured on this session:
    # 99.99% of painted pixels equal the world (the residue is spots
    # where the player rested long enough to win background votes);
    # 78.9% of the canvas is painted (flip-screen maps are unions of
    # whole rooms — the bounding box includes unvisited room area).
    agree, painted = _world_truth_agreement(our_maps, session)
    assert agree >= 0.999, (
        f"painted map pixels agree with the world on only {agree:.3%}"
    )
    assert painted >= 0.70, (
        f"only {painted:.1%} of the map canvas is painted"
    )


def test_ref_gameplay_shmup_constant_scroll(ref_binary, tmp_path):
    """The vertical-scroll shooter vs the binary: sustained constant
    -velocity camera motion (every frame pair declares (0, -2); a ±1
    mis-track would accumulate into a sheared map — map equality is the
    sharpest possible check), with a dense fast foreground: enemy wave
    formations stepping coherently AGAINST the scroll, bullet streams,
    expanding explosions.  Boss holds pause the scroll mid-session, so
    the matcher also re-enters the (0, 0) regime twice."""
    session = gameplay.play_shmup_session(
        seed=1, n_frames=280, frame_hw=(FH, FW)
    )
    clip_dir = tmp_path / "shmup"
    _write_clip(session.frames, clip_dir)

    ref_out = tmp_path / "refout"
    ref_out.mkdir()
    pngs = ref_full.run_reference(ref_binary, clip_dir, ref_out)
    ref_maps = _read_pngs(pngs)
    assert len(ref_maps) == 1, "constant scroll must yield one fragment"

    our_maps = _run_ours(clip_dir)
    _assert_maps_equal(ref_maps, our_maps, "shmup")

    # measured: 99.97% agreement; "painted" is 92.8% only because the
    # helper cannot tell palette-black CONTENT (runway speckle/dashes)
    # from unpainted canvas
    agree, painted = _world_truth_agreement(our_maps, session)
    assert agree >= 0.999, (
        f"painted map pixels agree with the world on only {agree:.3%}"
    )
    assert painted >= 0.85, (
        f"only {painted:.1%} of the map canvas is painted"
    )


def test_ref_gameplay_dialog_interludes(ref_binary, tmp_path):
    """JRPG dialog boxes over a STILL-SCROLLING world (autoscroll
    cutscene style) vs the binary.  The box is the one foreground class
    no small-sprite genre produces: a screen-anchored contour LARGER
    than fde's frame/5 area limit, so fde must DROP it from the
    foreground (fde.hpp:94-100) and its pixels vote into the atlas
    unmasked on both passes; and while it is up, its static keypoints
    vote (0, 0) against the terrain's true scroll — the per-region Borda
    majority (kpm.hpp:172-211) must keep following the terrain.
    Measured: the terrain out-votes the box everywhere (99.9995% world
    agreement) and the maps are byte-identical."""
    session = gameplay.play_session(
        seed=3, n_frames=240, frame_hw=(FH, FW),
        dialog_every=70, dialog_frames=36,
    )
    # the content contract: the camera really does scroll during the
    # dialog windows (else the (0,0) adversary is no adversary)
    cam = np.array(session.camera)
    d = np.abs(np.diff(cam, axis=0)).sum(axis=1)
    assert d[70:105].sum() > 50 and d[140:175].sum() > 50

    clip_dir = tmp_path / "dialog"
    _write_clip(session.frames, clip_dir)

    ref_out = tmp_path / "refout"
    ref_out.mkdir()
    pngs = ref_full.run_reference(ref_binary, clip_dir, ref_out)
    ref_maps = _read_pngs(pngs)
    assert len(ref_maps) == 1

    our_maps = _run_ours(clip_dir)
    _assert_maps_equal(ref_maps, our_maps, "dialog")

    agree, painted = _world_truth_agreement(our_maps, session)
    assert agree >= 0.999, (
        f"painted map pixels agree with the world on only {agree:.3%}"
    )
    assert painted >= 0.85


def test_ref_gameplay_top_hud_quirk(ref_binary, tmp_path):
    """The top-HUD window quirk (PARITY.md): live digits ABOVE the play
    area latch aws's score-0 tie-break (std::min_element +
    first-discovery order, aws.hpp:62-69) on a tiny digit blob, so the
    window is never accepted and NO maps come out — of either pipeline.
    A 90-frame session is plenty: the timer digit changes by frame 2 and
    owns the tie from then on."""
    session = gameplay.play_session(
        seed=3, n_frames=90, frame_hw=(FH, FW), hud_pos="top"
    )
    clip_dir = tmp_path / "tophud"
    _write_clip(session.frames, clip_dir)

    ref_out = tmp_path / "refout"
    ref_out.mkdir()
    pngs = ref_full.run_reference(ref_binary, clip_dir, ref_out)
    assert pngs == [], "the reference accepted a window despite the quirk"

    our_maps = _run_ours(clip_dir)
    assert our_maps == [], "we accepted a window the reference rejects"
