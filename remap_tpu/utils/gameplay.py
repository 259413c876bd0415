"""Deterministic gameplay-session simulator.

The reference's input domain is real captured gameplay (main.cpp:16-52:
a directory of raw frame dumps from an emulator).  No captures exist in
this environment, so tests sample synthetic clips — but the geometric
clips in `utils.testing` are iid-noise worlds with random-walk cameras,
which is *easier* than real content in exactly the ways that matter:

- real game worlds are built from a **tileset that repeats exactly**
  (the adversarial regime for bounded joins: every tile interior code
  recurs once per visible tile instance),
- real cameras **follow a player** — long constant-velocity runs,
  standing still, axis-locked scrolling, dead-zone kicks — instead of a
  per-frame iid step,
- real sprites are **animated** (shape changes frame to frame), not
  translated rectangles,
- real HUDs have **changing digits** (score/timer) inside an otherwise
  static chrome.

This module is a tiny deterministic "game": a tile-built side-scrolling
level, a player with gravity/jump physics driven by a seeded policy, a
dead-zone camera, patrolling animated enemies, and a score/timer HUD.
Every run is a pure function of its seed, so a session can serve as a
permanent differential fixture against the compiled reference binary
(tests/differential/test_ref_gameplay.py).

Nothing here imports JAX; frames are plain uint8 [H, W] palette-index
arrays exactly like the reference's raw dumps (nil.hpp:13-32).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

TILE = 16  # tile edge in pixels; tiles repeat EXACTLY, like real games


# ---------------------------------------------------------------------------
# Tileset: procedurally drawn but structured (bricks, ground, sky, pipes...)
# so repeated instances are pixel-identical while the *layout* is aperiodic.
# ---------------------------------------------------------------------------

def _speckle(t: np.ndarray, rng: np.random.Generator, color: int) -> None:
    """Diagonal single-pixel dither grain: one speck per row at column
    (5*r + phase) mod TILE — every row AND every column of the tile has
    exactly one speck (gcd(5,16)=1), so every screen pixel sees change
    under any scroll direction — which is what the aws heatmap needs on
    flat-color art.  The specks stay ISOLATED (adjacent rows' specks
    are 5 columns apart): no 3x3 window holds more than one and no 5x5
    more than two, so neither median moves (kpe.hpp:308-324) and the
    grain adds ZERO keypoints — it cannot inflate the join's
    repetition counts."""
    phase = int(rng.integers(0, TILE))
    for r in range(TILE):
        t[r, (5 * r + phase) % TILE] = color


def _tile_sky(rng: np.random.Generator) -> np.ndarray:
    t = np.full((TILE, TILE), 6, np.uint8)  # blue
    _speckle(t, rng, 14)  # faint dither grain
    return t


def _tile_sky_star(rng: np.random.Generator) -> np.ndarray:
    t = _tile_sky(rng)
    ys, xs = rng.integers(1, TILE - 1, 4), rng.integers(1, TILE - 1, 4)
    t[ys, xs] = 1  # white specks
    t[ys[0], (xs[0] + 1) % TILE] = 3  # one twinkle
    return t


def _tile_cloud(rng: np.random.Generator) -> np.ndarray:
    t = _tile_sky(rng)
    yy, xx = np.mgrid[0:TILE, 0:TILE]
    blob = ((yy - 8) ** 2 / 9.0 + (xx - 8) ** 2 / 25.0) < 4.0
    t[blob] = 1
    t[blob & (yy > 9)] = 15  # grey underside
    return t


def _tile_brick(rng: np.random.Generator) -> np.ndarray:
    t = np.full((TILE, TILE), 8, np.uint8)  # orange
    t[::4, :] = 9  # mortar rows (brown)
    for r in range(4):  # vertical joints, alternating half-brick offset
        t[r * 4 : r * 4 + 4, (r % 2) * 4 :: 8] = 9
    t[0, :] = 7  # highlight (yellow)
    weather = rng.random((TILE, TILE)) < 0.10  # chipped faces
    weather[t != 8] = False
    t[weather] = 2
    return t


def _tile_ground(rng: np.random.Generator) -> np.ndarray:
    """Turf surface: detail only in the top rows, flat dirt below
    (real games keep the dirt body flat — and a flat body contributes
    zero keypoints, keeping exact-tile code repetition in the bounded
    regime the matcher's stability bounds are built for)."""
    t = np.full((TILE, TILE), 9, np.uint8)  # brown
    t[0:2, :] = 5  # green turf
    speck = rng.random((4, TILE)) < 0.18
    speck[0:2] = False
    t[:4][speck] = 2  # red pebbles under the turf only
    return t


def _tile_dirt(rng: np.random.Generator) -> np.ndarray:
    t = np.full((TILE, TILE), 9, np.uint8)  # flat dirt body
    _speckle(t, rng, 2)  # soil grain (isolated: no keypoints)
    return t


def _tile_rock(rng: np.random.Generator) -> np.ndarray:
    t = np.full((TILE, TILE), 9, np.uint8)
    y, x = int(rng.integers(3, TILE - 6)), int(rng.integers(3, TILE - 6))
    t[y : y + 3, x : x + 4] = 15  # grey rock
    t[y, x] = 1                   # highlight
    return t


def _tile_block(rng: np.random.Generator) -> np.ndarray:
    t = np.full((TILE, TILE), 7, np.uint8)  # yellow
    t[[0, -1], :] = 9
    t[:, [0, -1]] = 9
    t[4:12, 4:12] = 8
    t[7:9, 7:9] = 1
    return t


def _tile_pipe(rng: np.random.Generator) -> np.ndarray:
    t = np.full((TILE, TILE), 5, np.uint8)  # green
    t[:, [0, 1, -2, -1]] = 13  # light green rim
    t[:, [4, 11]] = 3  # cyan sheen
    t[rng.integers(2, TILE - 2, 3), rng.integers(5, 11, 3)] = 13  # scuffs
    return t


def _tile_bush(rng: np.random.Generator) -> np.ndarray:
    t = _tile_sky(rng)
    yy, xx = np.mgrid[0:TILE, 0:TILE]
    blob = ((yy - 12) ** 2 / 16.0 + (xx - 8) ** 2 / 30.0) < 3.0
    t[blob] = 5
    t[blob & ((xx + yy) % 5 == 0)] = 13
    return t


def _tile_fence(rng: np.random.Generator) -> np.ndarray:
    t = _tile_sky(rng)
    t[6:, 2::5] = 9
    t[8, :] = 9
    t[12, :] = 9
    return t


def make_tileset(rng: np.random.Generator) -> np.ndarray:
    """[n_tiles, TILE, TILE] uint8 — index 0 is sky (the 'empty' tile)."""
    makers = [
        _tile_sky, _tile_sky_star, _tile_cloud, _tile_brick, _tile_ground,
        _tile_block, _tile_pipe, _tile_bush, _tile_fence, _tile_dirt,
        _tile_rock, _tile_rock,
    ]
    return np.stack([m(rng) for m in makers])


(SKY, SKY_STAR, CLOUD, BRICK, GROUND, BLOCK, PIPE, BUSH, FENCE, DIRT,
 ROCK_A, ROCK_B) = range(12)
SOLID = frozenset({BRICK, GROUND, BLOCK, PIPE, DIRT, ROCK_A, ROCK_B})


# ---------------------------------------------------------------------------
# Level: a side-scrolling strip of tile columns with varied ground height,
# platforms, pipes and decorations.  Aperiodic layout over exact tiles.
# ---------------------------------------------------------------------------

def make_level(
    rng: np.random.Generator, cols: int, rows: int
) -> np.ndarray:
    """[rows, cols] int tile-index map."""
    lvl = np.zeros((rows, cols), np.int64)
    # sparse sky decorations
    for c in range(cols):
        for r in range(rows - 8):
            p = rng.random()
            if p < 0.035:
                lvl[r, c] = CLOUD
            elif p < 0.14:
                lvl[r, c] = SKY_STAR
    ground = rows - 4
    ground_at = np.full(cols, rows - 4, np.int64)
    c = 0
    while c < cols:
        run = int(rng.integers(3, 9))
        step = int(rng.integers(-1, 2))
        # rolling hills spanning ~10 tiles of height so the camera's
        # vertical follow actually engages on climbs
        ground = int(np.clip(ground + step, rows - 12, rows - 2))
        for cc in range(c, min(c + run, cols)):
            ground_at[cc] = ground
            lvl[ground, cc] = GROUND
            # dirt body: flat, with sparse exact-repeating rock tiles
            for rr in range(ground + 1, rows):
                p = rng.random()
                lvl[rr, cc] = (
                    ROCK_A if p < 0.03 else ROCK_B if p < 0.06 else DIRT
                )
            # decorations on the turf
            p = rng.random()
            if p < 0.10 and ground - 1 >= 0:
                lvl[ground - 1, cc] = BUSH
            elif p < 0.18 and ground - 1 >= 0:
                lvl[ground - 1, cc] = FENCE
        # occasional pipe
        if rng.random() < 0.25 and c + run < cols - 2:
            h = int(rng.integers(1, 3))
            lvl[ground - h : ground, min(c + run - 2, cols - 1)] = PIPE
        c += run
    # floating platforms + block rows, a few tiles above the local turf
    n_plat = cols // 6
    for _ in range(n_plat):
        pc = int(rng.integers(2, cols - 6))
        pr = int(ground_at[pc] - rng.integers(3, 6))
        ln = int(rng.integers(2, 5))
        kind = BRICK if rng.random() < 0.6 else BLOCK
        lvl[pr, pc : pc + ln] = kind
        if rng.random() < 0.3:
            lvl[pr, pc + ln // 2] = BLOCK
    return lvl


def render_world(level: np.ndarray, tiles: np.ndarray) -> np.ndarray:
    """Expand the tile map into the pixel world [rows*TILE, cols*TILE]."""
    rows, cols = level.shape
    world = tiles[level]  # [rows, cols, TILE, TILE]
    return world.transpose(0, 2, 1, 3).reshape(rows * TILE, cols * TILE)


def solid_mask(level: np.ndarray) -> np.ndarray:
    return np.isin(level, list(SOLID))


# ---------------------------------------------------------------------------
# Sprites: small bitmap shapes with a transparent key (255), two-phase
# walk animation.
# ---------------------------------------------------------------------------

_T = 255  # transparent

PLAYER_FRAMES = [
    np.array(
        [
            [_T, _T, 2, 2, 2, 2, _T, _T],
            [_T, 2, 2, 2, 2, 2, 2, _T],
            [_T, 10, 10, 1, 10, 1, _T, _T],
            [_T, 10, 10, 10, 10, 10, _T, _T],
            [_T, _T, 2, 2, 2, _T, _T, _T],
            [_T, 2, 2, 2, 2, 2, _T, _T],
            [_T, 9, 9, _T, 9, 9, _T, _T],
            [_T, 9, _T, _T, _T, 9, _T, _T],
        ],
        np.uint8,
    ),
    np.array(
        [
            [_T, _T, 2, 2, 2, 2, _T, _T],
            [_T, 2, 2, 2, 2, 2, 2, _T],
            [_T, 10, 10, 1, 10, 1, _T, _T],
            [_T, 10, 10, 10, 10, 10, _T, _T],
            [_T, _T, 2, 2, 2, _T, _T, _T],
            [_T, 2, 2, 2, 2, 2, _T, _T],
            [_T, 9, 9, 9, 9, _T, _T, _T],
            [_T, _T, 9, _T, 9, _T, _T, _T],
        ],
        np.uint8,
    ),
]

ENEMY_FRAMES = [
    np.array(
        [
            [_T, _T, 4, 4, 4, 4, _T, _T],
            [_T, 4, 4, 4, 4, 4, 4, _T],
            [4, 1, 4, 4, 4, 4, 1, 4],
            [4, 4, 4, 4, 4, 4, 4, 4],
            [_T, 0, 0, _T, _T, 0, 0, _T],
        ],
        np.uint8,
    ),
    np.array(
        [
            [_T, _T, 4, 4, 4, 4, _T, _T],
            [_T, 4, 4, 4, 4, 4, 4, _T],
            [4, 1, 4, 4, 4, 4, 1, 4],
            [4, 4, 4, 4, 4, 4, 4, 4],
            [_T, _T, 0, 0, 0, 0, _T, _T],
        ],
        np.uint8,
    ),
]


def _draw_sprite(frame: np.ndarray, spr: np.ndarray, x: int, y: int) -> None:
    h, w = spr.shape
    fh, fw = frame.shape
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + w, fw), min(y + h, fh)
    if x1 <= x0 or y1 <= y0:
        return
    cut = spr[y0 - y : y1 - y, x0 - x : x1 - x]
    region = frame[y0:y1, x0:x1]
    frame[y0:y1, x0:x1] = np.where(cut == _T, region, cut)


# ---------------------------------------------------------------------------
# HUD: 3x5 digit font, score / timer counters that actually change.
# ---------------------------------------------------------------------------

_FONT = {
    "0": ["111", "101", "101", "101", "111"],
    "1": ["010", "110", "010", "010", "111"],
    "2": ["111", "001", "111", "100", "111"],
    "3": ["111", "001", "111", "001", "111"],
    "4": ["101", "101", "111", "001", "001"],
    "5": ["111", "100", "111", "001", "111"],
    "6": ["111", "100", "111", "101", "111"],
    "7": ["111", "001", "010", "010", "010"],
    "8": ["111", "101", "111", "101", "111"],
    "9": ["111", "101", "111", "001", "111"],
    "S": ["011", "100", "010", "001", "110"],
    "C": ["011", "100", "100", "100", "011"],
    "O": ["111", "101", "101", "101", "111"],
    "R": ["110", "101", "110", "101", "101"],
    "E": ["111", "100", "110", "100", "111"],
    "T": ["111", "010", "010", "010", "010"],
    "I": ["111", "010", "010", "010", "111"],
    "M": ["101", "111", "111", "101", "101"],
    " ": ["000", "000", "000", "000", "000"],
}


def _draw_text(
    frame: np.ndarray, text: str, x: int, y: int, color: int, scale: int = 2
) -> None:
    for ch in text:
        glyph = _FONT.get(ch, _FONT[" "])
        for r, row in enumerate(glyph):
            for c, bit in enumerate(row):
                if bit == "1":
                    frame[
                        y + r * scale : y + (r + 1) * scale,
                        x + c * scale : x + (c + 1) * scale,
                    ] = color
        x += 4 * scale


# ---------------------------------------------------------------------------
# The session: physics, camera, enemies, HUD — one deterministic playthrough.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Session:
    frames: List[np.ndarray]
    #: camera (x, y) per frame in world pixels
    camera: List[Tuple[int, int]]
    world: np.ndarray


def world_agreement(maps_rgb, session: Session) -> Tuple[float, float]:
    """Best-alignment agreement of the largest RGB map with the world.

    The map should be the union of visited views of the (sprite-free)
    world — except the all-zero ring the artifact filter leaves
    unprocessed at canvas edges (arf.hpp:274-303).  The exact crop
    origin depends on aws's contour bounds, so a small neighbourhood
    around the known camera extent is searched.  Returns (best agreement
    over painted map pixels, painted share of the canvas at that
    alignment)."""
    from remap_tpu.core import palette

    cam = np.array(session.camera)
    world_rgb = palette.NATIVE_TO_RGB[session.world]
    m = max(maps_rgb, key=lambda a: a.size)
    mh, mw = m.shape[:2]
    painted = (m != 0).any(axis=-1)
    y0 = cam[:, 1].min()
    x0 = cam[:, 0].min()
    best = (0.0, 0.0)
    wh, ww = world_rgb.shape[:2]
    for dy in range(-2, 7):
        for dx in range(-2, 7):
            yy, xx = y0 + dy, x0 + dx
            if yy < 0 or xx < 0 or yy + mh > wh or xx + mw > ww:
                continue
            crop = world_rgb[yy : yy + mh, xx : xx + mw]
            agree = float((crop == m).all(axis=-1)[painted].mean())
            if agree > best[0]:
                best = (agree, float(painted.mean()))
    return best


def _policy(rng: np.random.Generator, n: int) -> List[Tuple[int, bool]]:
    """Seeded 'player inputs': (walk direction, jump pressed) per frame.
    Direction persists for runs of frames — like a human holding right."""
    out: List[Tuple[int, bool]] = []
    while len(out) < n:
        kind = rng.random()
        if kind < 0.75:
            d, run = 1, int(rng.integers(14, 40))   # pushing on
        elif kind < 0.90:
            d, run = 0, int(rng.integers(8, 24))    # idling
        else:
            d, run = -1, int(rng.integers(6, 14))   # short backtracks
        for i in range(run):
            jump = rng.random() < 0.06
            out.append((d, jump))
    return out[:n]


# ---------------------------------------------------------------------------
# Top-down genre: a flip-screen adventure (4-direction movement, the camera
# pans one whole window per screen edge crossed, warp tiles teleport across
# the world).  The platformer above exercises mostly-horizontal scrolling;
# this genre covers what it cannot:
#
# - LONG STATIC-CAMERA runs (the camera only moves during screen flips and
#   warps): most matches declare offset (0,0) with only sprite-animation
#   differences,
# - fast axis-locked pans on BOTH axes (8 px/frame over a whole window),
# - camera teleports (warps) -> guaranteed match failures -> fragment
#   breaks, so the SPLICE stage runs on gameplay content (the platformer
#   yields a single fragment),
# - wall/tree/water tiles repeating in 2-D mazes (the platformer's
#   repetition is row-structured).
# ---------------------------------------------------------------------------

def _tile_tfloor(rng: np.random.Generator) -> np.ndarray:
    t = np.full((TILE, TILE), 8, np.uint8)  # sandy floor
    _speckle(t, rng, 9)  # isolated grain: zero keypoints (see _speckle)
    return t


def _tile_tfloor_crack(rng: np.random.Generator) -> np.ndarray:
    t = _tile_tfloor(rng)
    y = int(rng.integers(3, TILE - 4))
    x = int(rng.integers(3, TILE - 5))
    t[y, x : x + 3] = 9
    t[y + 1, x + 1] = 9
    return t


def _tile_twall(rng: np.random.Generator) -> np.ndarray:
    t = np.full((TILE, TILE), 15, np.uint8)  # grey block wall
    t[::8, :] = 0
    t[:, ::8] = 0
    t[1, 1:8] = 1  # highlight
    scuff = rng.random((TILE, TILE)) < 0.06
    scuff[t != 15] = False
    t[scuff] = 12
    # grain over the mortar lines too: the uniform black rows/columns of
    # a full-width (or full-height) wall otherwise never change under an
    # axis pan, slicing the aws heatmap's changed region (see _speckle)
    _speckle(t, rng, 12)
    return t


def _tile_twater(rng: np.random.Generator) -> np.ndarray:
    t = np.full((TILE, TILE), 6, np.uint8)  # blue
    t[2::5, :] = 14  # static wave bands
    t[3::5, 1::4] = 1  # foam specks
    return t


def _tile_ttree(rng: np.random.Generator) -> np.ndarray:
    t = _tile_tfloor(rng)
    yy, xx = np.mgrid[0:TILE, 0:TILE]
    blob = ((yy - 7) ** 2 + (xx - 8) ** 2) < 36
    t[blob] = 5
    t[blob & ((xx * 3 + yy * 5) % 7 == 0)] = 13
    t[13:15, 7:9] = 9  # trunk
    return t


def _tile_trock(rng: np.random.Generator) -> np.ndarray:
    t = _tile_tfloor(rng)
    t[5:12, 4:12] = 15
    t[5, 4:12] = 1
    t[11, 4:12] = 0
    return t


def _tile_twarp(rng: np.random.Generator) -> np.ndarray:
    t = _tile_tfloor(rng)
    yy, xx = np.mgrid[0:TILE, 0:TILE]
    ring = np.abs(((yy - 8) ** 2 + (xx - 8) ** 2) - 25) < 8
    t[ring] = 4  # purple swirl
    t[7:9, 7:9] = 0
    return t


def make_tileset_topdown(rng: np.random.Generator) -> np.ndarray:
    makers = [
        _tile_tfloor, _tile_tfloor_crack, _tile_twall, _tile_twater,
        _tile_ttree, _tile_trock, _tile_twarp,
    ]
    return np.stack([m(rng) for m in makers])


(TFLOOR, TFLOOR_CRACK, TWALL, TWATER, TTREE, TROCK, TWARP) = range(7)
SOLID_TOPDOWN = frozenset({TWALL, TWATER, TTREE, TROCK})


def make_level_topdown(
    rng: np.random.Generator, rows: int, cols: int
) -> np.ndarray:
    """[rows, cols] tile map: a walled maze of chambers over repeating
    floor, with ponds, trees and rocks (warps are placed by the session,
    which knows the spawn's reachable component)."""
    lvl = np.zeros((rows, cols), np.int64)
    lvl[rng.random((rows, cols)) < 0.08] = TFLOOR_CRACK
    # perimeter wall
    lvl[[0, -1], :] = TWALL
    lvl[:, [0, -1]] = TWALL
    # chamber walls every 9-14 tiles with 3-tile door gaps
    r = 0
    while True:
        r += int(rng.integers(9, 15))
        if r >= rows - 2:
            break
        lvl[r, :] = TWALL
        for _ in range(max(2, cols // 12)):
            g = int(rng.integers(1, cols - 4))
            lvl[r, g : g + 3] = TFLOOR
    c = 0
    while True:
        c += int(rng.integers(9, 15))
        if c >= cols - 2:
            break
        keep_doors = []
        for _ in range(max(2, rows // 12)):
            g = int(rng.integers(1, rows - 4))
            keep_doors.append(g)
        col_was = lvl[:, c].copy()
        lvl[:, c] = np.where(col_was == TWALL, TWALL, TWALL)
        for g in keep_doors:
            lvl[g : g + 3, c] = np.where(
                col_was[g : g + 3] == TWALL, TWALL, TFLOOR
            )
    # scenery on free floor
    free = ~np.isin(lvl, list(SOLID_TOPDOWN))
    free[[0, -1], :] = False
    free[:, [0, -1]] = False
    for kind, dens in ((TWATER, 0.02), (TTREE, 0.05), (TROCK, 0.03)):
        put = (rng.random((rows, cols)) < dens) & free
        lvl[put] = kind
        free &= ~put
    # connectivity repair: random walls + scenery can seal chambers;
    # carve one bridge tile per separated label pair until the interior
    # is a single 4-connected component (so the auto-pilot and the warp
    # placement can always reach everywhere)
    while True:
        free = ~np.isin(lvl, list(SOLID_TOPDOWN))
        free[[0, -1], :] = False
        free[:, [0, -1]] = False
        labels = np.full(lvl.shape, -1, np.int64)
        n_labels = 0
        for r, c in zip(*np.nonzero(free)):
            if labels[r, c] < 0:
                labels[_component(free, (int(r), int(c)))] = n_labels
                n_labels += 1
        if n_labels <= 1:
            break
        carved_pairs = set()
        for r in range(1, rows - 1):
            for c in range(1, cols - 1):
                if free[r, c]:
                    continue
                touch = {
                    int(labels[rr, cc])
                    for rr, cc in ((r - 1, c), (r + 1, c), (r, c - 1),
                                   (r, c + 1))
                    if labels[rr, cc] >= 0
                }
                if len(touch) >= 2:
                    pair = tuple(sorted(touch)[:2])
                    if pair not in carved_pairs:
                        carved_pairs.add(pair)
                        lvl[r, c] = TFLOOR
        if not carved_pairs:
            # components only touch diagonally or via the perimeter;
            # carve around the smallest label's bounding tile instead
            small = np.argmin(np.bincount(labels[labels >= 0]))
            rr, cc = [int(v[0]) for v in np.nonzero(labels == small)]
            lvl[max(rr - 1, 1), cc] = TFLOOR
            lvl[rr, max(cc - 1, 1)] = TFLOOR
    return lvl


def _component(free: np.ndarray, start: Tuple[int, int]) -> np.ndarray:
    """Boolean mask of the 4-connected free component containing start."""
    seen = np.zeros_like(free)
    if not free[start]:
        return seen
    seen[start] = True
    frontier = [start]
    while frontier:
        nxt = []
        for (r, c) in frontier:
            for dr, dc in ((0, 1), (1, 0), (0, -1), (-1, 0)):
                rr, cc = r + dr, c + dc
                if 0 <= rr < free.shape[0] and 0 <= cc < free.shape[1] \
                        and free[rr, cc] and not seen[rr, cc]:
                    seen[rr, cc] = True
                    nxt.append((rr, cc))
        frontier = nxt
    return seen


def _bfs_path(
    free: np.ndarray, start: Tuple[int, int], goal: Tuple[int, int]
) -> Optional[List[Tuple[int, int]]]:
    """Shortest 4-connected tile path start -> goal over free tiles, or
    None if unreachable.  Deterministic (fixed neighbour order)."""
    rows, cols = free.shape
    prev = np.full((rows, cols, 2), -1, np.int32)
    seen = np.zeros((rows, cols), bool)
    seen[start] = True
    frontier = [start]
    while frontier and not seen[goal]:
        nxt = []
        for (r, c) in frontier:
            for dr, dc in ((0, 1), (1, 0), (0, -1), (-1, 0)):
                rr, cc = r + dr, c + dc
                if 0 <= rr < rows and 0 <= cc < cols and free[rr, cc] \
                        and not seen[rr, cc]:
                    seen[rr, cc] = True
                    prev[rr, cc] = (r, c)
                    nxt.append((rr, cc))
        frontier = nxt
    if not seen[goal]:
        return None
    path = [goal]
    while path[-1] != start:
        r, c = path[-1]
        path.append((int(prev[r, c, 0]), int(prev[r, c, 1])))
    return path[::-1]


def play_topdown_session(
    seed: int,
    n_frames: int,
    frame_hw: Tuple[int, int],
    hud_rows: int = 24,
    border: int = 8,
    n_enemies: int = 4,
    world_rooms: Tuple[int, int] = (3, 3),
    warp_cooldown: int = 90,
    n_warp_pairs: int = 2,
) -> Session:
    """Simulate a flip-screen top-down playthrough (see the genre note
    above).  ``world_rooms`` sizes the world in whole camera windows;
    the flip grid anchors at the world origin, so camera positions are
    multiples of the window size except mid-pan (8 px/frame) and after
    a warp snap."""
    fh, fw = frame_hw
    rng = np.random.default_rng(0xD00DAD + seed)
    aw_y0, aw_y1 = border, fh - hud_rows - border
    aw_x0, aw_x1 = border, fw - border
    ah, aw = aw_y1 - aw_y0, aw_x1 - aw_x0

    rooms_y, rooms_x = world_rooms
    rows = (rooms_y * ah) // TILE + 1
    cols = (rooms_x * aw) // TILE + 1
    tiles = make_tileset_topdown(rng)
    level = make_level_topdown(rng, rows, cols)
    wh, ww = rooms_y * ah, rooms_x * aw
    tiles_y, tiles_x = wh // TILE, ww // TILE

    # spawn: the free tile nearest the center of room (0, 0), sprite
    # centered on it (path targets are tile centers, so alignment holds)
    ctr_r, ctr_c = (ah // 2) // TILE, (aw // 2) // TILE
    free_t = ~np.isin(level[:tiles_y, :tiles_x], list(SOLID_TOPDOWN))
    sr, sc = np.nonzero(free_t[: ah // TILE, : aw // TILE])
    assert len(sr), "no free spawn tile"
    i = int(np.argmin(np.abs(sr - ctr_r) + np.abs(sc - ctr_c)))
    spawn = (int(sr[i]), int(sc[i]))
    px, py = float(spawn[1] * TILE + 4), float(spawn[0] * TILE + 4)

    # warp pairs: far-apart tiles of the spawn's REACHABLE component, so
    # the auto-pilot can always path to one (a sealed-chamber seed would
    # otherwise never break a fragment)
    comp = _component(free_t, spawn)
    comp[spawn] = False
    cr, cc = np.nonzero(comp)
    warp_pairs: List[Tuple[Tuple[int, int], Tuple[int, int]]] = []
    for _ in range(n_warp_pairs):
        for _try in range(64):
            i, j = rng.integers(0, len(cr), 2)
            a = (int(cr[i]), int(cc[i]))
            b = (int(cr[j]), int(cc[j]))
            d = abs(a[0] - b[0]) + abs(a[1] - b[1])
            if d > (tiles_y + tiles_x) // 3 and level[a] == TFLOOR \
                    and level[b] == TFLOOR:
                level[a], level[b] = TWARP, TWARP
                warp_pairs.append((a, b))
                break
    warp_px = {
        (r * TILE + TILE // 2, c * TILE + TILE // 2): (
            pr * TILE + TILE // 2, pc * TILE + TILE // 2
        )
        for (a, b) in warp_pairs
        for ((r, c), (pr, pc)) in ((a, b), (b, a))
    }
    warp_tiles = sorted(a for p in warp_pairs for a in p)
    world = render_world(level, tiles)[:wh, :ww]

    # enemies wander in small boxes around reachable spots
    enemies = []
    for _ in range(n_enemies):
        i = int(rng.integers(0, len(cr)))
        ex = float(min(cc[i] * TILE, ww - 9))
        ey = float(min(cr[i] * TILE, wh - 9))
        enemies.append({
            "x": ex, "y": ey,
            "dx": 0.6 if rng.random() < 0.5 else -0.6,
            "dy": 0.6 if rng.random() < 0.5 else -0.6,
            "x0": max(ex - 40, 0), "x1": min(ex + 40, ww - 9),
            "y0": max(ey - 40, 0), "y1": min(ey + 40, wh - 9),
        })

    # auto-pilot: seeded waypoints + BFS tile paths (a demo-mode player;
    # random inputs cannot find 3-tile doors in a walled maze)
    def player_tile() -> Tuple[int, int]:
        return (int(py + 4) // TILE, int(px + 4) // TILE)

    def pick_path() -> List[Tuple[int, int]]:
        start = player_tile()
        for _try in range(32):
            if warp_tiles and rng.random() < 0.3:
                goal = warp_tiles[int(rng.integers(0, len(warp_tiles)))]
            else:
                i = int(rng.integers(0, len(cr)))
                goal = (int(cr[i]), int(cc[i]))
                d = abs(goal[0] - start[0]) + abs(goal[1] - start[1])
                if d < 4 or d > 28:  # keep plain strolls local
                    continue
            if goal == start:
                continue
            path = _bfs_path(free_t, start, goal)
            if path is not None and len(path) > 1:
                return path[1:]
        return []

    def flip_target(x: float, y: float) -> Tuple[float, float]:
        cx = (int(x + 4) // aw) * aw
        cy = (int(y + 4) // ah) * ah
        return (
            float(np.clip(cx, 0, ww - aw)), float(np.clip(cy, 0, wh - ah))
        )

    cam_x, cam_y = flip_target(px, py)
    pan_tx, pan_ty = cam_x, cam_y
    cooldown = 0
    path: List[Tuple[int, int]] = []
    idle = 0
    frames: List[np.ndarray] = []
    camera: List[Tuple[int, int]] = []
    score = 0

    for t in range(n_frames):
        panning = (cam_x, cam_y) != (pan_tx, pan_ty)
        if panning:
            # classic flip transition: the world pans, the player freezes.
            # 7 px/frame, NOT 8: the pan step must be coprime with the
            # 16-px tile so every screen pixel passes over a tile speck
            # during a pan (8 only samples two residues mod 16, leaving
            # never-changed stripes that shred the aws heatmap's changed
            # region into mini-contours and starve window acceptance)
            cam_x += float(np.clip(pan_tx - cam_x, -7, 7))
            cam_y += float(np.clip(pan_ty - cam_y, -7, 7))
        else:
            if idle > 0:
                idle -= 1
            else:
                if not path:
                    if rng.random() < 0.25:
                        idle = int(rng.integers(8, 30))
                    path = pick_path()
                if path and idle == 0:
                    tr, tc = path[0]
                    tx_, ty_ = tc * TILE + 4.0, tr * TILE + 4.0
                    if px != tx_:
                        px += float(np.clip(tx_ - px, -4, 4))
                    elif py != ty_:
                        py += float(np.clip(ty_ - py, -4, 4))
                    if (px, py) == (tx_, ty_):
                        path.pop(0)
            if cooldown > 0:
                cooldown -= 1
            key = (
                ((int(py) + 4) // TILE) * TILE + TILE // 2,
                ((int(px) + 4) // TILE) * TILE + TILE // 2,
            )
            if cooldown == 0 and key in warp_px:
                ty_, tx_ = warp_px[key]
                px, py = float(tx_ - 4), float(ty_ - 4)
                cam_x, cam_y = flip_target(px, py)  # SNAP: fragment break
                pan_tx, pan_ty = cam_x, cam_y
                cooldown = warp_cooldown
                path = []
            else:
                pan_tx, pan_ty = flip_target(px, py)
        cxi, cyi = int(round(cam_x)), int(round(cam_y))

        for e in enemies:
            e["x"] += e["dx"]
            e["y"] += e["dy"]
            if e["x"] <= e["x0"] or e["x"] >= e["x1"]:
                e["dx"] *= -1.0
            if e["y"] <= e["y0"] or e["y"] >= e["y1"]:
                e["dy"] *= -1.0
        if t % 9 == 0:
            score += int(rng.integers(0, 9))

        frame = np.full((fh, fw), 14, np.uint8)
        view = world[cyi : cyi + ah, cxi : cxi + aw].copy()
        for e in enemies:
            _draw_sprite(
                view, ENEMY_FRAMES[(t // 6) % 2],
                int(e["x"]) - cxi, int(e["y"]) - cyi,
            )
        phase = (t // 5) % 2
        _draw_sprite(
            view, PLAYER_FRAMES[phase], int(px) - cxi, int(py) - cyi
        )
        frame[aw_y0:aw_y1, aw_x0:aw_x1] = view
        hy = fh - hud_rows
        frame[hy : hy + hud_rows] = 0
        _draw_text(frame, "SCORE", 12, hy + 4, 1)
        _draw_text(frame, f"{score % 1000000:06d}", 60, hy + 4, 7)
        _draw_text(frame, "TIME", fw - 120, hy + 4, 1)
        _draw_text(frame, f"{max(0, 800 - t):03d}", fw - 76, hy + 4, 7)
        frames.append(frame)
        camera.append((cxi, cyi))

    return Session(frames=frames, camera=camera, world=world)


# ---------------------------------------------------------------------------
# Vertical-scroll shooter genre (shmup): the camera NEVER rests — constant
# 2-3 px/frame upward terrain scroll for the whole session (except short
# "boss hold" pauses) — and the foreground is DENSE and FAST: enemy wave
# formations sweeping against the scroll, bullet streams, and expanding
# explosion animations.  The platformer covers dead-zone run/stop motion
# and the flip-screen genre covers static-camera pans; this genre covers
# the opposite regime:
#
# - every single frame pair declares a nonzero vertical offset (long
#   constant-velocity runs, the easiest content to mis-track by ±1 and
#   never notice — exact camera recovery is asserted per frame),
# - a large coherent foreground moving AGAINST the terrain (a wave of
#   enemies all stepping down-screen together casts agreeing wrong-offset
#   votes — the Borda majority across regions must still follow terrain),
# - dozens of 1-3 px bullets flickering keypoint codes on and off,
# - foreground density pushes fde/fdf (many small contours per frame).
# ---------------------------------------------------------------------------

# Shmup tiles come in per-kind VARIANT sets (real tilesets do: 2-4
# canopy/wave drawings per terrain, laid per cell) — this keeps exact
# tile repetition (the bounded-join regime) while dividing each code's
# repeat count by the variant count, and detail is sparse/isolated
# (the _speckle rule) so per-region keypoint totals stay inside the
# default table capacity.  Measured on the pinned differential seed:
# <=~340 keypoints/region, max code repeat ~36 — repetitive enough to be
# honest tile-art, yet every declaration's per-row truncation bound
# holds at the DEFAULT limits (0 table / 0 join flags over 280 frames).
# Earlier drafts are a cautionary ledger: a dense per-tile canopy
# lattice measured ~3000 keypoints/region (4x the table), and two
# band/speckle interference bugs each minted one code repeated 74-153x
# per region (see the comments in _tile_water_v).

_SHMUP_VARIANTS = 8


def _tile_water_v(rng: np.random.Generator) -> np.ndarray:
    # NO _speckle here: the grain's period-5 diagonal collides with the
    # period-5 wave bands — the same speck-meets-band 5x5 patch recurs
    # across instances AND variants (measured: one code repeated 150x
    # per region).  Under the genre's constant vertical scroll the bands
    # alone change every pixel (step 2 is coprime with period 5), which
    # is all the aws heatmap needs; keypoints over open water come from
    # the sparse rock tiles instead.
    t = np.full((TILE, TILE), 6, np.uint8)  # deep blue
    # wave bands at a FIXED phase so they are world-aligned across tile
    # seams: per-variant phases put adjacent tiles' bands 2 rows apart
    # somewhere, and that double-band seam is a degenerate keypoint whose
    # code repeats along the whole row (measured: 74x in one region)
    t[2::5, :] = 14
    if rng.random() < 0.5:  # half the variants carry one foam fleck
        safe_rows = [0, 4, 5, 9, 10, 14, 15]  # >=2 rows from any band
        y = safe_rows[int(rng.integers(0, len(safe_rows)))]
        x = int(rng.integers(1, TILE - 3))
        t[y, x : x + 2] = 1
    return t


def _tile_wrock_v(rng: np.random.Generator) -> np.ndarray:
    """A rock poking out of the water: the distinctive anchor features
    that keep every grid region active over open ocean."""
    t = _tile_water_v(rng)
    y, x = int(rng.integers(2, TILE - 6)), int(rng.integers(2, TILE - 7))
    t[y : y + 3, x : x + 4] = 15
    t[y, x + 1 : x + 3] = 1       # highlight
    t[y + 3, x : x + 4] = 14      # foam skirt
    t[y + 1, x] = 0               # shadow
    return t


def _tile_sand_v(rng: np.random.Generator) -> np.ndarray:
    t = np.full((TILE, TILE), 7, np.uint8)  # yellow
    _speckle(t, rng, 8)
    y, x = int(rng.integers(2, TILE - 4)), int(rng.integers(2, TILE - 4))
    t[y : y + 2, x : x + 2] = 8  # one darker patch per variant
    return t


def _tile_grass_v(rng: np.random.Generator) -> np.ndarray:
    t = np.full((TILE, TILE), 5, np.uint8)  # green
    _speckle(t, rng, 13)
    y, x = int(rng.integers(2, TILE - 3)), int(rng.integers(2, TILE - 3))
    t[y, x : x + 2] = 13  # one small tuft
    t[y + 1, x] = 13
    return t


def _tile_forest_v(rng: np.random.Generator) -> np.ndarray:
    t = np.full((TILE, TILE), 5, np.uint8)
    _speckle(t, rng, 13)
    # two small canopy blobs per variant (not a dense lattice: a full
    # -canopy texture multiplies keypoints by every forest instance)
    for _ in range(2):
        y, x = int(rng.integers(2, TILE - 5)), int(rng.integers(2, TILE - 5))
        t[y : y + 3, x : x + 4] = 13
        t[y, x] = 5
        t[y + 2, x + 3] = 9  # shadow corner
    return t


def _tile_runway_v(rng: np.random.Generator) -> np.ndarray:
    t = np.full((TILE, TILE), 15, np.uint8)  # grey tarmac
    t[:, 7:9] = 1  # centre line
    t[int(rng.integers(0, 4))::4, 7:9] = 15  # dash phase per variant
    _speckle(t, rng, 0)
    return t


def _tile_ridge_v(rng: np.random.Generator) -> np.ndarray:
    t = _tile_grass_v(rng)
    y, x = int(rng.integers(4, 8)), int(rng.integers(4, 8))
    t[y : y + 4, x : x + 5] = 9
    t[y, x : x + 5] = 8  # lit slope edge
    return t


(WATER, SAND, GRASS, FOREST, RUNWAY, RIDGE, WROCK) = range(7)
_SHMUP_MAKERS = [
    _tile_water_v, _tile_sand_v, _tile_grass_v, _tile_forest_v,
    _tile_runway_v, _tile_ridge_v, _tile_wrock_v,
]


def make_tileset_shmup(rng: np.random.Generator) -> np.ndarray:
    """[n_kinds * VARIANTS, TILE, TILE]; tile index = kind * VARIANTS + v."""
    return np.stack([
        m(rng) for m in _SHMUP_MAKERS for _ in range(_SHMUP_VARIANTS)
    ])


def make_level_shmup(
    rng: np.random.Generator, rows: int, cols: int
) -> np.ndarray:
    """[rows, cols] tile map: an ocean strip with island blobs (sand
    fringe, grass core, forest/ridge detail) and an occasional runway.
    Entries are concrete tileset indices (kind * VARIANTS + variant)."""
    kind = np.full((rows, cols), WATER, np.int64)
    kind[rng.random((rows, cols)) < 0.05] = WROCK  # open-ocean anchors
    yy, xx = np.mgrid[0:rows, 0:cols]
    n_islands = max(3, rows // 6)
    for _ in range(n_islands):
        cy = int(rng.integers(2, rows - 2))
        cx = int(rng.integers(2, cols - 2))
        ry = float(rng.uniform(1.5, 4.0))
        rx = float(rng.uniform(1.5, cols / 2.5))
        d = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
        kind[d < 1.6] = SAND
        kind[d < 1.0] = GRASS
    grass = kind == GRASS
    kind[grass & (rng.random((rows, cols)) < 0.35)] = FOREST
    kind[grass & (rng.random((rows, cols)) < 0.10)] = RIDGE
    # a runway column through one island
    grassy_rows = np.nonzero(grass.sum(axis=1) > 4)[0]
    if len(grassy_rows) > 3:
        r0 = int(grassy_rows[int(rng.integers(0, len(grassy_rows)))])
        cands = np.nonzero(grass[r0])[0]
        c0 = int(cands[len(cands) // 2])
        r1 = r0
        while r1 < rows and kind[r1, c0] in (GRASS, FOREST, RIDGE):
            kind[r1, c0] = RUNWAY
            r1 += 1
    variant = rng.integers(0, _SHMUP_VARIANTS, size=(rows, cols))
    return kind * _SHMUP_VARIANTS + variant


PLAYER_SHIP_FRAMES = [
    np.array(
        [
            [_T, _T, _T, 1, _T, _T, _T],
            [_T, _T, 1, 1, 1, _T, _T],
            [_T, _T, 1, 3, 1, _T, _T],
            [1, _T, 1, 3, 1, _T, 1],
            [1, 1, 1, 1, 1, 1, 1],
            [1, 1, 2, 1, 2, 1, 1],
            [_T, _T, 7, _T, 7, _T, _T],
        ],
        np.uint8,
    ),
    np.array(
        [
            [_T, _T, _T, 1, _T, _T, _T],
            [_T, _T, 1, 1, 1, _T, _T],
            [_T, _T, 1, 3, 1, _T, _T],
            [1, _T, 1, 3, 1, _T, 1],
            [1, 1, 1, 1, 1, 1, 1],
            [1, 1, 2, 1, 2, 1, 1],
            [_T, _T, 8, _T, 8, _T, _T],  # exhaust flicker
        ],
        np.uint8,
    ),
]

ENEMY_SHIP_FRAMES = [
    np.array(
        [
            [4, _T, _T, _T, 4],
            [4, 4, 4, 4, 4],
            [_T, 4, 10, 4, _T],
            [_T, _T, 4, _T, _T],
        ],
        np.uint8,
    ),
    np.array(
        [
            [_T, 4, _T, 4, _T],
            [4, 4, 4, 4, 4],
            [_T, 4, 10, 4, _T],
            [_T, _T, 4, _T, _T],
        ],
        np.uint8,
    ),
]

EXPLOSION_FRAMES = [
    np.array([[_T, 7, _T], [7, 1, 7], [_T, 7, _T]], np.uint8),
    np.array(
        [
            [8, _T, 7, _T, 8],
            [_T, 7, 1, 7, _T],
            [7, 1, 1, 1, 7],
            [_T, 7, 1, 7, _T],
            [8, _T, 7, _T, 8],
        ],
        np.uint8,
    ),
    np.array(
        [
            [2, _T, _T, 8, _T, _T, 2],
            [_T, 8, _T, _T, _T, 8, _T],
            [_T, _T, 2, _T, 2, _T, _T],
            [8, _T, _T, _T, _T, _T, 8],
            [_T, _T, 2, _T, 2, _T, _T],
            [_T, 8, _T, _T, _T, 8, _T],
            [2, _T, _T, 8, _T, _T, 2],
        ],
        np.uint8,
    ),
]


def play_shmup_session(
    seed: int,
    n_frames: int,
    frame_hw: Tuple[int, int],
    hud_rows: int = 24,
    border: int = 8,
    scroll_speed: int = 2,
    hold_every: int = 150,
    hold_frames: int = 36,
) -> Session:
    """Simulate a vertical-scroll shooter run (see the genre note above).

    The camera scrolls UP the world at ``scroll_speed`` px/frame, pausing
    for ``hold_frames`` every ``hold_every`` frames (boss holds).  The
    camera x is locked (classic vertical shmup), so expected offsets are
    (0, -scroll) during scroll and (0, 0) during holds."""
    fh, fw = frame_hw
    rng = np.random.default_rng(0x5C0112 + seed)
    aw_y0, aw_y1 = border, fh - hud_rows - border
    aw_x0, aw_x1 = border, fw - border
    ah, aw = aw_y1 - aw_y0, aw_x1 - aw_x0

    # total scroll distance fixes the world height.  Replay the exact
    # hold schedule: holds trigger every `hold_every` SCROLL frames (the
    # loop's since_hold only counts scrolling frames), so a
    # holds-per-total-frames estimate undersizes the world on long
    # sessions and the camera runs out of world and rests at the top
    # (caught by review on the 1024-frame bench config: 56 px short,
    # 29 unplanned static frames)
    scrolled, hold_left, since_hold = 0, 0, 0
    for _ in range(1, n_frames):
        if hold_left > 0:
            hold_left -= 1
        else:
            scrolled += scroll_speed
            since_hold += 1
            if since_hold >= hold_every:
                hold_left = hold_frames
                since_hold = 0
    wh = ah + scrolled + TILE
    ww = aw
    tiles = make_tileset_shmup(rng)
    level = make_level_shmup(rng, wh // TILE + 1, ww // TILE + 1)
    world = render_world(level, tiles)[:wh, :ww]

    cam_y = wh - ah  # start at the bottom, scroll up
    hold_left = 0
    since_hold = 0

    # player (screen coords, darting runs like a human dodging)
    px, py = aw / 2.0, ah - 40.0
    pdx, run_left = 0, 0

    enemies: List[dict] = []   # screen coords: {x, y, vx, vy, phase}
    booms: List[dict] = []     # {x, y, age}
    pbullets: List[dict] = []  # {x, y}
    ebullets: List[dict] = []  # {x, y, vx, vy}
    next_wave = 20
    score = 0

    frames: List[np.ndarray] = []
    camera: List[Tuple[int, int]] = []

    for t in range(n_frames):
        # --- scroll / boss holds
        if t > 0:
            if hold_left > 0:
                hold_left -= 1
            else:
                cam_y = max(cam_y - scroll_speed, 0)
                since_hold += 1
                if since_hold >= hold_every and cam_y > 0:
                    hold_left = hold_frames
                    since_hold = 0

        # --- player darts
        if run_left == 0:
            pdx = int(rng.integers(-1, 2)) * 3
            run_left = int(rng.integers(6, 20))
        run_left -= 1
        px = float(np.clip(px + pdx, 8, aw - 15))
        py = float(np.clip(py + float(rng.integers(-1, 2)), ah - 80, ah - 16))
        if t % 8 == 0:
            pbullets.append({"x": px + 3, "y": py - 3})

        # --- enemy waves: formations entering from the top, sweeping down
        if t == next_wave:
            n = int(rng.integers(3, 6))
            x0 = float(rng.integers(20, aw - 20 - 14 * n))
            vx = float(rng.uniform(-1.2, 1.2))
            vy = float(rng.uniform(1.5, 2.6))
            for k in range(n):
                enemies.append({
                    "x": x0 + 14 * k, "y": -5.0 - 7 * k,
                    "vx": vx, "vy": vy, "phase": float(rng.uniform(0, 6.28)),
                })
            next_wave = t + int(rng.integers(24, 48))
        for e in enemies:
            e["x"] += e["vx"] + 1.3 * np.sin(0.11 * t + e["phase"])
            e["y"] += e["vy"]
            if rng.random() < 0.01 and e["y"] > 0:
                ebullets.append({
                    "x": e["x"] + 2, "y": e["y"] + 4,
                    "vx": float(np.clip((px - e["x"]) * 0.02, -1.5, 1.5)),
                    "vy": 3.0,
                })
        enemies = [e for e in enemies if e["y"] < ah + 8 and -8 < e["x"] < aw]

        # --- bullets
        for b in pbullets:
            b["y"] -= 4.0
        for b in ebullets:
            b["x"] += b["vx"]
            b["y"] += b["vy"]
        pbullets = [b for b in pbullets if b["y"] > -4]
        ebullets = [b for b in ebullets if -4 < b["y"] < ah + 4]

        # --- hits -> explosions
        survivors = []
        for e in enemies:
            hit = None
            for b in pbullets:
                if abs(b["x"] - e["x"] - 2) < 4 and abs(b["y"] - e["y"]) < 5:
                    hit = b
                    break
            if hit is not None:
                pbullets.remove(hit)
                booms.append({"x": e["x"], "y": e["y"], "age": 0})
                score += 150
            else:
                survivors.append(e)
        enemies = survivors
        for bm in booms:
            bm["age"] += 1
        booms = [bm for bm in booms if bm["age"] < 9]

        # --- render
        cyi = int(cam_y)
        frame = np.full((fh, fw), 0, np.uint8)  # black chrome
        view = world[cyi : cyi + ah, :].copy()
        for b in pbullets:
            _draw_sprite(view, np.full((3, 1), 7, np.uint8),
                         int(b["x"]), int(b["y"]))
        for b in ebullets:
            _draw_sprite(view, np.full((2, 2), 2, np.uint8),
                         int(b["x"]), int(b["y"]))
        for e in enemies:
            _draw_sprite(view, ENEMY_SHIP_FRAMES[(t // 4) % 2],
                         int(e["x"]), int(e["y"]))
        for bm in booms:
            _draw_sprite(view, EXPLOSION_FRAMES[bm["age"] // 3],
                         int(bm["x"]) - bm["age"] // 3,
                         int(bm["y"]) - bm["age"] // 3)
        _draw_sprite(view, PLAYER_SHIP_FRAMES[t % 2], int(px), int(py))
        frame[aw_y0:aw_y1, aw_x0:aw_x1] = view
        hy = fh - hud_rows
        frame[hy : hy + hud_rows] = 0
        _draw_text(frame, "SCORE", 12, hy + 4, 1)
        _draw_text(frame, f"{score % 1000000:06d}", 60, hy + 4, 7)
        _draw_text(frame, "TIME", fw - 120, hy + 4, 1)
        _draw_text(frame, f"{max(0, 800 - t):03d}", fw - 76, hy + 4, 7)
        frames.append(frame)
        camera.append((0, cyi))

    return Session(frames=frames, camera=camera, world=world)


# glyph set is {S C O R E T I M, digits, space} (_FONT above)
_DIALOG_LINES = [
    "IT IS TIME",
    "TO RISE 300",
    "MORE RICE 7",
    "SECTOR 90",
    "METEOR 215",
]


def _draw_dialog(
    view: np.ndarray, t_open: int, lines: List[str]
) -> None:
    """A JRPG dialog box over the bottom of the action window: dark fill,
    double white border, text typed one glyph per 2 frames.  Sized to
    exceed fde's area limit (area > frame/5 drops the contour from the
    foreground, fde.hpp:94-100) — the one foreground shape class the
    small-sprite genres never produce."""
    ah, aw = view.shape
    bh = max(ah // 3 + 8, 100)
    y0 = ah - bh - 6
    x0, x1 = 10, aw - 10
    box = view[y0 : y0 + bh, x0:x1]
    box[:] = 6  # dark blue fill
    box[[0, 1, -2, -1], :] = 1  # white border
    box[:, [0, 1, -2, -1]] = 1
    shown = max(0, t_open) // 2
    for i, line in enumerate(lines):
        take = min(len(line), max(0, shown - 6 * i))
        if take:
            _draw_text(view, line[:take], x0 + 10,
                       y0 + 10 + 14 * i, 1)


def play_session(
    seed: int,
    n_frames: int,
    frame_hw: Tuple[int, int],
    hud_rows: int = 24,
    border: int = 8,
    n_enemies: int = 3,
    level_cols: int = 140,
    level_rows: Optional[int] = None,
    hud_pos: str = "bottom",
    dialog_every: Optional[int] = None,
    dialog_frames: int = 36,
) -> Session:
    """Simulate one deterministic playthrough and render its capture.

    The returned frames look like the reference's input domain
    (main.cpp:16-52): a fixed screen with a static chrome (border), a
    HUD whose digits change, and an action window onto a tile-built
    world with animated foreground sprites.
    """
    fh, fw = frame_hw
    rng = np.random.default_rng(0xC0FFEE + seed)
    # action window beside the status bar.  The DEFAULT layout puts the
    # bar at the BOTTOM (the common C64-era layout) for a reason the
    # reference shares: aws's best-contour tie-break is
    # first-discovered-wins (std::min_element over score-0 ties,
    # aws.hpp:62-69 + row-major contour discovery), so a TOP bar with
    # changing digits latches a tiny digit blob as "best" forever and
    # the window is never accepted — in both pipelines alike
    # (PARITY.md "top-HUD window quirk"; hud_pos="top" reproduces it).
    if hud_pos == "top":
        aw_y0, aw_y1 = hud_rows + border, fh - border
    else:
        aw_y0, aw_y1 = border, fh - hud_rows - border
    aw_x0, aw_x1 = border, fw - border
    ah, aw = aw_y1 - aw_y0, aw_x1 - aw_x0

    if level_rows is None:
        # tall enough that hills/jumps drive the vertical camera too
        level_rows = ah // TILE + 11
    tiles = make_tileset(rng)
    level = make_level(rng, level_cols, level_rows)
    world = render_world(level, tiles)
    solid = np.kron(solid_mask(level), np.ones((TILE, TILE), bool))
    wh, ww = world.shape

    # player state (world pixel coords, feet-relative physics)
    px, py = TILE * 3.0, 0.0
    vx, vy = 0.0, 0.0
    on_ground = False
    inputs = _policy(rng, n_frames)

    # enemies: patrol [x0, x1] at ground height
    enemies = []
    for _ in range(n_enemies):
        ex = float(rng.integers(TILE * 8, ww - TILE * 8))
        span = float(rng.integers(TILE * 2, TILE * 6))
        enemies.append({
            "x": ex, "x0": ex - span, "x1": ex + span,
            "dir": 1.0 if rng.random() < 0.5 else -1.0,
        })

    def feet_floor(x: float, y: float) -> float:
        """Lowest free y (sprite top) so the 8x8 player stands on solid."""
        xi = int(np.clip(x + 4, 0, ww - 1))
        col = solid[:, xi]
        yi = int(np.clip(y + 8, 0, wh - 1))
        below = np.flatnonzero(col[yi:])
        if len(below):
            return float(yi + below[0] - 8)
        return float(wh - 8)

    # start standing
    py = feet_floor(px, 0.0)
    cam_x = float(np.clip(px - aw // 2, 0, ww - aw))
    cam_y = float(np.clip(py - ah // 2, 0, wh - ah))

    frames: List[np.ndarray] = []
    camera: List[Tuple[int, int]] = []
    score = 0

    for t in range(n_frames):
        d, jump = inputs[t]
        vx = 0.82 * vx + 0.60 * d
        if jump and on_ground:
            vy = -5.2
            on_ground = False
        vy = min(vy + 0.45, 6.0)  # gravity
        px = float(np.clip(px + vx, 0, ww - 9))
        floor = feet_floor(px, py)
        py = py + vy
        if py >= floor:
            py, vy, on_ground = floor, 0.0, True
        # dead-zone camera: only move when the player leaves the middle
        dz = aw // 12
        tgt = px - aw / 2
        if px - cam_x < aw / 2 - dz:
            cam_x = max(cam_x - min(3.0, (cam_x - tgt)), 0.0)
        elif px - cam_x > aw / 2 + dz:
            cam_x = min(cam_x + min(3.0, (tgt - cam_x)), ww - aw)
        ty = py - ah / 2
        if abs(ty - cam_y) > TILE // 2:
            cam_y = float(np.clip(
                cam_y + np.clip(ty - cam_y, -2.0, 2.0), 0, wh - ah
            ))
        cxi, cyi = int(round(cam_x)), int(round(cam_y))

        # enemies step + animate
        for e in enemies:
            e["x"] += e["dir"] * 0.8
            if e["x"] <= e["x0"] or e["x"] >= e["x1"]:
                e["dir"] *= -1.0
        if t % 7 == 0:
            score += int(rng.integers(0, 25))

        # ---- render ----
        frame = np.full((fh, fw), 14, np.uint8)  # chrome: light blue
        view = world[cyi : cyi + ah, cxi : cxi + aw].copy()
        # world-anchored enemies (foreground for fde/fdf)
        for e in enemies:
            ey = feet_floor(e["x"], 0.0) + 3  # 5-px tall sprite on ground
            _draw_sprite(
                view, ENEMY_FRAMES[(t // 6) % 2],
                int(e["x"]) - cxi, int(ey) - cyi,
            )
        # the player (screen-anchored via camera); idle frames still
        # animate — a slow walk-cycle "breathing" flip, like real sprites
        phase = (t // 4) % 2 if abs(vx) > 0.2 else (t // 10) % 2
        _draw_sprite(
            view, PLAYER_FRAMES[phase], int(px) - cxi, int(py) - cyi
        )
        # JRPG dialog interludes: a screen-anchored box over a STILL
        # -SCROLLING world (autoscroll cutscene style) — its static
        # keypoints vote (0, 0) against the terrain's true offset, and
        # its contour exceeds fde's frame/5 area limit
        if dialog_every and t >= dialog_every \
                and (t % dialog_every) < dialog_frames:
            k = (t // dialog_every) * 2
            lines = [_DIALOG_LINES[(k + i) % len(_DIALOG_LINES)]
                     for i in range(3)]
            _draw_dialog(view, t % dialog_every, lines)
        frame[aw_y0:aw_y1, aw_x0:aw_x1] = view
        # status bar: chrome + live counters
        hy = 0 if hud_pos == "top" else fh - hud_rows
        frame[hy : hy + hud_rows] = 0
        _draw_text(frame, "SCORE", 12, hy + 4, 1)
        _draw_text(frame, f"{score % 1000000:06d}", 60, hy + 4, 7)
        _draw_text(frame, "TIME", fw - 120, hy + 4, 1)
        _draw_text(frame, f"{max(0, 400 - t // 2):03d}", fw - 76, hy + 4, 7)
        frames.append(frame)
        camera.append((cxi, cyi))

    return Session(frames=frames, camera=camera, world=world)
