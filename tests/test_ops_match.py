"""Device matcher vs spec matcher across many random frame pairs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from remap_tpu.core.regions import make_layout
from remap_tpu.ops import kpe as jkpe
from remap_tpu.ops import kpm as jkpm
from remap_tpu.ops import tables as jtab
from remap_tpu.spec import kpe as skpe
from remap_tpu.spec import kpm as skpm
from remap_tpu.utils import testing


def run_both(frames, layout, weight_switch=10, capacity=2048):
    imgs = jnp.asarray(np.stack(frames))
    dense = jkpe.extract_dense(imgs, layout)
    tabs = jtab.extract_tables(dense.weight, dense.codes, layout, capacity)
    prev = jax.tree.map(lambda a: a[:-1], tabs)
    curr = jax.tree.map(lambda a: a[1:], tabs)
    res = jkpm.match_tables_jit(prev, curr, layout, weight_switch=weight_switch)
    assert not bool(np.asarray(res.overflow).any())

    specs = [skpe.extract(f, layout) for f in frames]
    spec_offs = [
        skpm.match_frames(
            specs[t - 1].regions, specs[t].regions, weight_switch=weight_switch
        )
        for t in range(1, len(frames))
    ]
    jax_offs = [
        tuple(int(v) for v in np.asarray(res.offset[t])) if res.ok[t] else None
        for t in range(len(frames) - 1)
    ]
    return spec_offs, jax_offs


def test_scrolling_world_matches():
    rng = np.random.default_rng(31)
    world = testing.make_world(200, 260, rng)
    layout = make_layout(96, 64, 4, 2, 16)
    path = testing.make_camera_path(16, (200, 260), (64, 96), rng, max_step=4)
    frames = [world[y : y + 64, x : x + 96] for x, y in path]
    spec_offs, jax_offs = run_both(frames, layout)
    assert spec_offs == jax_offs
    # and they equal the true camera deltas
    true = [
        (path[t][0] - path[t - 1][0], path[t][1] - path[t - 1][1])
        for t in range(1, len(path))
    ]
    assert jax_offs == true


def test_mixed_matchable_and_noise():
    rng = np.random.default_rng(33)
    world = testing.make_world(160, 200, rng)
    frames = [world[10 : 10 + 48, 10 : 10 + 64]]
    frames.append(world[12 : 12 + 48, 13 : 13 + 64])
    frames.append(rng.integers(0, 16, size=(48, 64), dtype=np.uint8))
    frames.append(rng.integers(0, 16, size=(48, 64), dtype=np.uint8))
    frames.append(world[50 : 50 + 48, 40 : 40 + 64])
    layout = make_layout(64, 48, 4, 2, 8)
    spec_offs, jax_offs = run_both(frames, layout)
    assert spec_offs == jax_offs
    assert jax_offs[0] == (3, 2)
    assert jax_offs[1] is None and jax_offs[2] is None


def test_weight_switch_paths():
    # exercise both branches of the adaptive weight filter on noisy frames
    rng = np.random.default_rng(35)
    world = testing.make_world(140, 180, rng)
    frames = [
        world[20 : 20 + 48, 20 : 20 + 64],
        world[22 : 22 + 48, 21 : 21 + 64],
    ]
    layout = make_layout(64, 48, 4, 2, 8)
    for ws in (0, 1, 10, 10_000):
        spec_offs, jax_offs = run_both(frames, layout, weight_switch=ws)
        assert spec_offs == jax_offs, ws


def test_sparse_keypoints_gate():
    # frames with almost no keypoints: gate on active regions
    flat = np.zeros((48, 64), dtype=np.uint8)
    a = flat.copy()
    a[10, 10] = 5  # a single anomalous pixel -> keypoints in one region only
    layout = make_layout(64, 48, 4, 2, 8)
    spec_offs, jax_offs = run_both([a, a.copy()], layout)
    assert spec_offs == jax_offs == [None]


def test_join_multiplicity_overflow_flagged():
    # a frame of repeated identical patches -> same code everywhere
    tile = np.zeros((48, 64), dtype=np.uint8)
    tile[::3, ::3] = 7  # periodic pattern, many identical codes
    imgs = jnp.asarray(np.stack([tile, tile]))
    layout = make_layout(64, 48, 4, 2, 8)
    dense = jkpe.extract_dense(imgs, layout)
    tabs = jtab.extract_tables(dense.weight, dense.codes, layout, 2048)
    prev = jax.tree.map(lambda a: a[:1], tabs)
    curr = jax.tree.map(lambda a: a[1:], tabs)
    res = jkpm.match_tables_jit(prev, curr, layout, weight_switch=10)
    if bool(np.asarray(tabs.valid).sum()) > 16:
        assert bool(np.asarray(res.overflow).any())


@pytest.mark.parametrize("mult", [0, 2])
def test_join_modes_agree(mult):
    # dense (0) and rolled joins must produce identical declarations
    rng = np.random.default_rng(77)
    world = testing.make_world(160, 200, rng, tile=4)
    frames = [
        world[20 : 20 + 48, 20 : 20 + 64],
        world[23 : 23 + 48, 22 : 22 + 64],
        world[25 : 25 + 48, 25 : 25 + 64],
    ]
    layout = make_layout(64, 48, 4, 2, 8)
    imgs = jnp.asarray(np.stack(frames))
    dense = jkpe.extract_dense(imgs, layout)
    tabs = jtab.extract_tables(dense.weight, dense.codes, layout, 2048)
    prev = jax.tree.map(lambda a: a[:-1], tabs)
    curr = jax.tree.map(lambda a: a[1:], tabs)
    res = jkpm.match_tables_jit(
        prev, curr, layout, weight_switch=10, multiplicity=mult
    )
    offs = [tuple(int(v) for v in o) for o in np.asarray(res.offset)]
    assert np.asarray(res.ok).all()
    assert offs == [(2, 3), (3, 2)]
    if mult == 0:
        assert not np.asarray(res.overflow).any()  # dense never overflows


def _tables_of(frames, layout, capacity=2048):
    imgs = jnp.asarray(np.stack(frames))
    dense = jkpe.extract_dense(imgs, layout)
    tabs = jtab.extract_tables(dense.weight, dense.codes, layout, capacity)
    prev = jax.tree.map(lambda a: a[:-1], tabs)
    curr = jax.tree.map(lambda a: a[1:], tabs)
    return prev, curr


@pytest.mark.parametrize("radius", [8, 16, pytest.param(32, marks=pytest.mark.slow)])
def test_vote_histogram_matches_exact(radius):
    """The matmul vote histogram agrees with the exact sort path whenever
    offsets fit the radius."""
    rng = np.random.default_rng(41)
    world = testing.make_world(200, 260, rng)
    layout = make_layout(96, 64, 4, 2, 16)
    path = testing.make_camera_path(12, (200, 260), (64, 96), rng, max_step=3)
    frames = [world[y : y + 64, x : x + 96] for x, y in path]
    prev, curr = _tables_of(frames, layout)
    exact = jkpm.match_tables_jit(prev, curr, layout, weight_switch=10)
    hist = jkpm.match_tables_jit(
        prev, curr, layout, weight_switch=10, vote_radius=radius
    )
    assert not bool(np.asarray(hist.overflow).any())
    assert np.array_equal(np.asarray(exact.ok), np.asarray(hist.ok))
    assert np.array_equal(np.asarray(exact.offset), np.asarray(hist.offset))


def test_vote_histogram_range_overflow_flags():
    """Out-of-radius offsets must raise range_overflow (the retry-exact
    signal), never silently drop votes.  Join limits held, so the plain
    overflow flag (capacity/multiplicity escalation) must stay clear."""
    rng = np.random.default_rng(43)
    world = testing.make_world(220, 300, rng)
    layout = make_layout(96, 64, 4, 2, 16)
    # a 40-px jump: well beyond radius 8
    frames = [
        world[20 : 20 + 64, 30 : 30 + 96],
        world[20 : 20 + 64, 70 : 70 + 96],
    ]
    prev, curr = _tables_of(frames, layout)
    exact = jkpm.match_tables_jit(prev, curr, layout, weight_switch=10)
    assert bool(exact.ok[0])
    assert tuple(int(v) for v in np.asarray(exact.offset[0])) == (40, 0)
    hist = jkpm.match_tables_jit(
        prev, curr, layout, weight_switch=10, vote_radius=8
    )
    assert bool(np.asarray(hist.range_overflow).any())
    assert not bool(np.asarray(hist.overflow).any())


def _hand_tables(layout, n_unique, n_rep, offset=(3, 2), capacity=256):
    """[1, R, K] tables: n_unique unique codes all voting ``offset``,
    plus ONE code repeated n_rep times on both sides (its pairs vote
    scattered offsets).  Deterministic control over join truncation."""
    import numpy as _np

    r_cnt = layout.region_count
    k = capacity
    rng = _np.random.default_rng(5)
    codes = _np.zeros((2, r_cnt, k, 4), _np.uint32)
    pos = _np.zeros((2, r_cnt, k, 2), _np.int32)
    valid = _np.zeros((2, r_cnt, k), bool)
    n = n_unique + n_rep
    assert n <= k
    for r in range(r_cnt):
        uc = rng.integers(1, 1 << 30, size=(n_unique, 4), dtype=_np.uint32)
        rep = rng.integers(1, 1 << 30, size=(4,), dtype=_np.uint32)
        codes[:, r, :n_unique] = uc
        codes[:, r, n_unique:n] = rep
        cx = rng.integers(5, 60, size=n)
        cy = rng.integers(5, 40, size=n)
        pos[1, r, :n, 0] = cx
        pos[1, r, :n, 1] = cy
        pos[0, r, :n, 0] = cx + offset[0]
        pos[0, r, :n, 1] = cy + offset[1]
        # scatter the repeated code's prev positions so its pairwise
        # offsets disagree with the main offset
        pos[0, r, n_unique:n, 0] = rng.integers(5, 90, size=n_rep)
        pos[0, r, n_unique:n, 1] = rng.integers(5, 60, size=n_rep)
        valid[:, r, :n] = True
    wc = _np.zeros((2, r_cnt, 3), _np.int32)
    wc[:, :, 1] = n  # all weight-1 -> adaptive switch uses all weights
    def tab(side):
        return jtab.RegionTables(
            codes=jnp.asarray(codes[side][None]),
            pos=jnp.asarray(pos[side][None]),
            valid=jnp.asarray(valid[side][None]),
            wcounts=jnp.asarray(wc[side][None]),
            overflow=jnp.zeros((1, r_cnt), bool),
        )
    return tab(0), tab(1)


def test_join_slots_equals_rolled():
    """The slot-major join (one broadcast per partner rank — half the
    offset-key sort volume) must enumerate EXACTLY the rolled join's
    pairs: same per-row partner multisets, same truncation accounting.
    Randomized tables with heavy code repetition and invalid rows."""
    rng = np.random.default_rng(123)
    k = 64
    for m in (1, 2, 4, 16):
        # ~12 distinct codes over 64 rows -> runs far longer than m
        codes = rng.integers(1, 12, size=(2, k, 4)).astype(np.uint32)
        pos = rng.integers(0, 90, size=(2, k, 2)).astype(np.int32)
        valid = rng.random((2, k)) < 0.8

        args = (
            jnp.asarray(codes[0]), jnp.asarray(pos[0]),
            jnp.asarray(valid[0]),
            jnp.asarray(codes[1]), jnp.asarray(pos[1]),
            jnp.asarray(valid[1]),
        )
        rolled = jkpm._join_rolled(*args, m, max_run=2 * m)
        slots = jkpm._join_slots(*args, m, coord_limit=96)

        assert int(rolled[3]) == int(slots[3])   # n_missed
        assert int(rolled[4]) == int(slots[4])   # rows_missed
        np.testing.assert_array_equal(np.asarray(rolled[5]),
                                      np.asarray(slots[5]))

        sent = 1 << 30

        def row_keys(out):
            dx, dy, pair = (np.asarray(a) for a in out[:3])
            keys = np.where(pair, (dx + 96) * 200 + (dy + 96), sent)
            return np.sort(keys, axis=0)     # per curr row (axis 1)

        rk = row_keys(rolled)                # [2m, 2K]
        sk = row_keys(slots)                 # [m, 2K]
        np.testing.assert_array_equal(rk[:m], sk)
        assert (rk[m:] == sent).all()        # rolled's extra slots empty


def test_join_slots_scan_equals_slots():
    """The split-field cummax join (used by the splice matcher, whose
    session canvases exceed _join_slots' single int32 pack) must
    enumerate EXACTLY the packed slot join's pairs: same per-row partner
    multisets, same truncation accounting — across multiplicities,
    run lengths far beyond the rolled join's max_run window, invalid
    rows, and coordinates needing multiple bit fields."""
    rng = np.random.default_rng(321)
    k = 64
    for m in (1, 2, 4, 16):
        # ~6 distinct codes over 64 rows -> runs of ~20, far beyond
        # max_run=2m at small m
        codes = rng.integers(1, 6, size=(2, k, 4)).astype(np.uint32)
        pos = rng.integers(0, 6000, size=(2, k, 2)).astype(np.int32)
        valid = rng.random((2, k)) < 0.8

        args = (
            jnp.asarray(codes[0]), jnp.asarray(pos[0]),
            jnp.asarray(valid[0]),
            jnp.asarray(codes[1]), jnp.asarray(pos[1]),
            jnp.asarray(valid[1]),
        )
        slots = jkpm._join_slots(*args, m, coord_limit=6000)
        scan = jkpm._join_slots_scan(*args, m, coord_limit=8192)

        assert int(slots[3]) == int(scan[3])     # n_missed
        assert int(slots[4]) == int(scan[4])     # rows_missed
        assert int(slots[7]) == int(scan[7])     # needed_m
        np.testing.assert_array_equal(np.asarray(slots[5]),
                                      np.asarray(scan[5]))

        sent = 1 << 62

        def row_keys(out):
            dx, dy, pair = (np.asarray(a).astype(np.int64) for a in out[:3])
            keys = np.where(
                pair > 0, (dx + 2**26) * 2**27 + (dy + 2**26), sent
            )
            return np.sort(keys, axis=0)     # per curr row (axis 1)

        np.testing.assert_array_equal(row_keys(slots), row_keys(scan))

        # the rolled join's window additionally truncates long runs;
        # every such pair must be in its missed accounting, so strict
        # callers escalate identically (the enumerated sets agree where
        # the window fits)
        rolled = jkpm._join_rolled(*args, m, max_run=2 * m)
        r_pairs = int(np.asarray(rolled[2]).sum())
        s_pairs = int(np.asarray(scan[2]).sum())
        assert r_pairs + int(rolled[3]) == s_pairs + int(scan[3])
        assert r_pairs <= s_pairs
        assert int(rolled[7]) == int(scan[7])    # same needed_m


def test_join_decision_bound():
    """A truncated join (repeated code beyond multiplicity) must flag
    overflow ONLY when the missed-pair mass could alter a region ticket:
    a few repeats against a dominant offset are provably harmless (no
    flag, result equals the dense join); heavy repeats must flag."""
    layout = make_layout(96, 64, 4, 2, 16)

    # 4 repeats at multiplicity 2: n_missed = 4*4 - 4*2 = 8 per region,
    # far below the 200-vote margin -> provably stable, no flag
    prev, curr = _hand_tables(layout, n_unique=200, n_rep=4)
    small = jkpm.match_tables_jit(prev, curr, layout, weight_switch=10,
                                  multiplicity=2)
    dense = jkpm.match_tables_jit(prev, curr, layout, weight_switch=10,
                                  multiplicity=0)
    assert not bool(np.asarray(small.overflow).any())
    assert bool(np.asarray(small.ok)[0])
    np.testing.assert_array_equal(np.asarray(small.offset),
                                  np.asarray(dense.offset))

    # sanity: the truncation is real (the join does miss pairs)
    out = jkpm._join_rolled(
        prev.codes[0, 0], prev.pos[0, 0], prev.valid[0, 0],
        curr.codes[0, 0], curr.pos[0, 0], curr.valid[0, 0],
        2, max_run=4,
    )
    assert int(out[3]) > 0

    # 60 repeats: missed mass 60*60 - 60*2 >> the margin -> must flag
    prev, curr = _hand_tables(layout, n_unique=40, n_rep=60)
    big = jkpm.match_tables_jit(prev, curr, layout, weight_switch=10,
                                multiplicity=2)
    assert bool(np.asarray(big.overflow).any())


def test_join_decision_bound_flags_tight_race():
    """When two offsets race within the missed-pair mass (the winner's
    per-region rank is vulnerable), the bound must flag even though the
    Borda margin looks healthy: a handful of unknown votes per region
    could flip every region's ranking."""
    import numpy as _np

    layout = make_layout(96, 64, 4, 2, 16)
    r_cnt = layout.region_count
    k = 256
    rng = _np.random.default_rng(9)
    codes = _np.zeros((2, r_cnt, k, 4), _np.uint32)
    pos = _np.zeros((2, r_cnt, k, 2), _np.int32)
    valid = _np.zeros((2, r_cnt, k), bool)
    n_a, n_b, n_rep = 20, 18, 4          # (3,2) leads (7,5) by only 2
    n = n_a + n_b + n_rep
    for r in range(r_cnt):
        uc = rng.integers(1, 1 << 30, size=(n_a + n_b, 4), dtype=_np.uint32)
        rep = rng.integers(1, 1 << 30, size=(4,), dtype=_np.uint32)
        codes[:, r, : n_a + n_b] = uc
        codes[:, r, n_a + n_b : n] = rep
        cx = rng.integers(5, 60, size=n)
        cy = rng.integers(5, 40, size=n)
        pos[1, r, :n, 0] = cx
        pos[1, r, :n, 1] = cy
        pos[0, r, :n_a, 0] = cx[:n_a] + 3
        pos[0, r, :n_a, 1] = cy[:n_a] + 2
        pos[0, r, n_a : n_a + n_b, 0] = cx[n_a : n_a + n_b] + 7
        pos[0, r, n_a : n_a + n_b, 1] = cy[n_a : n_a + n_b] + 5
        pos[0, r, n_a + n_b : n, 0] = rng.integers(5, 90, size=n_rep)
        pos[0, r, n_a + n_b : n, 1] = rng.integers(5, 60, size=n_rep)
        valid[:, r, :n] = True
    wc = _np.zeros((2, r_cnt, 3), _np.int32)
    wc[:, :, 1] = n

    def tab(side):
        return jtab.RegionTables(
            codes=jnp.asarray(codes[side][None]),
            pos=jnp.asarray(pos[side][None]),
            valid=jnp.asarray(valid[side][None]),
            wcounts=jnp.asarray(wc[side][None]),
            overflow=jnp.zeros((1, r_cnt), bool),
        )

    prev, curr = tab(0), tab(1)
    small = jkpm.match_tables_jit(prev, curr, layout, weight_switch=10,
                                  multiplicity=2)
    # missed mass 4*4-4*2 = 8 >= the 2-vote gap between the racing
    # offsets -> every region's winner rank is vulnerable -> must flag
    assert bool(np.asarray(small.overflow).any())
    dense = jkpm.match_tables_jit(prev, curr, layout, weight_switch=10,
                                  multiplicity=0)
    assert not bool(np.asarray(dense.overflow).any())
    assert tuple(int(v) for v in np.asarray(dense.offset)[0]) == (3, 2)


def test_join_bound_is_per_row_not_per_pair():
    """One code repeated 12x (scattered prev positions) against 40
    unique true-offset votes at multiplicity 2: the enumeration misses
    ~100+ PAIRS, but distinct pixels mean any single offset can gain at
    most one vote per affected ROW (12) — far under the 40-vote winner
    gap, so the declaration is provably stable: no flag, and the result
    must equal the dense join.  (The older per-pair bound counted the
    missed mass as ~120 unknown votes to one offset and escalated this
    exact shape.)"""
    layout = make_layout(96, 64, 4, 2, 16)
    prev, curr = _hand_tables(layout, n_unique=40, n_rep=12)

    small = jkpm.match_tables_jit(prev, curr, layout, weight_switch=10,
                                  multiplicity=2)
    dense = jkpm.match_tables_jit(prev, curr, layout, weight_switch=10,
                                  multiplicity=0)

    # the truncation is real and heavy in PAIR terms...
    out = jkpm._join_rolled(
        prev.codes[0, 0], prev.pos[0, 0], prev.valid[0, 0],
        curr.codes[0, 0], curr.pos[0, 0], curr.valid[0, 0],
        2, max_run=4,
    )
    assert int(out[3]) >= 40        # missed pairs
    assert int(out[4]) == 12        # affected rows

    # ...but provably harmless in ROW terms
    assert not bool(np.asarray(small.overflow).any())
    assert not bool(np.asarray(small.range_overflow).any())
    assert bool(np.asarray(small.ok)[0]) and bool(np.asarray(dense.ok)[0])
    np.testing.assert_array_equal(np.asarray(small.offset),
                                  np.asarray(dense.offset))
