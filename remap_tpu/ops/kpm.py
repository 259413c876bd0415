"""Batched frame-to-frame keypoint matching (device form of kpm.hpp).

The reference's per-region hash joins and vote maps (kpm.hpp:85-223) become
dense, sort-based primitives with static shapes:

- code join: a [K, K] all-words-equal comparison between the two regions'
  fixed-capacity tables (codes include the weight nibble, so the adaptive
  weight filter reduces to masking *current* entries, kpm.hpp:105-125),
- vote counting: encode each pair's offset as an int32 key, sort the K*K
  keys, and derive per-run counts from run boundaries (replacing the
  offset hash map, kpm.hpp:92-125),
- top-3 per region via top_k (count desc, ties -> smallest key — the
  reference's tie order is unspecified hash order; this is the canonical
  deterministic choice),
- Borda count + winner declaration across regions (kpm.hpp:172-211).

The whole matcher vmaps over (pair, region): matching frame t against
frame t-1 needs only the two tables, so a clip's every consecutive pair is
matched in one dispatch — the reference's serial loop (frc.hpp:97-122) is
parallel in disguise.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from remap_tpu.core.regions import GridLayout
from remap_tpu.ops.tables import RegionTables


class MatchResult(NamedTuple):
    offset: jax.Array    # [P, 2] int32 (dx, dy)
    ok: jax.Array        # [P] bool
    overflow: jax.Array  # [P] bool — join multiplicity exceeded somewhere
    #: [P] bool — out-of-radius votes *could* have changed a region
    #: ticket (vote_radius > 0 only); retry with vote_radius=0 — the
    #: join limits themselves did not overflow.
    range_overflow: jax.Array


def _run_counts(sorted_keys: jax.Array, sentinel: int):
    """Per-position run info of an ascending int32 array.

    Returns (is_start, counts) where counts[i] = run length for positions
    that start a non-sentinel run, else 0.
    """
    n = sorted_keys.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    is_start = jnp.concatenate(
        [jnp.ones((1,), bool), sorted_keys[1:] != sorted_keys[:-1]]
    )
    start_pos = jnp.where(is_start, iota, n)
    # next run start strictly after i
    suffix_min = jnp.flip(jax.lax.cummin(jnp.flip(start_pos)))
    next_start = jnp.concatenate(
        [suffix_min[1:], jnp.full((1,), n, jnp.int32)]
    )
    counts = jnp.where(
        is_start & (sorted_keys < sentinel), next_start - iota, 0
    )
    return is_start, counts


def _encode_offset(dx: jax.Array, dy: jax.Array, w: int, h: int) -> jax.Array:
    return (dx + w) * (2 * h) + (dy + h)


def _decode_offset(key: jax.Array, w: int, h: int):
    return key // (2 * h) - w, key % (2 * h) - h


_SENT = jnp.uint32(0xFFFFFFFF)


def _join_rolled(
    p_codes, p_pos, p_valid,      # [K,4] u32, [K,2] i32, [K] bool
    c_codes, c_pos, c_sel,
    multiplicity: int,
    max_run: int,
):
    """Enumerate equal-code (prev, curr) pair offsets, gather-free.

    Sort-merge join directly on the 4 code words (exact — no hashing):
    word 3 only carries nibble 24 + the weight nibble in its low byte
    (spec.kpe.pack_code), so the last key word is ``c3 << 1`` with the
    curr-side origin tag in bit 0 (subordinate to every code bit, so
    equal codes stay adjacent with prev entries first) and all-ones as
    the invalid sentinel (a valid key word never reaches it).  Six sort
    operands total: 4 key words + the two position columns as payload.

    Within an equal-code run, prev entries precede curr (the origin bit),
    so a curr entry's partners sit at small *backward distances* —
    enumerated with ``max_run`` fixed rolls and masks instead of gathers
    (the gather-free form was chosen for an accelerator whose gathers were
    slow; its price on the GPU is to be re-measured).

    Exact as long as each curr entry's backward distance to its run start
    is <= max_run and no code repeats more than ``multiplicity`` times in
    prev.  Two truncation measures are returned exactly:

    - ``n_missed``: total equal-code pairs the enumeration missed (sum
      over curr rows of the run's prev count, minus the pairs
      enumerated) — the raw diagnostic.
    - ``rows_missed``: the number of curr rows with at least one missed
      partner.  Table rows are distinct pixels, so for any single offset
      (dx, dy) a curr row at position p has at most ONE equal-code
      partner (the prev row at p + offset) — enumerated or not.  The
      vote count any single offset could gain from the missed mass is
      therefore bounded by ``rows_missed``, not ``n_missed`` — a bound
      up to (repeats - multiplicity)x tighter on repetitive content,
      which is exactly where truncation happens.

    Returns (dx [2K, S], dy [2K, S], pair_valid [2K, S], n_missed [],
    rows_missed [], curr_x [2K], curr_y [2K]).
    """
    k = p_codes.shape[0]
    n = 2 * k
    m = multiplicity

    codes = jnp.concatenate([p_codes, c_codes])          # [2K, 4]
    validc = jnp.concatenate([p_valid, c_sel])
    inv = jnp.where(validc, jnp.uint32(0), _SENT)
    tag = jnp.concatenate(
        [jnp.zeros((k,), jnp.uint32), jnp.ones((k,), jnp.uint32)]
    )
    px = jnp.concatenate([p_pos[:, 0], c_pos[:, 0]])
    py = jnp.concatenate([p_pos[:, 1], c_pos[:, 1]])

    s0, s1, s2, s3, spx, spy = jax.lax.sort(
        (
            codes[:, 0] | inv,
            codes[:, 1] | inv,
            codes[:, 2] | inv,
            ((codes[:, 3] << 1) | tag) | inv,
            px,
            py,
        ),
        num_keys=4,
    )
    is_curr_row = (s3 & 1) != 0
    not_sent = s3 != _SENT
    is_prev = (~is_curr_row) & not_sent
    is_curr = is_curr_row & not_sent

    iota = jnp.arange(n, dtype=jnp.int32)
    m3 = s3 | 1                   # mask the origin bit out of run keys
    neq = (
        (s0[1:] != s0[:-1])
        | (s1[1:] != s1[:-1])
        | (s2[1:] != s2[:-1])
        | (m3[1:] != m3[:-1])
    )
    is_start = jnp.concatenate([jnp.ones((1,), bool), neq])
    rid = jnp.cumsum(is_start)
    run_start = jax.lax.cummax(jnp.where(is_start, iota, 0))
    d = iota - run_start                                  # distance to start

    # prev count of the run, gather-free: carry pcum_ex at run starts
    pcum_ex = jnp.cumsum(is_prev) - is_prev
    start_val = jax.lax.cummax(jnp.where(is_start, pcum_ex, -1))
    n_prev = pcum_ex - start_val                          # for curr rows

    # every curr row should pair with ALL prev rows of its code
    # (kpm.hpp:92-125); the enumeration below may truncate — count the
    # true total here, subtract what was enumerated at the end
    total_true = jnp.sum(jnp.where(is_curr, n_prev, 0))

    def shifted(a, s):
        return jnp.concatenate([a[:1].repeat(s), a[:-s]]) if s else a

    dxs, dys, valids = [], [], []
    for s in range(1, max_run + 1):
        same_run = rid == shifted(rid, s)
        partner_prev = shifted(is_prev, s)
        # partner rank within run = d - s; enforce rank < multiplicity
        ok = (
            is_curr
            & partner_prev
            & same_run
            & (d - s < m)
            & (s <= d)
        )
        dxs.append(shifted(spx, s) - spx)
        dys.append(shifted(spy, s) - spy)
        valids.append(ok)

    dx = jnp.stack(dxs, axis=0)
    dy = jnp.stack(dys, axis=0)
    pair = jnp.stack(valids, axis=0)
    n_missed = total_true - jnp.sum(pair, dtype=jnp.int32)
    enum_row = jnp.sum(pair, axis=0, dtype=jnp.int32)        # [2K]
    rows_missed = jnp.sum(
        is_curr & (n_prev > enum_row), dtype=jnp.int32
    )
    # needed_m: the smallest multiplicity that would enumerate EVERY
    # pair — lets strict callers jump the escalation ladder in one step
    # (the dense endpoint is quadratic in capacity and cliffs on
    # session-scale canvases; real content's max code repetition is tiny)
    needed_m = jnp.max(jnp.where(is_curr, n_prev, 0)).astype(jnp.int32)
    # spx/spy are each sorted row's own (curr-side) coordinates; a pair's
    # prev-side coordinate is spx + dx (used by the cellular matcher).
    return dx, dy, pair, n_missed, rows_missed, spx, spy, needed_m


def _join_slots(
    p_codes, p_pos, p_valid,      # [K,4] u32, [K,2] i32, [K] bool
    c_codes, c_pos, c_sel,
    multiplicity: int,
    coord_limit: int,
):
    """The slot-major form of :func:`_join_rolled`: same pairs, same
    truncation accounting, HALF the slot space.

    Key observation: after the 6-operand code sort, every equal-code run
    holds all its prev entries before all its curr entries (the origin
    tag bit), so the j-th enumerated partner of EVERY curr row in a run
    is the SAME prev row — the run's j-th entry.  Instead of enumerating
    partners at 2*multiplicity backward roll distances (each curr row
    reaches its j-th partner at a different distance), broadcast each
    prev row's coordinates down its run once per slot j < multiplicity:

    - emit[j, i] = is_prev[i] & (distance-from-run-start[i] == j)
    - carry emitted values forward with ONE cumulative max per axis over
      packed keys ``rid * (coord_limit + 2) + coord + 1`` — run ids
      strictly increase along the scan, so a fresh run's pack always
      dominates stale carries from earlier runs,
    - pair[j, i] valid iff i is a curr row and j < n_prev of its run
      (which guarantees the carried value came from this run).

    The downstream offset-key sort shrinks from ``2K * 2m`` slots to
    ``2K * m`` — the exact full-range counting path's wall on repetitive
    (tile-periodic) content, where no bounded vote radius is provably
    exact and multiplicity must cover the tileset's code repetition.

    Enumerated partner set per curr row: the first ``min(n_prev, m)``
    prev entries of its run in sort order — identical to _join_rolled
    (equality asserted in tests/test_ops_match.py).

    ``coord_limit`` is a static upper bound on position coordinates
    (frame/canvas dims); the packing needs ``2K * (coord_limit + 2) <
    2**31`` — callers fall back to _join_rolled otherwise.

    Returns (dx [S, 2K], dy [S, 2K], pair [S, 2K], n_missed [],
    rows_missed [], curr_x [2K], curr_y [2K]).
    """
    k = p_codes.shape[0]
    n = 2 * k
    m = multiplicity
    lim = coord_limit + 2
    assert n * lim < (1 << 31) - 1, (n, coord_limit)

    codes = jnp.concatenate([p_codes, c_codes])          # [2K, 4]
    validc = jnp.concatenate([p_valid, c_sel])
    inv = jnp.where(validc, jnp.uint32(0), _SENT)
    tag = jnp.concatenate(
        [jnp.zeros((k,), jnp.uint32), jnp.ones((k,), jnp.uint32)]
    )
    px = jnp.concatenate([p_pos[:, 0], c_pos[:, 0]])
    py = jnp.concatenate([p_pos[:, 1], c_pos[:, 1]])

    s0, s1, s2, s3, spx, spy = jax.lax.sort(
        (
            codes[:, 0] | inv,
            codes[:, 1] | inv,
            codes[:, 2] | inv,
            ((codes[:, 3] << 1) | tag) | inv,
            px,
            py,
        ),
        num_keys=4,
    )
    is_curr_row = (s3 & 1) != 0
    not_sent = s3 != _SENT
    is_prev = (~is_curr_row) & not_sent
    is_curr = is_curr_row & not_sent

    iota = jnp.arange(n, dtype=jnp.int32)
    m3 = s3 | 1                   # mask the origin bit out of run keys
    neq = (
        (s0[1:] != s0[:-1])
        | (s1[1:] != s1[:-1])
        | (s2[1:] != s2[:-1])
        | (m3[1:] != m3[:-1])
    )
    is_start = jnp.concatenate([jnp.ones((1,), bool), neq])
    rid = jnp.cumsum(is_start).astype(jnp.int32)          # 1..n
    run_start = jax.lax.cummax(jnp.where(is_start, iota, 0))
    d = iota - run_start                                  # distance to start

    # prev count of the run at each row (gather-free, as in _join_rolled)
    pcum_ex = jnp.cumsum(is_prev) - is_prev
    start_val = jax.lax.cummax(jnp.where(is_start, pcum_ex, -1))
    n_prev = pcum_ex - start_val
    total_true = jnp.sum(jnp.where(is_curr, n_prev, 0))

    slot = jnp.arange(m, dtype=jnp.int32)[:, None]        # [m, 1]
    emit = is_prev[None, :] & (d[None, :] == slot)        # [m, n]
    base = rid * lim                                      # [n]

    def fill(v):
        packed = jnp.where(emit, base[None, :] + v[None, :] + 1, 0)
        carried = jax.lax.cummax(packed, axis=1)
        return carried % lim - 1                          # partner coord

    partner_x = fill(spx)
    partner_y = fill(spy)
    pair = is_curr[None, :] & (slot < n_prev[None, :])    # [m, n]
    dx = partner_x - spx[None, :]
    dy = partner_y - spy[None, :]

    n_missed = total_true - jnp.sum(pair, dtype=jnp.int32)
    enum_row = jnp.sum(pair, axis=0, dtype=jnp.int32)     # [2K]
    rows_missed = jnp.sum(
        is_curr & (n_prev > enum_row), dtype=jnp.int32
    )
    needed_m = jnp.max(jnp.where(is_curr, n_prev, 0)).astype(jnp.int32)
    return dx, dy, pair, n_missed, rows_missed, spx, spy, needed_m


def _join_slots_scan(
    p_codes, p_pos, p_valid,      # [K,4] u32, [K,2] i32, [K] bool
    c_codes, c_pos, c_sel,
    multiplicity: int,
    coord_limit: int = 8192,
):
    """:func:`_join_slots` beyond the single-cummax packing bound.

    Same slot-major enumeration (the j-th partner of every curr row in a
    run is the run's j-th prev entry) and the same "pack into a
    monotone key, carry with one cummax" fill — but the partner
    coordinate is SPLIT into bit fields small enough that each field's
    ``rid * 2^bits + field`` pack stays inside int32, one cummax per
    field.  Two scans per axis cover any canvas below 8192 px at up to
    ~16M table rows — the session-scale splice canvases that overflow
    :func:`_join_slots`' single pack (fgs.hpp:119-140 scale).

    (A tuple ``lax.associative_scan`` fill was measured first: it is
    compile-size-invariant in multiplicity but builds the log2(n)
    odd/even recursion in the graph itself — 145-166 s of remote XLA
    compile at n=2^20 vs sub-second for the built-in cummax lowering,
    benchmarks/fgs_match_probe.py.)

    Enumerates all first-min(n_prev, m) partners per curr row — a
    SUPERSET of :func:`_join_rolled`, whose ``max_run`` roll window
    additionally truncates long runs (both forms count every missed
    pair in ``n_missed``/``rows_missed``, so strict callers escalate
    identically; asserted in tests/test_ops_match.py).

    Compile-size note: NO construct grows with ``multiplicity`` (the
    slot axis is an array dimension) — the ~110 s-per-level compile
    wall of the unrolled ``_join_rolled`` at session capacities does
    not apply.

    Returns (dx [m, 2K], dy [m, 2K], pair [m, 2K], n_missed [],
    rows_missed [], curr_x [2K], curr_y [2K], needed_m [])."""
    k = p_codes.shape[0]
    n = 2 * k
    m = multiplicity
    coord_bits = max(1, (coord_limit - 1).bit_length())
    rid_bits = (n + 1).bit_length()
    field_bits = 30 - rid_bits
    assert field_bits >= 1, (n, coord_limit)

    codes = jnp.concatenate([p_codes, c_codes])          # [2K, 4]
    validc = jnp.concatenate([p_valid, c_sel])
    inv = jnp.where(validc, jnp.uint32(0), _SENT)
    tag = jnp.concatenate(
        [jnp.zeros((k,), jnp.uint32), jnp.ones((k,), jnp.uint32)]
    )
    px = jnp.concatenate([p_pos[:, 0], c_pos[:, 0]])
    py = jnp.concatenate([p_pos[:, 1], c_pos[:, 1]])

    s0, s1, s2, s3, spx, spy = jax.lax.sort(
        (
            codes[:, 0] | inv,
            codes[:, 1] | inv,
            codes[:, 2] | inv,
            ((codes[:, 3] << 1) | tag) | inv,
            px,
            py,
        ),
        num_keys=4,
    )
    is_curr_row = (s3 & 1) != 0
    not_sent = s3 != _SENT
    is_prev = (~is_curr_row) & not_sent
    is_curr = is_curr_row & not_sent

    iota = jnp.arange(n, dtype=jnp.int32)
    m3 = s3 | 1                   # mask the origin bit out of run keys
    neq = (
        (s0[1:] != s0[:-1])
        | (s1[1:] != s1[:-1])
        | (s2[1:] != s2[:-1])
        | (m3[1:] != m3[:-1])
    )
    is_start = jnp.concatenate([jnp.ones((1,), bool), neq])
    rid = jnp.cumsum(is_start).astype(jnp.int32)          # 1..n, monotone
    run_start = jax.lax.cummax(jnp.where(is_start, iota, 0))
    d = iota - run_start                                  # distance to start

    pcum_ex = jnp.cumsum(is_prev) - is_prev
    start_val = jax.lax.cummax(jnp.where(is_start, pcum_ex, -1))
    n_prev = pcum_ex - start_val
    total_true = jnp.sum(jnp.where(is_curr, n_prev, 0))

    slot = jnp.arange(m, dtype=jnp.int32)[:, None]        # [m, 1]
    emit = is_prev[None, :] & (d[None, :] == slot)        # [m, n]

    def fill_latest(val):
        """Forward fill along the row axis: at each position, ``val`` of
        the latest emit at or before it ("latest emit wins"; validity is
        enforced by the caller's ``slot < n_prev`` test).  One cummax
        per bit field: ``rid`` increases along the axis, so the packed
        key of the latest emit dominates every earlier one."""
        out = jnp.zeros((m, n), jnp.int32)
        shift = 0
        while shift < coord_bits:
            bits = min(field_bits, coord_bits - shift)
            field = (val >> shift) & ((1 << bits) - 1)
            packed = jnp.where(
                emit, (rid << bits) + field[None, :], 0
            )
            got = jax.lax.cummax(packed, axis=1) & ((1 << bits) - 1)
            out = out | (got << shift)
            shift += bits
        return out

    partner_x = fill_latest(spx)
    partner_y = fill_latest(spy)
    pair = is_curr[None, :] & (slot < n_prev[None, :])    # [m, n]
    dx = partner_x - spx[None, :]
    dy = partner_y - spy[None, :]

    n_missed = total_true - jnp.sum(pair, dtype=jnp.int32)
    enum_row = jnp.sum(pair, axis=0, dtype=jnp.int32)     # [2K]
    rows_missed = jnp.sum(
        is_curr & (n_prev > enum_row), dtype=jnp.int32
    )
    needed_m = jnp.max(jnp.where(is_curr, n_prev, 0)).astype(jnp.int32)
    return dx, dy, pair, n_missed, rows_missed, spx, spy, needed_m


def _join_dense(
    p_codes, p_pos, p_valid,      # [K,4] u32, [K,2] i32, [K] bool
    c_codes, c_pos, c_sel,
):
    """Exhaustive [K, K] pair enumeration — no multiplicity limit.

    The escalation endpoint for pathological inputs (heavily repeated
    codes): quadratic in table capacity but enumerates *every* equal-code
    pair, so there is no overflow condition.  Selected via
    ``multiplicity=0``."""
    eq = jnp.all(p_codes[:, None, :] == c_codes[None, :, :], axis=-1)
    pair = eq & p_valid[:, None] & c_sel[None, :]
    dx = p_pos[:, None, 0] - c_pos[None, :, 0]
    dy = p_pos[:, None, 1] - c_pos[None, :, 1]
    # [prev, curr] orientation = the joins' slot-major convention: axis 0
    # enumerates a row's partners, axis 1 is the curr row (whose
    # coordinates are the trailing returns)
    return (
        dx, dy, pair, jnp.zeros((), jnp.int32),
        jnp.zeros((), jnp.int32), c_pos[:, 0], c_pos[:, 1],
        jnp.zeros((), jnp.int32),
    )


def _region_votes(
    p_codes, p_pos, p_valid,      # [K,4] u32, [K,2] i32, [K] bool
    c_codes, c_pos, c_valid,
    use_all_weights,              # [] bool
    w: int,
    h: int,
    region_votes: int,
    multiplicity: int,
    vote_radius: int = 0,
):
    """Top-`region_votes` offsets of one region pair: (keys, counts,
    Borda swing bound, join-involved flag).

    Truncation is reported as a *bounded uncertainty*, not a hard flag:
    the join counts exactly how many curr rows have a missed equal-code
    partner (``rows_missed``), the histogram how many rows have an
    in-join vote outside the radius (``rows_out``).  Region rows are
    distinct pixels, so a single offset pairs each curr row with at most
    one prev position — any ONE offset can gain at most one unknown vote
    per affected row, i.e. ``u = rows_missed + rows_out`` (the total
    missed-PAIR count would be sound too, but up to repeats-minus-
    multiplicity times looser exactly on the repetitive content where
    truncation happens).  Comparing ``u`` against the adjacent count gaps of
    the top ``region_votes + 1`` visible offsets bounds how deep into
    the ticket the unknown mass could reach: if ``u`` is below the gap
    above rank k+1, ranks 1..k are provably fixed (a boosted lower
    offset cannot cross them, and an unseen offset — at most the
    (V+1)-th count plus ``u`` — cannot either; ``>=`` because an equal
    count could win the canonical smallest-key tie-break).  The region's
    Borda contribution to any single offset can then change by at most
    ``swing`` = the points of the highest vulnerable rank (3/2/1, or 0
    when the whole ticket is provably exact).  ``_borda_declare`` sums
    the swings and flags only when the *declared outcome* could change —
    which is what makes bounded join limits usable on repetitive content
    (HUD bands, tiled worlds) where tail-of-ticket ties are routine but
    almost never decisive."""
    sentinel = 4 * w * h

    c_weight = (c_codes[:, 3] >> 4) & 0xF
    c_sel = c_valid & (use_all_weights | (c_weight == 2))  # kpm.hpp:113-116

    if multiplicity == 0:  # exhaustive dense join (no limits)
        dx, dy, pair, n_missed, rows_missed = _join_dense(
            p_codes, p_pos, p_valid, c_codes, c_pos, c_sel
        )[:5]
    elif 2 * p_codes.shape[0] * (max(w, h) + 2) < (1 << 31) - 1:
        # slot-major join: half the offset-key sort volume of the rolled
        # form — the wall of the exact full-range path on tile-periodic
        # content (see _join_slots)
        dx, dy, pair, n_missed, rows_missed = _join_slots(
            p_codes, p_pos, p_valid, c_codes, c_pos, c_sel,
            multiplicity, coord_limit=max(w, h),
        )[:5]
    else:  # coordinate packing would overflow int32 (giant canvases)
        dx, dy, pair, n_missed, rows_missed = _join_rolled(
            p_codes, p_pos, p_valid, c_codes, c_pos, c_sel,
            multiplicity, max_run=2 * multiplicity,
        )[:5]

    def swing_bound(counts_ext, unknown):
        # counts_ext: top region_votes+1 counts, descending.  gaps[k] is
        # the boundary above rank k+2; the first vulnerable boundary
        # determines how many ranks' points are in play.
        gaps = counts_ext[:-1] - counts_ext[1:]
        vul = unknown >= gaps
        first = jnp.argmax(vul)               # first vulnerable boundary
        swing = jnp.where(
            (unknown > 0) & vul.any(), region_votes - first, 0
        )
        return swing.astype(jnp.int32)

    if vote_radius > 0:
        # matmul vote histogram: counts[dx, dy] = onehot(dx)^T @ onehot(dy)
        # over the enumerated pairs — one bf16 matmul with exact f32
        # integer accumulation replaces the offset-key sort.  Offsets
        # beyond the radius raise ``overflow`` and callers escalate to
        # the exact path (vote_radius=0), so results never silently
        # truncate; bins iterate (dx, dy) row-major = ascending encoded
        # key, preserving the canonical smallest-key tie-break.
        r = vote_radius
        nb = 2 * r + 1
        in_range = pair & (jnp.abs(dx) <= r) & (jnp.abs(dy) <= r)
        # rows (not pairs): one offset gains at most one vote per row.
        # Joins are slot-major [S, N] (rows on axis 1).
        rows_out = jnp.sum(
            (pair & ~in_range).any(axis=0), dtype=jnp.int32
        )
        iotab = jnp.arange(nb, dtype=jnp.int32)

        # Bound the one-hot working set without serializing: flatten the
        # enumerated pairs and matmul CHUNK of them at a time.  At the
        # serving shapes one chunk covers everything (a single matmul —
        # the fast path); only escalated replays (multiplicity 16 / the
        # dense join, where all-at-once one-hots reach gigabytes across
        # the vmapped region pairs) iterate.  An earlier formulation ran
        # a fori over join *columns* — tiny serial matmuls that slowed
        # the exact-canvas collect ~17x.
        n_flat = dx.size
        CHUNK = 1 << 15
        dxf = dx.reshape(-1)
        dyf = dy.reshape(-1)
        rngf = in_range.reshape(-1)
        if n_flat > CHUNK:
            pad = (-n_flat) % CHUNK
            dxf = jnp.pad(dxf, (0, pad))
            dyf = jnp.pad(dyf, (0, pad))
            rngf = jnp.pad(rngf, (0, pad))

            def chunk_step(s, acc):
                sl = s * CHUNK
                dxs = jax.lax.dynamic_slice(dxf, (sl,), (CHUNK,))
                dys = jax.lax.dynamic_slice(dyf, (sl,), (CHUNK,))
                rs = jax.lax.dynamic_slice(rngf, (sl,), (CHUNK,))
                a = ((dxs[:, None] + r) == iotab) & rs[:, None]
                b = ((dys[:, None] + r) == iotab) & rs[:, None]
                return acc + jax.lax.dot_general(
                    a.astype(jnp.bfloat16),
                    b.astype(jnp.bfloat16),
                    (((0,), (0,)), ((), ())),
                    preferred_element_type=jnp.float32,
                )

            counts2d = jax.lax.fori_loop(
                0,
                (n_flat + pad) // CHUNK,
                chunk_step,
                jnp.zeros((nb, nb), jnp.float32),
            )
        else:
            a = ((dxf[:, None] + r) == iotab) & rngf[:, None]
            b = ((dyf[:, None] + r) == iotab) & rngf[:, None]
            counts2d = jax.lax.dot_general(
                a.astype(jnp.bfloat16),
                b.astype(jnp.bfloat16),
                (((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            )                                              # [nb, nb]
        counts = counts2d.reshape(-1).astype(jnp.int32)
        bx = iotab[:, None].repeat(nb, 1).reshape(-1) - r   # dx per bin
        by = iotab[None, :].repeat(nb, 0).reshape(-1) - r   # dy per bin
        bin_keys = _encode_offset(bx, by, w, h)

        def pick_bin(cnts, _):
            i = jnp.argmax(cnts)
            return cnts.at[i].set(-1), (bin_keys[i], cnts[i])

        _, (top_keys, top_counts) = jax.lax.scan(
            pick_bin, counts, None, length=region_votes + 1
        )
        # join truncation and out-of-radius votes pool into one unknown
        # mass (per-row bounds); the join-involved flag attributes a
        # later declare-level flag to the join (multiplicity escalation)
        # vs the radius alone (cheap vote_radius=0 retry)
        swing = swing_bound(top_counts, rows_missed + rows_out)
        return (
            top_keys[:region_votes], top_counts[:region_votes],
            swing, n_missed > 0,
        )

    keys = jnp.where(
        pair, _encode_offset(dx, dy, w, h), jnp.int32(sentinel)
    ).reshape(-1)

    skeys = jax.lax.sort(keys)
    _, counts = _run_counts(skeys, sentinel)

    # top-k by iterated argmax (k passes beat a sort-based top_k for k=3;
    # argmax ties pick the first position = smallest key, the canonical
    # tie-break)
    def pick(cnts, _):
        i = jnp.argmax(cnts)
        return cnts.at[i].set(-1), (skeys[i], cnts[i])

    _, (top_keys, top_counts) = jax.lax.scan(
        pick, counts, None, length=region_votes + 1
    )
    swing = swing_bound(top_counts, rows_missed)
    return (
        top_keys[:region_votes], top_counts[:region_votes],
        swing, n_missed > 0,
    )


def _borda_declare(
    keys,          # [R, V] int32 (region-major)
    counts,        # [R, V] int32
    active,        # [] int32
    swings,        # [R] int32 — per-region Borda swing bounds
    w: int,
    h: int,
    region_count: int,
    region_votes: int,
    min_active_divisor: int,
    runner_up_divisor: int,
):
    """Borda count + declare (kpm.hpp:172-211), plus the declare-level
    stability flag.

    Each region's ``swing`` bounds the unknown vote mass's reach into
    its ticket: ranks above the first vulnerable boundary are provably
    fixed — their holders keep exactly those points.  Hence any offset
    can GAIN at most ``G = sum(swings)`` total points, and a specific
    offset can LOSE points only in regions where it currently holds a
    vulnerable rank (at most its held points there).  The declared
    (offset, ok) is provably exact iff the winner's identity and the
    ok-decision are unchanged at the extremes of those asymmetric
    intervals.  Returns (offset, ok, unstable)."""
    sentinel = 4 * w * h
    # Borda points: rank r in a region's ticket earns region_votes - r
    # (kpm.hpp:176-182); empty slots (count 0) earn nothing.
    points = jnp.arange(region_votes, 0, -1, dtype=jnp.int32)[None, :]
    points = jnp.where(counts > 0, points, 0).reshape(-1)
    flat_keys = jnp.where(
        counts.reshape(-1) > 0, keys.reshape(-1), jnp.int32(sentinel)
    )

    skeys, spoints = jax.lax.sort((flat_keys, points), num_keys=1)
    n = skeys.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    is_start = jnp.concatenate([jnp.ones((1,), bool), skeys[1:] != skeys[:-1]])
    start_pos = jnp.where(is_start, iota, n)
    suffix_min = jnp.flip(jax.lax.cummin(jnp.flip(start_pos)))
    next_start = jnp.concatenate([suffix_min[1:], jnp.full((1,), n, jnp.int32)])
    cp = jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.cumsum(spoints)])
    run_total = cp[next_start] - cp[iota]
    score = jnp.where(is_start & (skeys < sentinel), run_total, 0)

    top2, _ = jax.lax.top_k(score, 2)
    # winner key: first start with the max score (ties -> smallest key)
    win_pos = jnp.argmax(score)
    win_key = skeys[win_pos]
    dx, dy = _decode_offset(win_key, w, h)

    s1, s2 = top2[0], top2[1]
    gate = active >= region_count // min_active_divisor
    margin = active // runner_up_divisor
    ok = gate & (s1 > 0)
    # kpm.hpp:206-209: with a runner-up, the winner must lead by active/2.
    ok &= (s2 == 0) | (s1 >= s2 + margin)

    # declare-level stability under the unknown vote mass (docstring)
    G = swings.sum()
    rup_key = skeys[jnp.argmax(jnp.where(skeys == win_key, 0, score))]

    def max_loss(key):
        # points `key` could lose: its held rank where that rank is
        # vulnerable (rank index >= region_votes - swing)
        held = (keys == key) & (counts > 0)          # [R, V]
        rank = jnp.arange(region_votes, dtype=jnp.int32)[None, :]
        vulnerable = rank >= (region_votes - swings)[:, None]
        pts = region_votes - rank
        return jnp.sum(jnp.where(held & vulnerable, pts, 0))

    l1 = max_loss(win_key)
    l2 = max_loss(rup_key)
    ok_lo = gate & (s1 - l1 > 0) & (s1 - l1 >= s2 + G + margin)
    ok_hi = gate & (s1 + G > 0) & (
        (s2 - l2 <= 0) | (s1 + G >= s2 - l2 + margin)
    )
    winner_stable = s1 - l1 > s2 + G
    unstable = (G > 0) & (
        (ok_hi != ok_lo) | (ok & ~winner_stable)
    )
    return jnp.stack([dx, dy]), ok, unstable


def match_tables(
    prev: RegionTables,
    curr: RegionTables,
    layout: GridLayout,
    weight_switch: int,
    region_votes: int = 3,
    min_active_divisor: int = 4,
    runner_up_divisor: int = 2,
    multiplicity: int = 8,
    vote_radius: int = 0,
) -> MatchResult:
    """Match every (prev[i], curr[i]) pair of table batches: [P, R, ...].

    ``vote_radius > 0`` counts votes in a bounded-offset one-hot matmul
    histogram (offsets beyond the radius flag overflow for escalation);
    0 = exact sort-based counting over the full offset range."""
    w, h = layout.width, layout.height

    # adaptive weight switch per region (kpm.hpp:219-222: < vs <=)
    use_all = (prev.wcounts[..., 2] < weight_switch) | (
        curr.wcounts[..., 2] <= weight_switch
    )  # [P, R]

    votes_fn = jax.vmap(  # over regions
        jax.vmap(  # over pairs
            functools.partial(
                _region_votes,
                w=w,
                h=h,
                region_votes=region_votes,
                multiplicity=multiplicity,
                vote_radius=vote_radius,
            ),
            in_axes=0,
        ),
        in_axes=1,
        out_axes=1,
    )
    keys, counts, swings, join_involved = votes_fn(
        prev.codes, prev.pos, prev.valid,
        curr.codes, curr.pos, curr.valid,
        use_all,
    )  # [P, R, V], [P, R, V], [P, R], [P, R]

    active = (curr.wcounts.sum(axis=-1) > 0).sum(axis=-1).astype(jnp.int32)

    declare_fn = jax.vmap(
        functools.partial(
            _borda_declare,
            w=w,
            h=h,
            region_count=layout.region_count,
            region_votes=region_votes,
            min_active_divisor=min_active_divisor,
            runner_up_divisor=runner_up_divisor,
        )
    )
    offset, ok, unstable = declare_fn(keys, counts, active, swings)
    # attribute an unstable declaration to the join when truncation
    # contributed anywhere (multiplicity escalation, which also forces
    # exact counting), to the radius alone otherwise (vote_radius=0
    # retry suffices)
    join_cause = (join_involved & (swings > 0)).any(axis=1)
    return MatchResult(
        offset=offset,
        ok=ok,
        overflow=unstable & join_cause,
        range_overflow=unstable & ~join_cause,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "layout",
        "weight_switch",
        "region_votes",
        "min_active_divisor",
        "runner_up_divisor",
        "multiplicity",
        "vote_radius",
    ),
)
def match_tables_jit(
    prev: RegionTables,
    curr: RegionTables,
    layout: GridLayout,
    weight_switch: int,
    region_votes: int = 3,
    min_active_divisor: int = 4,
    runner_up_divisor: int = 2,
    multiplicity: int = 8,
    vote_radius: int = 0,
) -> MatchResult:
    return match_tables(
        prev, curr, layout, weight_switch, region_votes,
        min_active_divisor, runner_up_divisor, multiplicity, vote_radius,
    )
