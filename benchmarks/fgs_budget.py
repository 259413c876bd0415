#!/usr/bin/env python
"""Per-op budget of the fragment-splice (fgs) stage at session scale.

The 100k full-contract runs re-merge THREE session-scale fragments into
one ~4100^2 map; this script isolates the stage's components on
synthetic session-shaped fragments so the wall splits into:

  1. per-fragment dots upload ([H, W, 16] uint16 — 200-500 MB each,
     at snippet extraction, fgs.hpp:91-103 role)
  2. blend + whole-canvas dense keypoint extract (device dispatch)
  3. snippet finalize: keypoint-count fetch, fixed-capacity table
     build (ops.tables.extract_tables), codes/pos/valid + mask
     downloads
  4. pair match (ops.splice.match_fragments at session capacity,
     fgs.hpp:119-140 role)
  5. host canvas merge (np.pad + np.add on the [H, W, 16] canvases,
     fgs.hpp:165-183 role)
  6. merged-snippet re-extraction (upload + blend/extract again)
  7. the whole splice() wall for cross-checking the sum

Timing protocol: single-shot walls (the stage runs each component a
handful of times per session, so steady-state repeats would flatter
transfer- and compile-bound terms).
Run twice with the persistent compile cache to split cold/warm.

Usage: python benchmarks/fgs_budget.py [--size 4096] [--bands 3]
"""

import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def wall(name, fn):
    t0 = time.perf_counter()
    out = fn()
    ms = (time.perf_counter() - t0) * 1000
    print(f"{name:46s} {ms:10.1f} ms", flush=True)
    return ms, out


def make_session_fragments(n: int, bands: int, rng):
    """Session-shaped fragments: one tile world split into overlapping
    horizontal bands (what two mid-session teleports leave behind),
    every covered pixel holding ~40 votes for its world tone."""
    from remap_tpu.pipeline.state import Fragment, FrameRef

    tile = 16
    base = rng.integers(1, 16, size=(n // tile + 1, n // tile + 1))
    world = np.kron(base, np.ones((tile, tile), int))[:n, :n]
    # 10% detail pixels (as in bench.make_clip): flat tile interiors
    # yield ZERO keypoints from the dense extract — real worlds don't
    detail = rng.integers(1, 16, size=(n, n))
    world = np.where(rng.random((n, n)) < 0.10, detail, world)
    counts = rng.integers(20, 60, size=(n, n)).astype(np.uint16)

    overlap = 384
    cut = n // bands
    frags = []
    for b in range(bands):
        y0 = max(0, b * cut - overlap)
        y1 = min(n, (b + 1) * cut + overlap) if b < bands - 1 else n
        h = y1 - y0
        dots = np.zeros((h, n, 16), np.uint16)
        yy, xx = np.mgrid[0:h, 0:n]
        dots[yy, xx, world[y0:y1]] = counts[y0:y1]
        frags.append(
            Fragment(
                dots=dots,
                zero=(0, 0),
                frames=[FrameRef(b * 10 + i, (0, i)) for i in range(4)],
                store=None,
            )
        )
    return frags


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=4096)
    ap.add_argument("--bands", type=int, default=3)
    args = ap.parse_args()
    from benchmarks import device

    device.require_gpu()

    from remap_tpu.utils.runtime import setup_cache

    setup_cache()

    from remap_tpu.config import PipelineConfig
    from remap_tpu.pipeline import splice as spl

    cfg = PipelineConfig(screen_width=256, screen_height=240)
    rng = np.random.default_rng(7)
    frags = make_session_fragments(args.size, args.bands, rng)
    for f in frags:
        print(f"fragment {f.shape}  dots {f.dots.nbytes / 1e6:.0f} MB",
              flush=True)

    walls = {}

    # 1+2: dispatch = upload + blend/extract (async). Forcing needs the
    # finalize fetch, so time the pair dispatch->finalize per fragment.
    pendings = []
    t0 = time.perf_counter()
    for i, f in enumerate(frags):
        ms, p = wall(f"dispatch frag{i} (upload + blend/extract)",
                     lambda f=f: spl._snippet_dispatch(f, cfg))
        walls[f"dispatch{i}"] = ms
        pendings.append(p)
    snippets = []
    for i, p in enumerate(pendings):
        ms, s = wall(
            f"finalize frag{i} (count fetch + tables + downloads)",
            lambda p=p: spl._snippet_finalize(p, cfg),
        )
        walls[f"finalize{i}"] = ms
        snippets.append(s)
        print(f"  keypoints frag{i}: {int(s.valid.sum())} "
              f"(capacity {s.codes.shape[0]})", flush=True)
    walls["extract_total"] = sum(
        walls[k] for k in walls if k.startswith(("dispatch", "finalize"))
    )

    # 4: pair matches at session capacity (pad state = rolling max)
    pad = spl._PadState()
    pad.update(snippets)
    for i in range(len(snippets)):
        for j in range(i + 1, len(snippets)):
            ms, vote = wall(
                f"match pair ({i},{j})",
                lambda i=i, j=j: spl._match(
                    snippets[i], snippets[j], cfg, pad
                ),
            )
            walls[f"match{i}{j}"] = ms
            print(f"  vote: {vote}", flush=True)

    # 5: host merge of the best adjacent pair
    off01 = spl._match(snippets[0], snippets[1], cfg, pad)
    assert off01 is not None, "adjacent bands must match"
    ms, merged_frag = wall(
        "host merge (np.pad + np.add on dot canvases)",
        lambda: spl.merge_fragments(
            frags[0], frags[1], off01[0], (256, 240)
        ),
    )
    walls["host_merge"] = ms
    print(f"  merged shape {merged_frag.shape} "
          f"({merged_frag.dots.nbytes / 1e6:.0f} MB)", flush=True)

    # 6: merged-snippet re-extraction (the greedy loop pays this per
    # merge level — upload of the GROWN canvas included)
    ms, _ = wall(
        "re-extract merged snippet (upload+blend+tables)",
        lambda: spl._extract_snippet(merged_frag, cfg),
    )
    walls["re_extract"] = ms

    # 7: the whole stage for cross-checking the sum
    frags2 = make_session_fragments(args.size, args.bands, rng)
    ms, out = wall("splice() whole stage", lambda: spl.splice(
        frags2, cfg, frame_dims=(256, 240)
    ))
    walls["splice_total"] = ms
    print(f"  spliced -> {len(out)} fragment(s), "
          f"final {out[0].shape}", flush=True)

    print(json.dumps({
        "metric": "fgs per-op budget at session scale",
        "canvas": args.size,
        "bands": args.bands,
        "component_ms": {k: round(v, 1) for k, v in walls.items()},
        "value": round(walls["splice_total"] / 1000, 2),
        "unit": "seconds (whole splice stage wall)",
    }), flush=True)


if __name__ == "__main__":
    main()
