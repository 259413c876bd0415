#!/usr/bin/env python
"""Per-component profile of the realistic-content (gameplay) streaming
path: exact full-range vote counting at join multiplicity 16.

Tile-periodic content is the honest case: no fixed vote_radius is
provably exact, so the matcher runs the exact sort-count path.  This
script splits the cost (extract / tables / match / blit), each call
ending in block_until_ready, so optimization effort lands on the real
wall.

Usage: python benchmarks/profile_gameplay.py [--multiplicity 16]
"""

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def force(x):
    jax.block_until_ready(x)


def timed(name, fn, *args, reps=8):
    out = fn(*args)
    force(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
        force(out)
    dt = (time.perf_counter() - t0) / reps * 1000
    print(f"{name:<28} {dt:8.2f} ms/batch")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--multiplicity", type=int, default=16)
    ap.add_argument("--capacity", type=int, default=768)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--genre", default="platformer")
    args = ap.parse_args()
    from benchmarks import device

    device.require_gpu()

    import jax

    from remap_tpu.config import PipelineConfig
    from remap_tpu.core.regions import make_layout
    from remap_tpu.ops import kpe as kpe_ops
    from remap_tpu.ops import kpm as kpm_ops
    from remap_tpu.ops import tables as table_ops
    from remap_tpu.parallel.sharded import make_streaming_step
    from remap_tpu.utils import gameplay
    from remap_tpu.utils.runtime import setup_cache

    setup_cache()

    if args.genre == "shmup":
        session = gameplay.play_shmup_session(
            seed=11, n_frames=args.batch, frame_hw=(312, 388)
        )
    else:
        session = gameplay.play_session(
            seed=11, n_frames=args.batch, frame_hw=(312, 388),
            level_cols=420,
        )
    frames = np.stack([f[8:-32, 8:-8] for f in session.frames])
    B, h, w = frames.shape
    print(f"{B} frames {h}x{w}, M={args.multiplicity}, "
          f"cap={args.capacity}")

    cfg = PipelineConfig(
        screen_width=w, screen_height=h,
        region_capacity=args.capacity, frame_batch=B,
        join_multiplicity=args.multiplicity, vote_radius=0,
    )
    layout = make_layout(w, h, cfg.grid_width, cfg.grid_height,
                         cfg.grid_overlap)
    dev = jax.device_put(frames)

    # full streaming step
    init, step = make_streaming_step(layout, cfg, atlas_pad=128)
    step = jax.jit(step, donate_argnums=(1,))
    state = init()
    offs, ok, ovf, strayed, state = step(dev, state)
    force(offs)
    print(f"matched {np.asarray(ok)[1:].mean():.0%}, "
          f"flags any={np.asarray(ovf.combined).any()}")
    state = init()

    def full(x):
        nonlocal_state = step(x, init())
        return nonlocal_state[0]

    fullj = jax.jit(lambda x: step(x, init())[0])
    timed("full step", fullj, dev)

    # components
    extractj = jax.jit(
        lambda x: kpe_ops.extract_dense(x, layout, True).weight
    )
    timed("extract", extractj, dev)

    def tabfn(x):
        d = kpe_ops.extract_dense(x, layout, True)
        return table_ops.build_tables(
            d.weight, d.codes, layout, cfg.region_capacity, cfg.table_mode
        )
    tabj = jax.jit(tabfn)
    tabs = timed("extract+tables", tabj, dev)

    def matchfn(t):
        prev = jax.tree.map(lambda a: a[:-1], t)
        curr = jax.tree.map(lambda a: a[1:], t)
        return kpm_ops.match_tables(
            prev, curr, layout,
            weight_switch=cfg.match.weight_switch,
            multiplicity=cfg.join_multiplicity,
            vote_radius=cfg.vote_radius,
        )
    matchj = jax.jit(matchfn)
    timed("match (exact full-range)", matchj, tabs)

    # how full are the tables really?
    wc = np.asarray(tabs.wcounts)
    print(f"max keypoints/region: {wc.sum(-1).max()}  "
          f"(capacity {args.capacity})")
    nv = np.asarray(tabs.valid).sum(-1)
    print(f"valid rows/region: max {nv.max()}, mean {nv.mean():.0f}")
