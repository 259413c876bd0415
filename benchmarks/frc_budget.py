#!/usr/bin/env python
"""Per-phase budget of the frc collect loop at session scale.

The collect loop runs far below the streaming step's device rate; the
gap is host, transfer and dispatch time, which this script decomposes.
Phases accumulate (each includes the previous):

  read      : native feed read+crop+pack only (no device work)
  upload    : + jnp.asarray of each packed batch (forced at the end)
  dispatch  : + unpack + collect step dispatched, fetch ONE element
              every `depth` batches (the steady-state device pipeline)
  drain     : + the real drain (all six per-batch output fetches +
              store.put_packed_batch) — the production loop
  collect   : pipeline.collect.match_pass itself, for cross-checking

Usage: python benchmarks/frc_budget.py --clip-dir <raw frames dir>
       [--frames 25600]
(defaults to the 100k contract's rendered directory if present)
"""

import argparse
import glob
import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clip-dir", default=None)
    ap.add_argument("--frames", type=int, default=25_600)
    ap.add_argument("--batch", type=int, default=256)
    args = ap.parse_args()
    from benchmarks import device

    device.require_gpu()

    from remap_tpu.utils.runtime import setup_cache

    setup_cache()

    import jax
    import jax.numpy as jnp

    from remap_tpu.config import PipelineConfig
    from remap_tpu.core.regions import make_layout
    from remap_tpu.io import frames as frames_io
    from remap_tpu.pipeline import collect as collect_mod
    from remap_tpu.pipeline.state import FrameStore
    from remap_tpu.utils import backend

    clip_dir = args.clip_dir
    if clip_dir is None:
        cands = sorted(glob.glob(".bench_data/remap100k_*"))
        assert cands, "render the contract clip first (full_session_100k)"
        clip_dir = cands[0]
    W, H = 256, 240

    # the contract's cropped feed (the builder composes the aws window)
    from remap_tpu.core.geometry import Rect

    crop = Rect(left=8, top=8, right=W - 8, bottom=H - 32)
    feed = frames_io.RawDirectoryFeed(clip_dir, W, H, crop=crop)
    ch, cw = feed.out_dims
    n = min(args.frames, (len(feed) // args.batch) * args.batch)
    b = args.batch
    nb = n // b
    print(f"{nb} batches of {b} at {ch}x{cw} from {clip_dir}", flush=True)

    cfg = PipelineConfig(
        screen_width=cw, screen_height=ch,
        region_capacity=768, frame_batch=b,
        join_multiplicity=1, vote_radius=16, frame_store="hbm",
    )
    layout = make_layout(cw, ch, cfg.grid_width, cfg.grid_height,
                         cfg.grid_overlap)
    step = collect_mod.make_collect_step(layout, cfg)
    depth = cfg.collect_drain_depth

    walls = {}

    # --- read
    t0 = time.perf_counter()
    for i in range(nb):
        feed.read_packed_batch(i * b, b)
    walls["read"] = time.perf_counter() - t0
    print(f"read    {walls['read']:8.1f} s", flush=True)

    # --- upload
    t0 = time.perf_counter()
    last = None
    for i in range(nb):
        pk = feed.read_packed_batch(i * b, b)
        last = jnp.asarray(pk)
    np.asarray(last.ravel()[0])
    walls["upload"] = time.perf_counter() - t0
    print(f"upload  {walls['upload']:8.1f} s", flush=True)

    # --- dispatch (device pipeline, rare forcing)
    carry = (
        collect_mod._empty_carry(layout, cfg.region_capacity),
        jnp.zeros((1, ch, cw), jnp.uint8),
    )
    # warm the programs
    pk = feed.read_packed_batch(0, b)
    imgs = collect_mod._unpack_jit(jnp.asarray(pk), cw)
    out = step(imgs, carry)
    np.asarray(out[1])
    carry0 = out[-1]

    t0 = time.perf_counter()
    carry = carry0
    outs = []
    for i in range(nb):
        pk = feed.read_packed_batch(i * b, b)
        imgs = collect_mod._unpack_jit(jnp.asarray(pk), cw)
        out = step(imgs, carry)
        carry = out[-1]
        outs.append(out[1])
        if len(outs) >= depth:
            np.asarray(outs.pop(0).ravel()[0])
    for o in outs:
        np.asarray(o.ravel()[0])
    walls["dispatch"] = time.perf_counter() - t0
    print(f"dispatch{walls['dispatch']:8.1f} s", flush=True)

    # --- drain (the production loop body)
    store = FrameStore(ch, cw,
                       device_budget=backend.store_budget("hbm"))
    from collections import deque

    t0 = time.perf_counter()
    carry = carry0
    pending = deque()

    def drain(p):
        num, n_real, packed, packed_dev, median, scalars = p
        np.asarray(scalars)
        store.put_packed_batch(
            list(range(num, num + n_real)), packed,
            device_packed=packed_dev,
        )

    for i in range(nb):
        pk = feed.read_packed_batch(i * b, b)
        pdev = jnp.asarray(pk)
        imgs = collect_mod._unpack_jit(pdev, cw)
        median, scalars, carry = step(imgs, carry)
        pending.append((i * b, b, pk, pdev, median, scalars))
        if len(pending) >= depth:
            drain(pending.popleft())
    while pending:
        drain(pending.popleft())
    walls["drain"] = time.perf_counter() - t0
    print(f"drain   {walls['drain']:8.1f} s", flush=True)

    # --- the real thing
    feed2 = frames_io.RawDirectoryFeed(clip_dir, W, H, crop=crop)
    feed2.files = feed2.files[:n]
    t0 = time.perf_counter()
    collect_mod.match_pass(feed2, layout, cfg,
                           FrameStore(ch, cw,
                                      device_budget=backend.store_budget(
                                          "hbm")))
    walls["match_pass"] = time.perf_counter() - t0
    print(f"match_pass{walls['match_pass']:6.1f} s", flush=True)

    print(json.dumps({
        "metric": "frc collect per-phase budget",
        "frames": n,
        "phase_s": {k: round(v, 1) for k, v in walls.items()},
        "value": round(n / walls["match_pass"], 1),
        "unit": "frames/sec (match_pass)",
    }), flush=True)


if __name__ == "__main__":
    main()
