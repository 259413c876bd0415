#!/usr/bin/env python
"""Per-part device budget of the foreground (fdf) stage on one batch.

Isolates the stage's device parts on ONE warmed [B, H, W] batch, each
call ending in ``block_until_ready``:

  1. packed gather from the device mirror + device unpack
  2. median recompute (the default store_medians=False path; medians
     are a pure function of the frame, kpe.hpp:308-314)
  3. background equality mask (vmapped window compare)
  4. connected-component labels (ops.cc)
  5. foreground-mask assembly (ops.fde._masks_from_labels_sorted)
  6. masked vote blit into the fragment canvas

Two regimes: iid noise (adversarial: nearly every pixel a kept root, so
the assembly's dense fill runs) and a tiled world with one sprite per
frame (the production shape: a few kept components per frame).

Usage: python benchmarks/fdf_budget.py [--batch 256] [--height 208]
       [--width 240]
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmarks import device  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--height", type=int, default=208)
    ap.add_argument("--width", type=int, default=240)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()

    device.require_gpu()

    import jax
    import jax.numpy as jnp

    from remap_tpu.core.regions import make_layout
    from remap_tpu.ops import atlas as atlas_ops
    from remap_tpu.ops import cc as cc_ops
    from remap_tpu.ops import fde as fde_ops
    from remap_tpu.ops import kpe as kpe_ops
    from remap_tpu.pipeline.collect import _unpack_jit
    from remap_tpu.pipeline.state import pack_nibbles_batch
    from remap_tpu.utils.runtime import setup_cache

    setup_cache()
    print(device.card(), flush=True)
    B, H, W = args.batch, args.height, args.width
    ch, cw = H + 72, W + 80
    limit = (H * W) // 5
    rng = np.random.default_rng(7)
    apos_np = np.stack(
        [rng.integers(0, cw - W, B), rng.integers(0, ch - H, B)], axis=1
    ).astype(np.int32)
    apos = jnp.asarray(apos_np)

    tile = 16
    tbase = rng.integers(0, 16, size=(ch // tile + 1, cw // tile + 1))
    tworld = np.kron(tbase, np.ones((tile, tile), int))[:ch, :cw].astype(
        np.uint8)
    tframes = np.empty((B, H, W), np.uint8)
    for i in range(B):
        x, y = apos_np[i]
        crop = tworld[y : y + H, x : x + W].copy()
        sx, sy = rng.integers(0, W - 16), rng.integers(0, H - 12)
        crop[sy : sy + 12, sx : sx + 16] = rng.integers(
            0, 16, size=(12, 16), dtype=np.uint8)
        tframes[i] = crop
    regimes = {
        "noise": (rng.integers(0, 16, size=(B, H, W), dtype=np.uint8),
                  rng.integers(0, 16, size=(ch, cw), dtype=np.uint8)),
        "tiled+sprite": (tframes, tworld),
    }
    layout = make_layout(W, H, 1, 1, 0)
    idx = jnp.arange(B, dtype=jnp.int32)
    dots0 = jnp.zeros((ch, cw, atlas_ops.DEPTH), jnp.uint16)

    unpack = jax.jit(lambda p, i: _unpack_jit(p[i], W))
    medians = jax.jit(lambda im: kpe_ops.extract_dense(im, layout).median)
    changed = jax.jit(jax.vmap(
        lambda bg, f, p: ~fde_ops.equality_mask(bg, f, p),
        in_axes=(None, 0, 0)))
    labels = jax.jit(jax.vmap(cc_ops.label_components))
    masks = jax.jit(
        lambda lab, chg: fde_ops._masks_from_labels_sorted(lab, chg, limit))
    blit = jax.jit(lambda im, p, m, d: atlas_ops.blit_frames(
        im, p, ch, cw, masks=m, dots=d))
    total = jax.jit(lambda bg, im, p: fde_ops.extract_batch(
        bg, im, None, p, compute_medians=True))

    for name, (frames, bg_np) in regimes.items():
        packed = jnp.asarray(pack_nibbles_batch(frames))
        bg = jnp.asarray(bg_np)
        imgs = unpack(packed, idx)
        med = medians(imgs)
        chg = changed(bg, imgs, apos)
        lab = labels(med)
        fg = masks(lab, chg).astype(jnp.uint8)
        parts = {
            "unpack+gather": device.timeit(unpack, packed, idx,
                                           reps=args.reps),
            "medians": device.timeit(medians, imgs, reps=args.reps),
            "equality": device.timeit(changed, bg, imgs, apos,
                                      reps=args.reps),
            "labels": device.timeit(labels, med, reps=args.reps),
            "mask assembly": device.timeit(masks, lab, chg, reps=args.reps),
            "blit": device.timeit(blit, imgs, apos, fg, dots0,
                                  reps=args.reps),
            "extract_batch total": device.timeit(total, bg, imgs, apos,
                                                 reps=args.reps),
        }
        print(json.dumps({
            "metric": f"fdf device budget, {name}",
            "batch": B, "size": f"{W}x{H}",
            "ms": {k: v["median_ms"] for k, v in parts.items()},
            "device": device.describe(),
        }), flush=True)


if __name__ == "__main__":
    main()
