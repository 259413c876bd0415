#!/usr/bin/env python
"""Per-op device budget of the artifact-clean (arf) stage at session scale.

The 100k full-contract runs spend much of their arf wall on a ~4100^2
canvas; this script isolates the stage's components on ONE synthetic
session-scale dot canvas so the wall splits into upload / blend /
heatmap / select / finalize-download / host-margin-crop:

  1. host->device upload of the [N, N, 16] uint16 dot canvas (~0.5 GB
     at N=4096 — the dots live on host between fdf and clean)
  2. blend (argmax vote -> image + mask)
  3. rare-pattern heatmap (count + blur, arf.hpp:239-303)
  4. conditional Gaussian re-selection + stability flags
  5. unstable count and the finalize path it gates (a flagged pixel
     triggers host re-selection; the full-canvas download it used to
     pay is the worst case measured here)
  6. margins_of host scan (the final crop, runs on the host copy)

Timing protocol: repeated calls, each ending in block_until_ready;
single-shot walls for the host and transfer items.

Usage: python benchmarks/arf_budget.py [--size 4096] [--chain 4]
"""

import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def timed(name, fn, chain, *args):
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(chain):
        jax.block_until_ready(fn(*args))
    ms = (time.perf_counter() - t0) / chain * 1000
    print(f"{name:42s} {ms:10.2f} ms", flush=True)
    return ms


def wall(name, fn):
    t0 = time.perf_counter()
    out = fn()
    ms = (time.perf_counter() - t0) * 1000
    print(f"{name:42s} {ms:10.2f} ms (single-shot wall)", flush=True)
    return ms, out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=4096)
    ap.add_argument("--chain", type=int, default=4)
    args = ap.parse_args()
    from benchmarks import device

    device.require_gpu()

    import jax
    import jax.numpy as jnp

    from remap_tpu.utils.runtime import setup_cache

    setup_cache()

    from remap_tpu.config import PipelineConfig
    from remap_tpu.ops import arf as arf_ops
    from remap_tpu.ops import atlas as atlas_ops
    from remap_tpu.pipeline import clean as clean_mod

    cfg = PipelineConfig(screen_width=240, screen_height=208)
    N = args.size
    rng = np.random.default_rng(5)

    # session-shaped dot canvas: tile-world dominant tones with ~40
    # votes, a sparse second tone (rare patterns for the heatmap), an
    # empty margin band (real canvases are padded)
    tile = 16
    base = rng.integers(1, 16, size=(N // tile + 1, N // tile + 1))
    world = np.kron(base, np.ones((tile, tile), int))[:N, :N]
    dots_np = np.zeros((N, N, 16), np.uint16)
    yy, xx = np.mgrid[0:N, 0:N]
    counts = rng.integers(20, 60, size=(N, N)).astype(np.uint16)
    dots_np[yy, xx, world] = counts
    rare = rng.random((N, N)) < 1e-3
    rtone = rng.integers(1, 16, size=(N, N))
    ys_r, xs_r = np.nonzero(rare)
    dots_np[ys_r, xs_r, rtone[ys_r, xs_r]] = 1
    pad = 64
    dots_np[:pad] = 0
    dots_np[-pad:] = 0
    dots_np[:, :pad] = 0
    dots_np[:, -pad:] = 0

    walls = {}
    t0 = time.perf_counter()
    dots = jnp.asarray(dots_np)
    dots.block_until_ready()
    walls["upload"] = (time.perf_counter() - t0) * 1000
    print(f"{'h2d upload (%.0f MB)' % (dots_np.nbytes / 1e6):42s}"
          f" {walls['upload']:10.2f} ms", flush=True)

    blend_fn = jax.jit(atlas_ops.blend)
    walls["blend"] = timed("blend (vote argmax)", blend_fn, args.chain,
                           dots)
    image, mask = blend_fn(dots)

    heat_fn = jax.jit(
        lambda im, mk: arf_ops.heatmap(im, mk, cfg.artifact_filter_size)
    )
    walls["heatmap"] = timed("rare-pattern heatmap (count + blur)",
                             heat_fn, args.chain, image, mask)
    heat = heat_fn(image, mask)

    sel_fn = jax.jit(
        lambda d, h: arf_ops.select(
            d, h, cfg.artifact_filter_dev, cfg.artifact_heat_threshold
        )
    )
    walls["select"] = timed("conditional re-selection + flags", sel_fn,
                            args.chain, dots, heat)

    disp_fn = jax.jit(
        lambda d, im, mk: arf_ops.filter_fragment_dispatch(
            d, im, mk, cfg.artifact_filter_size, cfg.artifact_filter_dev,
            cfg.artifact_heat_threshold,
        )
    )
    walls["dispatch total"] = timed(
        "filter_fragment_dispatch (fused)", disp_fn, args.chain, dots,
        image, mask,
    )
    res = disp_fn(dots, image, mask)
    n_unstable = int(np.asarray(jnp.sum(res.unstable)))
    print(f"{'unstable (host re-selected) pixels':42s} {n_unstable:10d}",
          flush=True)

    ms, out_img = wall(
        "finalize (fetch + host re-selection)",
        lambda: arf_ops.filter_fragment_finalize(
            dots, res, cfg.artifact_filter_dev
        ),
    )
    walls["finalize"] = ms

    ms, _ = wall("margins_of host scan (crop bounds)",
                 lambda: clean_mod.margins_of(dots_np))
    walls["margins_of"] = ms

    total = walls["upload"] + walls["dispatch total"] + \
        walls["finalize"] + walls["margins_of"]
    print(json.dumps({
        "metric": "arf per-fragment budget at session scale",
        "canvas": N,
        "unstable_px": n_unstable,
        "component_ms": {k: round(v, 2) for k, v in walls.items()},
        "stage_path_ms": round(total, 2),
        "value": round(total / 1000, 2),
        "unit": "seconds/fragment (upload + dispatch + finalize + crop)",
    }), flush=True)


if __name__ == "__main__":
    main()
