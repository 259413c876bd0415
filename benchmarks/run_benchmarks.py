#!/usr/bin/env python
"""Extended benchmark sweep across the BASELINE.json configurations.

bench.py stays the one-line flagship contract; this runner reports the
whole matrix (JSON lines, one per config):

1. NES 256x240 grid-vote streaming (the flagship)
2. SNES 256x224 grid-vote streaming
3. C64 388x312 (the reference's own frame format)
4. 8-clip batch on one GPU (vmapped pipeline step, config 3)
5. NES xcorr matcher family
6. VGA 640x480 pyramid coarse-to-fine (config 5)
"""

import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")

from benchmarks import device  # noqa: E402


def result(name, fps, extra=""):
    print(
        json.dumps(
            {
                "metric": name + (f" ({extra})" if extra else ""),
                "value": fps,
                "unit": "frames/sec",
                "device": device.describe(),
            }
        ),
        flush=True,
    )


def bench_stream(name, h, w, capacity=768, matcher="grid_vote", seconds=6.0,
                 batch=256, multiplicity=1, frames=None, vote_radius=16,
                 expect_offsets=None):
    import jax

    from bench import make_clip
    from remap_tpu.config import PipelineConfig
    from remap_tpu.core.regions import make_layout
    from remap_tpu.parallel.sharded import make_streaming_step

    B = batch
    cfg = PipelineConfig(
        screen_width=w, screen_height=h,
        region_capacity=capacity, frame_batch=B, matcher=matcher,
        join_multiplicity=multiplicity,  # overflow asserted below
        vote_radius=vote_radius,
    )
    layout = make_layout(w, h, cfg.grid_width, cfg.grid_height,
                         cfg.grid_overlap)
    init, step = make_streaming_step(layout, cfg, atlas_pad=128)
    step = jax.jit(step, donate_argnums=(1,))
    if frames is None:
        frames = make_clip(B * 4, h, w)
    batches = [jax.device_put(x) for x in np.split(frames, 4, axis=0)]

    state = init()
    offs, ok, ovf, strayed, state = step(batches[0], state)
    matched = float(np.asarray(ok)[1:].mean())
    assert not np.asarray(ovf).any(), "join overflow: raise limits"
    if expect_offsets is not None:
        # declarations must equal the simulator's ground-truth camera
        # deltas — the "unchanged declarations" proof for any fast-path
        # limit (capacity / multiplicity / radius) this row picks
        np.testing.assert_array_equal(
            np.asarray(offs)[1:], expect_offsets[: B - 1]
        )
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    reps = 0
    while time.perf_counter() - t0 < seconds:
        offs, ok, ovf, strayed, state = step(batches[reps % 4], state)
        jax.block_until_ready(state)
        reps += 1
    fps = reps * B / (time.perf_counter() - t0)
    result(name, fps, f"matched {matched:.0%}")


def bench_multiclip(seconds=6.0):
    import jax

    from bench import make_clip
    from remap_tpu.config import PipelineConfig
    from remap_tpu.core.regions import make_layout
    from remap_tpu.parallel.sharded import make_pipeline_step

    C, T, H, W = 8, 64, 240, 256
    cfg = PipelineConfig(
        screen_width=W, screen_height=H, region_capacity=768, frame_batch=T
    )
    layout = make_layout(W, H, 4, 2, 16)
    step = jax.jit(make_pipeline_step(layout, cfg, atlas_pad=64))
    clips = np.stack(
        [make_clip(T, H, W, seed=s) for s in range(C)]
    )  # [C, T, H, W]
    dev = jax.device_put(clips)
    jax.block_until_ready(step(dev))
    t0 = time.perf_counter()
    reps = 0
    while time.perf_counter() - t0 < seconds:
        jax.block_until_ready(step(dev))
        reps += 1
    fps = reps * C * T / (time.perf_counter() - t0)
    result("8-clip vmap batch align+stitch at 256x240", fps)


def bench_gameplay(seconds=6.0):
    """Streaming throughput on SIMULATED GAMEPLAY (utils.gameplay): a
    tile-built platformer playthrough — exact-repeating tile codes
    (join repeats ~5-8 per region), keypoint-sparse sky/dirt regions,
    dead-zone run/stop camera, animated sprites.  The realistic
    counterpart of the iid-noise configs above; multiplicity 16 covers
    the tileset's repetition exactly (the no-overflow assertion inside
    bench_stream is the proof)."""
    from remap_tpu.utils import gameplay

    session = gameplay.play_session(
        seed=11, n_frames=1024, frame_hw=(312, 388), level_cols=420
    )
    # pre-cropped action window (aws runs once per clip, not per frame)
    frames = np.stack([f[8:-32, 8:-8] for f in session.frames])
    # exact-repeating tiles vote at +-16k offsets, so no fixed vote
    # radius is provably exact here (the stability bound flags every
    # frame at radius 16 — correctly); gameplay runs the exact
    # full-range counting path, multiplicity 16 (zero join flags).
    # Capacity 384 is the smallest lane-aligned size above the content's
    # true per-region keypoint maximum (319 measured; the bench's
    # no-overflow assertion is the per-run proof — same protocol as the
    # flagship's NES-specific 640).
    bench_stream(
        "align+stitch gameplay session 372x272 grid_vote",
        frames.shape[1], frames.shape[2], seconds=seconds,
        capacity=384, multiplicity=16, frames=frames, vote_radius=0,
        expect_offsets=np.diff(np.array(session.camera), axis=0),
    )


def bench_gameplay_shmup(seconds=6.0):
    """The vertical-scroll shooter genre: constant-velocity scroll with
    a dense hostile foreground (enemy wave formations voting against the
    terrain, bullet streams, explosions).  Like the platformer row, the
    tile-exact world repeats codes across instances, so the row runs the
    exact full-range counting path at multiplicity 16 — measured as the
    smallest power of two with ZERO join flags across the whole
    1024-frame session (8 flags at M=8; the no-overflow assertion in
    bench_stream is the per-run proof)."""
    from remap_tpu.utils import gameplay

    session = gameplay.play_shmup_session(
        seed=11, n_frames=1024, frame_hw=(312, 388)
    )
    frames = np.stack([f[8:-32, 8:-8] for f in session.frames])
    # capacity 384 > the genre's measured per-region keypoint max (244);
    # the no-overflow assertion proves it per run
    bench_stream(
        "align+stitch shmup session 372x272 grid_vote",
        frames.shape[1], frames.shape[2], seconds=seconds,
        capacity=384, multiplicity=16, frames=frames, vote_radius=0,
        expect_offsets=np.diff(np.array(session.camera), axis=0),
    )


def bench_pyramid(seconds=6.0):
    import jax
    import jax.numpy as jnp

    from bench import make_clip
    from remap_tpu.models.pyramid import match_pyramid

    B, H, W = 64, 480, 640
    # make_clip's cyclic palindrome needs an even count; take B+1
    frames = make_clip(B + 2, H, W)[: B + 1]
    prev = jax.device_put(frames[:-1])
    curr = jax.device_put(frames[1:])

    f = jax.jit(
        lambda p, c: match_pyramid(
            p, c, factor=4, coarse_radius=32, fine_radius=5
        )
    )
    offs, ok = f(prev, curr)
    matched = float(np.asarray(ok).mean())
    t0 = time.perf_counter()
    reps = 0
    while time.perf_counter() - t0 < seconds:
        jax.block_until_ready(f(prev, curr))
        reps += 1
    fps = reps * B / (time.perf_counter() - t0)
    result(
        "pyramid coarse-to-fine match at 640x480", fps, f"matched {matched:.0%}"
    )


def main():
    from remap_tpu.utils.runtime import setup_cache

    device.require_gpu()
    setup_cache()
    print(device.card(), flush=True)
    bench_stream("align+stitch NES 256x240 grid_vote", 240, 256)
    bench_stream("align+stitch SNES 256x224 grid_vote", 224, 256)
    bench_stream("align+stitch C64 388x312 grid_vote", 312, 388,
                 capacity=1024)
    bench_stream("align+stitch NES 256x240 xcorr", 240, 256,
                 matcher="xcorr")
    bench_stream("align+stitch VGA 640x480 grid_vote", 480, 640,
                 capacity=3072, batch=128)
    bench_multiclip()
    bench_pyramid()
    bench_gameplay()
    bench_gameplay_shmup()


if __name__ == "__main__":
    main()
