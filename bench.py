#!/usr/bin/env python
"""Benchmark: align+stitch throughput of the streaming step on one GPU.

Measures the production streaming primitive (parallel.sharded.
make_streaming_step): batches of 256x240 frames flow through batched
keypoint extraction -> region tables -> consecutive-pair vote matching
(with cross-batch carry) -> segmented positions -> resident-atlas stitch,
all as one jitted program whose atlas/matcher state stays on device.

The headline is frames over a window of steps dispatched back to back
and closed by one ``block_until_ready``; the median of steps each closed
by ``block_until_ready`` is reported beside it.  Two protocols: inputs
already on the device, and inputs uploaded packed (2 px/byte) and
unpacked on the device each step.  Needs a GPU; prints the card's name
and power limit, then ONE json line.
"""

import json
import statistics
import sys
import time

import numpy as np

H, W = 240, 256
BATCH = 256
N_BATCHES = 4


def make_session(n_frames: int, h: int, w: int, seed: int = 0):
    """Game-like synthetic clip: tiled world + light noise, drifting
    camera.  Keypoint density ~300-500 per grid region, i.e. a busy but
    realistic pixel-art load.  Returns (frames, world, xs, ys) with the
    camera's world position (xs[t], ys[t]) of each frame.

    The camera path is CYCLIC (palindromic walk): frame ``n-1`` is one
    normal walk step from frame ``0``, so the benchmark's batch recycling
    never manufactures a teleport pair — every cross-batch carry in the
    timed loop is a legitimate small-motion match, and the zero-overflow
    / matched=100% audit holds over the whole run."""
    rng = np.random.default_rng(seed)
    wh, ww = h + 200, w + 200
    tile = 8
    base = rng.integers(0, 16, size=(wh // tile + 1, ww // tile + 1), dtype=np.uint8)
    base = np.kron(base, np.ones((tile, tile), np.uint8))[:wh, :ww]
    detail = rng.integers(0, 16, size=(wh, ww), dtype=np.uint8)
    world = np.where(rng.random((wh, ww)) < 0.10, detail, base).astype(np.uint8)

    assert n_frames % 2 == 0
    half = n_frames // 2
    xs, ys = [100], [100]
    for _ in range(half):
        xs.append(int(np.clip(xs[-1] + rng.integers(-3, 4), 0, ww - w)))
        ys.append(int(np.clip(ys[-1] + rng.integers(-3, 4), 0, wh - h)))
    # palindrome: p_0..p_half then p_{half-1}..p_1 — adjacent diffs (and
    # the wrap p_1 -> p_0) all stay within the walk's +-3 step
    xs = xs[: half + 1] + xs[half - 1 : 0 : -1]
    ys = ys[: half + 1] + ys[half - 1 : 0 : -1]
    frames = np.empty((n_frames, h, w), np.uint8)
    for t in range(n_frames):
        frames[t] = world[ys[t] : ys[t] + h, xs[t] : xs[t] + w]
    return frames, world, xs, ys


def make_clip(n_frames: int, h: int, w: int, seed: int = 0):
    """The frames of ``make_session``."""
    return make_session(n_frames, h, w, seed)[0]


def stream_config(h: int = H, w: int = W, batch: int = BATCH):
    """The streaming configuration the benchmark and the A/B runs use."""
    from remap_tpu.config import PipelineConfig

    return PipelineConfig(
        screen_width=w,
        screen_height=h,
        # the smallest table size the no-overflow audit admits on this
        # load (512 overflows -> escalation would be required)
        region_capacity=640,
        # the declare-level stability bound (ops/kpm.py) proves M=1
        # sufficient on this load -- the audit below is the proof
        join_multiplicity=1,
        frame_batch=batch,
        # bounded-offset vote histogram; the audit proves no vote left
        # the radius (or the join limits)
        vote_radius=16,
    )


def _measure(ingest: bool, steps: int = 32) -> dict:
    """The streaming step over ``steps`` batches, two ways.

    - window: ``steps`` steps dispatched back to back and one
      ``block_until_ready`` at the end; frames over the whole window is
      the throughput a long session sees (dispatch gaps and stalls
      included);
    - per step: each step closed with ``block_until_ready``; the median
      is the step's own latency, a per-layer statistic.

    With ``ingest`` each batch crosses host->device packed and unpacks
    on device (the production serving loop); otherwise the batches are
    already on the device.  Raises if any timed step overflowed its
    exactness limits or if a step matched less than every pair."""
    import jax
    import jax.numpy as jnp

    from remap_tpu.core.regions import make_layout
    from remap_tpu.parallel.sharded import make_streaming_step
    from remap_tpu.pipeline.collect import _unpack_jit
    from remap_tpu.pipeline.state import pack_nibbles_batch

    cfg = stream_config(H, W, BATCH)
    layout = make_layout(W, H, cfg.grid_width, cfg.grid_height,
                         cfg.grid_overlap)
    init_state, step = make_streaming_step(layout, cfg, atlas_pad=128)
    step = jax.jit(step, donate_argnums=(1,))

    frames = make_clip(BATCH * N_BATCHES, H, W)
    if ingest:
        packed = [
            pack_nibbles_batch(b) for b in np.split(frames, N_BATCHES, axis=0)
        ]

        def feed(i):
            return _unpack_jit(jnp.asarray(packed[i % N_BATCHES]), W)

    else:
        batches = [
            jax.device_put(b) for b in np.split(frames, N_BATCHES, axis=0)
        ]

        def feed(i):
            return batches[i % N_BATCHES]

    state = init_state()
    jax.block_until_ready(step(feed(0), state)[4])   # compile
    state = init_state()
    offs, matched, overflow, strayed, state = step(feed(0), state)
    jax.block_until_ready(state)
    # the batch index runs on from batch 0 so every carry -- including
    # the cyclic wrap -- is a seamless walk step
    fed = 1
    overflows, matches = [], []

    step_s = []
    for _ in range(steps):
        t0 = time.perf_counter()
        offs, matched, overflow, strayed, state = step(feed(fed), state)
        jax.block_until_ready(state)
        step_s.append(time.perf_counter() - t0)
        overflows.append(overflow)
        matches.append(matched)
        fed += 1

    t0 = time.perf_counter()
    for _ in range(steps):
        offs, matched, overflow, strayed, state = step(feed(fed), state)
        overflows.append(overflow)
        matches.append(matched)
        fed += 1
    jax.block_until_ready(state)
    window_s = time.perf_counter() - t0

    for i, ov in enumerate(overflows):
        assert not np.asarray(ov).any(), f"overflow at timed step {i}"
    matched_frac = float(np.mean([np.asarray(m).mean() for m in matches]))
    assert matched_frac == 1.0, f"matched {matched_frac:.2%}"
    return {
        "fps": steps * BATCH / window_s,
        "window_s": window_s,
        "steps": steps,
        "step_ms": {"median": statistics.median(step_s) * 1e3,
                    "min": min(step_s) * 1e3, "max": max(step_s) * 1e3},
    }


def main():
    from benchmarks import device
    from remap_tpu.utils.runtime import setup_cache

    device.require_gpu()
    setup_cache()
    print(device.card(), flush=True)
    resident = _measure(ingest=False)
    ingest = _measure(ingest=True)
    print(json.dumps({
        "metric": "frames/sec aligned+stitched at 256x240, streaming step,"
                  f" {resident['steps']} batches of {BATCH} back to back"
                  " (every pair matched, zero overflow)",
        "value": resident["fps"],
        "unit": "frames/sec",
        "resident": resident,
        "ingest": ingest,
        "device": device.describe(),
    }))


if __name__ == "__main__":
    sys.exit(main())
