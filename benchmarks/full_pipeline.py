#!/usr/bin/env python
"""Full five-stage pipeline wall on a 1024-frame NES clip.

Renders a synthetic 256x240 clip (static HUD band + sprites + border)
and runs the complete builder (aws window scan -> frc collect -> fgs
splice -> fdf foreground -> arf clean) twice in-process: the first run
pays one-time remote compiles, the second is the honest warm wall.
Per-stage timings print through PerfCallbacks (the reference's
perf_counter seam, main.cpp:54-110).

    python benchmarks/full_pipeline.py [--frames N] [--vote-radius R]
"""

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=1024)
    p.add_argument("--vote-radius", type=int, default=16)
    # the synthetic world is keypoint-dense (~3000/region measured);
    # undersized tables escalate cleanly but pay replay passes
    p.add_argument("--capacity", type=int, default=3072)
    p.add_argument("--cpu", action="store_true")
    p.add_argument(
        "--feed", action="store_true",
        help="stage frames on disk and build from RawDirectoryFeed "
             "(the CLI's production path: native batch reader + "
             "double-buffered collect)",
    )
    args = p.parse_args()
    from benchmarks import device

    if not args.cpu:
        device.require_gpu()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from remap_tpu.config import PipelineConfig
    from remap_tpu.pipeline import builder
    from remap_tpu.utils import testing
    from remap_tpu.utils.runtime import setup_cache

    setup_cache()

    H, W = 240, 256
    rng = np.random.default_rng(1234)
    world = testing.make_world(H + 240, W + 280, rng)
    path = testing.make_camera_path(
        args.frames, (H + 240, W + 280), (H, W), rng, max_step=3
    )
    clip = testing.render_clip(
        world, path, (H, W), rng=rng,
        n_sprites=3, sprite_size=6, hud_rows=24, border=0,
    )
    frames = clip.frames
    print(f"{len(frames)} frames {frames[0].shape}", flush=True)

    cfg = PipelineConfig(
        screen_width=W, screen_height=H, frame_batch=256,
        vote_radius=args.vote_radius, region_capacity=args.capacity,
    )

    if args.feed:
        import tempfile, os
        from remap_tpu.io.frames import RawDirectoryFeed

        d = tempfile.mkdtemp(prefix="remap_bench_")
        for i, f in enumerate(frames):
            with open(os.path.join(d, str(i)), "wb") as fh:
                fh.write(f.tobytes())

        def factory():
            return RawDirectoryFeed(d, W, H)
    else:
        def factory():
            return iter(frames)

    for run in ("cold", "warm"):
        t0 = time.perf_counter()
        res = builder.build(
            factory, cfg, callbacks=builder.PerfCallbacks()
        )
        dt = time.perf_counter() - t0
        print(
            f"[{run}] total {dt:6.2f} s  "
            f"{len(frames) / dt:7.1f} fps e2e  maps={len(res.maps)}",
            flush=True,
        )


if __name__ == "__main__":
    main()
