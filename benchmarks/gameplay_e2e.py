#!/usr/bin/env python
"""Five-stage pipeline on simulated gameplay, on the GPU.

The gameplay differentials (tests/differential/test_ref_gameplay.py)
verify byte-equality with the compiled reference on the CPU; this script
runs the same platformer content through the GPU build and asserts:

  1. the GPU maps equal the CPU maps byte-for-byte (the repo's
     cross-backend bit-identity claim at the gameplay shape),
  2. painted pixels agree with the simulator's ground-truth world.

The CPU cross-check runs in a child process pinned to the CPU through
its environment (``JAX_PLATFORMS=cpu``, no visible CUDA device) before
it imports JAX, so it never opens the card.

Usage: python benchmarks/gameplay_e2e.py [--frames 320] [--seed 3]
       [--skip-cpu]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

FW, FH = 388, 312     # the reference's fixed screen (main.cpp:199)


def build(frames):
    from remap_tpu.config import PipelineConfig
    from remap_tpu.pipeline import builder

    cfg = PipelineConfig(screen_width=FW, screen_height=FH)
    t0 = time.perf_counter()
    res = builder.build_from_frames(frames, cfg)
    wall = time.perf_counter() - t0
    return [np.asarray(m) for m in res.maps], wall


def _cpu_child(frames_n: int, seed: int, out: str) -> None:
    """Child body: build on the CPU and save the maps to ``out``."""
    from remap_tpu.utils import gameplay
    from remap_tpu.utils.runtime import setup_cache

    setup_cache()
    s = gameplay.play_session(seed=seed, n_frames=frames_n,
                              frame_hw=(FH, FW))
    maps, wall = build(s.frames)
    np.savez(out, wall=wall, *maps)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=320)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--skip-cpu", action="store_true",
                    help="skip the CPU cross-check (GPU + world truth only)")
    ap.add_argument("--cpu-child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()

    if args.cpu_child:
        _cpu_child(args.frames, args.seed, args.cpu_child)
        return

    from benchmarks import device
    from remap_tpu.utils import gameplay
    from remap_tpu.utils.runtime import setup_cache

    device.require_gpu()
    setup_cache()
    print(device.card(), flush=True)
    session = gameplay.play_session(
        seed=args.seed, n_frames=args.frames, frame_hw=(FH, FW)
    )
    gpu_maps, gpu_wall = build(session.frames)
    print(f"GPU build: {gpu_wall:8.2f} s, {len(gpu_maps)} map(s)",
          flush=True)
    from remap_tpu.core import palette

    agree, painted = gameplay.world_agreement(
        [palette.native_to_rgb(m) for m in gpu_maps], session)
    assert agree >= 0.999, agree
    assert painted >= 0.80, painted
    result = {
        "metric": "gameplay five-stage build (388x312 platformer)",
        "frames": args.frames,
        "wall_s": gpu_wall,
        "world_agreement": agree,
        "painted": painted,
        "device": device.describe(),
    }

    if not args.skip_cpu:
        env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
        with tempfile.TemporaryDirectory(dir=ROOT,
                                         prefix=".gameplay_e2e-") as tmp:
            out = os.path.join(tmp, "cpu_maps.npz")
            subprocess.run(
                [sys.executable, __file__, "--frames", str(args.frames),
                 "--seed", str(args.seed), "--cpu-child", out],
                check=True, env=env, cwd=ROOT, timeout=3600,
            )
            data = np.load(out)
            cpu_maps = [data[f"arr_{i}"] for i in range(len(data) - 1)]
            assert len(cpu_maps) == len(gpu_maps)
            for a, b in zip(gpu_maps, cpu_maps):
                np.testing.assert_array_equal(a, b)
            result["cpu_cross_check"] = "byte-identical"
            result["cpu_wall_s"] = float(data["wall"])

    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
