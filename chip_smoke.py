#!/usr/bin/env python
"""Prove on a GPU that the map builder runs and gives the spec's maps.

One process, one card.  Five phases, each printing its size, the kernel
or XLA path each of its traced calls took (``utils.backend.TRACED``;
the jit caches are cleared before a phase, so its calls trace anew), its
wall time and its check:

1. the CLI on a 220-frame C64-width (388x312) gameplay session with a
   noise frame mid-clip (a fragment break the splicer re-merges): its
   PNG maps pixel-equal to the NumPy spec (``spec.pipeline.build``);
2. the CLI on a 2,048-frame session at 388x312: the largest map agrees
   with the simulator's world (>= 0.999 of painted pixels, >= 0.90
   painted);
3. the streaming step (bench.py's configuration: 256x240, batch 256,
   capacity 640, vote radius 16, multiplicity 1) over 8 batches: every
   pair matched, no exactness flag, the resident atlas equal to the
   world;
4. the Triton extraction kernel against its plain XLA form at 256x240
   and 388x312, batch 256: outputs bit-equal, both times printed;
5. the xcorr and pyramid matcher families recover known camera shifts.

``--four-cards`` runs, instead and alone, the multi-device checks that
``__graft_entry__.dryrun_multichip`` runs on virtual CPU devices: the
('data', 'space')-sharded step at 128x160 and with the pyramid matcher
at 640x480, each equal to the unsharded step, and the whole builder with
fragment round-robin on a teleport clip, equal to the spec.

Exits non-zero on any platform but a GPU and on any failed check; the
last line of a passing run is one JSON object naming the device.

Usage: python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from benchmarks import device  # noqa: E402
from remap_tpu.utils import backend  # noqa: E402

C64 = (312, 388)
NES = (240, 256)


def report(name: str, size: str, path: str, seconds: float,
           check: str) -> None:
    print(f"phase {name}: size {size}; path {path}; wall {seconds:.2f} s; "
          f"{check}", flush=True)


def run_phase(name: str, size: str, fn, check) -> None:
    """Run ``fn`` with fresh jit caches and report the paths it traced;
    ``check(result)`` says what was checked."""
    import jax

    jax.clear_caches()
    backend.TRACED.clear()
    t0 = time.perf_counter()
    result = fn()
    report(name, size, backend.traced_summary(), time.perf_counter() - t0,
           check(result))


def _write_raw(frames, directory: Path) -> None:
    directory.mkdir(parents=True)
    for i, f in enumerate(frames):
        np.asarray(f, np.uint8).tofile(str(directory / str(i)))


def _run_cli(frames, workdir: Path, name: str, cli_args=()) -> list:
    """Raw frames -> ``remap_tpu.cli.main`` in this process -> the RGB
    maps it wrote, in output order."""
    from remap_tpu import cli
    from remap_tpu.io import png as png_io

    h, w = frames[0].shape
    clip = workdir / name / "frames"
    _write_raw(frames, clip)
    prefix = str(workdir / name / "out")
    rc = cli.main([str(clip), "--width", str(w), "--height", str(h),
                   "--out-prefix", prefix, *cli_args])
    assert rc == 0, f"CLI exit {rc}"
    maps = []
    while Path(f"{prefix}{len(maps) + 1}.png").exists():
        maps.append(png_io.read_png(f"{prefix}{len(maps) + 1}.png"))
    return maps


def phase_cli_spec(workdir: Path, n_frames: int = 220, frame_hw=C64,
                   cli_args=()) -> dict:
    """Phase 1: CLI maps pixel-equal to the spec on a session with a
    mid-clip noise frame."""
    from remap_tpu.core import palette
    from remap_tpu.spec import pipeline as spec_pipeline
    from remap_tpu.utils import gameplay

    frames = list(gameplay.play_session(
        seed=3, n_frames=n_frames, frame_hw=frame_hw).frames)
    frames.insert(len(frames) // 2, np.random.default_rng(14).integers(
        0, 16, size=frame_hw, dtype=np.uint8))
    t0 = time.perf_counter()
    got = _run_cli(frames, workdir, "spec", cli_args)
    cli_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = [palette.native_to_rgb(m) for m in spec_pipeline.build(frames)]
    spec_s = time.perf_counter() - t0
    assert len(got) == len(want) > 0, (len(got), len(want))
    for i, (g, w_) in enumerate(zip(got, want)):
        assert g.shape == w_.shape, (i, g.shape, w_.shape)
        diff = int((g != w_).any(axis=-1).sum())
        assert diff == 0, f"map {i}: {diff} pixels differ from the spec"
    return {"frames": len(frames), "maps": len(got), "cli_s": cli_s,
            "spec_s": spec_s,
            "shapes": [tuple(m.shape[:2]) for m in got]}


def phase_cli_session(workdir: Path, n_frames: int = 2048, frame_hw=C64,
                      cli_args=(), min_agreement: float = 0.999,
                      min_painted: float = 0.90) -> dict:
    """Phase 2: the largest CLI map of a long session agrees with the
    simulator's world."""
    from remap_tpu.utils import gameplay

    session = gameplay.play_session(seed=3, n_frames=n_frames,
                                    frame_hw=frame_hw)
    t0 = time.perf_counter()
    maps = _run_cli(session.frames, workdir, "session", cli_args)
    cli_s = time.perf_counter() - t0
    agree, painted = gameplay.world_agreement(maps, session)
    assert agree >= min_agreement, f"world agreement {agree:.6f}"
    assert painted >= min_painted, f"painted {painted:.4f}"
    return {"frames": n_frames, "maps": len(maps), "cli_s": cli_s,
            "agreement": agree, "painted": painted}


def phase_streaming(frame_hw=NES, batch: int = 256, steps: int = 8) -> dict:
    """Phase 3: the streaming step matches every pair, raises no flag
    and its resident atlas equals the world."""
    import jax

    import bench
    from remap_tpu.core.regions import make_layout
    from remap_tpu.parallel.sharded import make_streaming_step

    h, w = frame_hw
    cfg = bench.stream_config(h, w, batch)
    layout = make_layout(w, h, cfg.grid_width, cfg.grid_height,
                         cfg.grid_overlap)
    frames, world, xs, ys = bench.make_session(batch * steps, h, w)
    init, step = make_streaming_step(layout, cfg, atlas_pad=128)
    step = jax.jit(step, donate_argnums=(1,))
    state = init()
    times, matched_all, flags, strays = [], [], 0, 0
    for i in range(steps):
        t0 = time.perf_counter()
        offs, matched, ovf, strayed, state = step(
            jax.device_put(frames[i * batch:(i + 1) * batch]), state)
        jax.block_until_ready(state)
        times.append(time.perf_counter() - t0)
        matched_all.append(np.asarray(matched))
        flags += int(np.asarray(ovf).any(axis=0).sum())
        strays += int(np.asarray(strayed))
    matched = np.concatenate(matched_all)[1:]   # frame 0 has no pair
    assert matched.all(), f"{int((~matched).sum())} pairs unmatched"
    assert flags == 0 and strays == 0, (flags, strays)
    dots = np.asarray(state.dots)
    anchor = np.asarray(state.anchor)
    ys_, xs_ = np.nonzero(dots.sum(axis=-1) > 0)
    assert len(ys_) > 0
    np.testing.assert_array_equal(
        dots.argmax(axis=-1)[ys_, xs_],
        world[ys_ + anchor[1] + ys[0], xs_ + anchor[0] + xs[0]])
    return {"frames": batch * steps, "first_step_s": times[0],
            "step_ms_median": float(np.median(times[1:]) * 1e3)
            if steps > 1 else None,
            "matched": float(matched.mean()), "flags": flags}


def phase_kernels(sizes=(NES, C64), batch: int = 256,
                  reps: int = 10) -> list:
    """Phase 4: the extraction kernel bit-equal to its XLA form; both
    times."""
    import jax.numpy as jnp

    from benchmarks import kernel_ab

    rng = np.random.default_rng(0)
    out = []
    for h, w in sizes:
        images = jnp.asarray(rng.integers(0, 16, (batch, h, w), np.uint8))
        ext = kernel_ab.op_extract(images, reps)
        assert ext["equal"], f"extract differs at {h}x{w}"
        out.append({
            "size": f"{w}x{h}",
            "extract_ms": {"triton": ext["kernel"]["median_ms"],
                           "xla": ext["xla"]["median_ms"]},
        })
    return out


def phase_matchers() -> dict:
    """Phase 5: xcorr and pyramid offsets equal the known camera path
    (the clips of tests/test_models.py)."""
    import jax.numpy as jnp

    from remap_tpu.models.pyramid import match_pyramid
    from remap_tpu.ops import correlate
    from remap_tpu.utils import testing

    world = testing.make_world(400, 520, np.random.default_rng(71), tile=8)

    def at(cams, h, w):
        return jnp.asarray(np.stack(
            [world[y:y + h, x:x + w] for x, y in cams]))

    def want(prev, curr):
        return [(cx - px, cy - py) for (px, py), (cx, cy) in zip(prev, curr)]

    prev, curr = [(100, 100), (130, 90), (80, 120)], [(103, 98), (140, 100),
                                                      (80, 120)]
    res = correlate.match_xcorr(at(prev, 96, 128), at(curr, 96, 128),
                                radius=16)
    assert np.asarray(res.ok).all()
    assert [tuple(o) for o in np.asarray(res.offset)] == want(prev, curr)
    prev, curr = [(60, 60), (200, 150)], [(108, 97), (150, 180)]
    offs, ok = match_pyramid(at(prev, 192, 256), at(curr, 192, 256),
                             factor=4, coarse_radius=16, fine_radius=7)
    assert np.asarray(ok).all()
    assert [tuple(o) for o in np.asarray(offs)] == want(prev, curr)
    return {"xcorr_pairs": 3, "pyramid_pairs": 2}


def run_one_card(workdir: Path) -> None:
    run_phase(
        "1 cli=spec", "388x312 x 221 frames",
        lambda: phase_cli_spec(workdir),
        lambda r: f"{r['maps']} map(s) {r['shapes']} pixel-equal to the "
                  f"spec (CLI {r['cli_s']:.2f} s, spec {r['spec_s']:.2f} s)")
    run_phase(
        "2 cli session", "388x312 x 2048 frames",
        lambda: phase_cli_session(workdir),
        lambda r: f"{r['maps']} map(s), world agreement "
                  f"{r['agreement']:.6f}, painted {r['painted']:.4f} "
                  f"(CLI {r['cli_s']:.2f} s)")
    run_phase(
        "3 streaming step", "256x240 x 8 batches of 256", phase_streaming,
        lambda r: f"matched {r['matched']:.0%}, flags {r['flags']}, atlas "
                  f"equal to the world (first step {r['first_step_s']:.2f} "
                  f"s, then median {r['step_ms_median']:.3f} ms/step)")
    run_phase(
        "4 kernels", "256x240 and 388x312 x 256", phase_kernels,
        lambda rs: "bit-equal; extract ms " + "; ".join(
            f"{r['size']} {r['extract_ms']}" for r in rs))
    run_phase(
        "5 xcorr+pyramid", "128x96 and 256x192", phase_matchers,
        lambda r: f"{r['xcorr_pairs']} xcorr + {r['pyramid_pairs']} "
                  "pyramid offsets (FFT, XLA) equal the camera path")


def run_four_cards() -> None:
    import jax

    import __graft_entry__ as graft
    from remap_tpu.parallel.mesh import make_mesh

    assert len(jax.devices()) == 4, f"{len(jax.devices())} devices, not 4"
    mesh = make_mesh(4, space=2)
    on_mesh = "4 cards, mesh data 2 x space 2"
    for name, size, fn in (
        ("sharded step 128x160 = unsharded", on_mesh,
         lambda: graft.check_sharded_step(mesh)),
        ("sharded pyramid 640x480 = unsharded", on_mesh,
         lambda: graft.check_pyramid_sharded(mesh)),
        ("builder teleport = spec",
         "4 cards, fragments round-robin, 96x72 x 41 frames",
         graft.check_builder_spec),
    ):
        run_phase(name, size, fn, lambda _: "equal")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card checks")
    args = ap.parse_args(argv)

    from remap_tpu.utils.runtime import setup_cache

    dev = device.require_gpu()
    cache = setup_cache()
    print(device.card(), flush=True)
    print(f"device_kind {dev.device_kind}; compile cache {cache}",
          flush=True)
    if args.four_cards:
        run_four_cards()
    else:
        # raw frames and maps go to a scratch directory of the checkout
        # (listed in .gitignore), removed on exit
        with tempfile.TemporaryDirectory(dir=ROOT,
                                         prefix=".chip_smoke-") as tmp:
            run_one_card(Path(tmp))
    print(json.dumps({"ok": True, "device": device.describe()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
