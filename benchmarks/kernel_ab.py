#!/usr/bin/env python
"""Each hand-written kernel against the plain XLA form it replaces.

For the extraction kernel of ``ops.pallas`` and each screen size, batch
256:

- the operation alone: kernel and XLA form on the same inputs, outputs
  compared bit for bit, both times printed;
- end to end: the streaming step (``parallel.sharded.
  make_streaming_step``, bench.py's configuration) with the kernel on
  and off.

A kernel stays in the program only if it is faster than the plain form,
end to end.  The two XLA assemblies of fdf's foreground masks
(``ops.fde``) are timed the same way, on the labels of the same medians.

Usage: python benchmarks/kernel_ab.py [--sizes 240x256,312x388]
       [--batch 256] [--reps 10] [--ops extract,fdf,step]
       [--extract-sweep 16x64w4,8x32w4]
Prints one JSON line per measurement.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmarks import device  # noqa: E402


def extract_pair(images):
    """(kernel out, XLA out) of the dense extraction, unmasked."""
    from remap_tpu.ops import kpe
    from remap_tpu.ops.pallas import extract as pext

    _, h, w = images.shape
    return (pext.extract_dense_raw(images),
            kpe._extract_dense(images, height=h, width=w))


def op_extract(images, reps: int) -> dict:
    import jax

    from remap_tpu.ops import kpe
    from remap_tpu.ops.pallas import extract as pext

    _, h, w = images.shape
    got, want = extract_pair(images)
    equal = all(
        bool((np.asarray(a) == np.asarray(b)).all())
        for a, b in zip(got, want)
    )
    xla = jax.jit(lambda im: kpe._extract_dense(im, height=h, width=w))
    return {
        "equal": equal,
        "kernel": device.timeit(pext.extract_dense_raw, images, reps=reps),
        "xla": device.timeit(xla, images, reps=reps),
    }


def op_fdf_assembly(images, reps: int) -> dict:
    """fdf mask assembly: the labels-sorted form against the vmapped
    per-frame ``foreground_mask``, both fed by XLA labels."""
    import jax
    import jax.numpy as jnp

    from remap_tpu.ops import cc, fde

    b, h, w = images.shape
    limit = (h * w) // 5
    medians = jax.jit(lambda im: extract_pair(im)[1].median)(images)
    changed = jnp.asarray(
        np.random.default_rng(1).random((b, h, w)) < 0.05)
    labels = jax.jit(jax.vmap(cc.label_components))(medians)

    sorted_form = jax.jit(
        lambda lab, chg: fde._masks_from_labels_sorted(lab, chg, limit))

    @jax.jit
    def vmapped_form(med, chg, lab):
        qleft = cc.quirky_fill_left_batch(lab)
        return jax.vmap(
            lambda m, c, la, q: fde.foreground_mask(
                m, c, limit, labels=la, fill_left=q)
        )(med, chg, lab, qleft)

    equal = bool((np.asarray(sorted_form(labels, changed))
                  == np.asarray(vmapped_form(medians, changed, labels))).all())
    return {
        "equal": equal,
        "labels": device.timeit(
            jax.jit(jax.vmap(cc.label_components)), medians, reps=reps),
        "labels_sorted": device.timeit(sorted_form, labels, changed,
                                       reps=reps),
        "vmapped": device.timeit(vmapped_form, medians, changed, labels,
                                 reps=reps),
    }


def extract_sweep(images, configs, reps: int) -> dict:
    """Extract kernel time per (tile, num_warps), each checked equal."""
    from remap_tpu.ops.pallas import extract as pext

    _, want = extract_pair(images)
    out = {}
    for tile, warps in configs:
        fn = lambda im, t=tile, nw=warps: pext.extract_dense_raw(
            im, tile=t, num_warps=nw)
        got = fn(images)
        equal = all(bool((np.asarray(a) == np.asarray(b)).all())
                    for a, b in zip(got, want))
        out[f"{tile[0]}x{tile[1]}w{warps}"] = {
            "equal": equal, **device.timeit(fn, images, reps=reps)}
    return out


def step_times(h: int, w: int, batch: int, reps: int) -> dict:
    """Streaming step per batch with the extraction kernel forced on
    and off."""
    import jax
    import jax.numpy as jnp

    import bench
    from remap_tpu.core.regions import make_layout
    from remap_tpu.parallel import sharded
    from remap_tpu.utils import backend

    cfg = bench.stream_config(h, w, batch)
    layout = make_layout(w, h, cfg.grid_width, cfg.grid_height,
                         cfg.grid_overlap)
    frames = jnp.asarray(bench.make_clip(batch, h, w))
    out = {}
    real_extract = backend.extract_path
    for name, on in (("xla", False), ("extract", True)):
        backend.extract_path = (
            lambda *a, on=on, **k: backend.TRITON if on else backend.XLA)
        # inner jitted ops cache their traces: drop them so each
        # variant traces its own paths
        jax.clear_caches()
        try:
            init, step = sharded.make_streaming_step(layout, cfg,
                                                     atlas_pad=128)
            step = jax.jit(step)
            state = init()
            out[name] = device.timeit(lambda im: step(im, state), frames,
                                      reps=reps)
        finally:
            backend.extract_path = real_extract
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="240x256,312x388")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--ops", default="extract,fdf,step",
                    help="comma list of extract, fdf, step")
    ap.add_argument("--extract-sweep", default="",
                    help="extract tiles to time, e.g. 16x64w4,8x32w4")
    args = ap.parse_args(argv)

    import jax.numpy as jnp

    from remap_tpu.utils.runtime import setup_cache

    dev = device.require_gpu()
    setup_cache()
    print(device.card(), flush=True)
    print(dev.device_kind, flush=True)
    ops = set(args.ops.split(","))
    def configs(spec):
        out = []
        for item in filter(None, spec.split(",")):
            tile, warps = item.split("w")
            out.append((tuple(map(int, tile.split("x"))), int(warps)))
        return out

    sweep = configs(args.extract_sweep)
    rng = np.random.default_rng(0)
    for size in args.sizes.split(","):
        h, w = map(int, size.split("x"))
        images = jnp.asarray(
            rng.integers(0, 16, (args.batch, h, w), dtype=np.uint8))
        rec = {"size": size, "batch": args.batch}
        if "extract" in ops:
            device.emit({"op": "extract", **rec,
                         **op_extract(images, args.reps)})
        if sweep:
            device.emit({"op": "extract_sweep", **rec,
                         **extract_sweep(images, sweep, args.reps)})
        if "fdf" in ops:
            device.emit({"op": "fdf_assembly", **rec,
                         **op_fdf_assembly(images, args.reps)})
        if "step" in ops:
            device.emit({"op": "streaming_step", **rec,
                         **step_times(h, w, args.batch, args.reps)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
