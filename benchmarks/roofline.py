#!/usr/bin/env python
"""Roofline accounting for the streaming step's parts on the GPU.

Places each part of the streaming pipeline (extract, tables, match, the
whole step) against the card's published ceilings
(``benchmarks/device.PEAKS``, keyed by ``device_kind``; any other device
is refused):

- **measured ms per call**, each call ending in ``block_until_ready``
  (median of repeats);
- **bytes accessed and flops from XLA's own cost model**
  (``compiled.cost_analysis()``) for the exact program measured; a
  Triton kernel is opaque to it, so its bytes read 0;
- achieved bytes/s and FLOP/s as a share of the peak memory bandwidth
  and of the bf16 tensor-core rate (integer work is labelled; its
  ceiling differs);
- a ``jax.profiler`` device trace of 8 full steps dispatched back to
  back, saved to ``--trace-dir`` and reduced by
  ``benchmarks/trace_report.py``: the device's idle share in that
  window and its time per kernel.

The byte and flop shares divide XLA's count by host-timed wall time and
leave out what the Triton kernel moves; the trace's device times are the
ones to quote.

Usage: python benchmarks/roofline.py [--batch 256] [--cap 640]
       [--trace-dir .bench_data/roofline_trace]
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmarks import device  # noqa: E402


def analyze(name, fn, args, rows, peak, reps=10):
    import jax

    compiled = jax.jit(fn).lower(*args).compile()
    cost = compiled.cost_analysis() or {}
    if isinstance(cost, list):
        cost = cost[0] if cost else {}
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    ms = device.timeit(jax.jit(fn), *args, reps=reps)["median_ms"]
    sec = ms / 1e3
    rows.append({
        "part": name,
        "ms": ms,
        "bytes_GB": byts / 1e9,
        "share_of_hbm_peak": byts / sec / peak["hbm_bytes_per_s"],
        "flops_G": flops / 1e9,
        "share_of_bf16_peak": flops / sec / peak["bf16_flops"],
    })
    print(json.dumps(rows[-1]), flush=True)
    return rows[-1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--cap", type=int, default=640)
    ap.add_argument("--trace-dir", default=".bench_data/roofline_trace")
    args = ap.parse_args()

    dev = device.require_gpu()
    peak = device.peaks(dev.device_kind)

    from remap_tpu.utils.runtime import setup_cache

    setup_cache()
    print(device.card(), flush=True)

    import jax
    import jax.numpy as jnp

    import bench
    from remap_tpu.core.regions import make_layout
    from remap_tpu.ops import kpe as kpe_ops
    from remap_tpu.ops import kpm as kpm_ops
    from remap_tpu.ops import tables as xtables
    from remap_tpu.parallel.sharded import make_streaming_step
    from remap_tpu.utils.profiling import device_trace

    H, W, B, K = 240, 256, args.batch, args.cap
    cfg = bench.stream_config(H, W, B)
    layout = make_layout(W, H, cfg.grid_width, cfg.grid_height,
                         cfg.grid_overlap)
    fdev = jnp.asarray(bench.make_clip(B, H, W))
    rows = []

    ext = lambda im: kpe_ops.extract_dense(im, layout)
    analyze("extract", ext, (fdev,), rows, peak)
    dense = jax.jit(ext)(fdev)

    tab = lambda w, c: xtables.build_tables(w, c, layout, K)
    analyze("tables (topk)", tab, (dense.weight, dense.codes), rows, peak)
    tabs = jax.jit(tab)(dense.weight, dense.codes)

    prev = jax.tree.map(lambda a: a[:-1], tabs)
    curr = jax.tree.map(lambda a: a[1:], tabs)
    mat = lambda p, c: kpm_ops.match_tables(
        p, c, layout,
        weight_switch=cfg.match.weight_switch,
        region_votes=cfg.match.region_votes,
        min_active_divisor=cfg.min_active_divisor,
        runner_up_divisor=cfg.runner_up_divisor,
        multiplicity=cfg.join_multiplicity,
        vote_radius=cfg.vote_radius,
    )
    analyze("match (join + matmul votes)", mat, (prev, curr), rows, peak)

    init_state, sstep = make_streaming_step(layout, cfg, atlas_pad=128)
    state = init_state()
    analyze("full streaming step", sstep, (fdev, state), rows, peak)

    from benchmarks import trace_report

    sstep_j = jax.jit(sstep)
    jax.block_until_ready(sstep_j(fdev, state))
    steps = 8
    with device_trace(args.trace_dir):
        for _ in range(steps):
            out = sstep_j(fdev, state)
            state = out[-1]
        jax.block_until_ready(state)
    print(json.dumps({
        "metric": "streaming-step roofline accounting at 256x240",
        "batch": B, "capacity": K, "rows": rows,
        "trace": trace_report.summarize(args.trace_dir, steps=steps),
        "device": device.describe(),
    }), flush=True)


if __name__ == "__main__":
    main()
