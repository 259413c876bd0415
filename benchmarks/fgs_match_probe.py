#!/usr/bin/env python
"""Compile-vs-execute split of the session-scale splice pair match.

fgs_budget.py showed each pair match costing 126-220 s at capacity
524288 on a cold process while the steady-state finalize was 0.86 s —
this probe separates the three suspects for one pair at the exact
session signature:

  1. jit cache miss: AOT ``lower().compile()`` wall per (multiplicity)
     signature (the mask bucket and capacity are fixed by the pair);
  2. device execute: the compiled program's chained-dispatch rate;
  3. the escalation ladder: how many multiplicity levels the pair
     actually walks (each level = one compile + one execute).

Usage: python benchmarks/fgs_match_probe.py [--size 4096] [--bands 3]
"""

import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=4096)
    ap.add_argument("--bands", type=int, default=3)
    args = ap.parse_args()
    from benchmarks import device

    device.require_gpu()

    from remap_tpu.utils.runtime import setup_cache

    setup_cache()

    import jax
    import jax.numpy as jnp

    from benchmarks.fgs_budget import make_session_fragments
    from remap_tpu.config import PipelineConfig
    from remap_tpu.ops import splice as splice_ops
    from remap_tpu.pipeline import splice as spl

    cfg = PipelineConfig(screen_width=256, screen_height=240)
    import os

    os.makedirs(".bench_data", exist_ok=True)
    cache = f".bench_data/fgs_probe_tables_{args.size}_{args.bands}.npz"

    if os.path.exists(cache):
        z = np.load(cache)
        h_codes, h_pos, h_valid = z["hc"], z["hp"], z["hv"]
        o_codes, o_pos, o_valid = z["oc"], z["op"], z["ov"]
        h_mask, h_dims, o_dims = z["hm"], z["hd"], z["od"]
        print(f"tables from {cache}", flush=True)
    else:
        rng = np.random.default_rng(7)
        frags = make_session_fragments(args.size, args.bands, rng)[:2]
        t0 = time.perf_counter()
        snippets = [spl._extract_snippet(f, cfg) for f in frags]
        print(f"extract 2 snippets: {time.perf_counter() - t0:.1f} s",
              flush=True)
        pad = spl._PadState()
        pad.update(snippets)
        k = pad.cap
        print(f"pad capacity {k}, mask bucket {pad.hb}x{pad.wb}",
              flush=True)

        def padded(s):
            extra = k - s.codes.shape[0]
            if extra == 0:
                return s.codes, s.pos, s.valid
            return (
                np.pad(s.codes, ((0, extra), (0, 0))),
                np.pad(s.pos, ((0, extra), (0, 0))),
                np.pad(s.valid, (0, extra)),
            )

        h, o = snippets
        h_codes, h_pos, h_valid = padded(h)
        o_codes, o_pos, o_valid = padded(o)
        h_mask = h.mask_bucket
        h_dims = np.array(h.dims, np.int32)
        o_dims = np.array(o.dims, np.int32)
        np.savez(cache, hc=h_codes, hp=h_pos, hv=h_valid, oc=o_codes,
                 op=o_pos, ov=o_valid, hm=h_mask, hd=h_dims, od=o_dims)

    k = h_codes.shape[0]
    print(f"capacity {k}, mask bucket {h_mask.shape}", flush=True)
    args_dev = (
        jnp.asarray(h_codes), jnp.asarray(h_pos), jnp.asarray(h_valid),
        jnp.asarray(o_codes), jnp.asarray(o_pos), jnp.asarray(o_valid),
        jnp.asarray(h_mask),
        jnp.asarray(h_dims),
        jnp.asarray(o_dims),
    )
    jax.block_until_ready(args_dev)

    report = {}
    for mult in (1, 2, 4, 8, 16):
        fn = lambda *a: splice_ops.match_fragments(
            *a, cell_w=cfg.splice_cell[0], cell_h=cfg.splice_cell[1],
            ratio=cfg.splice_cell_ratio, multiplicity=mult,
        )
        t0 = time.perf_counter()
        lowered = jax.jit(fn).lower(*args_dev)
        t_lower = time.perf_counter() - t0
        t0 = time.perf_counter()
        compiled = lowered.compile()
        t_compile = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = compiled(*args_dev)
        jax.block_until_ready(res)
        t_exec1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(3):
            res = compiled(*args_dev)
        jax.block_until_ready(res)
        t_exec = (time.perf_counter() - t0) / 3
        ov = bool(np.asarray(res.overflow))
        nm = int(np.asarray(res.needed_multiplicity))
        print(
            f"mult {mult:2d}: lower {t_lower:6.1f} s  compile "
            f"{t_compile:6.1f} s  exec1 {t_exec1:6.2f} s  exec "
            f"{t_exec:6.2f} s  overflow={ov} needed={nm} "
            f"count={int(np.asarray(res.count))}",
            flush=True,
        )
        report[f"mult{mult}"] = {
            "lower_s": round(t_lower, 2),
            "compile_s": round(t_compile, 2),
            "exec_s": round(t_exec, 3),
            "overflow": ov,
            "needed": nm,
        }
        if not ov:
            break

    print(json.dumps({
        "metric": "fgs pair-match compile/execute split at session scale",
        "capacity": int(k),
        "mask_bucket": list(h_mask.shape),
        "levels": report,
    }), flush=True)


if __name__ == "__main__":
    main()
