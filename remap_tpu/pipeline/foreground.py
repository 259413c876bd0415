"""Foreground filtering pass (fdf.hpp).

Second pass over stored frames: each fragment is blended into a background
(device argmax, ops.atlas.blend); its frames stream back through the
device in batches — equality mask, component-gated foreground mask
(ops.fde), masked vote blit into a fresh fragment canvas of the
background's dimensions (fdf.hpp:40-75).
"""

from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from remap_tpu.config import PipelineConfig
from remap_tpu.ops import atlas as atlas_ops
from remap_tpu.ops import fde as fde_ops
from remap_tpu.pipeline.collect import _unpack_jit
from remap_tpu.pipeline.state import Fragment, FrameRef


def filter_fragments(
    fragments: List[Fragment],
    cfg: PipelineConfig,
) -> List[Fragment]:
    """Fragments are independent — the reference blends their backgrounds
    with a thread pool (fdf.hpp:21-34) and we additionally run each
    fragment's whole frame loop on its own device when several are
    visible (round-robin, parallel.fragments): every chain dispatches
    async and the blocking fetches happen only after the LAST fragment's
    dispatch, so N devices process N fragments concurrently."""
    import jax

    b = cfg.frame_batch
    devs = jax.local_devices()
    multi = len(devs) > 1 and len(fragments) > 1
    default_dev = jax.devices()[0]

    pending = []
    for fi, frag in enumerate(fragments):
        dev = devs[fi % len(devs)] if multi else default_dev
        store = frag.store
        assert store is not None, "fragment has no frame store"
        fh, fw = store.height, store.width
        ch, cw = frag.shape

        dots_dev = (
            jax.device_put(frag.device_dots(), dev)
            if multi
            else frag.device_dots()
        )
        background, _ = atlas_ops.blend(dots_dev)

        out_dots = jnp.zeros((ch, cw, atlas_ops.DEPTH), jnp.uint16)
        if multi:
            out_dots = jax.device_put(out_dots, dev)
        nums = [r.number for r in frag.frames]
        poss = [r.position for r in frag.frames]

        for i in range(0, len(nums), b):
            chunk = nums[i : i + b]
            cpos = poss[i : i + b]
            n_real = len(chunk)
            # HBM mirror when collect ran on this device; packed upload
            # otherwise (the mirror lives on the default device only)
            if multi and dev != default_dev:
                packed = jax.device_put(
                    store.packed_images_batch(chunk), dev
                )
            else:
                packed = store.device_packed_batch(chunk)
            recompute = not store.has_medians
            # medians come from the HBM mirror when the session fits
            # (frame_store="hbm"), uploaded packed otherwise
            if recompute:
                meds_p = None
            elif multi and dev != default_dev:
                meds_p = jax.device_put(
                    store.packed_medians_batch(chunk), dev
                )
            else:
                meds_p = store.device_packed_medians_batch(chunk)
            if n_real < b:
                pad = b - n_real
                packed = jnp.concatenate(
                    [packed,
                     jnp.zeros((pad,) + packed.shape[1:], jnp.uint8)]
                )
                if meds_p is not None:
                    meds_p = jnp.concatenate(
                        [meds_p,
                         jnp.zeros((pad,) + meds_p.shape[1:], jnp.uint8)]
                    )
            imgs = _unpack_jit(jnp.asarray(packed), fw)
            apos = np.array(
                [(px - frag.zero[0], py - frag.zero[1]) for px, py in cpos]
                + [(0, 0)] * (b - n_real),
                np.int32,
            )
            meds_dev = (
                None if meds_p is None else _unpack_jit(meds_p, fw)
            )
            fg = fde_ops.extract_batch(
                background,
                imgs,
                meds_dev,
                jnp.asarray(apos),
                area_divisor=cfg.fde_area_divisor,
                compute_medians=recompute,
            )
            # padding frames must vote nowhere
            if n_real < b:
                fg = fg.at[n_real:].set(1)
            out_dots = atlas_ops.blit_frames(
                imgs,
                jnp.asarray(apos),
                atlas_h=ch,
                atlas_w=cw,
                masks=fg,
                dots=out_dots,
            )
        pending.append((frag, out_dots, nums, poss))

    # the filtered canvases stay device-resident for the clean stage
    # (materialized lazily on .dots access); nothing here blocks — every
    # fragment's chain was dispatched above
    results: List[Fragment] = []
    for frag, out_dots, nums, poss in pending:
        results.append(Fragment(
            dots_dev=out_dots,
            zero=frag.zero,
            frames=[FrameRef(number=n, position=p) for n, p in zip(nums, poss)],
            store=frag.store,
        ))
    return results
