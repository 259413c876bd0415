"""Fragment-axis parallelism: the reference's three thread-pool sites on
a device mesh.

The reference runs three stages task-parallel over fragments with
``std::execution::par``: arf per fragment (mpb.hpp:82), fdf's background
blends (fdf.hpp:24), and fgs's snippet extraction (fgs.hpp:98).  Here
fragments are INDEPENDENT device programs, so the translation is
round-robin device placement: fragment i's whole program chain runs on
``devices[i % N]``, dispatched asynchronously, fetched after every
fragment has been dispatched.  One chip behaves exactly as before
(programs queue); an N-chip host runs N fragments concurrently.

Semantics are untouched BY CONSTRUCTION: each fragment runs the same
program at its exact canvas shape on a different device.  Padding
fragments into common shape buckets was rejected: arf's pattern-frequency
heatmap counts identical 15-px windows across the whole canvas
(arf.hpp:143-186), and a blend's all-zero windows are indistinguishable
from genuine black content, so growing the canvas changes interior heat —
the per-shape program is the price of bit-parity (PARITY.md).

Used by pipeline.clean, pipeline.foreground and pipeline.splice whenever
more than one local device is visible; asserted equal to the serial path
in tests/test_parallel.py and certified by __graft_entry__.dryrun_multichip
path 4.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from remap_tpu.config import PipelineConfig
from remap_tpu.ops import arf as arf_ops
from remap_tpu.ops import atlas as atlas_ops
from remap_tpu.pipeline.state import Fragment


def fragment_devices(
    n: int, devices: Optional[Sequence[jax.Device]] = None
) -> List[jax.Device]:
    """Round-robin device assignment for ``n`` fragments."""
    if devices is None:
        devices = jax.local_devices()
    return [devices[i % len(devices)] for i in range(n)]


def clean_fragments(
    fragments: List[Fragment],
    cfg: PipelineConfig,
    devices: Optional[Sequence[jax.Device]] = None,
) -> List[np.ndarray]:
    """arf per fragment across devices (mpb.hpp:82's parallel transform).

    Phase 1 dispatches every fragment's blend + heatmap + select chain to
    its device (async); phase 2 fetches and applies the exact host
    re-selection of stability-flagged pixels + the margin crop.  Results
    equal pipeline.clean.clean exactly."""
    from remap_tpu.pipeline.clean import margins_of_fragment

    devs = fragment_devices(len(fragments), devices)
    pending = []
    for frag, dev in zip(fragments, devs):
        dots = jax.device_put(frag.device_dots(), dev)
        image, mask = atlas_ops.blend(dots)
        res = arf_ops.filter_fragment_dispatch(
            dots, image, mask,
            size=cfg.artifact_filter_size,
            dev=cfg.artifact_filter_dev,
            threshold=cfg.artifact_heat_threshold,
        )
        pending.append((frag, dots, res))

    maps: List[np.ndarray] = []
    for frag, dots, res in pending:
        out = arf_ops.filter_fragment_finalize(
            dots, res, cfg.artifact_filter_dev
        )
        left, top, right, bottom = margins_of_fragment(frag)
        h, w = out.shape
        maps.append(out[top : h - bottom, left : w - right])
    return maps


def blend_fragments(
    fragments: List[Fragment],
    devices: Optional[Sequence[jax.Device]] = None,
):
    """Per-fragment (background, mask) blends across devices
    (fdf.hpp:21-34's parallel get_background).  Returns device arrays,
    each resident on its fragment's device so the caller's per-fragment
    frame loop continues there."""
    devs = fragment_devices(len(fragments), devices)
    out = []
    for frag, dev in zip(fragments, devs):
        dots = jax.device_put(frag.device_dots(), dev)
        out.append(atlas_ops.blend(dots))
    return out, devs
