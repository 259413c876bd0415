"""Artifact-clean stage (mpb.hpp:79-94).

Per fragment: blend, rare-pattern heatmap, conditional Gaussian color
re-selection (ops.arf), then crop the canvas's empty margins
(arf.hpp:314-328).  Fragments are independent — the reference used a CPU
thread pool here; on the device each fragment is one program and multiple
fragments simply queue.
"""

from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from remap_tpu.config import PipelineConfig
from remap_tpu.ops import arf as arf_ops
from remap_tpu.ops import atlas as atlas_ops
from remap_tpu.pipeline.state import Fragment


def margins_of(dots: np.ndarray) -> tuple:
    nonempty = dots.any(axis=2)
    h, w = nonempty.shape
    if not nonempty.any():
        return (w, h, w, h)
    cols = np.nonzero(nonempty.any(axis=0))[0]
    rows = np.nonzero(nonempty.any(axis=1))[0]
    return (
        int(cols[0]),
        int(rows[0]),
        int(w - 1 - cols[-1]),
        int(h - 1 - rows[-1]),
    )


@jax.jit
def _margins_jit(dots):
    """Device form of :func:`margins_of`: one [5] fetch instead of
    downloading a session-scale canvas to scan it on the host."""
    nonempty = dots.any(axis=2)
    h, w = nonempty.shape
    cols = nonempty.any(axis=0)
    rows = nonempty.any(axis=1)
    left = jnp.argmax(cols)
    top = jnp.argmax(rows)
    right = w - 1 - jnp.argmax(cols[::-1])
    bottom = h - 1 - jnp.argmax(rows[::-1])
    return jnp.stack([
        left.astype(jnp.int32),
        top.astype(jnp.int32),
        (w - 1 - right).astype(jnp.int32),
        (h - 1 - bottom).astype(jnp.int32),
        nonempty.any().astype(jnp.int32),
    ])


def margins_of_fragment(frag: Fragment) -> tuple:
    """Empty margins of a fragment's canvas, on whichever side of the
    link the canvas already lives."""
    if frag.dots_dev is not None:
        ltrb = np.asarray(_margins_jit(frag.dots_dev))
        if not ltrb[4]:
            h, w = frag.shape
            return (w, h, w, h)
        return (int(ltrb[0]), int(ltrb[1]), int(ltrb[2]), int(ltrb[3]))
    return margins_of(frag.dots)


def clean_fragment(frag: Fragment, cfg: PipelineConfig) -> np.ndarray:
    dots = frag.device_dots()
    image, mask = atlas_ops.blend(dots)
    out = arf_ops.filter_fragment(
        dots,
        image,
        mask,
        size=cfg.artifact_filter_size,
        dev=cfg.artifact_filter_dev,
        threshold=cfg.artifact_heat_threshold,
    )
    out_np = np.asarray(out)
    left, top, right, bottom = margins_of_fragment(frag)
    h, w = out_np.shape
    return out_np[top : h - bottom, left : w - right]


def clean(fragments: List[Fragment], cfg: PipelineConfig) -> List[np.ndarray]:
    import jax

    devs = jax.local_devices()
    if len(devs) > 1 and len(fragments) > 1:
        # the reference's parallel transform (mpb.hpp:82) on the mesh:
        # fragments round-robin across devices, dispatched async,
        # fetched after all dispatches (parallel.fragments)
        from remap_tpu.parallel.fragments import clean_fragments

        return clean_fragments(fragments, cfg, devs)
    return [clean_fragment(f, cfg) for f in fragments]
