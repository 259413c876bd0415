"""Device meshes and shardings for multi-device runs.

The reference is a single process with three thread-parallel transforms
(SURVEY.md §2: mpb.hpp:82, fdf.hpp:24, fgs.hpp:98) and no distributed
layer.  Here the work scales two ways instead:

- **data parallelism over clips** (``data`` axis): independent gameplay
  clips batch across devices — BASELINE.json config 3 ("vmap over 8
  clips").
- **spatial parallelism over frame rows** (``space`` axis): for high-res
  captures (config 5, 640x480), extraction/blit shard the H dimension;
  XLA inserts halo collective-permutes for the 5x5 window sums crossing
  shard edges.

The mesh is a plain ('data', 'space') grid: the cards of one host reach
each other all to all (NVLink), so the layout follows the algorithm
alone.  There is no cross-host traffic in the hot loop (frames enter
per host, fragments exit per clip).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_devices: Optional[int] = None,
    space: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Mesh with axes ('data', 'space'); data = n_devices // space."""
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = list(devices)[:n_devices]
    assert n_devices % space == 0, (n_devices, space)
    arr = np.array(devices).reshape(n_devices // space, space)
    return Mesh(arr, axis_names=("data", "space"))


def clip_sharding(mesh: Mesh) -> NamedSharding:
    """[C, T, H, W] frames: clips over 'data', rows over 'space'."""
    return NamedSharding(mesh, P("data", None, "space", None))


def atlas_sharding(mesh: Mesh) -> NamedSharding:
    """[C, Ha, Wa, 16] atlases: clips over 'data', rows over 'space'."""
    return NamedSharding(mesh, P("data", "space", None, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
