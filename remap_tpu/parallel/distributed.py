"""Multi-process runtime wiring.

The reference is a single process (SURVEY.md §2 parallelism audit); here
the work scales across processes the JAX way: every process calls
``jax.distributed.initialize`` (gRPC coordination service), after which
``jax.devices()`` is the *global* device list and ``parallel.mesh.
make_mesh`` builds meshes over all processes' devices unchanged.  Frames
enter per process (each feeds its local clips); collectives cross
processes only at stage boundaries — BASELINE.json config 5.

Nothing detects a cluster: each process passes the coordinator's
``host:port``, the process count and its own id.
"""

from __future__ import annotations

from typing import Optional


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the distributed runtime (idempotent per process)."""
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def local_clip_slice(n_clips: int) -> slice:
    """Which clips of a [C, ...] global batch this process feeds.

    Clips shard over the 'data' axis; with processes stacked along it,
    process p owns the contiguous block [p*C/P, (p+1)*C/P)."""
    import jax

    p = jax.process_index()
    n = jax.process_count()
    assert n_clips % n == 0, (n_clips, n)
    per = n_clips // n
    return slice(p * per, (p + 1) * per)


def make_global_batch(images, mesh, sharding=None):
    """Assemble a global [C, T, H, W] array from per-process local clips.

    ``images`` is this process's local slice (see ``local_clip_slice``);
    the result is addressable across the whole mesh without any host
    gathering a full copy."""
    import jax

    from remap_tpu.parallel.mesh import clip_sharding

    if sharding is None:
        sharding = clip_sharding(mesh)
    return jax.make_array_from_process_local_data(sharding, images)
