"""Backend-dependent choices, made in one place from what JAX observes.

Everything that differs between the GPU and the CPU is decided here, at
trace time, from ``jax.devices()``: whether the hand-written extraction
kernel (``ops.pallas.extract``) runs, which shapes it covers, and how
many bytes of device memory the frame store may keep resident.  Callers
pass ``kernels=None`` to follow the device, or ``True``/``False`` to
force a path (the A/B measurements and the equality tests do).

- On a GPU the Triton kernel runs wherever its shape gate admits the
  call; elsewhere the plain XLA form runs.
- Off the GPU a forced kernel runs through the Pallas interpreter, so
  the CPU test suite checks the kernel's arithmetic.
- Each implementation notes itself in ``TRACED`` when it is traced
  (``record``), so a caller can see which path its calls took
  (``chip_smoke.py`` prints it).
- A ``pallas_call`` is opaque to XLA's SPMD partitioner, so programs
  jitted over a multi-device mesh (``parallel.sharded.make_sharded_step``)
  pass ``kernels=False``.
"""

from __future__ import annotations

import jax

#: kernel names, as ``chip_smoke.py`` prints the path each call took
TRITON = "triton"
XLA = "xla"

#: (op, shape, path) of every implementation traced in this process; a
#: jitted call that hits its cache is not traced again, so a caller that
#: wants one phase's paths clears this and ``jax.clear_caches()`` first
TRACED: set = set()


def record(op: str, shape: tuple, path: str) -> None:
    """Note, while tracing, that ``op`` ran on ``path`` for ``shape``."""
    TRACED.add((op, tuple(shape), path))

#: largest element count a kernel addresses in int32 arithmetic (with
#: room for the one-past-the-end offsets of masked lanes)
_INT32_OFFSETS = (1 << 31) - (1 << 10)

#: share of the device's memory limit the frame-store mirrors may hold;
#: the rest stays for the collect/foreground working set (a 256-frame
#: batch at 388x312 with its one-hot and join temporaries is a few GiB)
STORE_FRACTION = 0.5


def platform() -> str:
    """Platform of the default device: ``"gpu"`` or ``"cpu"``."""
    return jax.devices()[0].platform


def on_gpu() -> bool:
    return platform() == "gpu"


def interpret() -> bool:
    """Pallas calls run compiled on a GPU and interpreted elsewhere."""
    return not on_gpu()


def extract_path(b: int, h: int, w: int, kernels: bool | None = None) -> str:
    """Path of ``ops.kpe.extract_dense`` for a [b, h, w] batch.

    The Triton kernel addresses its flat code output ([b, h, w, 4]
    uint32 words) with int32 offsets; larger batches take XLA."""
    fits = b * h * w * 4 <= _INT32_OFFSETS
    run = on_gpu() if kernels is None else kernels
    return TRITON if run and fits else XLA


def traced_summary(traced=None, limit: int = 4) -> str:
    """``TRACED`` as one line: per op and path, how many shapes and the
    first ``limit`` of them; ``"xla only"`` when no call with a kernel
    form was traced."""
    groups: dict = {}
    for op, shape, path in sorted(TRACED if traced is None else traced):
        groups.setdefault((op, path), []).append(
            "x".join(map(str, shape)))
    if not groups:
        return "xla only"
    parts = []
    for (op, path), shapes in groups.items():
        more = f" +{len(shapes) - limit} more" if len(shapes) > limit else ""
        parts.append(f"{op}={path} for {len(shapes)} shape(s) "
                     f"[{', '.join(shapes[:limit])}{more}]")
    return "; ".join(parts)


def device_memory_limit(stats: dict | None = None) -> int:
    """Bytes the default device may allocate (0 when it does not say).

    ``stats`` defaults to ``jax.devices()[0].memory_stats()``; the CPU
    backend may report none."""
    if stats is None:
        stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("bytes_limit", 0))


def store_budget(mode: str, stats: dict | None = None,
                 fallback: int = 0) -> int:
    """Frame-store mirror budget in bytes for ``PipelineConfig.frame_store``.

    ``"hbm"`` keeps whole sessions resident, up to STORE_FRACTION of the
    device's memory limit (``fallback`` bytes where the device reports
    no limit); ``"host"`` keeps none; ``"auto"`` is ``"hbm"`` on an
    accelerator and ``"host"`` on the CPU, where a mirror would only copy
    host memory."""
    if mode == "auto":
        mode = "host" if platform() == "cpu" else "hbm"
    if mode == "host":
        return 0
    if mode == "hbm":
        limit = device_memory_limit(stats)
        return int(limit * STORE_FRACTION) if limit else fallback
    raise ValueError(f"frame_store must be auto/hbm/host, not {mode!r}")
