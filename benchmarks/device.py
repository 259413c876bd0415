"""What every measurement script shares: the device it runs on, its
published peaks, and a timer that waits for the device.

A measurement needs a GPU: ``require_gpu`` raises on any other platform,
so no CPU number is ever printed under a device metric's name.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

#: Published peaks by ``device_kind`` (NVIDIA H100 SXM data sheet, dense
#: rates without sparsity, at the 700 W power limit).  A card set below
#: that limit cannot hold these rates under load; ``card()`` reports it.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "bf16_flops": 989e12,
        "tf32_flops": 495e12,
        "f32_flops": 67e12,
        "int8_ops": 1979e12,
    },
}


def require_gpu():
    """The first device, which must be a GPU; raises otherwise."""
    import jax

    from remap_tpu.utils import backend

    dev = jax.devices()[0]
    if not backend.on_gpu():
        raise SystemExit(
            f"no GPU: JAX found {dev.platform!r} ({dev.device_kind}); "
            "measurements run on the card only"
        )
    return dev


def peaks(device_kind: str) -> dict:
    """Peak rates of a device kind; a kind not in PEAKS is an error."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for {device_kind!r}; add them to PEAKS"
        ) from None


def card() -> str:
    """``name, power.limit`` of each card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30,
    )
    return out.stdout.strip()


def describe() -> dict:
    """platform, device_kind and count of the visible devices."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def timeit(fn, *args, reps: int = 10, warmup: int = 1) -> dict:
    """Wall time of ``fn(*args)`` per call, each ending in
    ``block_until_ready``: median and spread over ``reps`` calls, after
    ``warmup`` calls whose first one compiles (reported as ``first_s``)."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    for _ in range(warmup - 1):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return {
        "first_s": first,
        "median_ms": statistics.median(times) * 1e3,
        "min_ms": min(times) * 1e3,
        "max_ms": max(times) * 1e3,
        "reps": reps,
    }


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)
