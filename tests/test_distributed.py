"""Fake-DCN multi-host test: 2 CPU processes x 4 virtual devices.

Each subprocess joins a jax.distributed coordination service on
localhost, builds the global ('data', 'space') mesh from the 8 global
devices, assembles its local clips into a global batch, and runs the
sharded pipeline step.  Each process checks its addressable output shards
against the unsharded single-device step (run locally on the full batch).
This is the executable form of BASELINE.json config 5's multi-process story.
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import os, sys
import numpy as np

pid = int(sys.argv[1])
port = sys.argv[2]

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax

# pinned through the config, so a GPU-enabled JAX stays on the CPU too
# (see tests/conftest.py)
jax.config.update("jax_platforms", "cpu")

from remap_tpu.parallel import distributed as dist

dist.initialize(
    coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=pid
)
assert jax.process_count() == 2
assert jax.device_count() == 8
assert jax.local_device_count() == 4

from remap_tpu.config import PipelineConfig
from remap_tpu.core.regions import make_layout
from remap_tpu.parallel.mesh import make_mesh
from remap_tpu.parallel.sharded import make_pipeline_step, make_sharded_step
from remap_tpu.utils import testing

cfg = PipelineConfig(
    screen_width=96, screen_height=64, region_capacity=256, frame_batch=4
)
layout = make_layout(96, 64, cfg.grid_width, cfg.grid_height,
                     cfg.grid_overlap)
mesh = make_mesh(8, space=1)

C, T = 8, 4
clips = []
for s in range(C):
    clip = testing.simple_clip(
        n_frames=T, frame_hw=(64, 96), world_hw=(160, 224), seed=500 + s
    )
    clips.append(np.stack(clip.frames))
images = np.stack(clips)  # deterministic on both hosts

local = images[dist.local_clip_slice(C)]
garr = dist.make_global_batch(local, mesh)

step = make_sharded_step(mesh, layout, cfg, atlas_pad=16)
res = step(garr)

# expected: the unsharded step on this process's local device
plain = jax.jit(make_pipeline_step(layout, cfg, atlas_pad=16))
exp = plain(jax.device_put(images, jax.local_devices()[0]))
exp_off = np.asarray(exp.offsets)
exp_ok = np.asarray(exp.matched)

for shard in res.offsets.addressable_shards:
    ci = shard.index[0]
    np.testing.assert_array_equal(np.asarray(shard.data), exp_off[ci])
for shard in res.matched.addressable_shards:
    ci = shard.index[0]
    np.testing.assert_array_equal(np.asarray(shard.data), exp_ok[ci])

print(f"worker {pid} OK", flush=True)
"""


@pytest.mark.slow
def test_two_process_fake_dcn(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    script = tmp_path / "worker.py"
    script.write_text(_WORKER)

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            env=env,
            cwd=repo,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=560)
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
        assert f"worker {pid} OK" in out
