"""The backend module's choices, the compile cache's directory and the
CLI's GPU requirement — everything that differs by device, checked on
the CPU with the device's answers stubbed."""

import os
import subprocess
import sys

import numpy as np
import pytest

from remap_tpu.utils import backend, runtime


@pytest.fixture
def on_platform(monkeypatch):
    def set_platform(name):
        monkeypatch.setattr(backend, "platform", lambda: name)

    return set_platform


@pytest.mark.parametrize("platform,kernels,expect", [
    ("gpu", None, backend.TRITON),
    ("gpu", False, backend.XLA),
    ("gpu", True, backend.TRITON),
    ("cpu", None, backend.XLA),
    ("cpu", True, backend.TRITON),     # forced: runs interpreted
])
def test_extract_path_follows_device(on_platform, platform, kernels,
                                     expect):
    on_platform(platform)
    assert backend.extract_path(256, 240, 256, kernels) == expect
    assert backend.interpret() == (platform != "gpu")


@pytest.mark.parametrize("b,h,w,expect", [
    (256, 312, 388, backend.TRITON),      # C64 batch
    (1, 2048, 3328, backend.TRITON),      # session-scale splice canvas
    (4096, 480, 640, backend.XLA),        # code words past int32 offsets
])
def test_extract_path_by_shape(on_platform, b, h, w, expect):
    on_platform("gpu")
    assert backend.extract_path(b, h, w) == expect


@pytest.mark.parametrize("kernels,expect", [
    (None, backend.XLA),       # the CPU: the device picks XLA
    (False, backend.XLA),
    (True, backend.TRITON),    # forced: the kernel runs interpreted
])
def test_traced_calls_record_their_path(monkeypatch, kernels, expect):
    """A traced ``extract_dense`` leaves the path that ran behind; a
    cached call traces nothing."""
    import jax
    import jax.numpy as jnp

    from remap_tpu.core.regions import make_layout
    from remap_tpu.ops import kpe

    monkeypatch.setattr(backend, "TRACED", set())
    layout = make_layout(32, 24, 4, 2, 8)
    fn = jax.jit(lambda im: kpe.extract_dense(im, layout, kernels).weight)
    jax.clear_caches()
    fn(jnp.zeros((2, 24, 32), jnp.uint8))
    assert backend.TRACED == {("extract", (2, 24, 32), expect)}
    backend.TRACED.clear()
    fn(jnp.zeros((2, 24, 32), jnp.uint8))
    assert backend.TRACED == set()


def test_traced_summary():
    traced = {("extract", (256, 312, 388), backend.TRITON),
              ("extract", (1, 300, 900), backend.TRITON),
              ("extract", (1, 300, 1000), backend.TRITON),
              ("extract", (4096, 480, 640), backend.XLA)}
    assert backend.traced_summary(traced, limit=2) == (
        "extract=triton for 3 shape(s) [1x300x900, 1x300x1000 +1 more]; "
        "extract=xla for 1 shape(s) [4096x480x640]")
    assert backend.traced_summary(set()) == "xla only"


@pytest.mark.parametrize("platform,mode,stats,expect", [
    ("gpu", "auto", {"bytes_limit": 60 << 30}, 30 << 30),
    ("gpu", "hbm", {"bytes_limit": 60 << 30}, 30 << 30),
    ("gpu", "host", {"bytes_limit": 60 << 30}, 0),
    ("cpu", "auto", {}, 0),
    ("cpu", "hbm", {}, 512 << 20),      # no limit reported: the fallback
])
def test_store_budget_from_memory_stats(on_platform, platform, mode, stats,
                                        expect):
    on_platform(platform)
    assert backend.store_budget(mode, stats, fallback=512 << 20) == expect


def test_store_budget_rejects_unknown_mode(on_platform):
    on_platform("gpu")
    with pytest.raises(ValueError):
        backend.store_budget("vmem", {"bytes_limit": 1 << 30})


def test_device_memory_limit_reads_bytes_limit():
    assert backend.device_memory_limit({"bytes_limit": 123}) == 123
    assert backend.device_memory_limit({"bytes_in_use": 5}) == 0


def test_collect_store_follows_frame_store(on_platform, monkeypatch):
    from remap_tpu.config import PipelineConfig
    from remap_tpu.pipeline import collect

    on_platform("gpu")
    monkeypatch.setattr(backend, "device_memory_limit",
                        lambda stats=None: 40 << 30)
    store = collect.new_store(8, 8, PipelineConfig(frame_store="auto"))
    assert store.device_budget == 20 << 30
    store = collect.new_store(8, 8, PipelineConfig(frame_store="host"))
    assert store.device_budget == 0


@pytest.mark.parametrize("env,expect", [
    (None, str(runtime.DEFAULT_CACHE_DIR)),
    ("/some/where/cache", "/some/where/cache"),
])
def test_cache_dir_resolution(monkeypatch, env, expect):
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
    assert runtime.cache_dir() == expect


def test_default_cache_dir_is_inside_the_checkout():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert str(runtime.DEFAULT_CACHE_DIR) == os.path.join(root, ".jax_cache")
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_setup_cache_sets_no_dir_when_env_is_set(monkeypatch, tmp_path):
    import jax

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert runtime.setup_cache() == str(tmp_path / "c")
    assert jax.config.jax_compilation_cache_dir == before
    assert not (tmp_path / "c").exists()


def test_cli_refuses_without_gpu(tmp_path):
    """Without ``--cpu`` the CLI needs a GPU: on the CPU it exits 1
    before reading any frame."""
    frames = tmp_path / "clip"
    frames.mkdir()
    np.zeros((8, 8), np.uint8).tofile(str(frames / "0"))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-m", "remap_tpu.cli", str(frames), "--width",
         "8", "--height", "8", "--out-prefix", str(tmp_path / "m")],
        capture_output=True, text=True, cwd=root, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert r.returncode == 1
    assert "no GPU" in r.stderr and "--cpu" in r.stderr
    assert not list(tmp_path.glob("m*.png"))
