"""Map builder: the five-stage orchestrator (mpb.hpp:28-41).

``build()`` = window scan -> cropped re-feed -> collect -> splice ->
foreground filter -> artifact clean -> native-code map images.  Every
stage boundary invokes the callbacks object with full intermediate state —
the reference's observability seam (mpb.hpp:44-77, main.cpp:127-192) —
and can checkpoint fragments to disk (io.checkpoint, the reference's
unused ful.hpp made real).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, List, Optional, Sequence

import numpy as np

from remap_tpu.config import PipelineConfig
from remap_tpu.core.geometry import Rect
from remap_tpu.pipeline import clean as clean_stage
from remap_tpu.pipeline import collect as collect_stage
from remap_tpu.pipeline import foreground as fg_stage
from remap_tpu.pipeline import splice as splice_stage
from remap_tpu.pipeline import window as window_stage
from remap_tpu.pipeline.state import Fragment
from remap_tpu.spec.aws import WindowInfo


class Callbacks:
    """Per-stage observation hooks (default: no-ops).

    Mirrors the reference's callbacks seam: every stage hands back its
    full intermediate state (mpb.hpp:44-77)."""

    def on_window(self, window: Optional[WindowInfo]) -> None: ...

    def on_collect(self, result: collect_stage.CollectResult) -> None: ...

    def on_splice(self, fragments: List[Fragment]) -> None: ...

    def on_filter(self, fragments: List[Fragment]) -> None: ...

    def on_clean(self, images: List[np.ndarray]) -> None: ...

    def on_checkpoint(self, tag: str, seconds: float) -> None:
        """After a stage checkpoint is written (tag = "collect" or
        "filtered").  Lets wall-clock observers attribute the save time
        to checkpointing instead of the following stage — a 100k-frame
        store compression is minutes, not noise."""
        ...


class PerfCallbacks(Callbacks):
    """Per-stage wall-clock fps, in the spirit of the reference's
    perf_counter prints (main.cpp:54-110)."""

    def __init__(self) -> None:
        import time

        self._t = time.perf_counter
        self._last = self._t()

    def _stage(self, name: str, frames: int) -> None:
        now = self._t()
        dt = max(now - self._last, 1e-9)
        fps = f"{frames / dt:8.1f} fps" if frames else " " * 12
        print(f"[{name}] {dt:6.2f} s  {fps}")
        self._last = now

    def on_window(self, window) -> None:
        self._stage("aws", 0)

    def on_collect(self, result) -> None:
        self._stage("frc", len(result.offsets))

    def on_splice(self, fragments) -> None:
        self._stage("fgs", 0)

    def on_filter(self, fragments) -> None:
        self._stage("fdf", sum(len(f.frames) for f in fragments))

    def on_clean(self, images) -> None:
        self._stage("arf", 0)


@dataclasses.dataclass
class BuildResult:
    maps: List[np.ndarray]
    window: Optional[WindowInfo]
    fragments: List[Fragment]
    collect: Optional[collect_stage.CollectResult]


def _save_checkpoint(
    cb: Callbacks,
    checkpoint_dir: Optional[str],
    tag: str,
    fragments: List[Fragment],
    include_store: bool = True,
):
    """Write the stage checkpoint on a worker thread.

    Compression is pure host work while the following stage is
    device-bound, so the save overlaps it instead of sitting between
    the stage callbacks (a 100k store used to add minutes of apparent
    stage wall).  Safe because no later stage mutates the store or the
    saved fragments' dot canvases (splice builds new arrays).  Returns
    the thread; the builder joins it before the next save and before
    returning."""
    if not checkpoint_dir:
        return None
    import threading
    import time

    from remap_tpu.io import checkpoint

    def work():
        t0 = time.perf_counter()
        checkpoint.save(checkpoint_dir, tag, fragments, include_store)
        cb.on_checkpoint(tag, time.perf_counter() - t0)

    th = threading.Thread(target=work, daemon=True)
    th.start()
    return th


def _checkpoint_stage(checkpoint_dir: str) -> Optional[str]:
    """Latest resumable stage saved under checkpoint_dir, if any."""
    import os

    for tag in ("filtered", "collect"):
        if os.path.exists(os.path.join(checkpoint_dir, tag, "meta.json")):
            return tag
    return None


def build(
    frames_factory: Callable[[], Iterable[np.ndarray]],
    cfg: PipelineConfig,
    callbacks: Optional[Callbacks] = None,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
) -> BuildResult:
    """``frames_factory()`` must yield the frame stream anew on each call
    (the reference re-feeds the files after the window scan, mpb.hpp:32).

    With ``resume`` and an existing checkpoint under ``checkpoint_dir``,
    the pipeline restarts from the latest saved stage boundary (the
    reference's unused ful.hpp made into a real resume loop): a
    ``filtered`` checkpoint skips straight to the artifact clean, a
    ``collect`` checkpoint skips the window scan and collection.
    """
    cb = callbacks or Callbacks()

    if resume and checkpoint_dir:
        from remap_tpu.io import checkpoint

        stage = _checkpoint_stage(checkpoint_dir)
        if stage == "filtered":
            filtered = checkpoint.load(checkpoint_dir, "filtered")
            cb.on_filter(filtered)
            maps = clean_stage.clean(filtered, cfg)
            cb.on_clean(maps)
            return BuildResult(
                maps=maps, window=None, fragments=filtered, collect=None
            )
        if stage == "collect":
            frags = checkpoint.load(checkpoint_dir, "collect")
            spliced = splice_stage.splice(frags, cfg)
            cb.on_splice(spliced)
            filtered = fg_stage.filter_fragments(spliced, cfg)
            cb.on_filter(filtered)
            t_save = _save_checkpoint(
                cb, checkpoint_dir, "filtered", filtered,
                include_store=False,
            )
            maps = clean_stage.clean(filtered, cfg)
            cb.on_clean(maps)
            if t_save is not None:
                t_save.join()
            return BuildResult(
                maps=maps, window=None, fragments=filtered, collect=None
            )

    window = window_stage.scan(frames_factory(), cfg)
    cb.on_window(window)
    if window is None:
        return BuildResult(maps=[], window=None, fragments=[], collect=None)

    crop = window.crop

    probe = frames_factory()
    if hasattr(probe, "with_crop"):
        # feeds (io.frames) re-crop natively: collect then reads packed
        # batches straight off disk (native/feed.cpp fast path).  The
        # window scan saw the feed's *already-cropped* frames, so compose
        # with any pre-existing crop rather than replacing it.
        base = getattr(probe, "crop", None)
        if base is not None:
            crop_abs = Rect(
                left=base.left + crop.left,
                top=base.top + crop.top,
                right=base.left + crop.right,
                bottom=base.top + crop.bottom,
            )
        else:
            crop_abs = crop
        source = probe.with_crop(crop_abs)
    else:
        def cropped(src=probe):
            for f in src:
                yield f[crop.top : crop.bottom, crop.left : crop.right]

        source = cropped()

    col = collect_stage.collect(source, cfg)
    cb.on_collect(col)
    t_save = _save_checkpoint(cb, checkpoint_dir, "collect", col.fragments)

    spliced = splice_stage.splice(col.fragments, cfg)
    cb.on_splice(spliced)

    filtered = fg_stage.filter_fragments(spliced, cfg)
    cb.on_filter(filtered)
    if t_save is not None:
        t_save.join()
    # the store is not re-saved: arf (the only stage past this point)
    # reads nothing but the dot canvases, and the collect checkpoint
    # already holds the frames — re-compressing the multi-GB store here
    # used to hide minutes inside the "arf" stage wall
    t_save = _save_checkpoint(
        cb, checkpoint_dir, "filtered", filtered, include_store=False
    )

    maps = clean_stage.clean(filtered, cfg)
    cb.on_clean(maps)
    if t_save is not None:
        t_save.join()
    return BuildResult(
        maps=maps, window=window, fragments=filtered, collect=col
    )


def build_from_frames(
    frames: Sequence[np.ndarray],
    cfg: PipelineConfig,
    **kwargs,
) -> BuildResult:
    return build(lambda: iter(frames), cfg, **kwargs)
