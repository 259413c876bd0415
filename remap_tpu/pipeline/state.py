"""Pipeline state containers: fragments and the frame store.

The reference keeps every frame in RAM as RLE-compressed bytes inside the
fragment records (fgm.hpp:27-37, frc.hpp:129-135) so the foreground pass
can re-read them (fdf.hpp:60-66).  Here frames and medians live in a
host-side :class:`FrameStore` as packed 4-bit nibbles (2 px/byte) — O(1)
random access, zero decode cost on device upload — with the RLE codec
available as an alternative backend (io.codec) for byte-parity and smaller
footprints.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


def pack_nibbles(img: np.ndarray) -> np.ndarray:
    """[H, W] uint8 (values < 16) -> [H, ceil(W/2)] uint8."""
    h, w = img.shape
    if w % 2:
        img = np.pad(img, ((0, 0), (0, 1)))
    return (img[:, 0::2] << 4) | img[:, 1::2]


def unpack_nibbles_device(packed, width: int):
    """Device-side unpack: [..., Wp] uint8 -> [..., width] uint8.

    Frames ride the (slow) host->device link packed 2 px/byte and expand
    on device."""
    import jax.numpy as jnp

    hi = packed >> 4
    lo = packed & 0x0F
    out = jnp.stack([hi, lo], axis=-1).reshape(*packed.shape[:-1], -1)
    return out[..., :width]


def unpack_nibbles(packed: np.ndarray, width: int) -> np.ndarray:
    h = packed.shape[0]
    out = np.empty((h, packed.shape[1] * 2), dtype=np.uint8)
    out[:, 0::2] = packed >> 4
    out[:, 1::2] = packed & 0x0F
    return out[:, :width]


class FrameStore:
    """Packed-nibble storage of frame + median images by frame number.

    The host copy is authoritative.  When the collect pass hands over
    the device buffers it already uploaded (``device_packed`` /
    ``device_packed_medians``), the store additionally keeps
    device-resident mirrors so later passes (blit, foreground) gather
    frames and medians from HBM instead of re-crossing the
    host->device link — the device-resident answer to the reference's
    keep-everything-in-RAM design (frc.hpp:129-135, nic.hpp:8-166).
    The mirrors are bounded by ``device_budget`` bytes (combined) and
    silently drop for sessions that exceed it — every consumer falls
    back to uploading the host copy.  ``PipelineConfig.frame_store``
    selects the budget (utils.backend.store_budget): "hbm" sizes it for
    session scale, a share of the device's memory limit (a 100k NES
    session is ~6.2 GB packed), "host" disables the mirrors, "auto" is
    "hbm" on an accelerator and "host" on the CPU."""

    #: default mirror budget (bytes of packed frames + medians), ~17k NES
    #: frames; also the "hbm" budget of a device that reports no limit
    DEVICE_MIRROR_CAP = 512 << 20

    def __init__(self, height: int, width: int, device_budget=None):
        self.height = height
        self.width = width
        self.device_budget = (
            self.DEVICE_MIRROR_CAP if device_budget is None
            else device_budget
        )
        self._images: Dict[int, np.ndarray] = {}
        self._medians: Dict[int, np.ndarray] = {}
        self._dev_parts: list = []    # device arrays, contiguous numbers
        self._dev_count = 0           # frames covered: numbers [0, n)
        self._dev_bytes = 0
        self._dev_stack = None        # concatenated mirror (lazy)
        self._dev_parts_m: list = []  # median mirror (same structure)
        self._dev_count_m = 0
        self._dev_stack_m = None

    def _invalidate_mirror(self, numbers) -> None:
        """Drop the device mirrors if a mirrored row is being replaced
        (host copy is authoritative; stale HBM rows must never win)."""
        if self._dev_parts and any(n < self._dev_count for n in numbers):
            self._dev_parts = None
            self._dev_stack = None
            self._dev_count = 0
        if self._dev_parts_m and any(
            n < self._dev_count_m for n in numbers
        ):
            self._dev_parts_m = None
            self._dev_stack_m = None
            self._dev_count_m = 0

    def put(self, number: int, image: np.ndarray, median: np.ndarray) -> None:
        self._invalidate_mirror([number])
        self._images[number] = pack_nibbles(image)
        self._medians[number] = pack_nibbles(median)

    def put_batch(
        self,
        numbers: List[int],
        images: np.ndarray,
        medians: Optional[np.ndarray] = None,
    ) -> None:
        self._invalidate_mirror(numbers)
        packed_i = pack_nibbles_batch(images)
        packed_m = pack_nibbles_batch(medians) if medians is not None else None
        for k, no in enumerate(numbers):
            self._images[no] = packed_i[k]
            if packed_m is not None:
                self._medians[no] = packed_m[k]

    def put_packed_batch(
        self,
        numbers: List[int],
        packed_images: np.ndarray,   # [B, H, ceil(W/2)] uint8
        packed_medians: Optional[np.ndarray] = None,
        device_packed: Optional[object] = None,  # same rows, on device
        device_packed_medians: Optional[object] = None,
    ) -> None:
        """Store already-packed rows (the native feed's output format).

        ``device_packed`` / ``device_packed_medians`` donate the device
        copies of the same rows to the mirrors (kept only while batches
        arrive contiguously from frame 0 and the budget holds)."""
        if device_packed is None:
            self._invalidate_mirror(numbers)
        for k, no in enumerate(numbers):
            self._images[no] = packed_images[k]
            if packed_medians is not None:
                self._medians[no] = packed_medians[k]
        if device_packed is not None and self._dev_parts is not None:
            contiguous = list(numbers) == list(
                range(self._dev_count, self._dev_count + len(numbers))
            )
            nbytes = int(np.prod(device_packed.shape))
            if (
                contiguous
                and self._dev_bytes + nbytes <= self.device_budget
            ):
                self._dev_parts.append(device_packed)
                self._dev_count += len(numbers)
                self._dev_bytes += nbytes
                self._dev_stack = None
            else:
                self._dev_parts = None   # disabled for this store
                self._dev_stack = None
                self._dev_count = 0
        if (
            device_packed_medians is not None
            and self._dev_parts_m is not None
        ):
            contiguous = list(numbers) == list(
                range(self._dev_count_m, self._dev_count_m + len(numbers))
            )
            nbytes = int(np.prod(device_packed_medians.shape))
            if (
                contiguous
                and self._dev_bytes + nbytes <= self.device_budget
            ):
                self._dev_parts_m.append(device_packed_medians)
                self._dev_count_m += len(numbers)
                self._dev_bytes += nbytes
                self._dev_stack_m = None
            else:
                self._dev_parts_m = None
                self._dev_stack_m = None
                self._dev_count_m = 0

    @staticmethod
    def _gather(parts_attr, stack, numbers):
        import jax.numpy as jnp

        if stack is None:
            stack = (
                parts_attr[0]
                if len(parts_attr) == 1
                else jnp.concatenate(parts_attr, axis=0)
            )
        return stack, stack[jnp.asarray(np.asarray(numbers, np.int32))]

    def device_packed_batch(self, numbers: List[int]):
        """Device [B, H, ceil(W/2)] uint8 for ``numbers`` — gathered
        from the HBM mirror when available, uploaded otherwise."""
        import jax.numpy as jnp

        if (
            self._dev_parts
            and all(0 <= n < self._dev_count for n in numbers)
        ):
            self._dev_stack, rows = self._gather(
                self._dev_parts, self._dev_stack, numbers
            )
            self._dev_parts = [self._dev_stack]
            return rows
        return jnp.asarray(self.packed_images_batch(numbers))

    def device_packed_medians_batch(self, numbers: List[int]):
        """Device packed medians for ``numbers`` from the HBM median
        mirror, uploading the host copy otherwise — the foreground
        pass's second link-crossing removed when the session fits."""
        import jax.numpy as jnp

        if (
            self._dev_parts_m
            and all(0 <= n < self._dev_count_m for n in numbers)
        ):
            self._dev_stack_m, rows = self._gather(
                self._dev_parts_m, self._dev_stack_m, numbers
            )
            self._dev_parts_m = [self._dev_stack_m]
            return rows
        return jnp.asarray(self.packed_medians_batch(numbers))

    def image(self, number: int) -> np.ndarray:
        return unpack_nibbles(self._images[number], self.width)

    @property
    def has_medians(self) -> bool:
        return bool(self._medians)

    def median(self, number: int) -> np.ndarray:
        return unpack_nibbles(self._medians[number], self.width)

    def images_batch(self, numbers: List[int]) -> np.ndarray:
        return np.stack([self.image(n) for n in numbers])

    def packed_images_batch(self, numbers: List[int]) -> np.ndarray:
        """Packed [B, H, ceil(W/2)] uint8 — upload these and unpack on
        device (unpack_nibbles_device)."""
        return np.stack([self._images[n] for n in numbers])

    def medians_batch(self, numbers: List[int]) -> np.ndarray:
        return np.stack([self.median(n) for n in numbers])

    def packed_medians_batch(self, numbers: List[int]) -> np.ndarray:
        """Packed [B, H, ceil(W/2)] uint8 medians — upload these and
        unpack on device: halves the host->device median traffic the
        foreground pass pays per batch and skips the host unpack loop."""
        return np.stack([self._medians[n] for n in numbers])

    @property
    def nbytes(self) -> int:
        return sum(a.nbytes for a in self._images.values()) + sum(
            a.nbytes for a in self._medians.values()
        )

    def __len__(self) -> int:
        return len(self._images)


def pack_nibbles_batch(imgs: np.ndarray) -> np.ndarray:
    b, h, w = imgs.shape
    if w % 2:
        imgs = np.pad(imgs, ((0, 0), (0, 0), (0, 1)))
    return (imgs[:, :, 0::2] << 4) | imgs[:, :, 1::2]


def pack_nibbles_device(imgs):
    """Device-side pack_nibbles_batch (jit-traceable, any leading dims):
    packing BEFORE the device->host download halves the median traffic
    collect pays per batch."""
    import jax.numpy as jnp

    if imgs.shape[-1] % 2:
        imgs = jnp.pad(
            imgs, [(0, 0)] * (imgs.ndim - 1) + [(0, 1)]
        )
    return (imgs[..., 0::2] << 4) | imgs[..., 1::2]


@dataclasses.dataclass(eq=False)
class FrameRef:
    number: int
    position: Tuple[int, int]  # (x, y) in fragment coordinate space


class Fragment:
    """A stitched map fragment: vote-histogram canvas + frame records.

    ``dots`` uses the reference's exact canvas dimensions (growth simulated
    arithmetically, fgm.hpp:190-233) so downstream keypoint extraction sees
    identical bounds.  ``zero`` is the canvas origin in position space;
    after :meth:`normalize` all record positions are canvas indices.

    The canvas may be **device-resident**: a session-scale [H, W, 16]
    uint16 canvas is ~0.5 GB, and keeping it on the device spares five
    host<->device crossings between collect and clean (download, splice
    upload, merged re-upload, foreground round-trip, clean upload).
    Stages that produce the canvas on device (collect.blit_pass,
    foreground) hand it over as ``dots_dev``; stages
    that consume it on device call :meth:`device_dots`.  Reading
    ``.dots`` lazily materializes (downloads) the host copy — the
    checkpoint writer and NumPy-level tests see the exact same array
    they always did, while the production pipeline never crosses the
    link.  Assigning ``.dots`` invalidates the device mirror (host copy
    is authoritative, as in :class:`FrameStore`)."""

    def __init__(
        self,
        dots: Optional[np.ndarray] = None,    # [Ha, Wa, 16] uint16
        zero: Tuple[int, int] = (0, 0),
        frames: Optional[List[FrameRef]] = None,
        store: Optional[FrameStore] = None,
        dots_dev=None,                        # same canvas, on device
    ):
        assert dots is not None or dots_dev is not None
        self._dots = dots
        self.dots_dev = dots_dev
        self.zero = zero
        self.frames = frames if frames is not None else []
        self.store = store

    @property
    def dots(self) -> np.ndarray:
        if self._dots is None:
            self._dots = np.asarray(self.dots_dev)
        return self._dots

    @dots.setter
    def dots(self, value: np.ndarray) -> None:
        self._dots = value
        self.dots_dev = None

    def device_dots(self):
        """The canvas on device (uploads and caches the host copy when
        no device mirror exists)."""
        if self.dots_dev is None:
            import jax.numpy as jnp

            self.dots_dev = jnp.asarray(self._dots)
        return self.dots_dev

    def drop_device(self) -> None:
        """Release the HBM mirror (materializes the host copy first)."""
        if self.dots_dev is not None:
            _ = self.dots
            self.dots_dev = None

    def normalize(self) -> None:
        zx, zy = self.zero
        for f in self.frames:
            f.position = (f.position[0] - zx, f.position[1] - zy)
        self.zero = (0, 0)

    @property
    def shape(self) -> Tuple[int, int]:
        a = self._dots if self._dots is not None else self.dots_dev
        return a.shape[0], a.shape[1]


def simulate_growth(
    positions: List[Tuple[int, int]], frame_w: int, frame_h: int
) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Replay fgm's step-quantised canvas growth (fgm.hpp:190-233) without
    data: returns (zero, (canvas_w, canvas_h)) after blitting frames of
    ``frame_w x frame_h`` at ``positions`` in order."""

    def round_step(change: int, step: int) -> int:
        rest = change % step
        return change - rest + (step if rest else 0)

    zx, zy = 0, 0
    cw, ch = frame_w, frame_h
    for px, py in positions:
        gl = round_step(zx - px, frame_w) if px < zx else 0
        gr = (
            round_step(px + frame_w - (zx + cw), frame_w)
            if px + frame_w > zx + cw
            else 0
        )
        gt = round_step(zy - py, frame_h) if py < zy else 0
        gb = (
            round_step(py + frame_h - (zy + ch), frame_h)
            if py + frame_h > zy + ch
            else 0
        )
        zx -= gl
        zy -= gt
        cw += gl + gr
        ch += gt + gb
    return (zx, zy), (cw, ch)
