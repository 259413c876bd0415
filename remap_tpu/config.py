"""Typed configuration for the whole pipeline.

The reference scatters its constants across headers (screen dims and filter
constants on the adapter, grid shape in frc.hpp:22-26, match thresholds in
kpm.hpp:206/388/401, kernel sizes in kpe.hpp:16-17, …).  Here every tunable
lives in one frozen dataclass so a run is fully described by one value.

Reference constant inventory (file:line cites into /root/reference/src):

- screen 388x312, artifact dev 2.0, filter size 15   (main.cpp:199-201)
- grid 4x2, overlap 16                                (frc.hpp:22-24)
- weight_switch 10, region_votes 3                    (frc.hpp:32-34)
- kernel 5 / kernel_half 2                            (kpe.hpp:16-17)
- max_weight 3                                        (kpr.hpp:96)
- aws: min area 1/3, height 2/5, width 2/3, stagnation 100 (aws.hpp:110-118)
- fde foreground area limit 1/5                       (fde.hpp:94)
- fgs cell 15x15, weight_switch SIZE_MAX              (fgs.hpp:105-122)
- kpm: >=1/4 regions active, runner-up margin active/2,
  0.66 matched-cell ratio                             (kpm.hpp:206,388,401)
- fgm histogram depth 16                              (fgm.hpp:12)

Device-specific additions (no reference equivalent): fixed keypoint-table
capacities (replacing the reference's unbounded hash maps, kpr.hpp:105-110),
frame batch size for device dispatch, and atlas padding granularity
(replacing fgm's dynamic matrix growth, fgm.hpp:190-233).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Vote-matching thresholds (kpm.hpp; frc.hpp:30-44, fgs.hpp:105-117)."""

    #: Use only weight-2 keypoints when both frames have "enough" of them:
    #: all weights are used iff ``prev_w2 < weight_switch or curr_w2 <=
    #: weight_switch`` (kpm.hpp:213-223).  frc uses 10; fgs uses "infinity"
    #: (always all weights).
    weight_switch: int = 10
    #: Top offsets kept per region before the Borda count (kpm.hpp:132).
    region_votes: int = 3


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    # --- frame geometry -------------------------------------------------
    #: (width, height) of the raw input frames.  Reference: 388x312 C64
    #: capture (main.cpp:199).  The streaming benchmark runs NES 256x240.
    screen_width: int = 388
    screen_height: int = 312

    # --- keypoint extraction (kpe) --------------------------------------
    kernel_size: int = 5          # kpe.hpp:16
    #: Grid of keypoint regions and the shared-band overlap (frc.hpp:22-24).
    grid_width: int = 4
    grid_height: int = 2
    grid_overlap: int = 16

    # --- matching (kpm) -------------------------------------------------
    match: MatchConfig = dataclasses.field(default_factory=MatchConfig)
    #: Minimum fraction of active regions to even attempt a frame match:
    #: ``active >= region_count // 4`` (kpm.hpp:400-403).
    min_active_divisor: int = 4
    #: Winner must lead runner-up by ``active // 2`` Borda points
    #: (kpm.hpp:206).
    runner_up_divisor: int = 2

    # --- fragment splicing (fgs) ----------------------------------------
    splice_cell: Tuple[int, int] = (15, 15)       # fgs.hpp:121
    #: matched_cells >= 0.66 * active_cells (kpm.hpp:388).
    splice_cell_ratio: float = 0.66
    #: Correlation-family splice acceptance (matcher != "grid_vote"):
    #: peak agreement >= ratio * overlap, overlap >= min_overlap pixels.
    splice_xcorr_ratio: float = 0.85
    splice_min_overlap: int = 1024

    # --- action window scan (aws) ---------------------------------------
    aws_min_area_divisor: int = 3       # area > screen_area/3   (aws.hpp:110)
    aws_min_height_num: int = 2         # h > 2*H/5              (aws.hpp:111)
    aws_min_height_den: int = 5
    aws_min_width_num: int = 2          # w > 2*W/3              (aws.hpp:112)
    aws_min_width_den: int = 3
    aws_stagnation_limit: int = 100     # aws.hpp:118
    #: Window-discovery mode.  "parity" replicates the reference exactly —
    #: including two regimes where it (and therefore we, byte-for-byte)
    #: emit NO maps at all (PARITY.md): the top-HUD tie latch (every
    #: CHANGED contour scores 0 in aws.hpp:62-69, so a live status bar
    #: ABOVE the play area wins every tie from its first change onward)
    #: and chrome-speck stagnation starvation (transient glitches on the
    #: static border/HUD re-mark the change heatmap forever,
    #: aws.hpp:37-96).  "robust" is a deliberate divergence that still
    #: produces maps on such captures: the window candidate is the
    #: LARGEST changed contour (not the first tied one), and a pixel
    #: must change more than ``aws_change_tolerance`` times before it is
    #: marked (transient specks are debounced; real action areas change
    #: constantly).
    discovery: str = "parity"
    #: "robust" discovery only: per-pixel change events tolerated before
    #: the heatmap marks the pixel as changing (a single transient glitch
    #: produces exactly two events: appear + disappear).
    aws_change_tolerance: int = 2

    # --- foreground extraction (fde) ------------------------------------
    #: Drop foreground contours with area > frame_area/5 (fde.hpp:94).
    fde_area_divisor: int = 5

    # --- artifact filter (arf) ------------------------------------------
    artifact_filter_size: int = 15      # main.cpp:201
    artifact_filter_dev: float = 2.0    # main.cpp:200
    #: Heat threshold: rare-pattern pixels have 1/sqrt((h+v)/2) > 0.25
    #: (arf.hpp:280).
    artifact_heat_threshold: float = 0.25

    # --- atlas (fgm) ----------------------------------------------------
    palette_depth: int = 16             # fgm.hpp:12

    # --- model family (alignment engine) --------------------------------
    #: "grid_vote" (reference-parity keypoint voting), "xcorr" (dense FFT
    #: correlation) or "pyramid" (coarse-to-fine xcorr for high-res).
    matcher: str = "grid_vote"

    # --- device execution parameters (new design surface) ---------------
    #: Fixed per-region keypoint-table capacity for frame matching.  The
    #: reference's hash maps are unbounded (kpr.hpp:105-110); we use static
    #: tables and report overflow so callers can re-run with more capacity.
    region_capacity: int = 512
    #: Capacity of the single whole-image region used in fragment splicing
    #: (fgs uses a 1x1 grid, fgs.hpp:17).
    splice_capacity: int = 2048
    #: How many dispatched collect batches may be in flight before the
    #: host blocks fetching the oldest one's outputs.  Depth 1 is classic
    #: double buffering (drain one batch late); deeper chains keep the
    #: device busy while the host drains.  Device memory grows by one
    #: batch of outputs per slot.
    collect_drain_depth: int = 8
    #: Region-table compaction backend: "auto" is the flat "topk".  All modes
    #: ("topk", "sort", "sort2") select the same first-capacity row-major
    #: keypoints; "sort2" additionally flags overflow when a 512-px chunk
    #: exceeds its keep quota (ops.tables.SORT2_QUOTA) — the escalation
    #: path then re-runs exactly, so results never silently diverge.
    table_mode: str = "auto"
    #: Vote counting: 0 = exact sort over the full offset range;
    #: > 0 = bounded-offset one-hot matmul histogram of radius
    #: ``vote_radius``
    #: (out-of-range votes flag overflow and the strict collect loop
    #: escalates to the exact path, so results never silently truncate).
    vote_radius: int = 0
    #: Max same-code multiplicity handled exactly by the sort-merge join
    #: in the matcher (overflow is flagged; raise for pathological inputs).
    join_multiplicity: int = 4
    #: Store per-frame medians in the host FrameStore.  Off by default:
    #: medians are a pure function of the frame and are recomputed on
    #: device in the foreground pass, avoiding a large device->host
    #: download per batch (downloads are 10-100x slower than uploads on
    #: the benchmark harness).  The RLE/store parity path can re-enable.
    store_medians: bool = False
    #: Frame-store device residency: "hbm" keeps packed frames (and
    #: medians, when stored) mirrored in device HBM after collect so
    #: the foreground pass never re-crosses the host->device link
    #: (a share of the device's memory, utils.backend.store_budget);
    #: "host" disables the mirrors; "auto" = hbm on a GPU, host on CPU.
    frame_store: str = "auto"
    #: Frames per device dispatch in the batched collect path.
    frame_batch: int = 128
    #: Atlas dimensions are rounded up to multiples of this to bound the
    #: number of distinct compiled shapes (replaces fgm's step growth).
    atlas_pad: int = 128

    # ---------------------------------------------------------------------
    @property
    def screen_dims(self) -> Tuple[int, int]:
        """(height, width) — row-major array convention."""
        return (self.screen_height, self.screen_width)

    @property
    def kernel_half(self) -> int:
        return self.kernel_size // 2

    @property
    def region_count(self) -> int:
        return self.grid_width * self.grid_height

    def with_screen(self, width: int, height: int) -> "PipelineConfig":
        return dataclasses.replace(self, screen_width=width, screen_height=height)


#: Benchmark-target config: NES-resolution frames (BASELINE.json configs[0]).
NES = PipelineConfig(screen_width=256, screen_height=240)
#: SNES clip config (BASELINE.json configs[1]).
SNES = PipelineConfig(screen_width=256, screen_height=224)
#: The reference's own C64 capture format (main.cpp:199).
C64 = PipelineConfig(screen_width=388, screen_height=312)
#: High-res capture, pyramid matching, sharded over a device mesh
#: (BASELINE.json configs[4]).
VGA = PipelineConfig(screen_width=640, screen_height=480)
