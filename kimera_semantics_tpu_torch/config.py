"""Configuration dataclasses of the PyTorch/CUDA port.

Counterpart: kimera_semantics_tpu/config.py. A field-for-field and
default-for-default copy, kept here so the port imports nothing of the JAX
package (tests/test_torch_core.py holds the two equal). Comments that speak
of the TPU describe the reference package's choices; the port keeps the same
fields and defaults so a configuration means the same thing in both.

Behavioral parity targets (reference: MIT-SPARK/Kimera-Semantics):
  - TSDF integrator options mirror voxblox `TsdfIntegratorBase::Config` as used by
    the reference launch files (kimera_semantics_ros/launch/kimera_semantics.launch:96-132).
  - Semantic options mirror `SemanticConfig`
    (kimera_semantics/include/kimera_semantics/semantic_integrator_base.h:68-87) and
    `getSemanticTsdfIntegratorConfigFromRosParam`
    (kimera_semantics_ros/src/ros_params.cpp:24-77).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Sequence, Tuple


class ColorMode(enum.Enum):
    """Mesh/voxel coloring mode.

    Mirrors `kimera::ColorMode` (semantic_integrator_base.h:57-62) and the string
    values accepted by ros_params.cpp:52-62.
    """

    COLOR = "color"                        # blended measured color (kColor)
    SEMANTIC = "semantic"                  # MLE label color (kSemantic)
    SEMANTIC_PROBABILITY = "semantic_probability"  # rainbow(exp(max log-odds))


class IntegratorType(enum.Enum):
    """Integrator selection. Mirrors `SemanticTsdfIntegratorType`
    (semantic_tsdf_integrator_factory.h:49-54): "merged"=0, "fast"=1."""

    MERGED = "merged"
    FAST = "fast"
    # voxblox TsdfIntegratorFactory's third type (inherited substrate
    # surface, SURVEY 2b); not exposed by the reference's semantic factory.
    SIMPLE = "simple"
    # TPU-native voxel-centric integrator (no reference equivalent by name;
    # same capability surface — see models/projective.py).
    PROJECTIVE = "projective"


# The reference initializes each voxel's 21 log-odds priors to the hard-coded
# constant -0.60205999132 (semantic_voxel.h:19-23). NB: the comment there claims
# log(1/21) but the constant is actually log10(1/4); we replicate the *constant*
# for parity. A uniform prior never affects the argmax label.
DEFAULT_UNIFORM_LOG_PRIOR = -0.60205999132

# Reference: kUnknownSemanticLabelId = 0 (common.h:21).
UNKNOWN_LABEL = 0


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Static geometry + capacity of the block-hashed voxel grid.

    The reference's `vxb::Layer` grows dynamically; under XLA we use a fixed
    capacity block table with overflow accounting (SURVEY.md section 7 design).
    """

    voxel_size: float = 0.05            # launch/kimera_semantics.launch:99
    voxels_per_side: int = 16           # STORAGE block side. The reference
                                        # uses 32 (launch:100); 16 packs TPU
                                        # tile groups better and samples near
                                        # blocks at a finer mip. Both run;
                                        # see io_voxels_per_side.
    block_capacity: int = 2048          # max allocated blocks (excl. trash slot)
    num_labels: int = 21                # runtime-configurable (ref: compile-time)
    world_extent_blocks: int = 512      # block coords in [-512, 512) per axis for
                                        # int32 key packing (10 bits + offset)
    io_voxels_per_side: int = 0         # externally-visible block side for
                                        # .vxblx interop (0 = same as storage).
                                        # The voxel-level state is identical
                                        # for any storage tiling (updates are
                                        # per voxel; finer blocks are a strict
                                        # sparsity refinement), so a user
                                        # vps=32 config runs on 16^3 storage
                                        # tiles and io/vxblx.py regroups 2x2x2
                                        # sibling tiles into true 32^3 blocks
                                        # at the serialization boundary.

    def __post_init__(self):
        # Flat voxel keys are int32: (capacity+1) * vps^3 must fit.
        if (self.block_capacity + 1) * self.vps3 >= 2 ** 31:
            raise ValueError(
                f"block_capacity={self.block_capacity} x vps^3={self.vps3} "
                "overflows int32 flat voxel keys; reduce capacity or vps")
        if self.block_capacity % 8:
            raise ValueError("block_capacity must be a multiple of 8 "
                             "(TPU sublane tile; grid/blocks.py row padding)")
        if self.io_voxels_per_side:
            if (self.io_voxels_per_side < self.voxels_per_side
                    or self.io_voxels_per_side % self.voxels_per_side):
                raise ValueError(
                    f"io_voxels_per_side={self.io_voxels_per_side} must be a "
                    f"multiple of voxels_per_side={self.voxels_per_side}")

    @property
    def io_vps(self) -> int:
        """Externally-visible (serialization) block side."""
        return self.io_voxels_per_side or self.voxels_per_side

    @property
    def padded_rows(self) -> int:
        """Rows per voxel channel: capacity + one 8-row tile so the trash
        slot (index == capacity) owns an exclusive sublane-tile group — the
        projective RMW kernel fetches channel rows in (8, V3) tile blocks
        (ops/pallas_kernels.py block_rmw_add). Rows capacity..capacity+7 are
        garbage by contract (the reference's discarded writes)."""
        return self.block_capacity + 8

    @property
    def vps3(self) -> int:
        return self.voxels_per_side ** 3

    @property
    def block_size(self) -> float:
        return self.voxel_size * self.voxels_per_side

    @property
    def table_size(self) -> int:
        # Open-addressing hash table, power-of-two, ~2x load headroom.
        return 1 << max(8, math.ceil(math.log2(self.block_capacity * 2)))


@dataclasses.dataclass(frozen=True)
class TsdfConfig:
    """Voxblox-equivalent TSDF integrator options (inherited surface, SURVEY 2b).

    Defaults follow the reference's canonical operating point
    (launch/kimera_semantics.launch:96-132) and voxblox defaults.
    """

    truncation_distance: float = 0.1     # voxblox default_truncation_distance
    max_ray_length_m: float = 5.0        # launch:101
    min_ray_length_m: float = 0.1        # voxblox default
    max_weight: float = 10000.0          # voxblox default
    use_const_weight: bool = False       # launch:104 sets true for gt; vxb default false
    use_weight_dropoff: bool = True      # voxblox default
    voxel_carving_enabled: bool = True   # launch:102
    allow_clear: bool = True             # voxblox default
    # Fast-integrator specifics (semantic_tsdf_integrator_fast.h:98-130):
    start_voxel_subsampling_factor: float = 2.0
    clear_checks_every_n_frames: int = 1
    # Merged-integrator specifics:
    enable_anti_grazing: bool = False
    # Free-space carving strategy for the ray-centric integrators:
    #   "decimated" (default): full-res rays traverse only the truncation
    #     band; free space is carved by octave-decimated ray jobs
    #     (ops/carve.py) — the TPU-native analogue of the reference's early
    #     ray termination (_fast.cpp:110-121), which likewise bounds
    #     redundant free-space updates. ~10x smaller update streams.
    #   "full": every ray traverses its whole extent (round-1 semantics;
    #     oracle-exact — tests pin this for sequential-reference comparisons).
    #   "projective": the truncation band stays ray-exact (band jobs); free
    #     space strictly before the band is carved by the dense per-block
    #     projective kernel instead of carve jobs — each frustum voxel
    #     carved exactly once per frame (the contract the reference's
    #     ApproxHashSet approximates), with no multi-million-entry
    #     sort/scan stream (models/fast.py _maybe_projective_carve).
    carve_mode: str = "decimated"
    # Banded-mode ray selection density (ops/carve.py band_octave_keep):
    #   "octave" (default): keep the center pixel of each k x k group with
    #     k = floor-pow2(T/d) — CONSERVATIVE: between octaves the kept
    #     density overshoots the reference's 1-ray-per-dedup-cell rate by
    #     up to 4x (measured ~2.1x mean at the canonical config), which is
    #     why the canonical scene needs a ~58k ray budget for zero drops.
    #   "matched": additionally thin each group's candidate with
    #     probability (k/(T/d))^2 via a per-group hash salted by the camera
    #     pose — EXACTLY the reference's expected density (1 per
    #     voxel/subsampling_factor cell, _fast.cpp:87-91), temporally
    #     dithered instead of first-come-wins. ~2x smaller band streams;
    #     a cell may skip a given frame (P~0.3) but coverage converges
    #     geometrically over frames.
    band_density: str = "octave"

    def __post_init__(self):
        # carve.py only special-cases "matched"; catch typos ("match") that
        # would otherwise silently fall back to octave behavior.
        if self.band_density not in ("octave", "matched"):
            raise ValueError(
                f"band_density={self.band_density!r} not in "
                "{'octave', 'matched'}")
        if self.carve_mode not in ("decimated", "full", "projective"):
            raise ValueError(
                f"carve_mode={self.carve_mode!r} not in "
                "{'decimated', 'full', 'projective'}")


@dataclasses.dataclass(frozen=True)
class SemanticConfig:
    """Mirror of `kimera::SemanticConfig` (semantic_integrator_base.h:68-87)."""

    semantic_measurement_probability: float = 0.9   # ros_params.cpp:43-49 (launch: 0.8)
    color_mode: ColorMode = ColorMode.SEMANTIC
    dynamic_labels: Tuple[int, ...] = (20,)          # launch:121-122 (humans)
    # Reference parity (default False): the reference votes the measured
    # label into EVERY voxel the ray traverses — carved free space included —
    # and its own comment concedes the near-surface gate would be better but
    # was left unimplemented (semantic_integrator_base.cpp:153-158). True
    # restricts semantic votes to voxels inside the truncation band
    # (|sdf| < truncation_distance), eliminating label bleed-through from
    # rays that pass in front of other surfaces (measured: sim-eval
    # label_accuracy 0.49 -> see tests/test_models.py gate test).
    update_near_surface_only: bool = False


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static shapes for the jit-compiled per-frame update."""

    max_rays: int = 32768        # rays integrated per frame after dedup/compaction
    max_steps: Optional[int] = None  # DDA steps per ray; None = derive from config
    dedup_table_size: int = 1 << 20  # matches ApproxHashSet 2^20 slots (_fast.h:98-130)
    use_pallas: bool = True      # fused Pallas DDA/update-stream kernel
                                 # (interpreted off-TPU; ops/pallas_kernels.py)
    scatter_mode: str = "segment"  # "direct" scatter-add | "sorted" segment-sum
                                 # + unique-index scatter | "segment" sort +
                                 # segmented-scan compaction (ops/reduce.py) —
                                 # fastest on TPU: XLA scatter cost is
                                 # per-index serial (~11 ns), so reduce the
                                 # 5.9M-entry stream to its ~10-100k unique
                                 # (voxel, label) segments before scattering
    segment_budget: int = 1 << 18  # "segment" mode: static cap on unique
                                 # (voxel, label) segments per frame; spills
                                 # are counted in grid.overflow
    staged_apply: bool = True    # "segment" mode on TPU: apply the reduced
                                 # segments through the aliased Pallas RMW
                                 # kernel via compact group-aligned staging
                                 # (ops/integrate.py _staged_segment_apply).
                                 # r4 finding: after any hash-probe
                                 # while_loop program runs, XLA grid-sized
                                 # scatters cost ~operand-bytes/100GB/s on
                                 # this runtime (sem_delta alone ~17.8
                                 # ms/frame); the staged path is immune.
                                 # False = the plain XLA scatter tail.
    sem_stage_mode: str = "packed"  # staged apply's semantic staging:
                                 # "packed" = P label-rank planes holding
                                 # (count*32 + label) packed f32 (one 8 MB
                                 # plane per rank — slow-mode scatter cost
                                 # scales with the staging operand, so small
                                 # wins); votes past rank P-1 drop and count
                                 # in grid.overflow. "dense" = full
                                 # (L, rows, V3) staging — exact for any
                                 # label multiplicity, ~L/P x the staging
                                 # bytes.
    sem_stage_ranks: int = 8     # "packed" mode: max distinct labels a
                                 # voxel can receive per frame
    meta_kernel: bool = True     # projective apply: compute the per-block
                                 # patch meta in the one-step Pallas kernel
                                 # (pallas_kernels.block_meta) instead of
                                 # the ~0.7 ms XLA small-op chain; needs
                                 # block_budget % 128 == 0 (else falls back)
    fused_apply: bool = True     # projective apply: ONE aliased Pallas
                                 # kernel fusing sample + RMW
                                 # (pallas_kernels.projective_apply_fused)
                                 # when vps^3 <= 8192; False = the two-
                                 # kernel sample -> block_rmw_add chain
    stream_active_fraction: float = 0.75  # "segment" mode: post-sort slice —
                                 # padded streams are ~50% trash, so the scan
                                 # and compaction sort run on this fraction
                                 # of the stream; denser streams spill to
                                 # grid.overflow. 1.0 disables.
    # Projective-integrator statics (models/projective.py):
    block_budget: int = 512      # touched-block list size per frame; spills
                                 # counted in grid.overflow
    patch_rows: int = 128        # image patch rows per block (origin aligned
                                 # to 8; mip level chosen so the projection
                                 # fits — ops/mip.py thresholds)
    patch_cols: int = 256        # image patch cols per block (origin 128-
                                 # aligned, hence the extra slack)
    sample_mode: str = "auto"    # "onehot" (MXU, TPU) | "gather" (XLA,
                                 # exact, CPU) | "auto"
    wire_atlas: str = "u16"      # sharded atlas exchange wire format
                                 # (parallel/sharding.py): "u16" = level-0
                                 # u16 depth/label (+ u8 RGB in COLOR mode)
                                 # with local pyramid rebuild — ~8x fewer
                                 # all-gather bytes, depth quantized at
                                 # ~0.08 mm (ops/mip.py wire_encode);
                                 # "f32" = full f32 atlas (bit-exact vs
                                 # single-device integration)
    alloc_stride: int = 4        # pixel subsampling for the block-level
                                 # allocation DDA
    # Decimated-carving statics (ops/carve.py; carve_mode == "decimated"):
    carve_budget: int = 49152    # carve jobs per frame after compaction
                                 # (multiple of 512; spills -> grid.overflow)
    carve_steps: int = 32        # DDA step budget per carve chunk job
    carve_gamma: float = 1.0     # ray density: level k carves distances
                                 # <= carve_gamma * voxel * f / k (~gamma
                                 # rays per voxel per image axis)
    carve_k_max: int = 32        # coarsest decimation factor
    band_steps: Optional[int] = None  # step budget for truncation-band jobs;
                                 # None = derived from trunc/voxel

    def __post_init__(self):
        if self.wire_atlas not in ("u16", "f32"):
            raise ValueError(
                f"wire_atlas={self.wire_atlas!r} not in {{'u16', 'f32'}}")

    def resolved_band_steps(self, grid: GridConfig, tsdf: TsdfConfig) -> int:
        if self.band_steps is not None:
            return self.band_steps
        return int(math.ceil(
            1.7321 * 2.0 * tsdf.truncation_distance / grid.voxel_size)) + 3

    def resolved_max_steps(self, grid: GridConfig, tsdf: TsdfConfig) -> int:
        if self.max_steps is not None:
            return self.max_steps
        if tsdf.voxel_carving_enabled:
            reach = tsdf.max_ray_length_m + tsdf.truncation_distance
        else:
            reach = 2.0 * tsdf.truncation_distance
        # Amanatides-Woo axis-sum step count <= sqrt(3) * length / voxel.
        return int(math.ceil(1.7321 * reach / grid.voxel_size)) + 3


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    """Top-level bundle used by integrators and the server."""

    grid: GridConfig = dataclasses.field(default_factory=GridConfig)
    tsdf: TsdfConfig = dataclasses.field(default_factory=TsdfConfig)
    semantic: SemanticConfig = dataclasses.field(default_factory=SemanticConfig)
    pipeline: PipelineConfig = dataclasses.field(default_factory=PipelineConfig)
    integrator: IntegratorType = IntegratorType.FAST

    def resolved_max_steps(self) -> int:
        return self.pipeline.resolved_max_steps(self.grid, self.tsdf)
