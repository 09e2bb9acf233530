"""Canonical configuration of the SLAM engine, PyTorch port.

A field-for-field copy of `lidarslam_tpu/config.py` (same dataclasses, enums,
names and defaults; tests/test_torch_config.py holds the two equal). It is
copied rather than imported because importing any `lidarslam_tpu` module
loads jax, which the port never imports.

Original notes follow.

One frozen-dataclass tree is the single source of truth for all tuning
parameters, mirroring the reference's canonical member-variable set and tuned
defaults (Slam.h:402-694, SpinningSensorKeypointExtractor.h:126-157,
KeypointsMatcher.h:43-76, RollingGrid.h:172-212) so that users of the
reference find the same knobs with the same names (snake_case) and defaults.

On top of the algorithmic parameters, this config fixes the *static
capacities* that turn the reference's dynamic containers into the fixed-shape
masked tensors XLA needs: rings x max points per ring for the range image,
max keypoints per type, map point capacity, k-NN candidate budgets.
All dataclasses are frozen + hashable so they can be passed as `static_argnums`
to `jax.jit`.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass


class Keypoint(enum.IntEnum):
    """Keypoint types (Enums.h:30-39)."""

    EDGE = 0
    PLANE = 1
    BLOB = 2


KEYPOINT_NAMES = {Keypoint.EDGE: "edge", Keypoint.PLANE: "plane", Keypoint.BLOB: "blob"}


class UndistortionMode(enum.IntEnum):
    """How to correct rolling-shutter distortion (Enums.h:43-64)."""

    NONE = 0
    ONCE = 1
    REFINED = 2


class EgoMotionMode(enum.IntEnum):
    """How to estimate ego-motion prior (Enums.h:68-93)."""

    NONE = 0
    MOTION_EXTRAPOLATION = 1
    REGISTRATION = 2
    MOTION_EXTRAPOLATION_AND_REGISTRATION = 3


class MappingMode(enum.IntEnum):
    """How to update the rolling maps (Enums.h:97-114)."""

    NONE = 0
    ADD_KPTS_TO_FIXED_MAP = 1
    UPDATE = 2


class SamplingMode(enum.IntEnum):
    """In-leaf downsampling strategy of the map voxel grid (Enums.h:120-142)."""

    FIRST = 0
    LAST = 1
    MAX_INTENSITY = 2
    CENTER_POINT = 3
    CENTROID = 4


class LoggingStorage(enum.IntEnum):
    """Keypoint-log storage backends (PointCloudStorage.h:318-352 roles).

    DEVICE keeps jax array references (zero host traffic, device memory);
    HOST pulls to numpy per frame; COMPRESSED quantizes to int16 @ 4 mm +
    uint8 intensity (~2.4x smaller); OCTREE is the reference's
    octree-compressed-RAM backend (Morton occupancy coding + DEFLATE,
    ~5-8x, io/octree.py); DISK writes one binary PCD per frame under
    SlamConfig.logging_dir (the PCDFileStorage analog). See io/storage.py."""

    DEVICE = 0
    HOST = 1
    COMPRESSED = 2
    DISK = 3
    OCTREE = 4


class MatchStatus(enum.IntEnum):
    """Per-keypoint matching rejection causes (KeypointsMatcher.h:82-93)."""

    SUCCESS = 0
    BAD_MODEL_PARAMETRIZATION = 1
    NOT_ENOUGH_NEIGHBORS = 2
    NEIGHBORS_TOO_FAR = 3
    BAD_PCA_STRUCTURE = 4
    INVALID_NUMERICAL = 5
    MSE_TOO_LARGE = 6
    UNKNOWN = 7


@dataclass(frozen=True)
class ExtractorConfig:
    """Spinning-sensor keypoint extractor parameters
    (SpinningSensorKeypointExtractor.h:126-157) and range-image capacities."""

    # --- capacities (TPU static shapes) ---
    n_rings: int = 16          # rows of the range image (max laser rings)
    max_ring_points: int = 2048  # columns of the range image (max firings/ring)
    max_keypoints: int = 4096  # compacted keypoint capacity per type
    # per-type overrides of max_keypoints (0 = use max_keypoints). The
    # reference keeps EVERY labeled point (SSKE.cxx:575-589); here the
    # capacity is a static shape, and plane candidates outnumber edges
    # ~3-5x in structured scenes — per-type budgets avoid both plane
    # saturation (which degrades to even subsampling) and paying the
    # matcher's Q-proportional device cost for an oversized edge budget.
    max_edge_keypoints: int = 0
    max_plane_keypoints: int = 0
    max_blob_keypoints: int = 0

    # --- algorithmic parameters (reference defaults) ---
    neighbor_width: int = 4
    min_distance_to_sensor: float = 1.5      # [m]
    min_beam_surface_angle: float = 10.0     # [deg]
    plane_sin_angle_threshold: float = 0.5   # sin(30 deg)
    edge_sin_angle_threshold: float = 0.86   # ~sin(60 deg)
    dist_to_line_threshold: float = 0.20     # [m]
    edge_depth_gap_threshold: float = 0.15   # [m]
    edge_saliency_threshold: float = 1.5     # [m]
    edge_intensity_gap_threshold: float = 50.0
    # line-fit consistency gates (SpinningSensorKeypointExtractor.cxx:52-55)
    line_max_distance: float = 0.02          # [m]
    line_max_angle_deg: float = 40.0         # [deg]
    # azimuthal resolution; <=0 means auto-estimate from first frame
    azimuthal_resolution: float = 0.0        # [rad]
    # iterations of the parallel greedy-NMS fixpoint (see ops/extractor.py)
    nms_rounds: int = 8
    # 1 blob keypoint every `blob_stride` points (SSKE.cxx:568)
    blob_stride: int = 3

    def kp_capacity(self, t) -> int:
        """Static keypoint capacity of one type (EDGE/PLANE/BLOB int)."""
        caps = (self.max_edge_keypoints, self.max_plane_keypoints,
                self.max_blob_keypoints)
        return caps[int(t)] or self.max_keypoints


@dataclass(frozen=True)
class MapConfig:
    """Rolling voxel-grid map parameters (RollingGrid.h:172-212) plus the
    TPU bucket-index layout that replaces the kd-tree."""

    # --- reference parameters ---
    grid_size: int = 50            # [voxels] rolling window is grid_size^3 voxels
    voxel_resolution: float = 10.0  # [m/voxel] outer voxel edge
    leaf_size: float = 0.2          # [m] inner sampling leaf edge
    min_frames_per_voxel: int = 0   # moving-object rejection threshold
    decaying_threshold: float = -1.0  # [s] forget removable points older than this
    sampling: SamplingMode = SamplingMode.MAX_INTENSITY

    # --- TPU capacities ---
    capacity: int = 1 << 17        # max stored map points (one per leaf)
    submap_capacity: int = 1 << 16  # max points in an extracted submap index


@dataclass(frozen=True)
class MatchingConfig:
    """Keypoint->map matching parameters (KeypointsMatcher.h:43-76).

    One instance for ego-motion matching, one for localization
    (defaults below are localization's; see SlamConfig for the ego set,
    Slam.h:614-643)."""

    single_edge_per_ring: bool = False
    max_neighbors_distance: float = 5.0   # [m]
    edge_nb_neighbors: int = 10
    edge_min_nb_neighbors: int = 4
    edge_max_model_error: float = 0.2     # [m]
    plane_nb_neighbors: int = 5
    planarity_threshold: float = 0.04
    plane_max_model_error: float = 0.2    # [m]
    blob_nb_neighbors: int = 10
    # [m] floor on the blob-ellipsoid sigma: bounds the Mahalanobis weight of
    # degenerate (single-arc) neighborhoods so blob residuals cannot drown
    # the edge/plane constraints (the float64 reference only isfinite-gates
    # this, BuildBlobMatch 318-336, and ships with blobs disabled)
    blob_min_sigma: float = 0.15
    # saturation distance schedule across ICP iterations (Slam.h:640-643)
    init_saturation_distance: float = 2.0   # [m]
    final_saturation_distance: float = 0.5  # [m]
    # TPU-first deviation from the reference's per-round re-query
    # (KeypointsMatcher re-runs the kd-tree search every ICP round,
    # Slam.cxx:1086-1090): query the map k-NN ONCE per frame in round 0
    # and reuse the neighbor coordinates in later rounds, recomputing
    # exact distances against each refined pose. Between rounds the pose
    # moves centimeters while the neighbor gate is metres
    # (max_neighbors_distance), so the candidate sets are stable; the
    # k-NN kernel is the hottest per-frame region, and skipping rounds
    # 2..n of it cuts its cost by ~the round count. Ignored on the
    # slab-sharded map path (its k-NN embeds collectives). Default False
    # = exact reference semantics.
    reuse_knn: bool = False


@dataclass(frozen=True)
class SolverConfig:
    """Batched LM solver parameters (LocalOptimizer + Slam.h:589-597)."""

    icp_max_iter: int = 3
    lm_max_iter: int = 15
    # Ceres-like defaults
    function_tolerance: float = 1e-6
    initial_lm_lambda: float = 1e-4
    two_d_mode: bool = False
    # >0: run exactly min(lm_unroll, lm_max_iter) statically-unrolled LM
    # iterations (convergence-gated no-ops) instead of a lax.while_loop.
    # Measured slightly slower than the dynamic loop on TPU (the while's
    # early exit skips whole evaluations; gated no-ops still pay them), so
    # the dynamic loop is the default.
    lm_unroll: int = 0


@dataclass(frozen=True)
class ConfidenceConfig:
    """Confidence-estimator parameters (Slam.h:649-694)."""

    overlap_sampling_ratio: float = 0.0   # [0-1]; 0 disables overlap estimation
    time_window_duration: float = 0.0     # [s]; 0 disables motion-limit checks
    velocity_limits: tuple = (3.4e38, 3.4e38)       # [m/s, deg/s]
    acceleration_limits: tuple = (3.4e38, 3.4e38)   # [m/s2, deg/s2]
    # number of scan points sampled for overlap LCP (static capacity)
    overlap_max_samples: int = 8192


@dataclass(frozen=True)
class SlamConfig:
    """Top-level config, mirroring Slam.h:402-694."""

    # streaming dispatch window: `add_frame_async` buffers this many sweeps
    # host-side and runs them as ONE device dispatch (a lax.scan chaining the
    # per-sweep steps), amortizing the per-dispatch host/link overhead that
    # dominates when the device sits behind a high-latency tunnel. 1 =
    # dispatch every sweep immediately (adds no latency). Frames carrying
    # external-sensor constraints and partial windows at flush() fall back
    # to the per-sweep dispatch. Results are bitwise-identical across
    # window settings at the default UndistortionMode.NONE; under
    # ONCE/REFINED the windowed wire quantizes per-point times to u8 over
    # the sweep span (0.4 ms steps at 10 Hz — measured 0.3 mm pose shift),
    # while the per-sweep path keeps f16 times.
    stream_window: int = 8

    # general
    use_edges: bool = True
    use_planes: bool = True
    use_blobs: bool = False
    ego_motion_mode: EgoMotionMode = EgoMotionMode.MOTION_EXTRAPOLATION
    undistortion: UndistortionMode = UndistortionMode.NONE
    mapping_mode: MappingMode = MappingMode.UPDATE
    verbosity: int = 0
    logging_timeout: float = -1.0   # <0: log everything; 0: disabled; >0: [s]
    logging_storage: LoggingStorage = LoggingStorage.DEVICE
    logging_dir: str = ""           # PCD directory for LoggingStorage.DISK

    # keyframes (Slam.h:535-536)
    kf_distance_threshold: float = 0.5  # [m]
    kf_angle_threshold: float = 5.0     # [deg]

    # ICP + LM budgets (Slam.h:589-597)
    ego_motion_icp_max_iter: int = 4
    ego_motion_lm_max_iter: int = 15
    localization_icp_max_iter: int = 3
    localization_lm_max_iter: int = 15

    # guards (Slam.h:667-676)
    max_extrapolation_ratio: float = 3.0
    min_nb_matched_keypoints: int = 20

    # external sensor constraints (SensorConstraints.h:30-31, 65-66)
    wheel_odom_weight: float = 0.0       # 0 disables the wheel-odometry residual
    wheel_odom_relative: bool = False    # per-frame increments vs since-start distance
    imu_weight: float = 0.0              # 0 disables the gravity residual
    sensor_time_offset: float = 0.0      # [s] sensor clock - lidar clock

    two_d_mode: bool = False

    # quantize host->device sweep uploads (4 mm int16 coords, uint8
    # intensity, float16 times) — ~2x less upload traffic; quantization is
    # far below spinning-LiDAR range noise
    compress_upload: bool = True
    # prefix-packed sweep wire (frame.FlatRangeImage): upload only the
    # valid, left-packed points (~25% fewer bytes at typical 64-beam fill)
    # and rebuild the (R, C) planes with one on-device gather per sweep.
    # Host->device transfers serialize with device compute on high-latency
    # links, so wire bytes convert ~1:1 into wall time there.
    flat_wire: bool = True
    # optional hard cap on the flat-wire point capacity (0 = none): by
    # default P is picked per window (max sweep total +5% headroom, rounded
    # up to an 8 Ki bucket — lossless, and sticky across windows so fill
    # noise can't retrigger compiles). A cap below a sweep's total drops the
    # tail columns of its fullest rings only (water-fill, frame.flatten_packed).
    wire_capacity: int = 0

    # sub-configs
    extractor: ExtractorConfig = ExtractorConfig()
    # per-LiDAR-device extractor overrides for multi-LiDAR rigs: one
    # extractor instance (own ring count / thresholds) per device_id, the
    # reference's KeyframeExtractors map (Slam.h:239-245,
    # LidarSlamNode.cxx:791-817). Tuple of (device_id, ExtractorConfig)
    # pairs so the frozen config stays hashable (static under jit).
    device_extractors: tuple = ()
    # per-keypoint-type maps with reference leaf sizes (Slam.cxx:155-157);
    # search rings sized for ~2.4 m guaranteed k-NN coverage per type
    edge_map: MapConfig = MapConfig(leaf_size=0.30)
    plane_map: MapConfig = MapConfig(leaf_size=0.60)
    blob_map: MapConfig = MapConfig(leaf_size=0.30)
    # ego-motion matching defaults (Slam.h:614-641)
    ego_matching: MatchingConfig = MatchingConfig(
        single_edge_per_ring=True,
        edge_nb_neighbors=8,
        edge_min_nb_neighbors=3,
        init_saturation_distance=5.0,
        final_saturation_distance=1.0,
    )
    # localization matching defaults (Slam.h:615-643)
    loc_matching: MatchingConfig = MatchingConfig()
    solver: SolverConfig = SolverConfig()
    confidence: ConfidenceConfig = ConfidenceConfig()

    def extractor_for(self, device_id: int) -> ExtractorConfig:
        """The extractor of one LiDAR device (Slam::GetKeyframeExtractor)."""
        for d, e in self.device_extractors:
            if d == device_id:
                return e
        return self.extractor

    def map_config(self, k: Keypoint) -> MapConfig:
        return (self.edge_map, self.plane_map, self.blob_map)[int(k)]

    def use_keypoints(self, k: Keypoint) -> bool:
        return (self.use_edges, self.use_planes, self.use_blobs)[int(k)]

    @property
    def used_types(self):
        return tuple(k for k in Keypoint if self.use_keypoints(k))

    def replace(self, **kw) -> "SlamConfig":
        return dataclasses.replace(self, **kw)
