"""Layered settings for the SLAM engine (the PyTorch port's own copy).

The port keeps its own settings module and imports nothing of the JAX
package ``mageslam_tpu``; this file mirrors ``mageslam_tpu/config.py``
class for class — same names, fields, defaults and JSON form — and a test
holds the two copies' ``to_json()`` equal so they cannot drift.  A JAX
settings object crosses over as JSON (``convert.settings_from_jax``).

Equivalent of the reference's PROPERTYBAG config system
(Core/MAGESLAM/Source/MageSettings.h:36-379 + arcana/propertybag.h): nested
typed settings structs with inline defaults and JSON round-trip.  Default
values follow the reference's defaults file-for-file (cited per bag) so that
behavior parity is threshold-for-threshold checkable; additions without a
reference analog (fixed array capacities, RANSAC batch shapes) live in
``CapacitySettings`` — static shape parameters of the preallocated state.

Settings objects are frozen dataclasses: hashable and immutable.
``to_json`` / ``from_json`` give the cereal-JSON-style round trip
(reference MAGESlam.cpp:138-143 requires explicit settings provenance; we
keep a ``loaded_from_file`` flag for parity).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field, fields, is_dataclass
from enum import IntEnum
from typing import Any


class CameraIdentity(IntEnum):  # MageSettings.h:13-18
    MONO = 0
    STEREO_1 = 1
    STEREO_2 = 2


class PosePriorMethod(IntEnum):  # MageSettings.h:28-33
    MOTION_MODEL = 0
    VISUAL_INERTIAL_FUSION = 1
    VISUAL_INERTIAL_FUSION_WITH_3DOF = 2


class FilterType(IntEnum):  # MageSettings.h:20-26
    NONE = 0
    FUSER3DOF = 1
    FUSER6DOF = 2
    SIMPLE6DOF = 3


@dataclass(frozen=True)
class OrbMatcherSettings:  # MageSettings.h OrbMatcherSettings
    # Deviation from the reference default (30): our generated-BRIEF
    # descriptors flip ~15-18% of bits under 1-2px keypoint localization
    # error, so the working threshold is 50 (= ORB-SLAM's TH_LOW).  The
    # engine only matches its own descriptors, so this is self-consistent.
    max_hamming_distance: int = 50
    min_hamming_difference: int = 1


@dataclass(frozen=True)
class BundleAdjustSettings:  # MageSettings.h BundleAdjustSettings
    num_steps: int = 1
    num_steps_per_run: int = 1
    min_steps: int = 1
    huber_width: float = 1.8
    huber_width_scale: float = 0.95
    max_outlier_error: float = 7.25
    max_outlier_error_scale_factor: float = 0.95
    min_mean_square_error: float = 0.25
    distance_tether_weight: float = 50.0
    low_connectivity_iterations_scale: float = 1.5


@dataclass(frozen=True)
class NewMapPointsCreationSettings:  # MageSettings.h NewMapPointsCreationSettings
    min_parallax_degrees: float = 0.0238961594253207
    max_epipolar_error: float = 3.84385518580709
    min_accepted_distance_ratio: float = 2.0
    min_keyframe_distance_for_creating_map_points_sq: float = 0.0
    max_keyframe_angle_degrees: float = 60.0
    new_map_points_search_radius: float = 11.8816156
    max_frames_for_new_points_creation: int = 5
    initial_matcher: OrbMatcherSettings = OrbMatcherSettings()
    associate_matcher: OrbMatcherSettings = OrbMatcherSettings()


@dataclass(frozen=True)
class GraphOptimizationSettings:  # MageSettings.h GraphOptimizationSettings
    max_outlier_error: float = 7.25
    max_outlier_error_scale_factor: float = 0.95
    num_steps: int = 0
    huber_width: float = 0.372231848644798


@dataclass(frozen=True)
class CovisibilitySettings:  # MageSettings.h CovisibilitySettings
    covis_min_threshold: int = 15
    covis_loop_threshold: int = 30
    covis_essential_threshold: int = 100
    upper_connections_for_ba: int = 2000
    lower_connections_for_ba: int = 1500
    covis_ba_step_threshold: int = 15
    max_steps: int = 1


@dataclass(frozen=True)
class KeyframeSettings:  # MageSettings.h KeyframeSettings
    min_frame_count: int = 60
    min_frame_count_reloc: int = 20
    min_tracking_point_count: int = 25
    max_tracking_point_overlap: float = 0.25
    max_tracking_point_matches: float = 300
    mapping_max_tracking_point_overlap: float = 0.9
    min_keyframe_covisibility_count: int = 3
    min_frame_move_to_min_depth_ratio: float = 0.13


@dataclass(frozen=True)
class MonoMapInitializationSettings:  # MageSettings.h MonoMapInitializationSettings
    # Deviation from the reference default (1.1 px): our FAST keypoints
    # localize to ~1.4 px median, so the epipolar inlier gate needs 2.5 px.
    fundamental_transfer_error_threshold: float = 2.5
    min_feature_matches: int = 65
    min_scoring_inliers: int = 50
    min_inlier_percentage: float = 0.5
    min_initial_map_points: int = 40
    min_map_points: int = 60
    min_third_frame_match_percentage: float = 0.5
    # quality clause of the third-frame confirmation (no reference analog
    # by name; the reference's 5-point solver + pose-disimilarity gates
    # make bad bootstraps rarer): a geometrically-bad init draw re-finds
    # ENOUGH points in the third frame but fits them ~50% worse —
    # measured 1.31 px^2 tracked MSE for a bad RANSAC draw vs
    # 0.79-0.90 px^2 for clean ones on the same pair.  Above this bar the
    # init is discarded and bootstrapping continues on a later pair.
    third_frame_max_mse_px2: float = 1.1
    feature_covisibility_threshold: float = 0.35
    max_parallax_3d_distance: float = 500.0
    max_parallax_3d_median_distance: float = 20.0
    min_candidate_pose_disimilarity: float = 0.3
    max_pose_contribution_z: float = 0.66
    ba_g2o_steps: int = 5
    ba_huber_width: float = 1.5
    ransac_iterations_for_models: int = 90
    # H/F dual-model selection (no reference analog by name; the reference
    # solves planar degeneracy with the grafted Nistér 5-point solver
    # instead, ComputeEssential.cpp:1-10): reconstruct from the homography
    # when its truncated transfer score is > this fraction of the combined
    # H+E score (ORB-SLAM's R_H heuristic)
    homography_model_ratio: float = 0.45
    max_epipolar_error: float = 3.5
    max_outlier_error: float = 2.5
    amount_ba_can_change_pose: float = 1.65
    new_points_creation_min_distance: float = 0.25
    frame_interval_ms: int = 0
    min_initialization_interval_ms: int = 150
    max_initialization_interval_ms: int = 540
    min_pixel_spread: float = 40.0
    final_ba_huber_width: float = 0.9
    final_ba_max_outlier_error: float = 4.0
    final_ba_max_outlier_error_scale_factor: float = 0.75
    final_ba_min_mean_square_error: float = 0.0
    final_ba_num_steps_per_run: int = 5
    final_ba_num_steps: int = 15
    extra_frame_max_outlier_error: float = 8.0
    extra_frame_ba_steps: int = 5
    extra_frame_huber_width: float = 4.0
    extra_frame_search_radius: float = 40.0
    five_point_matching: OrbMatcherSettings = OrbMatcherSettings()
    extra_frame_matching: OrbMatcherSettings = OrbMatcherSettings()
    new_map_points: NewMapPointsCreationSettings = NewMapPointsCreationSettings()


@dataclass(frozen=True)
class StereoMapInitializationSettings:  # MageSettings.h StereoMapInitializationSettings
    min_init_map_points: int = 15
    min_feature_matches: int = 40
    max_outlier_error: float = 2.5
    max_epipolar_error: float = 5.5
    min_accepted_distance_ratio: float = 2.0
    initialization_tether_strength: float = 50.0
    max_pose_contribution_z: float = 0.10
    amount_ba_can_change_pose: float = 1.65
    max_depth_meters: float = 2.3
    matcher: OrbMatcherSettings = OrbMatcherSettings()
    bundle_adjust: BundleAdjustSettings = BundleAdjustSettings()


@dataclass(frozen=True)
class FeatureExtractorSettings:  # MageSettings.h FeatureExtractorSettings
    num_features: int = 440
    scale_factor: float = 1.5
    gaussian_kernel_size: int = 7
    num_levels: int = 1
    fast_threshold: int = 4
    patch_size: int = 15
    use_orientation: bool = False
    feature_factor: float = 1.5
    feature_strength: float = 0.9
    strong_response: int = 20
    min_robustness_factor: float = 1.1
    max_robustness_factor: float = 2.0
    num_cells_x: int = 32
    num_cells_y: int = 32
    # r5 (VERDICT r4 #3, no direct reference analog — OpenCV ORB keeps
    # integer FAST locations): parabola-vertex subpixel localization on
    # the raw FAST score neighborhood + BILINEAR descriptor sampling at
    # the refined position.  Measured on the real-texture ring: keypoint
    # localization ~1.4 px -> sub-0.5 px and cross-frame descriptor bit
    # flips drop (sampling follows the corner instead of the pixel grid)
    use_subpixel: bool = True

    @property
    def image_border(self) -> float:
        return self.patch_size / 2.0


@dataclass(frozen=True)
class PoseEstimationSettings:  # MageSettings.h PoseEstimationSettings
    search_radius: float = 12.0
    wider_search_radius: float = 24.0
    extra_wider_search_radius: float = 36.0
    feature_match_threshold: int = 20
    feature_small_match_ratio_threshold: float = 0.333780871615353
    min_map_point_refinement_count: int = 0
    matcher: OrbMatcherSettings = OrbMatcherSettings()


@dataclass(frozen=True)
class TrackLocalMapSettings:  # MageSettings.h TrackLocalMapSettings
    min_degrees_between_current_view_and_map_point_view: float = 60.0
    ba_g2o_steps: int = 4
    ba_huber_width: float = 0.9
    initial_pose_ba_steps: int = 3
    initial_pose_ba_huber_width: float = 4.0
    recent_map_point_pct_success: float = 0.137686914508039
    match_search_radius: float = 8.0
    max_outlier_error: float = 4.5
    max_outlier_error_pose_estimation: float = 6.0
    unassociate_outliers: bool = True
    tracking_lost_count_until_reloc: int = 3
    min_map_point_refinement_count: int = 0
    min_tracked_feature_count: int = 20
    matcher: OrbMatcherSettings = OrbMatcherSettings()


@dataclass(frozen=True)
class LoopClosureSettings:  # MageSettings.h LoopClosureSettings
    enable_loop_closure: bool = True  # reference default False; console enables
    max_map_points: int = 200
    match_search_radius: float = 18.0
    min_keyframe: int = 10
    min_cluster_size: int = 3
    min_feature_matches: int = 0
    # candidate clusters per detection attempt: the online k-majority
    # vocabulary's similarity scores discriminate weakly (scores cluster
    # within ~0.02), so the true revisited sector often ranks 5th-8th —
    # scanning 8 clusters instead of the reference's effective 4 costs
    # one extra relocalize batch per keyframe and recovers most of the
    # ranking loss
    query_results: int = 8
    # temporal-consistency gate (no direct reference analog; the
    # reference's non-covisibility test alone lets a cluster from a few
    # seconds ago qualify, and with the cluster-pool relocalizer that
    # produces FALSE loop corrections on plain forward motion): loop
    # candidates must be at least this many frames older than the
    # closing keyframe (~3 s at 30 fps)
    min_frame_gap: int = 90
    # near-identity correction skip (r4): a detected "loop" whose reloc
    # pose agrees with the current pose within this fraction of the
    # median keyframe spacing AND whose scale ratio is within
    # exp(min_correction_log_scale) of 1 is already closed — applying
    # the correction would only inject reloc noise (loop/closure.py
    # detect_loop; measured ATE 2.2% -> 6.1% from such churn).
    # r5: 0.5 -> 1.0 — the spacing statistic now orders keyframes
    # temporally (advisor r4: slot adjacency is meaningless after
    # culling), which HALVED the measured median on the mid-drive maps
    # the 0.5 coefficient was calibrated against; at 0.5 a stitched-seam
    # re-closure fired on the healthy ring again (measured kf ATE
    # 0.19 -> 0.83 from one such closure)
    min_correction_baseline_ratio: float = 1.0
    min_correction_log_scale: float = 0.05
    bundle_adjust: BundleAdjustSettings = BundleAdjustSettings(
        num_steps=25)  # console.cpp:116-120 loop-closure BA budget
    cheap_loop_closure_matching: OrbMatcherSettings = OrbMatcherSettings()
    map_merge_matching: OrbMatcherSettings = OrbMatcherSettings()
    # essential-graph Sim3 relaxation before the global BA (the reference
    # ships PoseGraphOptimizer unused; here it propagates the correction
    # through the whole trajectory, loop/closure.py)
    # DEFAULT deviation from the reference (r4): the reference corrects a
    # loop by rigidly moving the covisible set + global BA
    # (LoopClosureWorker.cpp:164-210) and ships its PoseGraphOptimizer
    # unused; the Sim3 essential-graph relaxation measurably beats that
    # everywhere we graded it (150-frame formal ring: 0.06 vs 0.25 of
    # extent; adversarial injected drift: full-trajectory ATE 0.405 —
    # within noise of no-drift-injected-correction-needed — vs the rigid
    # mode's 1.33, tests/test_loop_closure_wins.py).  The rigid move
    # leaves a mid-trajectory discontinuity that only trajectory-wide
    # relaxation distributes; set False for reference-semantics parity.
    use_pose_graph: bool = True
    pose_graph_steps: int = 15
    pose_graph_min_covis: int = 30


@dataclass(frozen=True)
class PoseHistorySettings:  # MageSettings.h PoseHistorySettings
    initial_interpolation_connections: int = 4
    max_interpolation_connections: int = 1
    pose_history_size: int = 10000  # ~5.5 minutes @30fps
    keyframe_history_size: int = 1000


@dataclass(frozen=True)
class BoundingDepthSettings:  # MageSettings.h BoundingDepthSettings
    roi_min_x: float = 0.1
    roi_min_y: float = 0.1
    roi_max_x: float = 0.9
    roi_max_y: float = 0.9
    near_depth_softness: float = 0.0
    far_depth_softness: float = 0.0


@dataclass(frozen=True)
class BagOfWordsSettings:  # MageSettings.h BagOfWordsSettings
    qualifying_candidate_score: float = 0.75
    use_direct_index: bool = True
    direct_index_levels: int = 4
    training_frames: int = 15
    training_tree_levels: int = 2
    training_tree_branching_factor: int = 6
    max_training_iteration: int = 12
    min_training_size: int = 1000


@dataclass(frozen=True)
class RelocalizationSettings:  # MageSettings.h RelocalizationSettings
    min_brute_force_correspondences: int = 20
    min_radius_match_correspondences: int = 15
    min_map_points: int = 10
    # Soft inlier gate on the per-candidate PnP HYPOTHESIS (no reference
    # analog by name — the reference applies MinMapPoints after the full
    # TrackLocalMap re-track, PoseEstimationWorker.cpp:90-97; our engines
    # do the same, so this pre-gate only prunes hopeless candidates).
    min_pnp_hypothesis_inliers: int = 5
    # Deviation from the reference default (0.4): our reloc pool is the
    # candidate's covisible-cluster map points (~2.5x a single keyframe's
    # associations), so the same true-match count is a smaller fraction of
    # the pool (measured ~27-30% at the 10-frame-separation recovery the
    # occlusion e2e exercises); the absolute inlier floor and the
    # full-local-map re-track verification still gate acceptance.
    ransac_inliers_pct_required: float = 0.2
    ba_inliers_pct_required: float = 0.4
    ransac_confidence: float = 0.6
    round_robin_iterations: int = 5
    ransac_iterations: int = 2
    ba_iterations: int = 10
    search_radius: float = 20.0
    max_ba_reprojection_error: float = 8.0
    max_pnp_reprojection_error: float = 8.0
    # Deviation from the reference matcher default (MinHammingDifference=1):
    # relocalization matches brute-force across wide viewpoint baselines
    # where our generated-BRIEF descriptors are noisier than trained ORB —
    # measured precision at 10-frame separation rises 56% -> 68% with an
    # ambiguity margin of 8-16 while keeping 15+ true matches (the PnP
    # minimum).  The reference leans on distinctive learned descriptors
    # instead (PoseEstimator.cpp:219-437).
    matcher: OrbMatcherSettings = OrbMatcherSettings(
        min_hamming_difference=8)


@dataclass(frozen=True)
class MappingSettings:  # MageSettings.h MappingSettings
    max_reloc_query_results: int = 4
    max_pending_keyframes: int = 4
    max_loop_closure_query_results: int = 1000
    min_num_keyframes_for_map_point_culling: int = 3
    use_cheap_loop_closure: bool = True
    persist_lambda: bool = True
    min_lambda: float = 0.001
    new_map_points: NewMapPointsCreationSettings = NewMapPointsCreationSettings()


@dataclass(frozen=True)
class PosePriorSettings:  # MageSettings.h PosePriorSettings
    pose_prior: PosePriorMethod = PosePriorMethod.MOTION_MODEL
    assume_imu_and_camera_colocated: bool = False


@dataclass(frozen=True)
class ParallelSettings:
    """Multi-chip execution (no reference analog — the reference is a
    single-process library, SURVEY.md §2.2; this is the TPU-native
    scaling surface, BASELINE.json config 5)."""

    # shard the global-BA landmark blocks over all local devices for
    # fossilize and (host-engine) loop-closure global BA
    use_distributed_global_ba: bool = False
    min_devices: int = 2
    # keyframe-block TRAJECTORY sharding for long sequences (SURVEY.md §7
    # item 7): when on and the live keyframe count clears the threshold,
    # fossilize / loop global BA route through
    # parallel.trajectory_sharding.trajectory_sharded_global_ba —
    # contiguous temporal keyframe blocks per device with halo exchange;
    # dropped long-range covisibility is re-injected as SIX_DOF tethers
    use_trajectory_sharding: bool = False
    trajectory_min_keyframes: int = 64
    trajectory_halo: int = 4
    trajectory_max_tethers: int = 64
    trajectory_tether_min_covis: int = 8


@dataclass(frozen=True)
class RuntimeSettings:  # MageSettings.h RuntimeSettings
    tracking_reads_per_loop_detection: int = 2
    tracking_reads_per_loop_closure: int = 30
    # drop-frame backpressure (Tasks/Runtime.cpp:107-121 OneAtATime): when
    # frames arrive faster than the pipeline drains, process the LATEST
    # pending frame and mark the stale ones SKIPPED instead of queueing
    # unbounded work.  max_pipeline_depth = how many dispatched-but-
    # unresolved device steps may be outstanding before pacing kicks in.
    drop_frames_when_busy: bool = False
    max_pipeline_depth: int = 3
    pose_prior: PosePriorSettings = PosePriorSettings()


@dataclass(frozen=True)
class FuserSettings:  # MageSettings.h FuserSettings
    use_fuser: bool = False  # console.cpp:93 golden path disables
    return_fuser_output: bool = False
    apply_visual_update: bool = True
    std_dev_pose_error: float = 0.004
    drop_mag_samples: bool = True
    delta_pose_rate_ms: int = 66
    min_delta_pose_rate_ms: int = 65
    max_delta_pose_rate_ms: int = 129
    filter_type: FilterType = FilterType.FUSER3DOF
    matcher: OrbMatcherSettings = OrbMatcherSettings()


@dataclass(frozen=True)
class VolumeOfInterestSettings:  # MageSettings.h VolumeOfInterestSettings
    threshold: float = 0.5
    iterations: int = 3
    voxel_count_floor: int = 16000
    away_prominence: float = 1.2
    toward_prominence: float = 0.1
    side_prominence: float = 1.0
    kernel_angle_x_rads: float = 1.0471975512  # 60 deg
    kernel_angle_y_rads: float = 0.69813170079  # 40 deg
    kernel_pitch_rads: float = 0.0
    kernel_roll_rads: float = 0.0
    kernel_yaw_rads: float = 0.08726646259  # 5 deg
    kernel_depth_modifier: float = 1.0


@dataclass(frozen=True)
class PerCameraSettings:  # MageSettings.h PerCameraSettings
    features: FeatureExtractorSettings = FeatureExtractorSettings()
    new_point_grid_width: int = 4
    new_point_grid_height: int = 3
    new_point_max_grid_count: int = 6
    undistort_image_pixels: bool = False
    keyframe_decision_grid_width: int = 8
    keyframe_decision_grid_height: int = 5
    keyframe_decision_min_map_points_per_grid_cell: int = 2
    keyframe_decision_allowed_empty_cell_percentage: float = 0.4


@dataclass(frozen=True)
class StereoSettings:  # MageSettings.h StereoSettings
    use_stereo_init: bool = False
    primary_tracking_camera: CameraIdentity = CameraIdentity.STEREO_2
    camera1: PerCameraSettings = PerCameraSettings()
    camera2: PerCameraSettings = PerCameraSettings()
    map_init: StereoMapInitializationSettings = StereoMapInitializationSettings()


@dataclass(frozen=True)
class MonoSettings:  # MageSettings.h MonoSettings
    camera: PerCameraSettings = PerCameraSettings()
    map_init: MonoMapInitializationSettings = MonoMapInitializationSettings()


@dataclass(frozen=True)
class Metadata:  # MageSettings.h Metadata
    loaded_from_file: bool = False
    tracking_width: int = 320


@dataclass(frozen=True)
class CapacitySettings:
    """TPU-specific static shape capacities (no reference analog — the
    reference grows std::vectors; we preallocate device arrays).  These are
    baked into compiled programs; changing them recompiles."""

    max_features: int = 512          # per-frame keypoint slots (>= num_features*factor)
    max_keyframes: int = 256         # keyframe slots in MapState
    max_map_points: int = 8192       # landmark slots in MapState
    max_obs_per_keyframe: int = 512  # association slots per keyframe (= max_features)
    local_ba_keyframes: int = 16     # local BA window keyframe slots
    local_ba_points: int = 2048      # local BA window landmark slots
    ransac_hypotheses: int = 128     # vmapped RANSAC hypothesis batch
    pnp_ransac_hypotheses: int = 64
    match_candidates: int = 16       # top-k candidate slots in radius match
    track_candidates: int = 1024     # compacted tracking candidate slots
    pose_history_size: int = 10000
    bow_query_results: int = 8
    vocab_nodes: int = 256           # BoW tree node capacity
    loop_cluster_slots: int = 8


@dataclass(frozen=True)
class MageSlamSettings:  # MageSettings.h MageSlamSettings (container)
    metadata: Metadata = Metadata()
    bundle_adjust: BundleAdjustSettings = BundleAdjustSettings()
    graph_optimization: GraphOptimizationSettings = GraphOptimizationSettings()
    covisibility: CovisibilitySettings = CovisibilitySettings()
    keyframe: KeyframeSettings = KeyframeSettings()
    pose_estimation: PoseEstimationSettings = PoseEstimationSettings()
    relocalization: RelocalizationSettings = RelocalizationSettings()
    bag_of_words: BagOfWordsSettings = BagOfWordsSettings()
    track_local_map: TrackLocalMapSettings = TrackLocalMapSettings()
    pose_history: PoseHistorySettings = PoseHistorySettings()
    bounding_depth: BoundingDepthSettings = BoundingDepthSettings()
    mapping: MappingSettings = MappingSettings()
    runtime: RuntimeSettings = RuntimeSettings()
    parallel: ParallelSettings = ParallelSettings()
    fuser: FuserSettings = FuserSettings()
    loop_closure: LoopClosureSettings = LoopClosureSettings()
    volume_of_interest: VolumeOfInterestSettings = VolumeOfInterestSettings()
    stereo: StereoSettings = StereoSettings()
    mono: MonoSettings = MonoSettings()
    capacity: CapacitySettings = CapacitySettings()

    # ----- serialization (cereal-JSON analog) -----
    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(_to_dict(self), indent=indent)

    @staticmethod
    def from_json(text: str) -> "MageSlamSettings":
        return _from_dict(MageSlamSettings, json.loads(text))

    def replace(self, **kwargs) -> "MageSlamSettings":
        return dataclasses.replace(self, **kwargs)

    def camera_settings(self, identity: CameraIdentity) -> PerCameraSettings:
        """Per-camera settings resolution (MageSettings.h:365-379)."""
        if identity == CameraIdentity.MONO:
            return self.mono.camera
        if identity == CameraIdentity.STEREO_1:
            return self.stereo.camera1
        return self.stereo.camera2


def _to_dict(obj: Any) -> Any:
    if is_dataclass(obj):
        return {f.name: _to_dict(getattr(obj, f.name)) for f in fields(obj)}
    if isinstance(obj, IntEnum):
        return int(obj)
    return obj


def _from_dict(cls, data: Any) -> Any:
    if is_dataclass(cls) and isinstance(data, dict):
        kwargs = {}
        for f in fields(cls):
            if f.name in data:
                kwargs[f.name] = _coerce(f.type, data[f.name], cls, f.name)
        return cls(**kwargs)
    return data


def _coerce(type_name, value, owner_cls, field_name):
    f = next(f for f in fields(owner_cls) if f.name == field_name)
    default = f.default if f.default is not dataclasses.MISSING else None
    if default is None and f.default_factory is not dataclasses.MISSING:  # type: ignore
        default = f.default_factory()  # type: ignore
    if is_dataclass(default):
        return _from_dict(type(default), value)
    if isinstance(default, IntEnum):
        return type(default)(value)
    return value
