"""Configuration dataclasses with the reference's default values.

A copy of `dynosam_tpu/utils/config.py` (the port imports nothing of the
JAX package); field names and defaults must stay identical so that
`convert.config_from_dict` round-trips a JAX config.

Mirrors the reference's two-tier YAML + gflags config surface
(`params/FrontendParams.yaml`, `params/backend.flags`,
`params/frontend.flags`, `params/pipeline.flags`) as plain dataclasses so
every experiment knob of the reference exists here with the same default.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    # reference: FrontendParams.yaml tracker_params + frontend.flags
    max_features_per_frame: int = 1000
    max_nr_keypoints_before_anms: int = 2000
    shrink_row: int = 0
    shrink_col: int = 0
    semantic_mask_step_size: int = 4          # frontend.flags
    use_propogate_mask: bool = False          # frontend.flags (sic)
    # reference frontend.flags defaults this to false (OMD quirk); long
    # dynamic tracklets are required for the backend's motion chains, so
    # our default is True
    use_dynamic_track: bool = True
    # frames a freed slot stays blocked before reuse (prevents two physical
    # points aliasing into one backend landmark within a window)
    slot_cooldown_frames: int = 12
    use_byte_tracker: bool = False            # frontend.flags
    max_feature_track_age: int = 25           # FeatureTracker.cc:227-231
    min_distance_btw_tracked_and_detected_features: float = 8.0
    # CLAHE(2.0, 8x8) on the detector input (`FeatureDetector.cc:95-109`,
    # `TrackerParams.hpp:94` default true); KLT tracks the RAW image, like
    # the reference (its tracking-side CLAHE is commented out,
    # `StaticFeatureTracker.cc:292-294`)
    use_clahe_filter: bool = True
    # CLAHE histogram bins: the (blocks, pixels, bins) soft-CDF operand
    # build scales linearly with bins and is pure VPU elementwise
    # (~0.5 ms/frame at 256).  64 bins matches OpenCV's 256-bin output as
    # closely as our 256 does (mean |diff| 2.43 vs 2.43 levels, corr
    # .9985 — the linear within-bin interpolation smooths the CDF), and
    # only the DETECTOR image uses CLAHE.
    clahe_bins: int = 64
    # detector selection (reference FeatureDetectorType: GFTT vs
    # ORB_SLAM_ORB, `FeatureDetector.cc:76-84`): "shi_tomasi" (GFTT
    # analog, default), "harris", "fast", or "orb" (pyramid FAST +
    # orientation + steered BRIEF descriptors, `frontend/orb.py`)
    feature_detector_type: str = "shi_tomasi"
    # ORB extractor params (`TrackerParams.hpp:81-84` OrbParams defaults)
    orb_scale_factor: float = 1.2
    orb_n_levels: int = 8
    orb_init_threshold_fast: int = 20
    orb_min_threshold_fast: int = 7
    # descriptor re-association of recently lost static tracks (an
    # extension of the reference's ExternalFlowFeatureTracker descriptor
    # path, whose descriptors are computed but never matched —
    # `StaticFeatureTracker.cc:81-83`); requires feature_detector_type
    # "orb".  A new detection whose descriptor mutually best-matches a
    # cooling-down slot within the radius revives that tracklet id.
    orb_reassociate: bool = False
    orb_reassoc_max_hamming: float = 50.0
    orb_reassoc_radius_px: float = 48.0
    cell_size: int = 30                       # occupancy grid bin (px)
    # instance-mask census: label values are capped to [0, max_instance_labels)
    # and an instance needs >= min_object_pixels mask support to become an
    # object slot (the analog of the reference's mask shrink/size gating)
    max_instance_labels: int = 256
    min_object_pixels: int = 50
    # pixel count at which a ByteTrack detection's score saturates to 1.0
    # (mask-area proxy for the detector confidence ByteTrack expects)
    byte_score_pixel_norm: float = 200.0
    klt_window: int = 21
    klt_levels: int = 3
    klt_iterations: int = 30
    klt_eps: float = 0.01
    # Pallas LK patch kernel on TPU (ops/pallas/lk.py); the pure-XLA path
    # stays for CPU and as an escape hatch
    use_pallas_klt: bool = True
    # Warm-start static KLT from the dense optical-flow input channel (a
    # mandatory pipeline input, same signal the reference's
    # ExternalFlowFeatureTracker trusts outright for static tracks,
    # `StaticFeatureTracker.cc:48-219`).  LK then only polishes sub-pixel
    # error, so the pyramid shrinks to `klt_warm_levels` and
    # `klt_warm_iterations` — strictly more accurate than external-flow
    # tracking, ~an order of magnitude cheaper than cold pyramidal LK.
    # The homography-RANSAC verification gate runs either way.
    klt_flow_warm_start: bool = True
    klt_warm_levels: int = 1
    klt_warm_iterations: int = 10
    # Skip the detection stage (CLAHE + response + NMS + slot fill) while
    # more than (1 - frac) * max_features_per_frame tracks survive.  0.0
    # (default) = always top up, the reference's behaviour
    # (`KltFeatureTracker::trackStatic` detects whenever tracked < max);
    # e.g. 0.05 tolerates a 5% feature deficit and runs detection as a
    # `lax.cond` branch only when the pool drains below it.
    redetect_min_free_fraction: float = 0.0


@dataclasses.dataclass(frozen=True)
class MotionSolverConfig:
    # reference: FrontendParams.yaml camera/object_motion_solver
    ransac_threshold_pnp: float = 0.2         # OpenGV angular units (unused
    #                                           by the pixel-space scorer)
    ransac_threshold_px: float = 2.0          # our reprojection threshold
    min_inliers: int = 5
    ransac_iterations: int = 500
    ransac_probability: float = 0.995
    ransac_threshold_mono: float = 2e-4       # MotionSolver.cc 2d2d default
    # 2d2d hypothesis count: each 8-point hypothesis costs a batched 9x9
    # eigh, and ALL batched small-LAPACK kernels serialize on TPU
    # (CLAUDE.md) — 500 of them cost ~8 ms/frame.  64 samples at ~85%
    # static-inlier ratio still find an all-inlier set with prob
    # 1 - 3e-9 (0.85^8 = 0.27 per draw); the final refit re-solves on the
    # best inlier SET either way.
    ransac_iterations_2d2d: int = 64
    ransac_threshold_stereo: float = 0.001    # 3d3d (opengv squared-distance
    #                                           units; see threshold_stereo_m)
    # metric 3d3d inlier radius used by our Arun scorer; the reference's
    # opengv threshold is in a different unit system, 0.1 m matches its
    # effective gate on KITTI-scale scenes
    ransac_threshold_stereo_m: float = 0.1
    # 2-pt translation-only mono solver when an external rotation prior is
    # available (MotionSolver.cc:161-177 `ransac_use_2point_mono`)
    ransac_use_2point_mono: bool = False
    # valid-slot compaction cap for the K x N hypothesis scoring: the ego
    # pool is NS + ND slots (~6144) with ~1000 live tracks, and the (K, N)
    # scoring intermediates scale with the pool.  Exact whenever the live
    # count <= cap (ops/ransac.py score_cap).  0 disables.
    ransac_score_cap: int = 1536


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    # reference: FrontendParams.yaml
    scene_flow_mag_threshold: float = 0.12
    scene_flow_dist_threshold: float = 0.5
    max_background_depth: float = 40.0
    max_object_depth: float = 25.0
    use_ego_motion_pnp: bool = True
    # ego-motion solver family, the analog of the reference's
    # EgoMotionSolver mode selection (`MotionSolver.cc:111-320`):
    #   "3d2d" — PnP RANSAC (RGB-D default, geometricOutlierRejection3d2d)
    #   "3d3d" — Arun point-cloud alignment (geometricOutlierRejection3d3d)
    #   "2d2d" — Nister-style essential matrix (geometricOutlierRejection2d2d),
    #            metric scale recovered from depth when available (mono path
    #            stays scale-free); with `ransac_use_2point_mono` and a
    #            constant-velocity rotation prior, the 2-pt translation-only
    #            solver is used instead
    # `use_ego_motion_pnp=False` is the legacy alias for "3d3d".
    ego_motion_solver: str = "3d2d"
    use_object_motion_pnp: bool = True
    refine_camera_pose_with_joint_of: bool = True
    refine_motion_with_joint_of: bool = True
    refine_motion_with_3d: bool = True
    joint_of_outlier_reject: bool = True
    refinement_3d_outlier_reject: bool = True
    # optimize -> remove-outlier-factors -> re-optimize rounds in the two
    # refinement stages (the reference hardcodes 4,
    # `MotionSolver-inl.hpp:194-232` / :406)
    refinement_outlier_rounds: int = 4
    # LM iteration cap per refinement round.  The refiners solve their
    # normal equations exactly per iteration (`backend/small_schur.py`), so
    # convergence is quadratic near the optimum and the while_loop's
    # early-exit does the real work; the cap bounds the SEQUENTIAL depth of
    # the fused frontend program on TPU (each iteration is a full
    # linearize+solve chain).  gtsam's LM on these tiny well-conditioned
    # problems converges in <= ~5 iterations; the rendered-sequence A/B
    # (scripts/ab_accuracy.py, BENCH_NOTES) shows cap 5 == cap 10 ATE while
    # saving ~7 ms/frame on TPU.
    refinement_max_lm_iterations: int = 5
    min_dynamic_features_per_object: int = 30  # VisionTools.cc demotion rule
    # per-frame cap on object slots that run the full motion solve
    # (RANSAC + refinements); slots are picked by point support.  The
    # reference solves only OBSERVED objects — this is the static-shape
    # analog (~3 ms/slot on TPU, so the cap directly buys frame time)
    max_active_objects: int = 8
    scene_flow_percentage: float = 0.5
    # objects classified static by scene flow contribute their points to the
    # NEXT frame's ego-motion solve (reference demotes such features to the
    # static set rather than discarding them)
    use_static_object_points_for_ego: bool = True
    use_motion_model_gating: bool = False      # motionModelOutlierRejection3d2d
    motion_model_threshold_px: float = 10.0
    camera_solver: MotionSolverConfig = dataclasses.field(default_factory=MotionSolverConfig)
    object_solver: MotionSolverConfig = dataclasses.field(default_factory=MotionSolverConfig)
    tracker: TrackerConfig = dataclasses.field(default_factory=TrackerConfig)


@dataclasses.dataclass(frozen=True)
class BackendConfig:
    # reference: params/backend.flags
    constant_object_motion_rotation_sigma: float = 0.01
    constant_object_motion_translation_sigma: float = 0.01
    motion_ternary_factor_noise_sigma: float = 1e-5
    odometry_rotation_sigma: float = 0.05
    odometry_translation_sigma: float = 0.1
    static_point_noise_sigma: float = 0.06
    dynamic_point_noise_sigma: float = 0.0625
    opt_window_size: int = 10
    opt_window_overlap: int = 4
    use_vo_factor: bool = True
    use_smoothing_factor: bool = True
    # ObjectKinematicFactor (`src/factors/ObjectKinematicFactor.cc:37-74`):
    # e = Log(L_k^-1 H L_{k-1}) tying consecutive object poses through a
    # motion.  The reference defines-but-never-adds it
    # (RGBDBackendModule.cc:46 includes the header only); here it is wired
    # as an optional WorldPose family using the frontend's measured motions
    # as H — default off to match the reference's effective behaviour.
    use_object_kinematic_factor: bool = False
    object_kinematic_sigma: float = 0.1
    use_full_batch_opt: bool = False
    backend_updater_enum: int = 0             # 0=MotionInWorld, 1=LLWorld
    # fixed-lag smoothing (the analog of the reference's
    # IncrementalFixedLagSmoother option, `RGBDBackendModule.hpp:45`):
    # marginalize the frames leaving each sliding window onto the boundary
    # camera pose and carry the 6x6 marginal as a full-covariance prior
    # replacing the isotropic gauge anchor (`backend/fixed_lag.py`).
    # Default off = the reference's fresh-rebuild behaviour.
    use_fixed_lag_prior: bool = False
    init_H_with_identity: bool = True
    # Schur-eliminated (variable projection) reduced solve over {X, H};
    # landmarks recovered in closed form (backend/varpro.py)
    use_varpro: bool = False
    # Direct reduced solver: eliminate landmark blocks exactly per LM
    # iteration and solve the dense {X, H} reduced system by Cholesky
    # (backend/schur.py) instead of matrix-free PCG.  ~4.5x faster to
    # convergence on window-10 solves (TPU v5e, BENCH_NOTES); windows
    # larger than `schur_max_window` (full-batch long sequences) fall
    # back to PCG, whose memory footprint is O(variables) not O(W^2).
    use_schur: bool = True
    schur_max_window: int = 16
    # Offline throughput pipeline only: solve this many pending sliding
    # windows per dispatch, vmapped (the window-10 solve is op-latency
    # bound, so batching ~halves its amortized per-frame cost).  Windows
    # in a batch warm-start from the state before ANY of them solved
    # (one writeback of staleness for the later windows — the online
    # pipeline and wpd=1 keep the reference's strictly sequential
    # semantics, `RGBDBackendModule.cc:343-388`).
    opt_windows_per_dispatch: int = 1
    # Window compaction: each window solve gathers only the top-K
    # most-observed track slots / objects before building its normal
    # system, so solve cost tracks window content rather than global pool
    # capacity (the reference's constructGraph(from,to) likewise rebuilds
    # window graphs from only the in-range map nodes,
    # `RGBDBackendModule.cc:280-341`).  0 disables; pools at or below the
    # cap are passed through untouched (bit-identical).
    window_max_static: int = 1024
    window_max_dynamic: int = 1024
    window_max_objects: int = 8
    # Formulation gating (Formulation.hpp:117-121)
    min_static_observations: int = 2
    min_dynamic_observations: int = 3
    # robust kernel (RGBDBackendModule noise models, Huber k)
    huber_k_static: float = 0.0001
    huber_k_dynamic: float = 0.0001
    # first pose prior sigma (RGBDBackendModule initial prior)
    initial_pose_prior_sigma: float = 1e-4
    # LM settings (gtsam LevenbergMarquardtParams defaults)
    lm_initial_lambda: float = 1e-5
    lm_lambda_factor: float = 10.0
    lm_max_lambda: float = 1e7
    lm_min_lambda: float = 1e-10
    lm_max_iterations: int = 30
    lm_rel_error_tol: float = 1e-5
    lm_abs_error_tol: float = 1e-5
    cg_max_iterations: int = 100
    cg_tol: float = 1e-6


@dataclasses.dataclass(frozen=True)
class CapacityConfig:
    """Fixed capacities for the slot pools (static shapes under jit)."""

    max_static_tracks: int = 2048    # NS: headroom over max_features
    #                                   for the slot-reuse cooldown
    max_dynamic_tracks: int = 6144   # ND (incl. cooldown headroom)
    max_objects: int = 16            # O
    max_frames: int = 512            # F cap for full-batch state


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    # reference: params/pipeline.flags
    data_provider_type: int = 0
    starting_frame: int = -1
    ending_frame: int = -1
    use_backend: bool = True
    # reference `prefer_data_provider_camera_params` (PipelineParams): use
    # the dataset's own calibration over `camera_params_yaml`
    prefer_data_provider_camera_params: bool = True
    camera_params_yaml: Optional[str] = None
    output_path: Optional[str] = None
    save_frontend_json: bool = False
    frontend_from_file: bool = False
    use_frontend_logger: bool = False


@dataclasses.dataclass(frozen=True)
class DynoConfig:
    """Aggregate of all param groups (analog of `DynoParams`,
    `pipeline/PipelineParams.hpp:43-78`)."""

    frontend: FrontendConfig = dataclasses.field(default_factory=FrontendConfig)
    backend: BackendConfig = dataclasses.field(default_factory=BackendConfig)
    capacity: CapacityConfig = dataclasses.field(default_factory=CapacityConfig)
    pipeline: PipelineConfig = dataclasses.field(default_factory=PipelineConfig)


def _coerce_to(cur, v):
    """Coerce a string override to the field's current type (CLI `--set`
    values and YAML scalars arrive as strings; a truthy "false" or a "5"
    that fails `<` against a traced int are classic silent-config bugs)."""
    if not isinstance(v, str) or isinstance(cur, str) or cur is None:
        return v
    if isinstance(cur, bool):
        return v.strip().lower() in ("1", "true", "yes", "on")
    if isinstance(cur, int):
        return int(v)
    if isinstance(cur, float):
        return float(v)
    return v


def _update_dataclass(obj, data: dict):
    import dataclasses as _dc

    kwargs = {}
    for f in _dc.fields(obj):
        if f.name not in data:
            continue
        cur = getattr(obj, f.name)
        v = data[f.name]
        if _dc.is_dataclass(cur) and isinstance(v, dict):
            kwargs[f.name] = _update_dataclass(cur, v)
        else:
            kwargs[f.name] = _coerce_to(cur, v)
    return dataclasses.replace(obj, **kwargs)


def load_config(yaml_path: Optional[str] = None, overrides: Optional[dict] = None) -> DynoConfig:
    """Build a DynoConfig from an optional YAML file + flat overrides.

    The YAML mirrors the dataclass structure (frontend/backend/capacity/
    pipeline groups); `overrides` accepts dotted keys
    (e.g. {"backend.opt_window_size": 20}) — the analog of the reference's
    gflags-over-YAML layering (`README.md:241-279`).
    """
    cfg = DynoConfig()
    if yaml_path:
        import yaml as _yaml

        with open(yaml_path) as f:
            data = _yaml.safe_load(f) or {}
        cfg = _update_dataclass(cfg, data)
    if overrides:
        nested: dict = {}
        for key, v in overrides.items():
            parts = key.split(".")
            d = nested
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = v
        cfg = _update_dataclass(cfg, nested)
    return cfg
