"""Typed configuration for the whole engine (a copy of the JAX
reference package's ``config.py``: same dataclasses, field names and
defaults).

One dataclass tree covering everything the reference reads from YAML
(``/root/reference/Examples/RGB-D/TUM1.yaml`` via ``Tracking.cc:53-147``)
*plus* every constant the reference hard-codes in source (line-matcher
thresholds ``LineMatcher.h:94-98``, line budget ``LineExtractor.cpp:23``,
tracking decision thresholds throughout ``Tracking.cc``), so behavior is
tunable without touching code.

All fields are python scalars, so configs are hashable.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from .geometry.projection import Camera


@dataclass(frozen=True)
class OrbConfig:
    """ORBextractor settings (TUM1.yaml ORBextractor.* + ORBextractor.cc)."""

    n_features: int = 1000          # ORBextractor.nFeatures
    scale_factor: float = 1.2       # ORBextractor.scaleFactor
    n_levels: int = 8               # ORBextractor.nLevels
    ini_th_fast: int = 20           # ORBextractor.iniThFAST
    min_th_fast: int = 7            # ORBextractor.minThFAST
    cell_size: int = 32             # ~30px cells (ORBextractor.cc:790); 32 tiles better
    max_kp_per_cell: int = 8        # spatial balancing cap (replaces quadtree)
    patch_size: int = 31            # IC-angle / descriptor patch
    edge_threshold: int = 19        # border margin (ORBextractor.cc EDGE_THRESHOLD)
    max_keypoints: int = 1024       # padded capacity of FrameState arrays
    # Kept for field parity with the JAX package's OrbConfig. The port ignores
    # it: on CUDA the FAST score+NMS always runs the hand-written kernel
    # (ops/fast.py::fast_score_nms).
    use_pallas_fast: bool = False


@dataclass(frozen=True)
class LineConfig:
    """Line extraction + matching (LineExtractor.cpp, LineMatcher.h:94-98)."""

    max_lines: int = 96             # padded capacity (reference keeps top 80)
    keep_top: int = 80              # LineExtractor.cpp:23
    min_length_px: float = 24.0     # minimum segment length to keep
    grad_threshold: float = 30.0    # gradient magnitude gate for support pixels
    n_orientation_bins: int = 12    # orientation quantization for detection
    rho_bin_px: float = 2.0         # perpendicular-offset histogram resolution
    gap_tolerance_px: float = 8.0   # max gap when finding the longest run
    # LBD descriptor
    lbd_n_bands: int = 9
    lbd_band_width: int = 7
    # matching thresholds (LineMatcher.h:94-98)
    angle_th_deg: float = 15.0      # mfAngleTh
    length_ratio_th: float = 0.45   # length similarity gate
    overlap_th: float = 0.5         # axis-projection overlap gate
    # LBD gate in NORMALIZED squared-L2 units over the quantized 72-dim
    # descriptor (ops/lbd.py; the reference gates OpenCV-LBD Hamming bits
    # at 45 — our descriptor is the float LBD vector, where measured
    # true-pair distances sit ~0.15-0.2 and wrong pairs ~1.0)
    desc_dist_th: float = 0.6
    reproj_err_th: float = 45.0     # endpoint reprojection gate (px)
    relax_offsets: tuple = (10.0, -0.1, -0.1, 0.2, 10.0)  # retry relaxation
    low_match_ratio: float = 0.2    # retry trigger: matches/NL < 0.2


@dataclass(frozen=True)
class MatcherConfig:
    """ORB point matcher (ORBmatcher.cc:49-51 + call sites in Tracking.cc)."""

    th_low: int = 50
    th_high: int = 100
    nn_ratio_tracking: float = 0.9
    nn_ratio_reloc: float = 0.75
    histo_length: int = 30          # rotation-consistency histogram bins
    check_orientation: bool = True
    search_radius_motion: float = 15.0   # th in TrackWithMotionModel
    search_radius_local: float = 3.0     # th in SearchLocalPoints (RGB-D uses
                                         # th=3, Tracking.cc:1756-1762; tighter
                                         # values cause confirmation-bias drift)


@dataclass(frozen=True)
class TrackingConfig:
    """Frontend state machine thresholds (Tracking.cc)."""

    # In the reference mMinFrames=0 but LocalMapping's busy flag throttles
    # insertion to every few frames; our mapping pass is synchronous, so an
    # explicit minimum models the same backpressure (without it every frame
    # becomes a keyframe, points get culled young, and covisibility starves).
    min_frames_between_kf: int = 3
    max_frames_between_kf: int = 30       # fps (Tracking.cc:90-95)
    # gray bits kept by the input quantization (top bits, restored with a
    # half step); the JAX package's results depend on it, so the port keeps
    # it. 8 = lossless.
    gray_wire_bits: int = 6
    th_depth: float = 40.0 / 12.5         # bf * ThDepth/fx semantic; set via yaml
    depth_map_factor: float = 5000.0
    rgb_order: bool = False               # Camera.RGB
    min_inliers_motion: int = 20          # TrackWithMotionModel success gate
    min_inliers_ref_kf: int = 15
    # When the motion stage lands under this, the fused step runs the
    # TrackReferenceKeyFrame-equivalent rescue (windowless local-map match
    # + pose LM from the last pose, Tracking.cc:335-337,942-1032).
    rescue_min_inliers: int = 20
    min_inliers_local_map: int = 30
    min_inliers_local_map_recent_kf: int = 50
    temporal_points_cap: int = 100        # UpdateLastFrame (Tracking.cc:1136)
    temporal_lines_cap: int = 45          # UpdateLastFrame (Tracking.cc:1207)
    local_map_kf_cap: int = 80            # UpdateLocalKeyFrames (Tracking.cc:1981)
    reloc_min_inliers: int = 10
    reset_if_lost_with_kfs_leq: int = 5
    # Frames in flight before a result is retired (0 = auto, which is 1 in
    # the port: a local device has no fetch latency to hide, and lagged
    # keyframe decisions cost tracking quality on fast motion).
    pipeline_depth: int = 0


@dataclass(frozen=True)
class MappingConfig:
    """LocalMapping pass (LocalMapping.cc)."""

    culling_min_found_ratio: float = 0.25
    # The reference culls landmarks with <=3 observations at age 2
    # (LocalMapping.cc:280, cnThObs=3) — viable there because triangulated
    # points are born with 2 observations. This engine seeds landmarks from
    # RGB-D depth (direct 3D evidence, no multi-view confirmation needed),
    # so the bar is one lower; 3 starves covisibility under fast rotation.
    culling_min_obs: int = 2
    triangulation_neighbors: int = 10     # top-N covisible KFs (stereo/RGB-D)
    kf_culling_redundancy: float = 0.9    # ≥90% MPs seen ≥3x elsewhere
    covisibility_weight_min: int = 15     # UpdateConnections threshold
    local_ba_window: int = 32             # padded local-KF capacity
    local_ba_fixed_cap: int = 32
    local_ba_point_cap: int = 4096
    local_ba_obs_cap: int = 16384
    local_ba_line_cap: int = 256
    local_ba_lobs_cap: int = 1024
    local_ba_iters1: int = 5
    local_ba_iters2: int = 10
    # Above this camera count the Schur solve switches from the dense
    # (C,C,6,6) reduced system to the matrix-free PCG solver (optim.ba_cg)
    # — O(P*C) memory for the off-diagonal blocks vs O(O) for CG. 64 keeps
    # every local-BA window dense (fastest small solve) and routes
    # whole-map GBA through CG.
    ba_dense_camera_cap: int = 64
    ba_cg_iters: int = 48                 # PCG iterations per LM step
    # Past the dense cap, when >1 device is visible (one host's chips or a
    # multi-host slice), whole-map GBA shards its landmark
    # blocks over the mesh (parallel.ba.distributed_bundle_adjust)
    use_distributed_ba: bool = True
    distributed_ba_iters: int = 8         # damped GN steps on the mesh


@dataclass(frozen=True)
class LoopConfig:
    """LoopClosing + KeyFrameDatabase (LoopClosing.cc, KeyFrameDatabase.cc)."""

    min_kf_gap: int = 10
    covisibility_consistency_th: int = 3
    bow_share_ratio: float = 0.8          # 0.8 * maxCommonWords
    acc_score_ratio: float = 0.75
    sim3_min_matches: int = 20
    sim3_min_inliers: int = 20
    loop_accept_matches: int = 40
    # Group-connectivity gate: candidates whose covisibility group is
    # already connected to the current group by >= this many shared points
    # are dropped (the drift is reconciled; a Sim3 correction would tear
    # fusion apart). Well ABOVE the generic covisibility threshold (15):
    # per-KF fusion at a revisit routinely creates a few dozen shared
    # points before a loop event fires, and a genuine large-drift loop
    # must not be suppressed by that trickle.
    group_connectivity_min: int = 60
    essential_graph_iters: int = 20
    gba_iters: int = 10
    fix_scale: bool = True                # RGB-D: scale observable


@dataclass(frozen=True)
class MapCapacity:
    """Fixed-capacity arena sizes (device-side map arrays)."""

    max_keyframes: int = 1024
    max_points: int = 65536
    max_lines: int = 8192
    max_obs_per_point: int = 32
    max_obs_per_line: int = 24


@dataclass(frozen=True)
class CloudConfig:
    """Dense point-cloud mapping (PointCloudMapping.cc)."""

    pixel_stride: int = 3
    depth_min: float = 0.01
    depth_max: float = 10.0
    voxel_size: float = 0.01


@dataclass(frozen=True)
class SlamConfig:
    camera: Camera = field(default_factory=Camera)
    orb: OrbConfig = field(default_factory=OrbConfig)
    lines: LineConfig = field(default_factory=LineConfig)
    matcher: MatcherConfig = field(default_factory=MatcherConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    mapping: MappingConfig = field(default_factory=MappingConfig)
    loop: LoopConfig = field(default_factory=LoopConfig)
    capacity: MapCapacity = field(default_factory=MapCapacity)
    cloud: CloudConfig = field(default_factory=CloudConfig)
    use_lines: bool = True

    def replace(self, **kw) -> "SlamConfig":
        return dataclasses.replace(self, **kw)


def tum1_config() -> SlamConfig:
    """The reference's TUM1.yaml settings (freiburg1 camera)."""
    cam = Camera(
        fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989,
        k1=0.262383, k2=-0.953104, p1=-0.005358, p2=0.002628, k3=1.163314,
        bf=40.0, width=640, height=480,
    )
    return SlamConfig(
        camera=cam,
        tracking=TrackingConfig(
            max_frames_between_kf=30, th_depth=40.0 / 517.306408 * 40.0,
            depth_map_factor=5000.0,
        ),
    )


def load_yaml(path: str) -> SlamConfig:
    """Load an OpenCV-style settings YAML (the reference's TUM*.yaml format)."""
    import re

    vals: dict[str, float] = {}
    with open(path) as f:
        for line in f:
            m = re.match(r"\s*([A-Za-z0-9_.]+)\s*:\s*([-+0-9.eE]+)", line)
            if m:
                try:
                    vals[m.group(1)] = float(m.group(2))
                except ValueError:
                    pass
    cam = Camera(
        fx=vals.get("Camera.fx", 525.0),
        fy=vals.get("Camera.fy", 525.0),
        cx=vals.get("Camera.cx", 319.5),
        cy=vals.get("Camera.cy", 239.5),
        k1=vals.get("Camera.k1", 0.0),
        k2=vals.get("Camera.k2", 0.0),
        p1=vals.get("Camera.p1", 0.0),
        p2=vals.get("Camera.p2", 0.0),
        k3=vals.get("Camera.k3", 0.0),
        bf=vals.get("Camera.bf", 40.0),
        width=int(vals.get("Camera.width", 640)),
        height=int(vals.get("Camera.height", 480)),
    )
    orb = OrbConfig(
        n_features=int(vals.get("ORBextractor.nFeatures", 1000)),
        scale_factor=vals.get("ORBextractor.scaleFactor", 1.2),
        n_levels=int(vals.get("ORBextractor.nLevels", 8)),
        ini_th_fast=int(vals.get("ORBextractor.iniThFAST", 20)),
        min_th_fast=int(vals.get("ORBextractor.minThFAST", 7)),
    )
    tracking = TrackingConfig(
        max_frames_between_kf=int(vals.get("Camera.fps", 30)),
        th_depth=cam.bf * vals.get("ThDepth", 40.0) / cam.fx,
        depth_map_factor=vals.get("DepthMapFactor", 5000.0),
        rgb_order=bool(vals.get("Camera.RGB", 1)),
    )
    return SlamConfig(camera=cam, orb=orb, tracking=tracking)
