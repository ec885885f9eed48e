#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`dynosam_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit (`nvcc`).  Phases, in order; any failure exits non-zero and prints
no result line:

1. card   -- `nvidia-smi` name and power limit, `torch.cuda.get_device_name`;
2. build  -- nvcc builds every kernel of the port (`dynosam_tpu_torch/csrc`)
             for sm_90a; prints the build seconds and ptxas' resource usage;
3. kernels -- each kernel (K1 LK level, K2 point sampler, K3 Shi-Tomasi
             response, K4 ORB orientation and steered BRIEF) at the
             frontend's main-path shapes on KITTI-sized rendered frames,
             held against its plain PyTorch version on the card within a
             stated tolerance, then timed with CUDA events beside its plain
             version, the library yardstick where one exists, and its bound.
             K5 (the refinement rounds, both kinds) and K6 (the motion
             RANSAC, 3d2d and 3d3d) on every call that eager steps make on
             the main path's frames (and, for 3d3d, the same frames in that
             ego mode) and on the golden scene: each against its plain
             version on the card, with tolerances from the plain version's
             own spread (the plain version on the CPU against it on the
             card, K_MARGIN times that, at least ULP_FLOOR); counts and
             inlier rows may differ only where a residual lies within that
             spread of its threshold or of the chi^2 gate (such rows are
             counted and printed); every call launched twice and the two
             results equal bit for bit; then timed per call, on the device (the
             profiler; K6's scoring and polish kernels also apart) and plain,
             beside a bound from the FLOPs and bytes this data needs (no
             single PyTorch call computes either), with each kernel's launch
             shape (clusters, CTAs, threads, dynamic shared memory) and
             ptxas' registers and spills; then a frontend-only run over 4
             frames whose graphed steps must launch both and equal the eager
             steps bit for bit.
             K1 is also held on slots within 10 px of the border and on
             slots whose warm start is off by more than its staged window's
             margin; K2 on float32, int32, bool and strided channels read in
             place, `valid=None` and a (C, H, W) tensor, and its main-path
             call forms (C=1 depth, the flow's two planes, depth + int32
             mask) are timed beside `grid_sample`; K3 also on noise at
             shapes off its tile (37x53, 5x1290, 400x7, 1x1); K4 also at
             1, 7 and 33 keypoints and on keypoints off the canvas, NaN
             and within 15 px of a level seam;
4. main path -- the frontend-only pipeline (`DynoPipeline`, use_backend
             False, Shi-Tomasi detector) on 12 rendered 1280x384 frames
             with 3 moving objects: frames/s over the steady frames, kernel
             launches per frame (fails unless K1, K2 and K3 launched on
             every steady frame), camera ATE against the renderer's ground
             truth (fails unless finite and <= 0.05 m) and the objects with
             a valid motion;
5. ORB path -- the same pipeline and frames with the ORB detector
             (`testing/scenes.py:kitti_orb_config`): the same report; fails
             unless K4, K1 and K2 launched on every steady frame and K3 on
             none, or the ATE is above 0.05 m;
6. pipeline path -- the offline pipeline with the sliding-window backend
             (`throughput.make_offline_runner`, `kitti_pipeline_config`:
             window 10, overlap 4, 7 LM iterations) over 22 rendered frames
             of the same scene (4 + 3 segments of 6: three window solves,
             two warm-started from the previous write-back): ms per frame
             and frames/s, each window's solve time between CUDA events,
             LM iterations, initial and final error, host reads (counted
             by PyTorch's sync debug mode) and objects with an active
             motion; fails unless K1, K2 and K3 launched on every frame
             after the first and K4 on none, every window's final error is
             finite and below its initial error, the estimate store covers
             frames 0..21 and the backend camera ATE is under 0.06 m; then
             the window solves' CUDA graphs (`schur.lm_optimize_schur`
             replays each LM iteration; `GraphedSolves`): captures in the
             run, replays per window, and each window solved again on its
             own inputs graphed and eager (`_graphs=False`), both timed with
             CUDA events; fails unless each window replayed the head plus
             one graph per LM iteration and its run's result equals the
             eager solve and the graphed repeat bit for bit;
7. golden  -- the round's accuracy bar on the card: the golden scene of
             `tests/test_accuracy_regression.py` (32 frames 120x160, 2
             moving objects, 0.5 px flow and 1 % depth noise) through
             `pipeline.run_and_log` with the full-batch backend (one LM-PCG
             solve over 32 frames) and the port's `evaluate_all`: every
             frontend band (`:123-134`), the backend bands and the 0.8x
             object-improvement check (`:137-152`), and the sliding-vs-batch
             ordering (`:155-163`, sliding windows through
             `run_from_packets`); prints the full-batch solve's time (CUDA
             events), LM iterations, CG iterations per LM iteration and host
             reads; fails unless K1, K2 and K3 launched on every frame after
             the first;
8. online -- the default-config online pipeline at KITTI width, as a CLI
             user runs it: `run_and_log` (`DynoPipeline` with `RGBDBackend`,
             `BackendConfig()`: window 10, overlap 4, 30 LM iterations,
             `max_frames` 512) over the 22 frames of the pipeline path, then
             `evaluate_all`: ms per spin and each window's solve time, LM
             iterations and host reads from that run, and frames/s end to
             end (spins and `finish`) from a second, unprobed run; fails
             unless the windows
             start at 0, 6, 12 and (the final partial window) 18, every
             window's final error is below its initial error, the frontend
             and backend camera ATE are under 0.05 and 0.06 m, and K1, K2
             and K3 launched on every frame after the first and K4 on none;
             then the window solves' graphs as in the pipeline path, and the
             kernels of one eager reduced-system factorisation at the
             window's size (cuSOLVER, which a capture can hold, or MAGMA);
             then K7-K9 (`csrc/window.cu`: the WorldMotion window LM's
             build, Schur reduction and update, the update also at a zero
             step as the LM head) on the run's first window (no active
             motion factor, F1) and on the simulator's window-10 scenario
             (active motion factors), through `testing/window_check.py`:
             every entry of each kernel's outputs within K_MARGIN times
             its plain version's float32 spread on the entry's block (a
             6x6 block of Hcc or the reduced system, a point's vector;
             the plain version on the CPU and at inputs moved by one or
             two ulps), at least ULP_FLOOR of the block's scale, each
             kernel twice bit
             for bit, K9 rejecting a failed factorisation as its plain
             version does, each window solved graphed through K7-K9
             against the ATen pieces (error within 3e-2, camera within
             2e-3 m, iterations within 2); each kernel timed per call and
             on the device beside its plain version and a bound from the
             FLOPs and bytes that window needs, with its launch shape and
             ptxas' registers and spills; each window solved graphed under
             the profiler (`testing/window_split.py`): every kernel's
             device time a launch and an LM iteration, K7's, K8's, the
             factorisation's (cuSOLVER) and K9's, failing above 5 kernels
             an LM iteration for K8 and K9;
             then 6 frames of the same configuration, each spin's graph
             replays and host reads by site: fails unless every steady
             spin replays two graphs and reads the host at most 3 times,
             never in a refinement or a RANSAC;
9. world pose -- the online phase's run with WorldPose (`backend_updater_enum`
             1) and the fixed-lag boundary prior: the same report plus
             each boundary-prior build's time and host reads; fails unless
             the windows are those of the online phase, every error drops,
             the backend log is `rgbd_LL_world_backend` with camera ATE
             under 0.06 m, K1-K3 launched on every frame after the first,
             and the graphed solves pass the online phase's checks;
10. batched -- the offline pipeline with `opt_windows_per_dispatch` 2 over
             the first 16 frames of the pipeline path's scene (windows 0
             and 6 in one dispatch): ms per dispatch, LM iterations and host
             reads per window; the same packets replayed through a
             sequential runner give the windows' sequential reads; fails
             unless the batched store's masks equal the sequential store's
             and its camera translations are within twice the later
             window's anchor shift plus BATCHED_TOL_M of them, and K1-K3
             launched on every frame after the first.

11. ego modes -- the main path's frames through the frontend-only pipeline
             with `ego_motion_solver` "3d2d" (the main path's, for its host
             reads), "3d3d", "2d2d" and "2d2d" with the 2-point solver
             (`ransac_use_2point_mono`): frames/s, host reads
             per frame (sync debug mode) and the frames whose ego solve is
             valid; fails unless K1-K3 launched on every steady frame and
             K4 on none, or a camera ATE is above 0.05 m;
12. masks  -- the online pipeline (`kitti_online_config`, 22 frames) with
             `use_propogate_mask` and `use_byte_tracker`, fed host frames
             whose instance ids are permuted on every frame and whose first
             object is deleted on frames 7 and 14; fails unless ByteTrack
             gives each rendered object one id while it is whole in view,
             propagation restores MASK_RESTORED of the deleted object's
             rendered pixels at MASK_PRECISION, the frontend and backend
             camera ATE are under 0.05 and 0.06 m, and K1-K3 launched on
             every frame after the first;
13. rectify -- the 12 rendered frames distorted (radtan [-0.15, 0.03, 0,
             0]) and read back as host frames through a `DatasetProvider`
             with `distortion` set, so the card rectifies them (the mask
             by the same index on the host): the rectifier's full-frame K2
             call (N = H * W, gray and flow planes bilinear, depth
             nearest) against its plain version (fails above PS_TOL_REL or
             on a nearest sample that differs), timed beside its plain
             version, `grid_sample` and its bound; fails unless the
             rectified interior recovers the render (RECTIFY_*), and the
             frontend-only pipeline on the rectified frames launches K1-K3
             on every steady frame with camera ATE <= 0.05 m;
14. stereo -- the block matcher at 1280x384, D = 64, on a textured pair of
             disparity 8: ms per call, peak memory; fails unless more than
             80 % of interior pixels are within 1 px, the median depth is
             within 10 % of the truth and the result equals the CPU run's
             (valid pixels, sub-pixel values within STEREO_CPU_TOL);
15. streaming -- the pipeline path's 22 frames written in the KITTI layout,
             read back by `KittiDataset` through the native decoder (fails
             unless `native/libdynoloader.so` loads) as they decode, into
             `throughput.run_streaming`: frames/s with decode overlapped;
             fails unless the store equals `run_offline`'s on the decoded
             frames bit for bit, the backend camera ATE is under 0.06 m and
             K1-K3 launched on every frame after the first.

16. multi-sequence -- `parallel.batch_eval.MultiSequencePipeline` over two
             KITTI-width sequences (`kitti_config`; scenes rendered from
             seeds 0 and 1, 12 frames each) in lockstep: frames/s summed
             over sequences and host reads per lockstep frame; fails unless
             K1-K3 launch twice as often per steady frame as on the main
             path, each sequence's camera ATE is within ATE_LIMIT_M and its
             packets equal its single-sequence `frontend_step` run under
             the same generators;
17. distributed -- a one-rank NCCL group (`multihost.initialize(...,
             device="cuda")`, `make_mesh(1)`): `distributed_schur_optimize`
             for both updaters on the pipeline path's first window (compacted
             as the backend compacts it) and on the window-10 simulator
             scenario, each against `lm_optimize_schur` on the same inputs
             (iterations within 1, error within DIST_ERR_RTOL, camera
             translations within DIST_X_TOL_M), and `distributed_optimize`
             on the golden full batch against the single-device LM-PCG with
             Hutchinson's diagonal, as JAX's solves (the same LM
             iterations, error within DIST_ERR_RTOL, camera translations
             within DIST_X_TOL_M; the
             analytic-diagonal solve printed beside both); ms per solve
             (CUDA events), host reads, collectives per LM iteration (2 on
             one frame block for the Schur solve; 7 with a split frame axis,
             counted on the CPU); then `mp_worker` as one
             process with `--device cuda`, whose verdict must be ok; the
             group is destroyed at the end of the phase;
18. tools  -- `utils.debug.deterministic_replay` at atol 0 of one
             KITTI-width `frontend_step`, of the pipeline's first window
             solve and of the golden full-batch LM-PCG; `nan_debug` on the
             window solve with a NaN in one static measurement must raise
             and name the operator.

19. evaluation -- the evaluation tools of `dynosam_tpu_torch/scripts/`:
             the experiment sweep's 6 rows (`experiment_sweep.sweep_row`)
             on its own layout (16 frames 192x256, 2 yaw-only objects,
             written from a render on the card): each row's camera ATEs
             and wall seconds; fails unless K1-K3 launched on every frame
             after the first of every row and K4 on none, every backend
             ATE is finite, and each row's frontend and backend camera ATE
             lie within SWEEP_TOL_M of the JAX package's committed sweep
             (`artifacts/experiments/results.json`, the same layout on the
             CPU), the band `tests/test_torch_scripts.py` holds the port's
             sweep row to against JAX; then the sliding-vs-batch study
             (`sliding_vs_batch.compare`, the simulator's 24 frames):
             both runs' final errors and the mean and maximum of each
             error curve, which must be finite; then `run_experiments` and
             `kitti_semantic_to_motion` on an 8-frame layout in a
             temporary directory: fails if `results.json` or a motion mask
             is missing, or a mask read back differs from the one
             written.

The golden phase also runs drift recovery (`tests/test_accuracy_regression.py:166-228`)
for both updaters: the golden packets with a growing camera drift through
the full-batch backend, 100 LM iterations allowed; it fails unless each
recovered ATE is below the corrupted ATE / 1.8 and 0.11 m (JAX's bounds).

Launch counts are set to 0 just before each path and read just after it.
Every path that runs the frontend must launch K5 and K6 on every frame
after the first (the 2d2d ego modes run K6 for the objects only), and
every graphed steady step must read the host at most twice (the `eigh`).
The pipeline and online paths must launch K8 once per LM iteration of
their window solves, K9 once per iteration and once a solve (its head)
and K7 at least once a solve; the world pose path none of them.

The first line is the card's name and power limit as `nvidia-smi` gives
them; the line before the last is a JSON object with one entry per kernel,
the last line `{"ok": true, "device": {...}}`.  Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks at the full 700 W (NVIDIA data sheet): HBM bytes/s and
# float32 FLOP/s outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

# Tolerances of each kernel against its plain version on the same inputs.
LK_TOL_PX = 0.05       # flow; the eps stop may fall one step apart
LK_TOL_ERR = 0.1       # mean |residual| in grey levels, same reason
PS_TOL_REL = 1e-5      # bilinear samples, relative to max |value|
RESP_TOL_REL = 1e-5    # response, relative to max |response|
# K4: the plain version repeats the kernel's float32 arithmetic in its
# order, so only atan2's last place may differ; descriptor bits may flip
# only where a tap pair is tied to that last place
ORB_TOL_ANGLE = 1e-5   # rad
ORB_MIN_BITS = 0.999   # share of descriptor bits that agree
ATE_LIMIT_M = 0.05
BACKEND_ATE_LIMIT_M = 0.06   # the JAX sliding-window band (tests/test_accuracy_regression.py:162)
PIPELINE_FRAMES = 22         # overlap 4 + 3 segments of stride 6
# the golden bands (tests/test_accuracy_regression.py:123-163)
GOLDEN_FRONTEND = {"ate_trans_rmse": 0.010, "rpe_trans_rmse": 0.004, "rpe_rot_deg_rmse": 0.03}
GOLDEN_FRONTEND_OBJECTS = {"ame_trans_rmse": 0.30, "ame_rot_deg_rmse": 3.0, "rme_trans_rmse": 0.08}
GOLDEN_BACKEND_ATE_M = 0.022
GOLDEN_BACKEND_AME_M = 0.15
GOLDEN_IMPROVEMENT = 0.8     # backend AME (both parts) below 0.8x the frontend's
GOLDEN_SLIDING_ATE_M = 0.06
GOLDEN_ORDERING = 1.10       # full-batch ATE at most 1.10x the sliding windows'
# drift recovery (tests/test_accuracy_regression.py:166-228): the drift per
# frame (rotation, translation tangent) and JAX's bounds
DRIFT_PER_FRAME = (0.0, 0.0015, 0.0, 0.02, 0.008, 0.0)
DRIFT_FACTOR = 1.8           # recovered ATE below the corrupted ATE / 1.8
DRIFT_ATE_M = 0.11
# batched windows against the sequential run: the later window of a
# dispatch warm-starts and anchors on the store as it stood before the
# dispatch (there: the frontend pose of its first frame), not on the
# previous window's estimate, so the window moves with the difference
# between the two anchors; the stores may differ by twice that shift plus
# BATCHED_TOL_M for the LM's stopping tolerance
BATCHED_TOL_M = 1e-4
BATCHED_FRAMES = 16          # overlap 4 + 2 segments of 6: one dispatch of 2 windows
# slice 8: the alternate ego modes (path key, label, solver, 2-point prior),
# after the main path's 3d2d mode run the same way for its host reads
EGO_MODES = (("ego_3d2d", "ego 3d2d (the main path's mode)", "3d2d", False),
             ("ego_3d3d", "ego 3d3d", "3d3d", False), ("ego_2d2d", "ego 2d2d", "2d2d", False),
             ("ego_2point", "ego 2d2d 2-point", "2d2d", True))
# masks: the first object is deleted from the segmenter's mask on these two
# non-adjacent frames (JAX propagates from the previous frame's segmenter
# mask, not the propagated one); propagation must restore this share of its
# rendered pixels, with this share of the restored label on the object.
# The forward scatter of rounded targets (JAX's algorithm) leaves holes
# where the 0.5 px flow noise sends two pixels to one target: 0.68 of the
# pixels came back in a 640x192 CPU rehearsal
MASK_DELETED = (7, 14)
MASK_RESTORED = 0.5
MASK_PRECISION = 0.95
# rectify: the lens of `tests/test_distortion.py:77-140`; the interior margin
# (rows, columns) and what the rectified render must recover there: median
# |gray difference| (grey levels, after two bilinear resamplings), the share
# of depth pixels within RECTIFY_DEPTH_REL (nearest neighbour twice on a
# sloped surface lands a pixel off) and of mask pixels equal, the share of
# flow vectors within RECTIFY_FLOW_PX
RECTIFY_COEFFS = (-0.15, 0.03, 0.0, 0.0)
RECTIFY_MARGIN = (16, 32)
RECTIFY_GRAY = 1.0
RECTIFY_SHARE = 0.98
RECTIFY_DEPTH_REL = 0.01
RECTIFY_FLOW_PX = 0.1
RECTIFY_FLOW_SHARE = 0.95
# stereo: a pair of constant disparity; the acceptance of `tests/test_stereo.py`
STEREO_DISPARITY = 8
STEREO_HIT = 0.8             # share of interior pixels within 1 px
STEREO_DEPTH_REL = 0.10      # median depth against the true depth
STEREO_CPU_TOL = 1e-4        # px, sub-pixel values against the CPU run (float32 order)
# slice 9: sequences of the multi-sequence phase (scene seeds), and the
# float32 tolerances of a distributed window solve against the
# single-device one (`tests/test_torch_schur.py`): iterations within 1,
# error rtol, camera translations (m)
MULTI_SEEDS = (0, 1)
DIST_ERR_RTOL = 3e-2
DIST_X_TOL_M = 2e-3
# slice 11: the evaluation phase.  The sweep's frames and objects (the JAX
# package's committed sweep, `artifacts/experiments/results.json`); each
# row's camera ATEs against that table within the band
# `tests/test_torch_scripts.py` holds the port's sweep row to against JAX
# on one layout (1e-3 m, inside `tests/test_torch_pipeline.py:354-355`'s
# 3e-3 m); the sliding-vs-batch frames (the JAX script's default) and the
# frames of the run_experiments / motion-mask layout
SWEEP_FRAMES = 16
SWEEP_OBJECTS = 2
SWEEP_TOL_M = 1e-3
SVB_FRAMES = 24
EVAL_LAYOUT_FRAMES = 8

# FLOPs counted per unit of work (adds, subtracts, multiplies, divides,
# square roots; clamps and index arithmetic not counted).
FLOP_BILINEAR = 13     # 2 weight complements, 8 products, 3 sums
FLOP_LK_GRAD = 10      # 2 differences, 2 halvings, 3 products, 3 sums
FLOP_LK_STEP = 18      # bilinear sample, residual, 2 multiply-adds
FLOP_LK_SOLVE = 12     # 2x2 solve and clamp of one step
FLOP_LK_ERR = 15       # bilinear sample, residual, abs-add
FLOP_RESPONSE = 100    # Sobel 2x11, 3 products, 3x24 box sums, 3 divides, lambda_min 9
FLOP_ORB_MOMENT = 4    # per disc pixel: 2 products, 2 sums
FLOP_ORB_KEYPOINT = 6  # r (2 products, 1 sum, 1 root), ca and sa (2 divides); atan2 not counted
FLOP_ORB_TAP = 8 + FLOP_BILINEAR   # rotation (4 products, 4 sums), bilinear sample
# K5 and K6, counted from their sources: per row and LM iteration, the
# linearisation, the track's elimination and its part of S (pass A) and the
# back-substitution and trial error (pass B); per row and round, the head's
# and the tail's residuals
FLOP_K5_ITERATION_ROW = {"FlowPose": 800, "MotionOnly": 3300}
FLOP_K5_ROUND_ROW = {"FlowPose": 90, "MotionOnly": 200}
FLOP_K6_HYPOTHESIS = 200   # two triads, R = F E^T, centroids, t (and the inverse in 3d2d)
FLOP_K6_SCORE_ROW = 30     # transform, projection or difference, norm, compare
FLOP_K6_POLISH_ROW = 200   # transform, residual, Jacobian rows, their part of A and g
# K5 and K6 against their plain versions on the card, each problem held to
# K_MARGIN times the plain version's own spread on that problem: its largest
# difference from the plain version on the card over N_SPREAD_RUNS other
# runs of the same math in another float order -- on the CPU, on the card
# with the rows in N_PERMUTED other orders (every sum adds in another
# order), and on the card with every float input moved by PERTURB, one or
# two ulps -- so an ill-conditioned problem gets the wide spread its own
# runs show and a well-conditioned one a narrow one; at least ULP_FLOOR of
# the output's scale;
# where an outlier decision at the chi^2
# gate fell the other way (a row within the spread of the gate), the pose
# and blocks within LOOSE, the bands tests/test_torch_refine.py holds the
# port's refinements to against JAX's (rotation, translation m, blocks)
K_MARGIN = 4.0
ULP_FLOOR = 16 * 2.0 ** -23
PERTURB = 2.0 ** -22
N_PERTURBED, N_PERMUTED = 2, 2
N_SPREAD_RUNS = 1 + N_PERTURBED + N_PERMUTED   # and the CPU
LOOSE = {"R": 2e-4, "t": 2e-3, "blocks": 1e-2}

# the kernels of each path, and each kernel's name in `kernels.launch_counts()`
PATH_KERNELS = {"shi_tomasi": ("lk", "point_sample", "response", "refine", "ransac"),
                "orb": ("orb_sample", "lk", "point_sample", "refine", "ransac"),
                "pipeline": ("lk", "point_sample", "response", "refine", "ransac"),
                "golden": ("lk", "point_sample", "response", "refine", "ransac"),
                "online": ("lk", "point_sample", "response", "refine", "ransac"),
                "world_pose": ("lk", "point_sample", "response", "refine", "ransac"),
                "batched": ("lk", "point_sample", "response", "refine", "ransac"),
                "ego_3d2d": ("lk", "point_sample", "response", "refine", "ransac"),
                "ego_3d3d": ("lk", "point_sample", "response", "refine", "ransac"),
                "ego_2d2d": ("lk", "point_sample", "response", "refine", "ransac"),
                "ego_2point": ("lk", "point_sample", "response", "refine", "ransac"),
                "masks": ("lk", "point_sample", "response", "refine", "ransac"),
                "rectify": ("lk", "point_sample", "response", "refine", "ransac"),
                "stereo": (),
                "streaming": ("lk", "point_sample", "response", "refine", "ransac"),
                "multi_sequence": ("lk", "point_sample", "response", "refine", "ransac"),
                "distributed": (),
                "tools": ("lk", "point_sample", "response", "refine", "ransac"),
                "evaluation": ("lk", "point_sample", "response", "refine", "ransac")}
COUNTER = {"lk_level": "lk", "point_sample": "point_sample",
           "shi_tomasi_response": "response", "orb_orientation_descriptors": "orb_sample",
           "refine_rounds": "refine", "ransac": "ransac",
           "window_build": "window_build", "window_step": "window_step", "window_update": "window_update"}
# K7-K9 run on the LM iterations of WorldMotion direct-Schur window solves,
# not on every frame: each path that solves such windows must launch K8
# once per LM iteration of its solves, K9 once per iteration and once a
# solve (its head) and K7 at least once a solve (`check_window_launches`);
# the per-frame checks leave them out
WINDOW_KERNELS = ("window_build", "window_step", "window_update")
WINDOW_KERNELS_PER_ITERATION = 5     # K8's and K9's kernels an LM iteration at most (9 before their redesign)


class SmokeFailure(RuntimeError):
    pass


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60,
    )
    _require(out.returncode == 0, f"nvidia-smi failed: {out.stdout}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warmup: int = 3) -> float:
    """Mean milliseconds of `fn` over `reps` back-to-back calls, between two
    CUDA events on the current stream, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(n_bytes: float, n_flop: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flop / PEAK_F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def distinct_taps(torch, x, y, h: int, w: int) -> int:
    """Distinct pixels that border-clamped bilinear samples at (x, y) read
    (the 2x2 taps of each sample, as `kernels/point_sample.py:bilinear_gather`);
    x and y broadcast against each other."""
    x, y = torch.broadcast_tensors(x, y)
    x = x.reshape(-1).clamp(0, w - 1)
    y = y.reshape(-1).clamp(0, h - 1)
    x0, y0 = x.floor().long(), y.floor().long()
    x1, y1 = (x0 + 1).clamp(max=w - 1), (y0 + 1).clamp(max=h - 1)
    return int(torch.cat([y0 * w + x0, y0 * w + x1, y1 * w + x0, y1 * w + x1]).unique().numel())


# ------------------------------------------------------------------ kernels
def check_lk(torch, frames, device, reps):
    from dynosam_tpu_torch.kernels import lk
    from dynosam_tpu_torch.ops.klt import flow_at

    f0, f1 = frames[0], frames[1]
    h, w = f0.gray.shape
    n, win, iters, eps = 2048, 21, 10, 0.01
    rng = np.random.default_rng(1)
    p = torch.as_tensor(rng.uniform([12, 12], [w - 12, h - 12], (n, 2)).astype(np.float32), device=device)
    valid = torch.as_tensor(rng.random(n) < 1000 / n, device=device)
    g0 = flow_at(f0.flow, p, valid)           # warm start from dense flow
    # two more groups, held at the same tolerances: slots within 10 px of
    # an edge (a quarter on each), whose windows leave the image; and slots
    # whose warm start is off by 6-9 px, more than the 4 px margin of the
    # kernel's staged window of `cur`, so their steps leave it
    nb = 256
    side, t, d = rng.integers(0, 4, nb), rng.uniform(0, 1, nb), rng.uniform(0, 10, nb)
    xb = np.where(side == 0, d, np.where(side == 1, w - 1 - d, t * (w - 1)))
    yb = np.where(side == 2, d, np.where(side == 3, h - 1 - d, t * (h - 1)))
    pb = torch.as_tensor(np.stack([xb, yb], -1).astype(np.float32), device=device)
    po = torch.as_tensor(rng.uniform([40, 40], [w - 40, h - 40], (nb, 2)).astype(np.float32), device=device)
    ang, rad = rng.uniform(0, 2 * np.pi, nb), rng.uniform(6, 9, nb)
    off = torch.as_tensor(np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1).astype(np.float32), device=device)
    every = torch.ones(nb, dtype=torch.bool, device=device)
    groups = (("main", p, g0, valid), ("border", pb, flow_at(f0.flow, pb), every),
              ("warm start off the tile", po, flow_at(f0.flow, po) + off, every))
    dg = de = 0.0
    for name, pp, gg, vv in groups:
        g_k, e_k = lk.lk_level(f0.gray, f1.gray, pp, gg, vv, win, iters, eps)
        g_p, e_p = lk.lk_level_plain(f0.gray, f1.gray, pp, gg, vv, win, iters, eps)
        torch.cuda.synchronize()
        dgi = float((g_k - g_p).abs().max())
        dei = float((e_k - e_p).abs().max())
        print(f"K1 lk_level {name}: {int(vv.sum())} of {pp.shape[0]} slots active, win {win}, {iters} iters, "
              f"eps {eps}: max |dg| {dgi:.3g} px (tol {LK_TOL_PX}), max |derr| {dei:.3g} (tol {LK_TOL_ERR}), "
              f"max |g - g0| {float((g_p - gg)[vv].abs().max()):.3g} px", flush=True)
        _require(np.isfinite(dgi) and dgi <= LK_TOL_PX, f"K1 {name} disagrees with its plain version: {dgi}")
        _require(np.isfinite(dei) and dei <= LK_TOL_ERR, f"K1 {name} error disagrees: {dei}")
        dg, de = max(dg, dgi), max(de, dei)

    g_k, _ = lk.lk_level(f0.gray, f1.gray, p, g0, valid, win, iters, eps)
    _, _, steps = lk.lk_level_plain(f0.gray, f1.gray, p, g0, valid, win, iters, eps, return_iters=True)
    ms = cuda_ms(torch, lambda: lk.lk_level(f0.gray, f1.gray, p, g0, valid, win, iters, eps), reps)
    plain_ms = cuda_ms(torch, lambda: lk.lk_level_plain(f0.gray, f1.gray, p, g0, valid, win, iters, eps),
                       max(reps // 20, 3), warmup=1)
    n_act = int(valid.sum())
    total_steps = int(steps.sum())
    flop = (n_act * ((win + 2) ** 2 * FLOP_BILINEAR + win * win * (FLOP_LK_GRAD + FLOP_LK_ERR))
            + total_steps * (win * win * FLOP_LK_STEP + FLOP_LK_SOLVE))
    # bytes this call's data needs: the distinct prev pixels under the
    # (win+2)^2 template taps at p, the distinct cur pixels under the win^2
    # taps at the final p+g, p of the active slots, valid and g0 of all
    # slots, and the outputs g and err
    r = win // 2
    o_t = torch.arange(-r - 1, r + 2, device=device, dtype=torch.float32)
    o_c = torch.arange(-r, r + 1, device=device, dtype=torch.float32)
    pa, ga = p[valid], g_k[valid]
    prev_px = distinct_taps(torch, pa[:, 0, None, None] + o_t[None, None, :],
                            pa[:, 1, None, None] + o_t[None, :, None], h, w)
    q = pa + ga
    cur_px = distinct_taps(torch, q[:, 0, None, None] + o_c[None, None, :],
                           q[:, 1, None, None] + o_c[None, :, None], h, w)
    nbytes = (prev_px + cur_px) * 4 + n_act * 8 + n * (1 + 8) + n * (8 + 4)
    b_ms, b_by = bound_ms(nbytes, flop)
    return dict(name="lk_level", route="cuda", source="dynosam_tpu_torch/csrc/lk.cu",
                replaces="dynosam_tpu/ops/pallas/lk.py:873", max_abs_err=dg,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                note=f"timed on the main group: {total_steps} Gauss-Newton steps over {n_act} active slots; "
                     f"{prev_px} prev and {cur_px} cur pixels read; max |derr| {de:.3g} over all groups")


def check_point_sample(torch, frames, device, reps):
    from dynosam_tpu_torch.kernels import point_sample as ps

    f = frames[1]
    h, w = f.gray.shape
    n = 6144
    rng = np.random.default_rng(2)
    uv = torch.as_tensor(rng.uniform([-2, -2], [w + 1, h + 1], (n, 2)).astype(np.float32), device=device)
    valid = torch.as_tensor(rng.random(n) >= 0.3, device=device)
    depth, mask = f.depth, f.mask               # float32 and int32, read in place
    flow = f.flow.unbind(-1)                    # the (H, W, 2) field's two strided planes
    forbid = mask != 0                          # bool
    B, NN = "bilinear", "nearest"
    cases = (
        ("C=1 float32 bilinear", (depth,), (B,), valid),
        ("C=1 int32 nearest", (mask,), (NN,), valid),
        ("C=1 bool nearest", (forbid,), (NN,), None),
        ("flow: 2 strided planes", flow, (B, B), valid),
        ("depth + int32 mask", (depth, mask), (B, NN), valid),
        ("8 channels: float32, int32, bool and strided, both modes",
         (depth, mask, mask, forbid, forbid, flow[0], flow[1], depth), (B, NN, B, NN, B, B, B, NN), valid),
        ("(C, H, W) tensor", torch.stack([depth, f.gray]), (B, NN), valid),
    )
    worst = 0.0
    for name, chans, modes, vv in cases:
        before = ps.launches
        got = ps.point_sample(chans, uv, modes, vv)
        _require(ps.launches == before + 1, f"K2 {name}: the launch count rose by {ps.launches - before}")
        want = ps.point_sample_plain(chans, uv, modes, vv)
        torch.cuda.synchronize()
        _require(got.shape == (n, len(modes)) and got.dtype == torch.float32, f"K2 {name}: shape {got.shape}")
        d_near, d_rel = 0.0, 0.0
        for c, m in enumerate(modes):
            d = float((got[:, c] - want[:, c]).abs().max())
            if m == NN:
                d_near = max(d_near, d)
            else:
                d_rel = max(d_rel, d / max(float(want[:, c].abs().max()), 1e-9))
                worst = max(worst, d)
        rows0 = True if vv is None else bool((got[~vv] == 0).all())
        print(f"K2 point_sample {name}: N {n}, {0 if vv is None else int((~vv).sum())} invalid rows: "
              f"nearest max |d| {d_near:.3g} (tol 0), bilinear max |d| / max |value| {d_rel:.3g} "
              f"(tol {PS_TOL_REL}), invalid rows 0: {rows0}", flush=True)
        _require(d_near == 0.0, f"K2 {name}: nearest samples differ: {d_near}")
        _require(np.isfinite(d_rel) and d_rel <= PS_TOL_REL, f"K2 {name}: bilinear samples disagree: {d_rel}")
        _require(rows0, f"K2 {name}: invalid rows not zero")

    ms = cuda_ms(torch, lambda: ps.point_sample((depth,), uv, (B,), valid), reps)
    plain_ms = cuda_ms(torch, lambda: ps.point_sample_plain((depth,), uv, (B,), valid), reps)
    # library yardstick: grid_sample on normalised coordinates (align_corners
    # maps -1/+1 to the first/last pixel centre; border padding clamps)
    grid = torch.stack([uv[:, 0] / (w - 1) * 2 - 1, uv[:, 1] / (h - 1) * 2 - 1], dim=-1)[None, None]
    depth4 = depth[None, None]
    lib = lambda: torch.nn.functional.grid_sample(  # noqa: E731
        depth4, grid, mode="bilinear", padding_mode="border", align_corners=True)
    lib_d = float((lib()[0, 0, 0] * valid - ps.point_sample_plain((depth,), uv, (B,), valid)[:, 0]).abs().max())
    library_ms = cuda_ms(torch, lib, reps)
    # the main path's other two call forms, timed beside it
    flow_ms = cuda_ms(torch, lambda: ps.point_sample(flow, uv, (B, B), valid), reps)
    pair_ms = cuda_ms(torch, lambda: ps.point_sample((depth, mask), uv, (B, NN), valid), reps)
    # bytes this call's data needs: the distinct pixels its valid rows touch,
    # the valid rows' coordinates (an invalid row reads only its mask), the
    # mask and the output
    n_valid = int(valid.sum())
    taps = distinct_taps(torch, uv[valid, 0], uv[valid, 1], h, w)
    nbytes = taps * 4 + n_valid * 8 + n + n * 4
    flop = n_valid * FLOP_BILINEAR
    b_ms, b_by = bound_ms(nbytes, flop)
    print(f"K2 grid_sample yardstick agrees to {lib_d:.3g}; per call: C=1 depth {ms * 1e3:.2f} us, "
          f"grid_sample {library_ms * 1e3:.2f} us ({'at or under' if ms <= library_ms else 'ABOVE'} it), "
          f"flow (2 strided planes) {flow_ms * 1e3:.2f} us, depth + int32 mask {pair_ms * 1e3:.2f} us", flush=True)
    return dict(name="point_sample", route="cuda", source="dynosam_tpu_torch/csrc/point_sample.cu",
                replaces="dynosam_tpu/ops/pallas/point_sample.py:136", max_abs_err=worst,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                ms_flow=flow_ms, ms_depth_mask=pair_ms,
                note=f"timed at N 6144, C 1 (depth), bilinear; {taps} pixels read")


def check_response(torch, frames, device, reps):
    from dynosam_tpu_torch.kernels import response

    g = frames[1].gray
    h, w = g.shape
    # the KITTI frame, then uniform noise on shapes that are no multiple of
    # the kernel's tile (28 columns by 32 rows a block), down to one pixel
    rng = np.random.default_rng(3)
    cases = [("KITTI frame", g)] + [
        ("noise", torch.as_tensor(rng.uniform(0, 255, shp).astype(np.float32), device=device))
        for shp in ((37, 53), (5, 1290), (400, 7), (1, 1))]
    worst = 0.0
    for label, img in cases:
        got = response.shi_tomasi_response(img)
        want = response.shi_tomasi_response_plain(img)
        torch.cuda.synchronize()
        d = float((got - want).abs().max())
        rel = d / max(float(want.abs().max()), 1e-9)
        print(f"K3 shi_tomasi_response {label} {img.shape[0]}x{img.shape[1]}: max |d| {d:.3g} (rel to "
              f"max |response| {rel:.3g}, tol {RESP_TOL_REL})", flush=True)
        _require(np.isfinite(rel) and rel <= RESP_TOL_REL,
                 f"K3 disagrees with its plain version on {img.shape[0]}x{img.shape[1]}: {rel}")
        worst = max(worst, d)
    ms = cuda_ms(torch, lambda: response.shi_tomasi_response(g), reps)
    plain_ms = cuda_ms(torch, lambda: response.shi_tomasi_response_plain(g), max(reps // 10, 3))
    b_ms, b_by = bound_ms(2 * h * w * 4, h * w * FLOP_RESPONSE)
    return dict(name="shi_tomasi_response", route="cuda", source="dynosam_tpu_torch/csrc/response.cu",
                replaces="dynosam_tpu/ops/pallas/response.py:83", max_abs_err=worst,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)


def check_orb_sample(torch, frames, device, reps):
    from dynosam_tpu_torch.frontend.orb import orb_pyramid
    from dynosam_tpu_torch.kernels import orb_sample as k4
    from dynosam_tpu_torch.ops.clahe import clahe
    from dynosam_tpu_torch.testing.scenes import kitti_orb_config

    # the main path's call: the 8-level canvas of a CLAHE'd KITTI frame and
    # the keypoints the extractor selects on it
    tc = kitti_orb_config().frontend.tracker
    det = clahe(frames[1].gray, n_bins=tc.clahe_bins)
    pyr = orb_pyramid(det, tc.max_nr_keypoints_before_anms, tc.orb_n_levels, tc.orb_scale_factor,
                      float(tc.orb_init_threshold_fast), float(tc.orb_min_threshold_fast))
    raw, blur, uv = pyr.canvas_raw, pyr.canvas_blur, pyr.canvas_uv
    hc, wc = raw.shape
    n = uv.shape[0]
    n_valid = int(sum(int(b[4].sum()) for b in pyr.blocks))
    # the rows where one level of the canvas ends and the next begins
    h0 = frames[1].gray.shape[0]
    heights = [max(int(round(h0 / tc.orb_scale_factor ** lvl)), 1)
               for lvl, b in enumerate(pyr.blocks) if b[5]]
    _require(sum(heights) == hc, f"K4: level heights {heights} do not make the {hc}-row canvas")
    seams = np.cumsum(heights)[:-1]
    # the main path's call, then keypoint counts that fill no block of the
    # kernel (4 keypoints a block), then keypoints off the canvas, NaN and
    # within 15 px of a level seam (their discs and windows cross it)
    rng = np.random.default_rng(4)
    sy = np.repeat(seams, 8) + rng.uniform(-15, 15, 8 * len(seams))
    edge = np.concatenate([
        np.stack([rng.uniform(0, wc - 1, sy.size), sy], -1),
        [[-40.0, 3.0], [wc + 5.0, hc + 9.0], [-3.0, hc + 30.0], [0.0, 0.0], [wc - 1.0, hc - 1.0],
         [np.nan, 20.0], [30.0, np.nan], [np.nan, np.nan]]]).astype(np.float32)
    groups = (("main path", uv), ("N 1", uv[:1]), ("N 7", uv[:7]), ("N 33", uv[:33]),
              ("off the canvas, NaN and near the level seams", torch.as_tensor(edge, device=device)))
    da = 0.0
    for label, u in groups:
        ang, desc = k4.orb_orientation_descriptors(raw, blur, u)
        ang_p, desc_p = k4.orb_orientation_descriptors_plain(raw, blur, u)
        torch.cuda.synchronize()
        d = (ang - ang_p).abs()
        dai = float(torch.minimum(d, 2 * np.pi - d).max())
        bits = float((desc == desc_p).float().mean())
        pm = bool(((desc == 1) | (desc == -1)).all())
        print(f"K4 orb_orientation_descriptors {label}: canvas {hc}x{wc} ({len(heights)} levels), "
              f"{u.shape[0]} keypoints ({n_valid} valid on the main path): max |dangle| {dai:.3g} rad "
              f"(tol {ORB_TOL_ANGLE}), bits agree {bits:.6f} (min {ORB_MIN_BITS}), all bits +-1 {pm}", flush=True)
        _require(np.isfinite(dai) and dai <= ORB_TOL_ANGLE, f"K4 {label}: angles disagree with its plain version: {dai}")
        _require(bits >= ORB_MIN_BITS, f"K4 {label}: descriptors disagree with its plain version: {bits}")
        _require(pm and bool(torch.isfinite(ang).all()), f"K4 {label}: output not finite or not +-1")
        da = max(da, dai)
        if label == "main path":
            main = ang, bits
    ang, bits = main

    ms = cuda_ms(torch, lambda: k4.orb_orientation_descriptors(raw, blur, uv), reps)
    plain_ms = cuda_ms(torch, lambda: k4.orb_orientation_descriptors_plain(raw, blur, uv), max(reps // 10, 3))
    # bytes this call's data needs: the distinct raw pixels under the discs
    # (offsets with a non-zero weight), the distinct blurred pixels under the
    # bilinear taps, the 512 pattern taps, uv in, angle and desc out
    r = 15
    oy, ox = torch.meshgrid(torch.arange(-r, r + 1, device=device), torch.arange(-r, r + 1, device=device),
                            indexing="ij")
    disc = ((ox * ox + oy * oy) <= r * r) & ((ox != 0) | (oy != 0))
    ox, oy = ox[disc].float(), oy[disc].float()
    xs = (uv[:, 0:1].round() + ox[None]).clamp(0, wc - 1).long()
    ys = (uv[:, 1:2].round() + oy[None]).clamp(0, hc - 1).long()
    raw_px = int((ys * wc + xs).unique().numel())
    taps = torch.as_tensor(k4.TAPS, device=device)
    ca, sa = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    tx = uv[:, 0:1] + ca * taps[None, :, 0] - sa * taps[None, :, 1]
    ty = uv[:, 1:2] + sa * taps[None, :, 0] + ca * taps[None, :, 1]
    blur_px = distinct_taps(torch, tx, ty, hc, wc)
    nbytes = (raw_px + blur_px) * 4 + taps.numel() * 4 + n * 8 + n * (4 + 256)
    flop = n * (int(disc.sum()) * FLOP_ORB_MOMENT + FLOP_ORB_KEYPOINT + 512 * FLOP_ORB_TAP)
    b_ms, b_by = bound_ms(nbytes, flop)
    return dict(name="orb_orientation_descriptors", route="cuda", source="dynosam_tpu_torch/csrc/orb_sample.cu",
                replaces="dynosam_tpu/ops/pallas/orb_sample.py:248", max_abs_err=da,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                note=f"{n} keypoints on a {hc}x{wc} canvas; {raw_px} raw and {blur_px} blurred pixels read; "
                     f"bits agree {bits:.6f}")


# ---------------------------------------------------------- solver kernels
def record_solver_calls(torch, device, n_main: int = 6, n_golden: int = 6, n_3d3d: int = 3) -> dict:
    """The arguments of every call of K5's and K6's wrappers (cloned:
    `refine.run_rounds`, `ops/ransac.hypotheses_and_polish`) that eager steps make
    on the main path's frames in the 3d3d ego mode (frames 0..n_3d3d-1, for
    K6's 3d3d mode), on the main path's frames (`kitti_config`, 1280x384,
    frames 0..n_main-1) and on the golden scene (frames 0..n_golden-1),
    each labelled with its scene and frame:
    {"K5": [(label, kind, P, R0)], "K6": [(label, args, kwargs)]}."""
    import functools

    from dynosam_tpu_torch import pipeline
    from dynosam_tpu_torch.frontend import refine
    from dynosam_tpu_torch.ops import ransac as ops_ransac
    from dynosam_tpu_torch.pipeline import DynoPipeline
    from dynosam_tpu_torch.testing.scenes import golden_config, golden_dataset, kitti_config, kitti_scene
    from dynosam_tpu_torch.utils.graphs import tree_clone

    calls = {"K5": [], "K6": []}
    where = {"label": None}
    real5, real6, real_step = refine.run_rounds, ops_ransac.hypotheses_and_polish, pipeline.frontend_step

    def rounds(kind, P, R0):
        calls["K5"].append((where["label"], kind, tree_clone(P), tree_clone(R0)))
        return real5(kind, P, R0)

    def ransac(*args):
        calls["K6"].append((where["label"], tree_clone(args), {}))
        return real6(*args)

    refine.run_rounds, ops_ransac.hypotheses_and_polish = rounds, ransac
    pipeline.frontend_step = functools.partial(real_step, _graphs=False)
    try:
        scene, frames = kitti_scene(device, n_frames=max(n_main, n_3d3d))
        ds = golden_dataset(device)
        main = kitti_config()
        d3 = dataclasses.replace(main, frontend=dataclasses.replace(main.frontend, ego_motion_solver="3d3d"))
        for name, cam, cfg, fr in (("3d3d", scene.cam, d3, frames[:n_3d3d]),
                                   ("main path", scene.cam, main, frames[:n_main]),
                                   ("golden", ds.camera_params(), golden_config(False),
                                    [ds.frame(i) for i in range(n_golden)])):
            cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(cfg.pipeline, use_backend=False))
            pipe = DynoPipeline(cam, cfg, device=device)
            for k, f in enumerate(fr):
                where["label"] = f"{name} frame {k}"
                pipe.spin_once(f)
        torch.cuda.synchronize()
    finally:
        refine.run_rounds, ops_ransac.hypotheses_and_polish, pipeline.frontend_step = real5, real6, real_step
    return calls


def _spread_tol(spread: float, scale: float) -> float:
    """A kernel's tolerance on one output: K_MARGIN times the plain
    version's own spread, at least ULP_FLOOR of the output's scale."""
    return max(K_MARGIN * spread, ULP_FLOOR * scale)


def _perturbed(torch, tree, seed: int):
    """`tree` with every float tensor multiplied by 1 +- PERTURB, the sign
    drawn per element from `seed`: the same inputs one or two ulps off."""
    def move(x):
        if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
            return x
        g = torch.Generator(device=x.device).manual_seed(seed)
        sign = torch.randint(0, 2, x.shape, generator=g, device=x.device).to(x.dtype) * 2 - 1
        return x * (1 + sign * PERTURB)

    return torch.utils._pytree.tree_map(move, tree)


def _row_order(torch, n: int, seed: int, device):
    """A permutation of n rows drawn from `seed`, and its inverse."""
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(seed)).to(device)
    return perm, torch.argsort(perm)


def _rows_permuted(torch, tree, bsz: int, n: int, perm):
    """`tree` with every tensor's row axis (the one after the problems' B,
    where a tensor has (B, N) in its shape) taken in the order `perm`."""
    def take(x):
        if isinstance(x, torch.Tensor):
            for d in range(x.dim() - 1):
                if tuple(x.shape[d:d + 2]) == (bsz, n):
                    return x.index_select(d + 1, perm)
        return x

    return torch.utils._pytree.tree_map(take, tree)


def _plain_trace(torch, kind, P, R0, i: int = 0):
    """The plain rounds on the card, traced: the LM iterations they run,
    summed over the problems (each round's LM counter where the round ran:
    the work this call's data needs), and problem `i`'s pose change in each
    LM iteration that moved it (the largest component of R and t)."""
    from dynosam_tpu_torch.frontend import refine
    from dynosam_tpu_torch.utils.graphs import tree_clone

    total, steps = [0], []
    real_tail, real_it = refine.round_tail, refine.round_iteration

    def tail(kind_, P_, R, L, first):
        total[0] += int((L["it"] * R["run"]).sum())
        return real_tail(kind_, P_, R, L, first)

    def iteration(kind_, P_, R, L, first):
        out = real_it(kind_, P_, R, L, first)
        d = max(float((out["glob"].R[i] - L["glob"].R[i]).abs().max()),
                float((out["glob"].t[i] - L["glob"].t[i]).abs().max()))
        if d > 0:
            steps.append(d)
        return out

    refine.round_tail, refine.round_iteration = tail, iteration
    try:
        refine.rounds_plain(kind, P, tree_clone(R0))
    finally:
        refine.round_tail, refine.round_iteration = real_tail, real_it
    return total[0], steps


def device_ms_per_call(torch, fn, names, reps: int = 5) -> float:
    """The device time of the kernels whose names contain one of `names`,
    per call of `fn`, from the profiler's CUDA activity."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and any(n in e.name for n in names))
    return us / reps / 1e3


def same_bits(torch, a, b) -> bool:
    """Every tensor of two trees equal bit for bit (NaNs included)."""
    leaves = torch.utils._pytree.tree_leaves
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and torch.equal(x.contiguous().view(torch.uint8), y.contiguous().view(torch.uint8))
        for x, y in zip(la, lb) if isinstance(x, torch.Tensor))


def kernel_resources(torch, source: str, match: str) -> str:
    """ptxas' registers, spills and static shared memory of the kernels of
    `source` whose mangled names contain `match`, from this process's build."""
    from dynosam_tpu_torch.kernels import build

    use = {k: v for k, v in build.resource_usage(source).items() if match in k}
    if not use:
        return "not reported (the library was not built in this process)"
    return "; ".join(f"{name.split(match)[-1][:28] or match}: {u.get('registers')} registers, spill stores "
                     f"{u.get('spill_stores')} B, loads {u.get('spill_loads')} B, {u.get('smem')} B static smem"
                     for name, u in sorted(use.items()))


def hold_refine_rounds(torch, calls) -> tuple:
    """K5 against its plain version on every call of `calls` (see
    `check_refine_rounds`), and each call launched twice, both results equal
    bit for bit.  Returns the largest |kernel - plain| over the pose and
    blocks of agreeing problems and each call's tolerances by (label, kind)."""
    from dynosam_tpu_torch.frontend import refine
    from dynosam_tpu_torch.utils.graphs import tree_clone

    def to_cpu(tree):
        return torch.utils._pytree.tree_map(lambda x: x.cpu() if isinstance(x, torch.Tensor) else x, tree)

    def outputs(R, kind):
        g = R["res"][kind.glob]
        return dict(R=g.R.reshape(-1, 9), t=g.t, blocks=torch.cat([R["carried"][k] for k in kind.keys], -1),
                    error=R["error"], active=R["active"], it=R["it"], n_new=R["n_new"])

    def chi2(kind, P, R0, R):
        prob = kind.problem(P, R0["active"])
        r = prob.residual_fn(R["res"])[kind.gated]
        return torch.sum(r * r, dim=-1)

    runs, repeats = [], 0
    for label, kind, P, R0 in calls:
        got = refine.run_rounds(kind, P, tree_clone(R0))
        again = refine.run_rounds(kind, P, tree_clone(R0))
        _require(same_bits(torch, outputs(got, kind), outputs(again, kind)),
                 f"K5 {type(kind).__name__}, {label}: two launches on the same inputs differ")
        repeats += 1
        card_p = refine.rounds_plain(kind, P, tree_clone(R0))
        P_cpu, R0_cpu = to_cpu(P), to_cpu(R0)
        cpu_p = refine.rounds_plain(kind, P_cpu, R0_cpu)
        others = [outputs(refine.rounds_plain(kind, _perturbed(torch, P, seed), _perturbed(torch, R0, seed)), kind)
                  for seed in range(N_PERTURBED)]
        bsz, n = R0["active"].shape
        for seed in range(N_PERMUTED):
            perm, inv = _row_order(torch, n, seed, R0["active"].device)
            o = outputs(refine.rounds_plain(kind, _rows_permuted(torch, P, bsz, n, perm),
                                            _rows_permuted(torch, R0, bsz, n, perm)), kind)
            others.append(_rows_permuted(torch, o, bsz, n, inv))
        torch.cuda.synchronize()
        dev = got["error"].device
        c = {k: v.to(dev) for k, v in outputs(cpu_p, kind).items()}
        runs.append(dict(label=label, kind=kind, k=outputs(got, kind), p=outputs(card_p, kind), c=c,
                         others=[c] + others,
                         chi2_p=chi2(kind, P, R0, card_p), chi2_c=chi2(kind, P_cpu, R0_cpu, cpu_p).to(dev)))
    floats = ("R", "t", "blocks", "error")
    same = lambda a, b, i: all(torch.equal(a[key][i], b[key][i]) for key in ("active", "it", "n_new"))  # noqa: E731

    def spread_of(r, i):
        """Problem i's largest difference from the plain version on the
        card over the other runs that took its outlier decisions, or None."""
        mates = [o for o in r["others"] if same(r["p"], o, i)]
        if not mates:
            return None
        out = {}
        for key in floats:
            d = torch.stack([(r["p"][key][i] - o[key][i]).abs() for o in mates])
            d = d[torch.isfinite(d)]
            out[key] = float(d.max()) if d.numel() else 0.0
        return out

    worst, near_rows, diverged, own, fallback = 0.0, 0, 0, 0, 0
    for kname in ("FlowPose", "MotionOnly"):
        mine = [r for r in runs if type(r["kind"]).__name__ == kname]
        if not mine:
            continue
        gate = mine[0]["kind"].chi2_gate
        largest = {key: 0.0 for key in floats}
        dchi = 0.0
        for r in mine:
            bsz = r["p"]["error"].shape[0]
            r["spread"] = [spread_of(r, i) for i in range(bsz)]
            known = [sp for sp in r["spread"] if sp is not None]
            r["call_spread"] = {key: max([sp[key] for sp in known], default=None) for key in floats}
            for sp in known:
                largest = {key: max(largest[key], sp[key]) for key in floats}
            ok = (r["chi2_p"] <= 2 * gate) & torch.isfinite(r["chi2_c"])
            if bool(ok.any()):
                dchi = max(dchi, float((r["chi2_p"] - r["chi2_c"]).abs()[ok].max()))
        delta = _spread_tol(dchi, gate)
        for r in mine:
            r["tol"] = []
            for i in range(r["p"]["error"].shape[0]):
                sp = r["spread"][i]
                if sp is None:
                    fallback += 1
                    sp = {key: largest[key] if r["call_spread"][key] is None else r["call_spread"][key]
                          for key in floats}
                    print(f"K5 {kname}, {r['label']}, problem {i}: every other run of the plain version took "
                          f"other outlier decisions; held to its call's largest spread {sp}", flush=True)
                else:
                    own += 1
                tol = {key: _spread_tol(sp[key], float(r["p"][key][i].abs().max())) for key in floats}
                r["tol"].append(tol)
                diff = {key: float((r["k"][key][i] - r["p"][key][i]).abs().max()) for key in floats}
                if same(r["k"], r["p"], i):
                    bad = [key for key in floats if not diff[key] <= tol[key]]
                    _require(not bad, f"K5 {kname}, {r['label']}, problem {i}: {bad} differ by "
                                      f"{[diff[key] for key in bad]} (tolerances {[tol[key] for key in bad]})")
                    worst = max(worst, max(diff[key] for key in ("R", "t", "blocks")))
                    continue
                diverged += 1
                rows = (r["k"]["active"][i] != r["p"]["active"][i]).nonzero()[:, 0]
                near = ((r["chi2_p"][i] - gate).abs() <= delta) | (r["p"]["active"][i] != r["c"]["active"][i])
                near_rows += int(rows.numel())
                print(f"K5 {kname}, {r['label']}, problem {i}: an outlier decision at the gate differs: rows "
                      f"{rows.tolist()[:8]} (chi^2 {[round(float(r['chi2_p'][i][j]), 4) for j in rows[:8]]}, gate "
                      f"{gate}, spread {delta:.3g}); rounds {int(r['k']['it'][i])} / {int(r['p']['it'][i])}; "
                      f"|dR| {diff['R']:.3g}, |dt| {diff['t']:.3g}, |dblocks| {diff['blocks']:.3g}", flush=True)
                _require(bool(near[rows].all()), f"K5 {kname}, {r['label']}, problem {i}: rows {rows.tolist()} "
                                                 f"changed their outlier decision away from the gate")
                _require(diff["R"] <= LOOSE["R"] and diff["t"] <= LOOSE["t"] and diff["blocks"] <= LOOSE["blocks"],
                         f"K5 {kname}, {r['label']}, problem {i}: {diff} beyond {LOOSE}")
        print(f"K5 {kname}: {len(mine)} calls, {sum(r['p']['error'].shape[0] for r in mine)} problems, each held "
              f"to {K_MARGIN}x its own spread over {N_SPREAD_RUNS} other runs (CPU, {N_PERMUTED} row orders, "
              f"{N_PERTURBED} perturbed inputs), at least "
              f"{ULP_FLOOR:.3g} of its outputs' scale; the largest spread {json.dumps({k: float('%.3g' % v) for k, v in largest.items()})}, chi^2 "
              f"{dchi:.3g}", flush=True)
    print(f"K5: max |kernel - plain| over the pose and blocks of agreeing problems {worst:.3g}; {own} problems held "
          f"to their own spread, {fallback} to their call's; {diverged} problems with an outlier decision at the "
          f"gate that differs ({near_rows} rows); {repeats} calls launched twice, equal bit for bit", flush=True)
    tol_of = {(r["label"], type(r["kind"]).__name__): r["tol"] for r in runs}
    return worst, tol_of


def check_refine_rounds(torch, calls, card, reps) -> dict:
    """K5 against its plain version on every recorded call: the kernel (its
    wrapper, `refine.run_rounds`, on the card) and the plain version on the
    card, and the plain version's other runs (on the CPU, and on the card
    with its rows in other orders or its inputs one or two ulps off), whose
    spread sets the tolerances.  Each problem is held to its own spread: where the kernel's
    discrete outputs (active rows, rounds, new outliers) equal the plain
    version's on the card, every float output is within `_spread_tol` of
    that problem's largest difference over the other runs that took its
    outlier decisions (of its call's largest, where none did); where they
    differ, each differing row must lie within the spread of the chi^2
    gate (or differ between the plain version's CPU and card runs too),
    and the pose and blocks within LOOSE.  Then the main path's two calls of a steady frame are
    timed, and the ego problem's tolerance is printed beside its pose
    change per LM iteration."""
    from dynosam_tpu_torch.frontend import refine
    from dynosam_tpu_torch.kernels import refine as k5
    from dynosam_tpu_torch.utils.graphs import tree_clone

    worst, tol_of = hold_refine_rounds(torch, calls)

    timed = [r for r in calls if r[0].startswith("main path") and r[0] != "main path frame 0"][-2:]
    rows_out = {}
    for label, kind, P, R0 in timed:
        kname = type(kind).__name__
        bsz, n = R0["active"].shape
        ms = cuda_ms(torch, lambda: refine.run_rounds(kind, P, R0), reps)
        dev_ms = device_ms_per_call(torch, lambda: refine.run_rounds(kind, P, R0), ("refine_rounds_kernel",))
        plain_ms = cuda_ms(torch, lambda: refine.rounds_plain(kind, P, tree_clone(R0)), 3, warmup=1)
        its, steps = _plain_trace(torch, kind, P, R0)
        rounds = int(refine.rounds_plain(kind, P, tree_clone(R0))["it"].sum())
        b = 2 if kind.glob == "X" else 6
        rc = 8 if kind.glob == "X" else 4
        flop = its * n * FLOP_K5_ITERATION_ROW[kname] + rounds * n * FLOP_K5_ROUND_ROW[kname]
        nbytes = bsz * n * (4 * rc + 4 * b + 1) + bsz * 48 + bsz * n * (4 * b + 1) + bsz * (48 + 4 + 16)
        b_ms, b_by = bound_ms(nbytes, flop)
        rows_out[kname] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                               shape=f"B {bsz} x N {n}", its=its, rounds=rounds)
        print(f"K5 refine_rounds {kname} ({label}, B {bsz} x N {n}, {rounds} rounds, {its} LM iterations over the "
              f"problems): {ms * 1e3:.1f} us per call, {dev_ms * 1e3:.1f} us on the device, plain {plain_ms:.2f} ms, "
              f"bound {b_ms * 1e3:.2f} us by {b_by} on {card}", flush=True)
        shape = k5.launch_shape(k5.FLOW_POSE if kind.glob == "X" else k5.MOTION_ONLY, bsz, n)
        print(f"K5 refine_rounds {kname} launch: {bsz} clusters of {shape['cluster']} CTAs ({shape['ctas']} CTAs) of "
              f"{shape['threads']} threads, {shape['smem']} B of dynamic shared memory a CTA (at most "
              f"{shape['max_rows']} rows a problem)", flush=True)
        if kname == "FlowPose" and steps:
            t0 = tol_of[(label, kname)][0]
            print(f"K5 FlowPose ego problem ({label}): tolerance R {t0['R']:.3g}, t {t0['t']:.3g}; its pose change "
                  f"per LM iteration that moved it: median {float(np.median(steps)):.3g}, smallest "
                  f"{min(steps):.3g}, last {steps[-1]:.3g} ({len(steps)} iterations)", flush=True)
    print(f"K5 ptxas: {kernel_resources(torch, 'refine.cu', 'refine_rounds_kernel')}", flush=True)
    fp, mo = rows_out["FlowPose"], rows_out["MotionOnly"]
    return dict(name="refine_rounds", route="cuda", source="dynosam_tpu_torch/csrc/refine.cu",
                replaces="none: dynosam_tpu/frontend/refine.py:57,186 (the lax.while_loops around "
                         "dynosam_tpu/backend/small_schur.py:88)",
                max_abs_err=worst, ms=fp["ms"], plain_ms=fp["plain_ms"], bound_ms=fp["bound_ms"],
                bound_by=fp["bound_by"], library_ms=None, device_ms=fp["device_ms"],
                ms_motion_only=mo["ms"], device_ms_motion_only=mo["device_ms"], plain_ms_motion_only=mo["plain_ms"],
                bound_ms_motion_only=mo["bound_ms"], bound_by_motion_only=mo["bound_by"],
                note=f"FlowPose {fp['shape']}, MotionOnly {mo['shape']} (the main path's last steady frame); "
                     f"MotionOnly {mo['ms'] * 1e3:.1f} us per call, {mo['device_ms'] * 1e3:.1f} us on the device, "
                     f"plain {mo['plain_ms']:.2f} ms")


def _ransac_plain(torch, packed, cam, thr, steps, min_inl, diagnostics):
    from dynosam_tpu_torch.ops import ransac as ops_ransac

    r = ops_ransac.hypotheses_and_polish_plain(*packed, cam, thr, steps, min_inl, diagnostics)
    return r.pose.R, r.pose.t, r.inliers, r.n_inliers, r.status


def hold_ransac(torch, calls) -> float:
    """K6 against its plain version on every call of `calls` (see
    `check_ransac`), and each call launched twice, both results and counts
    equal bit for bit.  Returns the largest |kernel - plain| pose
    difference."""
    from dynosam_tpu_torch.core.camera import project_local
    from dynosam_tpu_torch.core.lie import SE3, se3_apply, se3_inverse
    from dynosam_tpu_torch.kernels import ransac as k6

    def final_err(R, t, src, dst, uv, cam):
        """The polish's final errors of pose (R, t) (B,) over the rows."""
        T = SE3(R, t)
        if uv is None:
            return torch.linalg.vector_norm(se3_apply(T[:, None], src) - dst, dim=-1)
        pred, z = project_local(cam, se3_apply(se3_inverse(T)[:, None], src))
        e = torch.linalg.vector_norm(pred - uv, dim=-1)
        return torch.where(z > 0.05, e, torch.full_like(e, float("inf")))

    runs, repeats = [], 0
    for label, args, kw in calls:
        src, dst, valid, idx, uv, cam, thr, steps, min_inl = args
        packed = k6.pack(src, dst, valid, idx, uv)
        counts = torch.empty(idx.shape[:2], dtype=torch.int32, device=src.device)
        got = k6.ransac(src, dst, valid, idx, uv, cam, thr, steps, min_inl, counts=counts)
        counts2 = torch.empty_like(counts)
        again = k6.ransac(src, dst, valid, idx, uv, cam, thr, steps, min_inl, counts=counts2)
        _require(same_bits(torch, (got, counts), (again, counts2)),
                 f"K6 {label}: two launches on the same inputs differ")
        repeats += 1
        dp, dc = {}, {}
        card_p = _ransac_plain(torch, packed, cam, thr, steps, min_inl, dp)
        cpu_p = _ransac_plain(torch, [None if t is None else t.cpu() for t in packed], cam, thr, steps, min_inl, dc)
        moved = []
        for seed in range(N_PERTURBED):
            dm = {}
            moved.append((_ransac_plain(torch, _perturbed(torch, packed, seed), cam, thr, steps, min_inl, dm), dm))
        bsz, n = valid.shape
        for seed in range(N_PERMUTED):
            perm, inv = _row_order(torch, n, seed, src.device)
            dm = {}
            s_, d_, v_, _, u_ = _rows_permuted(torch, packed, bsz, n, perm)
            o = _ransac_plain(torch, (s_, d_, v_, inv[packed[3]], u_), cam, thr, steps, min_inl, dm)
            moved.append((_rows_permuted(torch, o, bsz, n, inv),
                          {**dm, "final_err": dm["final_err"].index_select(1, inv)}))
        torch.cuda.synchronize()
        dev = src.device
        dc = {k: v.to(dev) for k, v in dc.items()}
        c = tuple(x.to(dev) for x in cpu_p)
        runs.append(dict(label=label, thr=thr, min_inl=min_inl, k=got, counts=counts, p=card_p, dp=dp, c=c, dc=dc,
                         others=[(c, dc)] + moved,
                         err_k=final_err(got[0], got[1], *packed[:2], packed[4], cam), valid=packed[2],
                         ego=label.startswith("main path") and uv is not None and src.shape[0] == 1))

    def own_delta(e_p, e_c, m, thr):
        """K_MARGIN times each leading index's largest CPU-vs-card error
        difference within twice the threshold, at least ULP_FLOOR x thr."""
        ok = (e_p <= 2 * thr) & (e_c <= 2 * thr) & m
        spread = torch.where(ok, (e_p - e_c).abs(), torch.zeros_like(e_p)).amax(-1)
        return torch.clamp(K_MARGIN * spread, min=ULP_FLOOR * thr)

    # the plain version's CPU-vs-card spread of the scoring errors, by the
    # rows it is taken over: the checks use the last (rows of hypotheses
    # proper in both runs, within twice the threshold in both)
    where = {"finite in both runs": 0.0, "improper hypotheses": 0.0, "proper, beyond 2x the threshold": 0.0,
             "proper, within 2x the threshold": 0.0}
    for r in runs:
        e_p, e_c, thr = r["dp"]["err"], r["dc"]["err"], r["thr"]
        both = (r["dp"]["proper"] & r["dc"]["proper"])[..., None]
        fin = torch.isfinite(e_p) & torch.isfinite(e_c)
        near2 = (e_p <= 2 * thr) & (e_c <= 2 * thr)
        d = (e_p - e_c).abs()
        for key, m in (("finite in both runs", fin), ("improper hypotheses", fin & ~both),
                       ("proper, beyond 2x the threshold", fin & both & ~near2),
                       ("proper, within 2x the threshold", both & near2)):
            if bool(m.any()):
                where[key] = max(where[key], float(d[m].max()))
    d_err = where["proper, within 2x the threshold"]

    worst, n_count_diff, n_best_diff, n_row_diff, n_own, n_fallback, n_self = 0.0, 0, 0, 0, 0, 0, 0
    ego_lines = []
    for r in runs:
        thr = r["thr"]
        dp, dc = r["dp"], r["dc"]
        delta_k = own_delta(dp["err"], dc["err"], (dp["proper"] & dc["proper"])[..., None], thr)   # (B, K)
        near = ((dp["err"] - thr).abs() <= delta_k[..., None]) | (dp["proper"] != dc["proper"])[..., None]
        dcount = (r["counts"].long() - dp["scores"]).abs()
        allowed = near.sum(-1)
        _require(bool((dcount <= allowed).all()), f"K6 {r['label']}: hypothesis counts differ by "
                                                  f"{int(dcount.max())} beyond their rows near the threshold")
        n_count_diff += int((dcount > 0).sum())
        # each problem's spread over the other runs that chose its best
        # hypothesis: the pose's largest component, and the final errors
        # within twice the threshold
        pose_sp = torch.zeros_like(dp["best"], dtype=torch.float32)
        err_sp = torch.zeros_like(pose_sp)
        agree = torch.zeros_like(dp["best"], dtype=torch.bool)                                          # (B,)
        pose_d = []
        for o, do in r["others"]:
            a = do["best"] == dp["best"]
            d = torch.maximum((r["p"][0] - o[0]).abs().flatten(1).amax(-1), (r["p"][1] - o[1]).abs().amax(-1))
            ok = (dp["final_err"] <= 2 * thr) & (do["final_err"] <= 2 * thr) & a[:, None]
            e = torch.where(ok, (dp["final_err"] - do["final_err"]).abs(), torch.zeros_like(dp["final_err"]))
            pose_sp = torch.where(a, torch.maximum(pose_sp, d), pose_sp)
            pose_d.append(torch.where(a, d, torch.full_like(d, float("nan"))))
            err_sp = torch.where(a, torch.maximum(err_sp, e.amax(-1)), err_sp)
            agree |= a
        delta_f = torch.clamp(K_MARGIN * err_sp, min=ULP_FLOOR * thr)                                   # (B,)
        call_pose = float(pose_sp[agree].max()) if bool(agree.any()) else None
        call_delta = float(delta_f[agree].max()) if bool(agree.any()) else _spread_tol(d_err, thr)
        best_k = torch.argmax(r["counts"], dim=-1)
        for i in range(best_k.shape[0]):
            R_k, t_k, inl_k, n_k, st_k = (x[i] for x in r["k"])
            R_p, t_p, inl_p, n_p, st_p = (x[i] for x in r["p"])
            _require(int(n_k) == int(inl_k.sum()) or int(st_k) != 0, f"K6 {r['label']}: count and inliers disagree")
            # the final inliers are those of the kernel's own pose
            own_inl = (r["err_k"][i] < thr) & r["valid"][i] & (st_k == 0)
            rows = (inl_k != own_inl).nonzero()[:, 0]
            n_self += int(rows.numel())
            _require(bool(((r["err_k"][i][rows] - thr).abs() <= call_delta).all()),
                     f"K6 {r['label']}, problem {i}: final inliers {rows.tolist()[:8]} are not its pose's")
            if int(best_k[i]) != int(dp["best"][i]):
                n_best_diff += 1
                d = max(float((R_k - R_p).abs().max()), float((t_k - t_p).abs().max()))
                print(f"K6 {r['label']}, problem {i}: best hypothesis {int(best_k[i])} against the plain version's "
                      f"{int(dp['best'][i])} (counts {int(r['counts'][i, best_k[i]])} / "
                      f"{int(dp['scores'][i, dp['best'][i]])}); status {int(st_k)} / {int(st_p)}; "
                      f"pose {d:.3g}", flush=True)
                continue
            if bool(agree[i]):
                n_own += 1
                sp, delta_b = float(pose_sp[i]), float(delta_f[i])
            else:
                n_fallback += 1
                sp = call_pose if call_pose is not None else float(pose_sp.max())
                delta_b = call_delta
                print(f"K6 {r['label']}, problem {i}: every other run of the plain version chose another "
                      f"hypothesis than the card's {int(dp['best'][i])}; held to its call's spread (pose {sp:.3g}, "
                      f"errors {delta_b:.3g})", flush=True)
            d = max(float((R_k - R_p).abs().max()), float((t_k - t_p).abs().max()))
            tol = _spread_tol(sp, max(1.0, float(t_p.abs().max())))
            _require(d <= tol, f"K6 {r['label']}, problem {i}: pose differs by {d} (tolerance {tol}; the other "
                               f"runs' differences {[float('%.3g' % x[i]) for x in pose_d]}, nan where another "
                               f"hypothesis won)")
            worst = max(worst, d)
            rows = (inl_k != inl_p).nonzero()[:, 0]
            n_row_diff += int(rows.numel())
            near_f = (dp["final_err"][i] - thr).abs() <= delta_b
            _require(bool(near_f[rows].all()), f"K6 {r['label']}, problem {i}: final inliers {rows.tolist()} "
                                               f"differ away from the threshold")
            _require(int(st_k) == int(st_p) or bool(rows.numel()),
                     f"K6 {r['label']}, problem {i}: status {int(st_k)} against {int(st_p)}")
            if r["ego"]:
                ego_lines.append(f"K6 ego problem ({r['label']}): pose tolerance {tol:.3g} (its spread {sp:.3g}), "
                                 f"|kernel - plain| {d:.3g}; its Gauss-Newton steps' largest components "
                                 f"{[float('%.3g' % x) for x in dp['steps'][i].tolist()]}")
    n3 = sum(1 for c in calls if c[1][4] is None)
    print(f"K6: {len(runs)} calls ({n3} in 3d3d), {sum(r['counts'].shape[0] for r in runs)} problems; the plain "
          f"version's CPU-vs-card spread of the scoring errors, by rows: "
          f"{json.dumps({k: float('%.3g' % v) for k, v in where.items()})} (the checks read the last); "
          f"problems held to their own pose spread ({N_SPREAD_RUNS} other runs: CPU, {N_PERMUTED} row orders, "
          f"{N_PERTURBED} perturbed inputs) {n_own}, to "
          f"their call's {n_fallback}; tolerance {K_MARGIN}x "
          f"the spread, at least {ULP_FLOOR:.3g} of the scale; hypotheses whose count differs (by rows near the "
          f"threshold) {n_count_diff}, problems whose best hypothesis differs {n_best_diff}, final inlier rows "
          f"that differ {n_row_diff}, that differ from the kernel's own pose's {n_self}; max |kernel - plain| "
          f"pose {worst:.3g}", flush=True)
    for line in ego_lines[-3:]:
        print(line, flush=True)
    print(f"K6: {repeats} calls launched twice, results and counts equal bit for bit", flush=True)
    return worst


def check_ransac(torch, calls, card, reps) -> dict:
    """K6 against its plain version on every recorded call, with the plain
    version on the CPU for the spread: each hypothesis's inlier count
    equals the plain version's on the card but for rows whose scoring error
    lies within that hypothesis's own spread of the threshold (K_MARGIN
    times the largest CPU-vs-card difference of its errors within twice
    the threshold, at least ULP_FLOOR of it; a hypothesis that is proper in
    one plain run only may differ in every row).  Each problem whose best
    hypothesis is the plain version's holds its pose to its own spread
    (its largest difference from the plain version on the card over the
    other runs that chose the same hypothesis: on the CPU, and on the card
    with its rows in other orders or its inputs one or two ulps off; its
    call's largest where none did) and its final inliers to rows within its own spread of the
    threshold (likewise).  Every problem's final
    inliers are those of the kernel's own pose, its errors computed here in
    PyTorch, but for rows within its call's spread of the threshold; count
    and status follow the inliers.  Then the main path's two calls of a
    steady frame are timed, and the ego problem's pose tolerance is printed
    beside its Gauss-Newton steps."""
    from dynosam_tpu_torch.kernels import ransac as k6

    worst = hold_ransac(torch, calls)
    timed = [c for c in calls if c[0].startswith("main path") and c[0] != "main path frame 0"][-2:]
    rows_out = {}
    for label, args, kw in timed:
        src, dst, valid, idx, uv, cam, thr, steps, min_inl = args
        mode = "3d2d" if uv is not None else "3d3d"
        bsz, n = valid.shape
        k = idx.shape[1]
        packed = k6.pack(src, dst, valid, idx, uv)
        ms = cuda_ms(torch, lambda: k6.ransac(src, dst, valid, idx, uv, cam, thr, steps, min_inl), reps)
        call = lambda: k6.ransac(src, dst, valid, idx, uv, cam, thr, steps, min_inl)  # noqa: E731
        dev_ms = device_ms_per_call(torch, call, ("ransac_score_kernel", "ransac_polish_kernel"))
        score_ms = device_ms_per_call(torch, call, ("ransac_score_kernel",))
        polish_ms = device_ms_per_call(torch, call, ("ransac_polish_kernel",))
        plain_ms = cuda_ms(torch, lambda: _ransac_plain(torch, packed, cam, thr, steps, min_inl, None), 5, warmup=1)
        flop = bsz * k * (FLOP_K6_HYPOTHESIS + n * FLOP_K6_SCORE_ROW) + bsz * n * (steps * FLOP_K6_POLISH_ROW
                                                                                   + 2 * FLOP_K6_SCORE_ROW)
        nbytes = bsz * n * (12 + 12 + (8 if uv is not None else 0) + 1) + bsz * k * 24 + bsz * (48 + n + 8)
        b_ms, b_by = bound_ms(nbytes, flop)
        kind = "ego" if bsz == 1 else "objects"
        rows_out[kind] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                              shape=f"{mode} B {bsz} x K {k} x N {n}", score_ms=score_ms, polish_ms=polish_ms)
        print(f"K6 ransac {kind} ({label}, {mode}, B {bsz} x K {k} hypotheses x N {n} rows): {ms * 1e3:.1f} us per "
              f"call, {dev_ms * 1e3:.1f} us on the device (score {score_ms * 1e3:.1f} us, polish "
              f"{polish_ms * 1e3:.1f} us), plain {plain_ms:.2f} ms, bound {b_ms * 1e3:.2f} us by {b_by} on {card}",
              flush=True)
        shape = k6.launch_shape(bsz, n, k, uv is not None)
        print(f"K6 ransac {kind} launch: scoring {shape['score_blocks']} blocks of {shape['score_threads']} threads, "
              f"{shape['score_warps']} warps a hypothesis; "
              f"polish {bsz} clusters of {shape['cluster']} CTAs ({shape['ctas']} CTAs) of {shape['threads']} "
              f"threads, {shape['smem']} B of dynamic shared memory a CTA", flush=True)
    print(f"K6 ptxas: {kernel_resources(torch, 'ransac.cu', 'ransac_')}", flush=True)
    ego, obj = rows_out["ego"], rows_out["objects"]
    return dict(name="ransac", route="cuda", source="dynosam_tpu_torch/csrc/ransac.cu",
                replaces="none: dynosam_tpu/ops/ransac.py:165,314 (ransac_rigid, ransac_pose_3d2d)",
                max_abs_err=worst, ms=ego["ms"], plain_ms=ego["plain_ms"], bound_ms=ego["bound_ms"],
                bound_by=ego["bound_by"], library_ms=None, device_ms=ego["device_ms"],
                device_ms_score=ego["score_ms"], device_ms_polish=ego["polish_ms"],
                ms_objects=obj["ms"], device_ms_objects=obj["device_ms"], plain_ms_objects=obj["plain_ms"],
                device_ms_score_objects=obj["score_ms"], device_ms_polish_objects=obj["polish_ms"],
                bound_ms_objects=obj["bound_ms"], bound_by_objects=obj["bound_by"],
                note=f"ego {ego['shape']}, objects {obj['shape']} (the main path's last steady frame); objects "
                     f"{obj['ms'] * 1e3:.1f} us per call, {obj['device_ms'] * 1e3:.1f} us on the device, plain "
                     f"{obj['plain_ms']:.2f} ms")


# ---------------------------------------------------------------- main path
def check_solver_graphs(torch, device, card, n: int = 4) -> None:
    """K5 and K6 inside the frontend's CUDA graphs: the frontend-only main
    path (`kitti_config`) over n KITTI-width frames with every step
    recorded, then each step taken again eagerly and graphed
    (`check_graphed_steps`).  Fails unless every step after the first
    replayed graphs that launch K5 and K6 and equals the eager step bit for
    bit."""
    from dynosam_tpu_torch import kernels
    from dynosam_tpu_torch.pipeline import DynoPipeline
    from dynosam_tpu_torch.testing.scenes import kitti_config, kitti_scene

    scene, frames = kitti_scene(device, n_frames=n)
    pipe = DynoPipeline(scene.cam, kitti_config(), device=device)
    launched = []
    with GraphedSteps(torch) as rec:
        for f in frames:
            before = kernels.launch_counts()
            pipe.spin_once(f)
            after = kernels.launch_counts()
            launched.append({k: after[k] - before[k] for k in ("refine", "ransac")})
    for k, (call, got) in enumerate(zip(rec.calls, launched)):
        replays = call[6]["replays"] - call[5]["replays"]
        _require(k == 0 or (replays > 0 and got["refine"] >= 1 and got["ransac"] >= 1),
                 f"K5/K6 graphed steps: step {k} replayed {replays} graphs launching {got}")
    print(f"K5/K6 in graphed steps: launches a frame {launched}", flush=True)
    check_graphed_steps(torch, "K5/K6 graphed steps", rec, card)


def ate_rmse(est: np.ndarray, gt: np.ndarray) -> float:
    """Camera ATE (m): RMSE of positions after one Umeyama SE(3) fit of the
    estimated positions onto the ground truth (evo's APE with -a)."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    u, _, vt = np.linalg.svd((gt - mu_g).T @ (est - mu_e) / est.shape[0])
    s = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s[2, 2] = -1
    r = u @ s @ vt
    aligned = est @ r.T + (mu_g - r @ mu_e)
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=1))))


def run_main_path(torch, scene, frames, cfg, device):
    """Drive the frontend-only pipeline over `frames`; returns the summary
    and the per-frame kernel launches.  Launch counts are zeroed just
    before the pipeline starts and read just after each frame."""
    from dynosam_tpu_torch import kernels
    from dynosam_tpu_torch.pipeline import DynoPipeline

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    pipe = DynoPipeline(scene.cam, cfg, device=device)
    kernels.reset_launch_counts()
    per_frame, times, prev = [], [], kernels.launch_counts()
    for f in frames:
        sync()
        t0 = time.perf_counter()
        pipe.spin_once(f)
        sync()
        times.append(time.perf_counter() - t0)
        now = kernels.launch_counts()
        per_frame.append({k: now[k] - prev[k] for k in now})
        prev = now
    totals = kernels.launch_counts()
    packets = pipe.packets
    est = np.stack([p.X_world.t.double().cpu().numpy() for p in packets])
    gt = np.stack([x.t.double().cpu().numpy() for x in scene.X_gt[:len(packets)]])
    n_motion = [int(p.objects.motion_valid.sum()) for p in packets]
    finite = all(bool(torch.isfinite(p.X_world.t).all() and torch.isfinite(p.X_world.R).all())
                 for p in packets)
    return dict(per_frame=per_frame, totals=totals, times=times, ate=ate_rmse(est, gt),
                finite=finite, n_motion=n_motion,
                n_static=[int(p.static_obs.valid.sum()) for p in packets])


def report_path(res, label, required, frames, card) -> None:
    """Print one path's frames/s, launches, observations and ATE; fail
    unless each `required` kernel launched on every steady frame, every
    other kernel on none, and the ATE is finite and within the limit."""
    n_frames = len(frames)
    h, w = frames[0].gray.shape
    steady = list(range(2, n_frames))
    dt = sum(res["times"][k] for k in steady)
    print(f"{label}: frontend-only pipeline, {n_frames} frames {w}x{h}; steady frames "
          f"{steady[0]}..{steady[-1]}: {len(steady) / dt:.2f} frames/s, "
          f"{dt / len(steady) * 1e3:.1f} ms/frame (host clock, synchronised) on {card}", flush=True)
    print(f"{label}: ms per frame {[round(t * 1e3, 1) for t in res['times']]}", flush=True)
    for k, lf in enumerate(res["per_frame"]):
        print(f"{label}: frame {k} launches {lf} static obs {res['n_static'][k]} "
              f"objects with motion {res['n_motion'][k]}", flush=True)
    for k in range(1, n_frames):
        missing = [n for n in required if res["per_frame"][k][n] < 1]
        _require(not missing, f"{label}, frame {k}: kernels {missing} never launched")
    stray = [n for n, c in res["totals"].items() if n not in required and c > 0]
    _require(not stray, f"{label}: kernels {stray} launched off their path")
    print(f"{label}: camera ATE {res['ate']:.5f} m (limit {ATE_LIMIT_M})", flush=True)
    _require(res["finite"], f"{label}: camera poses are not finite")
    _require(np.isfinite(res["ate"]) and res["ate"] <= ATE_LIMIT_M, f"{label}: ATE {res['ate']} m")


class SyncCounter:
    """Counts the host synchronisations PyTorch reports in its sync debug
    mode ("warn": one warning per synchronising call) inside the block,
    and (`sites`) counts them by the port's source lines they were issued
    from, innermost first."""

    def __init__(self, torch):
        self.torch = torch
        self.count = 0
        self.sites = {}

    def __enter__(self):
        import traceback

        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.simplefilter("always")

        def show(message, *_a, **_k):
            if "synchroniz" in str(message):
                frames = [f for f in traceback.extract_stack() if "dynosam_tpu_torch" in f.filename]
                key = " < ".join(f"{f.filename.split('dynosam_tpu_torch/')[-1]}:{f.lineno}"
                                 for f in reversed(frames[-3:]))
                self.sites[key] = self.sites.get(key, 0) + 1

        warnings.showwarning = show
        self._mode = self.torch.cuda.get_sync_debug_mode()
        self.torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        self.torch.cuda.set_sync_debug_mode(self._mode)
        self.count = sum(self.sites.values())
        self._catch.__exit__(*exc)
        return False


def run_pipeline_path(torch, device, card) -> dict:
    """Drive the offline pipeline (frontend every frame, window solve every
    6 frames) over PIPELINE_FRAMES rendered frames; launch counts are
    zeroed just before the run and read after each frame."""
    from dynosam_tpu_torch import kernels
    from dynosam_tpu_torch.testing.scenes import kitti_pipeline_config, kitti_scene
    from dynosam_tpu_torch.throughput import make_offline_runner

    n = PIPELINE_FRAMES
    scene, frames = kitti_scene(device, n_frames=n)
    runner = make_offline_runner(scene.cam, kitti_pipeline_config(n), n, device=device)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    prev = kernels.launch_counts()
    per_frame, times, reads = [], [], []
    with GraphedSolves() as graphs, GraphedSteps(torch) as steps:
        for f in frames:
            t0 = time.perf_counter()
            runner.frontend(f)
            start = runner.window_due()
            if start is not None:
                with SyncCounter(torch) as sc:
                    runner.solve(start)
                reads.append(sc.count)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            now = kernels.launch_counts()
            per_frame.append({k: now[k] - prev[k] for k in now})
            prev = now
    totals = kernels.launch_counts()
    out = runner.result()
    label = "pipeline path"
    h, w = frames[0].gray.shape
    print(f"{label}: frontend + window-10 backend, {n} frames {w}x{h}: {n / sum(times):.2f} frames/s, "
          f"{sum(times) / n * 1e3:.1f} ms/frame over all {n} frames (host clock, synchronised) on {card}",
          flush=True)
    print(f"{label}: ms per frame {[round(t * 1e3, 1) for t in times]}", flush=True)
    for k, lf in enumerate(per_frame):
        print(f"{label}: frame {k} launches {lf}", flush=True)
    _require(len(out.windows) == 3, f"{label}: {len(out.windows)} window solves, not 3")
    for win, n_reads in zip(out.windows, reads):
        r = win.result
        err0, err = float(r.initial_error), float(r.error)
        n_motion = int(win.masks.motion_active.any(0).sum())
        print(f"{label}: window [{win.start}, {win.start + 10}): solve {win.solve_ms():.2f} ms (CUDA events), "
              f"{r.iterations} LM iterations, error {err0:.6g} -> {err:.6g}, host reads {n_reads} "
              f"(the LM reads once per iteration: {r.iterations}), objects with an active motion {n_motion} "
              f"on {card}", flush=True)
        _require(np.isfinite(err) and err < err0, f"{label}: window {win.start} error {err0} -> {err}")
    for k in range(1, n):
        missing = [name for name in PATH_KERNELS["pipeline"] if per_frame[k][name] < 1]
        _require(not missing, f"{label}, frame {k}: kernels {missing} never launched")
    stray = [name for name, c in totals.items() if name not in PATH_KERNELS["pipeline"] + WINDOW_KERNELS and c > 0]
    _require(not stray, f"{label}: kernels {stray} launched off their path")
    check_window_launches(label, totals, [win.result.iterations for win in out.windows])
    est = out.est
    check_graphed_solves(torch, label, graphs, [win.solve_ms() for win in out.windows], card)
    check_graphed_steps(torch, label, steps, card)
    _require(bool(est.X_valid[:n].all()), f"{label}: the estimate store misses frames {est.X_valid[:n]}")
    X = est.X.t[:n].double().cpu().numpy()
    _require(bool(np.isfinite(X).all()), f"{label}: backend poses are not finite")
    gt = np.stack([x.t.double().cpu().numpy() for x in scene.X_gt[:n]])
    fe = np.stack([p.X_world.t.double().cpu().numpy() for p in out.packets])
    ate, fe_ate = ate_rmse(X, gt), ate_rmse(fe, gt)
    print(f"{label}: backend camera ATE {ate:.5f} m (limit {BACKEND_ATE_LIMIT_M}), frontend {fe_ate:.5f} m",
          flush=True)
    _require(np.isfinite(ate) and ate < BACKEND_ATE_LIMIT_M, f"{label}: backend ATE {ate} m")
    return dict(totals=totals, packets=out.packets)


class PipelineProbe:
    """For one run of the online pipeline: times each `DynoPipeline.spin_once`
    on the host clock between two synchronisations and reads the kernel
    launches after it, counts the host reads of each backend solve
    (`RGBDBackend._optimize`) with `SyncCounter`, and times each fixed-lag
    prior build (`RGBDBackend._slide_prior`, synchronised before and after)
    and counts its reads apart from its solve's.  Launch counts are zeroed
    on entry and read on exit."""

    def __init__(self, torch):
        self.torch = torch
        self.times, self.per_frame, self.reads, self.priors = [], [], [], []

    def __enter__(self):
        from dynosam_tpu_torch import kernels
        from dynosam_tpu_torch.backend.backend import RGBDBackend
        from dynosam_tpu_torch.pipeline import DynoPipeline

        torch, probe = self.torch, self
        self._kernels, self._classes = kernels, (DynoPipeline, RGBDBackend)
        self._spin, self._optimize = DynoPipeline.spin_once, RGBDBackend._optimize
        self._prior = RGBDBackend._slide_prior

        def spin_once(pipe, images):
            torch.cuda.synchronize()
            before = kernels.launch_counts()
            t0 = time.perf_counter()
            out = probe._spin(pipe, images)
            torch.cuda.synchronize()
            probe.times.append(time.perf_counter() - t0)
            now = kernels.launch_counts()
            probe.per_frame.append({k: now[k] - before[k] for k in now})
            return out

        def optimize(backend, start, window):
            with SyncCounter(torch) as sc:
                probe._optimize(backend, start, window)
            probe.reads.append(sc.count)

        def slide_prior(backend, start):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with SyncCounter(torch) as sc:
                out = probe._prior(backend, start)
            torch.cuda.synchronize()
            probe.priors.append((start, (time.perf_counter() - t0) * 1e3, sc.count))
            return out

        DynoPipeline.spin_once, RGBDBackend._optimize = spin_once, optimize
        RGBDBackend._slide_prior = slide_prior
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        self.totals = self._kernels.launch_counts()
        self._classes[0].spin_once, self._classes[1]._optimize = self._spin, self._optimize
        self._classes[1]._slide_prior = self._prior
        return False


class GraphedSolves:
    """Records every `lm_optimize_schur` call the backend makes inside the
    block (through `backend.backend.solve_problem`): its arguments, its
    result and the window-LM graph counts (`schur.graph_counts`) before
    and after it.  Only Python runs around each call; the solve's inputs
    are fresh tensors that nothing writes afterwards, so they are kept as
    they are for `check_graphed_solves`."""

    def __enter__(self):
        from dynosam_tpu_torch.backend import backend as tbe
        from dynosam_tpu_torch.backend import schur

        self._mod, self.real, self.calls = tbe, tbe.lm_optimize_schur, []
        self.counts = [schur.graph_counts()]
        real, calls = self.real, self.calls

        def recorded(*args, **kw):
            before = schur.graph_counts()
            out = real(*args, **kw)
            calls.append((args, kw, out, before, schur.graph_counts()))
            return out

        tbe.lm_optimize_schur = recorded
        return self

    def __exit__(self, *exc):
        from dynosam_tpu_torch.backend import schur

        self._mod.lm_optimize_schur = self.real
        self.counts.append(schur.graph_counts())
        return False


class GraphedSteps:
    """Records every `frontend_step` the pipelines make inside the block
    (through the names `pipeline` and `throughput` import): its arguments,
    its generator's state before it, its outputs, its time on the host
    clock between two synchronisations and the frontend graph counts
    (`frontend.graph_counts`) before and after it.  The inputs are the
    frames and the states the steps returned, which nothing writes
    afterwards, so `check_graphed_steps` re-runs each step on them."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        from dynosam_tpu_torch import pipeline, throughput
        from dynosam_tpu_torch.frontend import frontend as fe

        torch = self.torch
        self._mods, self.real, self.calls = (pipeline, throughput), fe.frontend_step, []
        self.counts = [fe.graph_counts()]
        real, calls = self.real, self.calls

        def recorded(*args, **kw):
            gen = kw.get("generator")
            state = None if gen is None else gen.get_state()
            torch.cuda.synchronize()
            before = fe.graph_counts()
            t0 = time.perf_counter()
            out = real(*args, **kw)
            torch.cuda.synchronize()
            calls.append((args, kw, state, out, (time.perf_counter() - t0) * 1e3, before, fe.graph_counts()))
            return out

        for m in self._mods:
            m.frontend_step = recorded
        return self

    def __exit__(self, *exc):
        from dynosam_tpu_torch.frontend import frontend as fe

        for m in self._mods:
            m.frontend_step = self.real
        self.counts.append(fe.graph_counts())
        return False


def check_graphed_steps(torch, label, rec, card) -> None:
    """Print the run's frontend-step graph captures and, per frame, its
    graph replays and its time in the run; then take each step again on
    its own inputs, eagerly (`_graphs=False`) and graphed, its generator
    restored, each on the host clock between two synchronisations, and a
    steady frame's graphed repeat under the sync debug mode, whose host
    reads are printed by their source lines.  Fails unless every step but
    the first replayed graphs, every result equals the eager one bit for
    bit (packet, state, report and ego result), and the steady step reads
    the host at most twice (the `eigh`) and never in a refinement or a
    RANSAC."""
    c0, c1 = rec.counts
    leaves = torch.utils._pytree.tree_leaves
    print(f"{label}: frontend-step graph captures {c1['captures'] - c0['captures']} in this run "
          f"({c1['captures']} in the process), replays {c1['replays'] - c0['replays']} over {len(rec.calls)} steps",
          flush=True)
    eager_ms, graphed_ms, run_ms = [], [], []
    steady = len(rec.calls) // 2
    for k, (args, kw, gen_state, got, ms, before, after) in enumerate(rec.calls):
        replays = after["replays"] - before["replays"]
        first = kw.get("first_frame", False)
        _require(first or replays > 0, f"{label}: step {k} replayed no graph")

        def again(graphed):
            gen = kw.get("generator")
            if gen is not None:
                gen = torch.Generator(device=gen.device)
                gen.set_state(gen_state)
            return lambda: rec.real(*args, **{**kw, "generator": gen, "_graphs": graphed})

        eager, e_ms = _timed_host(torch, again(False))
        if k == steady:
            with SyncCounter(torch) as sc:
                graphed, g_ms = _timed_host(torch, again(True))
            print(f"{label}: step {k} graphed, {sc.count} host reads by site: {sc.sites} (the design: the "
                  f"homography refit's eigh, 2)", flush=True)
            solver_sites = [site for site in sc.sites if any(m in site for m in ("refine", "ransac", "small_schur"))]
            _require(sc.count <= 2 and not solver_sites,
                     f"{label}: step {k} reads the host {sc.count} times: {sc.sites}")
        else:
            graphed, g_ms = _timed_host(torch, again(True))
        same = [all(torch.equal(a, b) for a, b in zip(leaves(tuple(got)), leaves(tuple(x)))) for x in (eager, graphed)]
        print(f"{label}: step {k}{' (first frame, eager)' if first else ''}: {replays} graph replays, {ms:.2f} ms "
              f"in the run; again on its inputs: eager {e_ms:.2f} ms, graphed {g_ms:.2f} ms; the run's outputs "
              f"{'equal' if same[0] else 'differ from'} the eager step's bit for bit, the repeat's "
              f"{'equal' if same[1] else 'differ from'} them on {card}", flush=True)
        _require(all(same), f"{label}: step {k}: graphed outputs differ from the eager step's")
        if not first:
            eager_ms.append(e_ms)
            graphed_ms.append(g_ms)
            run_ms.append(ms)
    if run_ms:
        print(f"{label}: frontend step, mean of {len(run_ms)} steady steps: {sum(run_ms) / len(run_ms):.2f} ms in "
              f"the run (graphed), again graphed {sum(graphed_ms) / len(graphed_ms):.2f} ms, eager "
              f"{sum(eager_ms) / len(eager_ms):.2f} ms (host clock, synchronised) on {card}", flush=True)


def _timed_host(torch, fn):
    """(result, ms): fn() on the host clock between two synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _bit_equal(torch, a, b) -> bool:
    leaves = torch.utils._pytree.tree_leaves
    return (all(torch.equal(x, y) for x, y in zip(leaves(a.values), leaves(b.values)))
            and torch.equal(a.error, b.error) and (a.iterations, a.converged) == (b.iterations, b.converged))


def check_graphed_solves(torch, label, rec, solve_ms, card) -> None:
    """Print the run's window-LM captures and, per window, its time in the
    run (`solve_ms`, CUDA events), its graph replays and LM iterations;
    then solve the window again on its own inputs graphed and eager
    (`_graphs=False`), each between CUDA events.  Fails unless the run
    replayed the head plus one graph per LM iteration and its result
    equals both bit for bit: a replay runs the eager loop's kernels in the
    same order on inputs of the same layout.  (Should cuBLAS ever choose
    another algorithm under capture, the card's window tolerances of
    `tests/test_torch_cuda.py:test_window_solve_on_the_card_matches_the_cpu`,
    3e-2 in error and 2e-3 m in camera translations, are the fallback.)"""
    c0, c1 = rec.counts
    print(f"{label}: window-LM graph captures {c1['captures'] - c0['captures']} in this run "
          f"({c1['captures']} in the process), replays {c1['replays'] - c0['replays']} over "
          f"{len(rec.calls)} window solves", flush=True)
    _require(len(rec.calls) == len(solve_ms), f"{label}: {len(rec.calls)} recorded solves, {len(solve_ms)} timed")
    for i, ((args, kw, got, before, after), ms) in enumerate(zip(rec.calls, solve_ms)):
        replays, captured = after["replays"] - before["replays"], after["captures"] - before["captures"]
        graphed, g_ms, _, _ = _timed(torch, lambda: rec.real(*args, **kw))
        eager, e_ms, _, _ = _timed(torch, lambda: rec.real(*args, **kw, _graphs=False))
        dx = float((got.values["X"].t - eager.values["X"].t).abs().max())
        rel = abs(float(got.error) - float(eager.error)) / abs(float(eager.error))
        print(f"{label}: window solve {i}: {ms:.2f} ms in the run (CUDA events{', capture included' if captured else ''}"
              f"), {replays} graph replays for {got.iterations} LM iterations; again on its inputs: graphed "
              f"{g_ms:.2f} ms, eager {e_ms:.2f} ms ({eager.iterations} LM iterations); the run's result "
              f"{'equals' if _bit_equal(torch, got, eager) else 'differs from'} the eager one bit for bit "
              f"(error rel {rel:.3g}, camera {dx:.3g} m), the repeat "
              f"{'equals' if _bit_equal(torch, got, graphed) else 'differs from'} the run's on {card}", flush=True)
        _require(replays == 1 + got.iterations, f"{label}: window {i}: {replays} replays, {got.iterations} iterations")
        _require(_bit_equal(torch, got, eager) and _bit_equal(torch, got, graphed),
                 f"{label}: window {i}: graphed against eager: error rel {rel}, camera {dx} m, iterations "
                 f"{got.iterations} / {eager.iterations}, converged {got.converged} / {eager.converged}")


def factorisation_kernels(torch, n: int, device) -> list:
    """The device kernels of one eager `cholesky_ex` + `cholesky_solve` of
    an (n, n) SPD system, as the profiler names them (copies and fills
    left out): `testing/window_split.py`'s."""
    from dynosam_tpu_torch.testing import window_split

    return window_split.factorisation_kernels(torch, n, device)


def check_window_launches(label, totals, iterations) -> None:
    """K8 launched once per LM iteration of the path's WorldMotion window
    solves (`iterations`, one entry a solve), K9 once per iteration and once
    a solve for its head, K7 once a solve at least (every solve rebuilds on
    its first iteration) and at most once an iteration; graph replays count
    the launches they replay."""
    n_it = sum(iterations)
    print(f"{label}: K7-K9 launches {[totals[k] for k in WINDOW_KERNELS]} over {len(iterations)} window solves of "
          f"{n_it} LM iterations", flush=True)
    _require(totals["window_step"] == n_it and totals["window_update"] == n_it + len(iterations),
             f"{label}: K8 / K9 launched {totals['window_step']} / {totals['window_update']} times over "
             f"{len(iterations)} solves of {n_it} iterations")
    _require(len(iterations) <= totals["window_build"] <= n_it,
             f"{label}: K7 launched {totals['window_build']} times over {len(iterations)} solves of {n_it} iterations")


def check_window_kernels(torch, device, card, kitti_calls) -> list:
    """K7-K9 (`csrc/window.cu`) against their plain versions
    (`testing/window_check.py`) on the online phase's first KITTI-width
    window (no active motion factor, F1) and on the simulator window (active
    motion factors): each entry of each output within K_MARGIN times its
    plain version's float32 spread on the entry's block, each kernel twice
    bit for bit, K9 rejecting a failed
    factorisation as its plain version does; then each window solved
    graphed through K7-K9 against the ATen pieces.  Each kernel timed on the
    KITTI window per call (CUDA events, the wrapper's host work included)
    and on the device (the profiler), beside its plain version on the card
    and a bound from the FLOPs and bytes that window's data needs; launch
    shapes and ptxas' registers and spills printed; then each window solved
    graphed under the profiler (`testing/window_split.py`): each kernel's
    device time a launch and an LM iteration, K7's, K8's, the
    factorisation's (cuSOLVER) and K9's, and K8's and K9's kernels an LM
    iteration, which must be at most WINDOW_KERNELS_PER_ITERATION.  Returns
    K7-K9's rows."""
    from dynosam_tpu_torch.kernels import window as kwin
    from dynosam_tpu_torch.testing import window_check as wc
    from dynosam_tpu_torch.testing import window_split as ws

    def say(line):
        print(f"{line} on {card}", flush=True)

    windows = [("kitti window", *kitti_calls[0]), ("simulator window", wc.simulator_window(device), {})]
    errs, reports = {p: 0.0 for p in wc.PIECES}, {}
    for label, args, kw in windows:
        lm = wc.window_lm(args, kw)
        pieces = wc.Pieces(lm)
        rep = wc.hold_pieces(pieces, label, out=say)
        for piece, r in rep.items():
            _require(not r["bad"] and r["repeat"], f"{label}: K{wc.KERNEL_ID[piece]} window_{piece}: "
                     f"fields {r['bad']} out of tolerance, repeat {r['repeat']}")
            row = "update" if piece == "head" else piece
            errs[row] = max(errs[row], r["max_abs_err"])
        _require(wc.hold_failed_step(pieces, label, out=say), f"{label}: K9 on a failed factorisation")
        solve = wc.hold_solve(args, kw, label, out=say)
        _require(solve["ok"], f"{label}: the solve through K7-K9 against the ATen pieces: {solve}")
        reports[label] = (lm, pieces)
        sysf = pieces.s0["sys"]
        W_, ND_ = sysf.Rc.shape[:2]
        kept = int((sysf.onehot.sum(-1) != 0).sum())
        say(f"{label}: K8 keeps {kept} (frame, track) records of 54 + 3 (6W + 1) floats, "
            f"{kept * (54 + 3 * (6 * W_ + 1)) * 4 / 1e6:.3f} MB, against the {W_ * ND_ * 3 * (12 * W_ + 1) * 4 / 1e6:.3f} "
            f"MB of every track's chain solutions")
    for label, args, kw in windows:
        split = ws.solve_split(torch, args, kw)
        ws.report(label, split, out=say)
        g, it = split["groups"], split["iterations"]
        per_it = (g["K8"]["launches"] + g["K9"]["launches"] - 2) / it      # K9's head launches two
        say(f"{label}: K8 and K9 {per_it:.2f} kernels an LM iteration (at most {WINDOW_KERNELS_PER_ITERATION}); "
            f"the factorisation {g['factorisation']['us'] / it:.2f} us an LM iteration (cuSOLVER)")
        _require(per_it <= WINDOW_KERNELS_PER_ITERATION, f"{label}: K8 and K9 ran {per_it} kernels an LM iteration")
    lm, pieces = reports["kitti window"]
    sysf = lm.s["sys"]
    W, NS, ND, O = sysf.Us.shape[0], sysf.Us.shape[1], sysf.Rc.shape[1], sysf.Dmm.shape[1]
    print(f"window kernels: launch shape at W {W}, NS {NS}, ND {ND}, O {O}: {kwin.launch_shape(W, NS, ND, O)}; "
          f"{kernel_resources(torch, 'window.cu', 'window_')}", flush=True)
    times = wc.time_pieces(pieces)
    replaces = {"build": "dynosam_tpu/backend/schur.py:611", "step": "dynosam_tpu/backend/schur.py:1072",
                "update": "dynosam_tpu/backend/schur.py:1463"}
    device = wc.device_ms(pieces)
    rows = []
    for piece, (flop, nbytes) in wc.work(pieces).items():
        dev_ms = device[piece]
        b_ms, b_by = bound_ms(nbytes, flop)
        ms, plain_ms = times[piece]
        row = dict(name=f"window_{piece}", route="cuda", source="dynosam_tpu_torch/csrc/window.cu",
                   replaces=replaces[piece], max_abs_err=errs[piece], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=b_by, library_ms=None, device_ms=dev_ms,
                   note=f"KITTI window W {W}, NS {NS}, ND {ND}, O {O}; device {dev_ms * 1e3:.1f} us a launch")
        rows.append(row)
        print(f"K{7 + wc.PIECES.index(piece)} window_{piece}: {ms * 1e3:.1f} us per call (wrapper), device "
              f"{dev_ms * 1e3:.1f} us a launch, plain {plain_ms * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us by {b_by} "
              f"({flop / 1e6:.1f} MFLOP, {nbytes / 1e6:.2f} MB) on {card}", flush=True)
    return rows


def check_launches(probe, label, required, n_frames) -> None:
    for k in range(1, n_frames):
        missing = [name for name in required if probe.per_frame[k][name] < 1]
        _require(not missing, f"{label}, frame {k}: kernels {missing} never launched")
    stray = [name for name, c in probe.totals.items() if name not in required + WINDOW_KERNELS and c > 0]
    _require(not stray, f"{label}: kernels {stray} launched off their path")


def report_solves(label, backend, reads, card) -> None:
    """Print each backend solve: window, time (CUDA events), LM and CG
    iterations, error and host reads; fail unless every error dropped."""
    for (start, window, r, events), n_reads in zip(backend.solves, reads):
        err0, err = float(r.initial_error), float(r.error)
        cg = "" if r.cg_iterations is None else f", CG iterations per LM iteration {r.cg_iterations}"
        print(f"{label}: solve [{start}, {start + window}): {events[0].elapsed_time(events[1]):.2f} ms (CUDA "
              f"events), {r.iterations} LM iterations{cg}, error {err0:.6g} -> {err:.6g}, host reads {n_reads} "
              f"on {card}", flush=True)
        _require(np.isfinite(err) and err < err0, f"{label}: solve at {start}: error {err0} -> {err}")


def run_golden_phase(torch, device, card) -> dict:
    """The golden run on the card, held to every band of
    `tests/test_accuracy_regression.py:123-163` by the port's evaluator."""
    import tempfile

    from dynosam_tpu_torch.eval import metrics
    from dynosam_tpu_torch.eval.evaluator import evaluate_all
    from dynosam_tpu_torch.pipeline import run_and_log, run_from_packets
    from dynosam_tpu_torch.testing.scenes import GOLDEN_FRAMES, golden_config, golden_dataset

    label = "golden"
    ds = golden_dataset(device)
    with tempfile.TemporaryDirectory() as out:
        with PipelineProbe(torch) as probe:
            result = run_and_log(ds, golden_config(True), out, device=device)
        evals = evaluate_all(out)
    n = GOLDEN_FRAMES
    print(f"{label}: {n} frames 160x120 through run_and_log with the full-batch backend: frontend "
          f"{n / sum(probe.times):.2f} frames/s (host clock, synchronised) on {card}", flush=True)
    check_launches(probe, label, PATH_KERNELS["golden"], n)
    backend = result.backend
    _require([(s, w) for s, w, _, _ in backend.solves] == [(0, n)],
             f"{label}: solves {[(s, w) for s, w, _, _ in backend.solves]}, not one full batch")
    report_solves(label, backend, probe.reads, card)

    fe, be = evals["frontend"], evals["rgbd_motion_world_backend"]
    checks = [(f"frontend camera {k}", fe["camera"][k], lim) for k, lim in GOLDEN_FRONTEND.items()]
    checks += [(f"frontend objects {k}", fe["objects_mean"][k], lim) for k, lim in GOLDEN_FRONTEND_OBJECTS.items()]
    checks += [("backend camera ate_trans_rmse", be["camera"]["ate_trans_rmse"], GOLDEN_BACKEND_ATE_M),
               ("backend objects ame_trans_rmse", be["objects_mean"]["ame_trans_rmse"], GOLDEN_BACKEND_AME_M)]
    for k in ("ame_trans_rmse", "ame_rot_deg_rmse"):
        checks.append((f"backend {k} / frontend's", be["objects_mean"][k] / fe["objects_mean"][k], GOLDEN_IMPROVEMENT))

    be_sw = run_from_packets(result.packets, golden_config(False), device=device)
    X, xv = be_sw.camera_poses()
    xv = xv.cpu().numpy()
    T = np.tile(np.eye(4), (int(xv.sum()), 1, 1))
    T[:, :3, :3] = X.R.double().cpu().numpy()[xv]
    T[:, :3, 3] = X.t.double().cpu().numpy()[xv]
    gt = np.stack([ds.ground_truth(k).X_world for k in range(n)])[xv]
    sw_ate = metrics.ate(T, gt)["trans"].rmse
    fb_ate = be["camera"]["ate_trans_rmse"]
    checks += [("sliding-window camera ATE", sw_ate, GOLDEN_SLIDING_ATE_M),
               ("full-batch ATE / sliding ATE", fb_ate / sw_ate, GOLDEN_ORDERING)]
    for name, value, limit in checks:
        ok = np.isfinite(value) and (value <= limit if "/ sliding" in name else value < limit)
        print(f"{label}: {name} {value:.5g} (limit {limit}): {'ok' if ok else 'FAIL'}", flush=True)
        _require(ok, f"{label}: {name} {value} against {limit}")
    print(f"{label}: sliding windows {[(s, w) for s, w, _, _ in be_sw.solves]}, each "
          f"{[r.iterations for _, _, r, _ in be_sw.solves]} LM iterations", flush=True)
    run_drift_recovery(torch, device, card, result.packets, np.stack([ds.ground_truth(k).X_world for k in range(n)]))
    return dict(totals=probe.totals, packets=result.packets)


def run_online_phase(torch, device, card, world_pose: bool = False) -> dict:
    """The default-config online pipeline at KITTI width through
    `run_and_log` and `evaluate_all`; with `world_pose`, under WorldPose
    (updater 1) with the fixed-lag boundary prior."""
    import dataclasses
    import tempfile

    from dynosam_tpu_torch.eval.evaluator import evaluate_all
    from dynosam_tpu_torch.pipeline import backend_log_prefix, run_and_log
    from dynosam_tpu_torch.testing.scenes import RenderedDataset, kitti_online_config, kitti_scene

    label = "world pose" if world_pose else "online"
    cfg = kitti_online_config()
    if world_pose:
        cfg = dataclasses.replace(cfg, backend=dataclasses.replace(cfg.backend, backend_updater_enum=1,
                                                                   use_fixed_lag_prior=True))
    prefix = backend_log_prefix(cfg.backend.backend_updater_enum)
    n = PIPELINE_FRAMES
    scene, frames = kitti_scene(device, n_frames=n)
    with tempfile.TemporaryDirectory() as out:
        with PipelineProbe(torch) as probe, GraphedSolves() as graphs, GraphedSteps(torch) as steps:
            result = run_and_log(RenderedDataset(scene, frames), cfg, out, device=device)
        evals = evaluate_all(out)
    h, w = frames[0].gray.shape
    if not world_pose:
        # end to end: a second run timed by `DynoPipeline.run` itself, from
        # the first spin through `finish` (the final window's solve
        # included), synchronised once at the end and not after every spin
        # as the probe is
        with tempfile.TemporaryDirectory() as out:
            timed = run_and_log(RenderedDataset(scene, frames), cfg, out, device=device)
        print(f"{label}: DynoPipeline + RGBDBackend (default BackendConfig, max_frames 512), {n} frames {w}x{h}: "
              f"end to end {timed.fps:.2f} frames/s, {1e3 / timed.fps:.1f} ms/frame ({n} spins and finish, "
              f"DynoPipeline.run's host clock, a second run) on {card}", flush=True)
    steady = list(range(2, n))
    spin_s = sum(probe.times)
    print(f"{label}: per spin_once (host clock, synchronised before and after each; finish not included): "
          f"{spin_s / n * 1e3:.1f} ms mean over {n} spins, steady frames 2..{n - 1} "
          f"{sum(probe.times[k] for k in steady) / len(steady) * 1e3:.1f} ms mean; ms per spin "
          f"{[round(t * 1e3, 1) for t in probe.times]}", flush=True)
    for k, lf in enumerate(probe.per_frame):
        print(f"{label}: frame {k} launches {lf}", flush=True)
    check_launches(probe, label, PATH_KERNELS["world_pose" if world_pose else "online"], n)
    backend = result.backend
    check_window_launches(label, probe.totals, [] if world_pose else [r.iterations for _, _, r, _ in backend.solves])
    starts = [(s, w_) for s, w_, _, _ in backend.solves]
    _require(starts == [(0, 10), (6, 10), (12, 10), (18, 10)], f"{label}: windows {starts}")
    # a window's reads as counted around `_optimize` exclude its prior build's
    report_solves(label, backend, probe.reads, card)
    check_graphed_solves(torch, label, graphs, [ev[0].elapsed_time(ev[1]) for _, _, _, ev in backend.solves], card)
    check_graphed_steps(torch, label, steps, card)
    if not world_pose:
        vals = graphs.calls[0][2].values
        W, O = vals["H"].t.shape[:2]
        n_red = 6 * W * (1 + O)
        names = factorisation_kernels(torch, n_red, device)
        print(f"{label}: linalg backend {torch.backends.cuda.preferred_linalg_library()}; one eager cholesky_ex + "
              f"cholesky_solve at the reduced system's {n_red}x{n_red} ran "
              f"{'MAGMA' if any('magma' in k.lower() for k in names) else 'cuSOLVER'} kernels {names}", flush=True)
    for start, ms, reads in probe.priors:
        print(f"{label}: boundary prior for the window at {start}: {ms:.2f} ms (host clock, synchronised), "
              f"host reads {reads} on {card}", flush=True)
    _require(len(probe.priors) == (4 if world_pose else 0), f"{label}: {len(probe.priors)} prior builds")
    _require(bool(torch.isfinite(backend._prior_L).all()) if world_pose else True, f"{label}: prior not finite")
    fe_ate = evals["frontend"]["camera"]["ate_trans_rmse"]
    _require(prefix in evals, f"{label}: no {prefix} logs, modules {sorted(evals)}")
    be_ate = evals[prefix]["camera"]["ate_trans_rmse"]
    print(f"{label}: camera ATE frontend {fe_ate:.5f} m (limit {ATE_LIMIT_M}), backend ({prefix}) {be_ate:.5f} m "
          f"(limit {BACKEND_ATE_LIMIT_M}), backend frames {evals[prefix]['camera']['n_frames']}", flush=True)
    _require(np.isfinite(fe_ate) and fe_ate < ATE_LIMIT_M, f"{label}: frontend ATE {fe_ate} m")
    _require(np.isfinite(be_ate) and be_ate < BACKEND_ATE_LIMIT_M, f"{label}: backend ATE {be_ate} m")
    return dict(totals=probe.totals, window_calls=[(args, kw) for args, kw, *_ in graphs.calls])


def check_steady_spin_reads(torch, device, card, n: int = 6) -> list:
    """`kitti_online_config` (the online cell's setting) over `n` frames,
    before any window solve: each spin's frontend graph replays and host
    reads (sync debug mode) by site.  Fails unless every steady spin (frame
    2 on) replays two graphs and reads the host at most 3 times (the
    design: the homography refit's `eigh` twice, `update_map` once), never
    in a refinement or a RANSAC."""
    from dynosam_tpu_torch.frontend import frontend as fe
    from dynosam_tpu_torch.pipeline import DynoPipeline
    from dynosam_tpu_torch.testing.scenes import kitti_online_config, kitti_scene

    label = "steady spins"
    scene, frames = kitti_scene(device, n_frames=n)
    pipe = DynoPipeline(scene.cam, kitti_online_config(), device=device)
    out = []
    for k, f in enumerate(frames):
        before = fe.graph_counts()["replays"]
        with SyncCounter(torch) as sc:
            pipe.spin_once(f)
        torch.cuda.synchronize()
        replays = fe.graph_counts()["replays"] - before
        out.append((replays, sc.count))
        print(f"{label}: frame {k}: {replays} frontend graph replays, {sc.count} host reads by site {sc.sites} "
              f"on {card}", flush=True)
        if k >= 2:
            solver_sites = [site for site in sc.sites if any(m in site for m in ("refine", "ransac", "small_schur"))]
            _require(replays == 2, f"{label}: frame {k} replayed {replays} graphs, not 2")
            _require(sc.count <= 3 and not solver_sites, f"{label}: frame {k} reads the host {sc.count} times: "
                                                        f"{sc.sites}")
    return out


def run_drift_recovery(torch, device, card, packets, ground_truth) -> None:
    """Drift recovery on the golden packets for both updaters
    (`tests/test_accuracy_regression.py:166-228`): a growing camera drift
    on every packet, odometry sigmas loosened 10x, the full-batch backend
    with 100 LM iterations allowed; fails unless each recovered ATE is
    below the corrupted ATE / DRIFT_FACTOR and DRIFT_ATE_M."""
    import dataclasses

    from dynosam_tpu_torch.core.lie import se3_compose, se3_exp
    from dynosam_tpu_torch.eval import metrics
    from dynosam_tpu_torch.pipeline import run_from_packets
    from dynosam_tpu_torch.testing.scenes import golden_config

    label = "drift recovery"
    drift = torch.tensor(DRIFT_PER_FRAME, device=device)
    corrupted = [p._replace(X_world=se3_compose(se3_exp(drift * float(k)), p.X_world)) for k, p in enumerate(packets)]

    def ate(R, t, valid):
        T = np.tile(np.eye(4), (int(valid.sum()), 1, 1))
        T[:, :3, :3] = R.double().cpu().numpy()[valid]
        T[:, :3, 3] = t.double().cpu().numpy()[valid]
        return metrics.ate(T, ground_truth[valid])["trans"].rmse

    every = np.ones(len(packets), bool)
    corrupted_ate = ate(torch.stack([p.X_world.R for p in corrupted]), torch.stack([p.X_world.t for p in corrupted]),
                        every)
    print(f"{label}: corrupted camera ATE {corrupted_ate:.5f} m", flush=True)
    _require(corrupted_ate > 0.08, f"{label}: the drift is not material ({corrupted_ate} m)")
    for updater in (0, 1):
        cfg = golden_config(True)
        cfg = dataclasses.replace(cfg, backend=dataclasses.replace(
            cfg.backend, backend_updater_enum=updater, lm_max_iterations=100, odometry_translation_sigma=1.0,
            odometry_rotation_sigma=0.5))
        torch.cuda.synchronize()
        with SyncCounter(torch) as sc:
            be = run_from_packets(corrupted, cfg, device=device)
        torch.cuda.synchronize()
        (start, window, r, events), = be.solves
        X, xv = be.camera_poses()
        rec = ate(X.R, X.t, xv.cpu().numpy())
        cg = sum(r.cg_iterations)
        ms = events[0].elapsed_time(events[1])
        print(f"{label}: updater {updater}: full-batch solve [{start}, {start + window}) {ms:.2f} ms (CUDA events), "
              f"{r.iterations} LM iterations, {cg} CG iterations, host reads {sc.count}, error {float(r.initial_error):.6g} -> {float(r.error):.6g}; recovered ATE {rec:.5f} m (limits "
              f"{corrupted_ate / DRIFT_FACTOR:.5f} and {DRIFT_ATE_M}) on {card}", flush=True)
        _require(np.isfinite(rec) and rec < corrupted_ate / DRIFT_FACTOR and rec < DRIFT_ATE_M,
                 f"{label}: updater {updater} recovered ATE {rec} m against corrupted {corrupted_ate} m")


def run_batched_phase(torch, device, card) -> dict:
    """The offline pipeline with two windows per dispatch over the first
    BATCHED_FRAMES frames of the pipeline path's scene, against a
    sequential runner replaying the same packets."""
    import dataclasses

    from dynosam_tpu_torch import kernels
    from dynosam_tpu_torch.testing.scenes import kitti_pipeline_config, kitti_scene
    from dynosam_tpu_torch.throughput import make_offline_runner

    label = "batched"
    n = BATCHED_FRAMES
    scene, frames = kitti_scene(device, n_frames=PIPELINE_FRAMES)
    frames = frames[:n]
    base = kitti_pipeline_config(n)
    cfg = dataclasses.replace(base, backend=dataclasses.replace(base.backend, opt_windows_per_dispatch=2))
    runner = make_offline_runner(scene.cam, cfg, n, device=device)
    _require(runner.wpd == 2, f"{label}: {runner.wpd} windows per dispatch")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    prev = kernels.launch_counts()
    per_frame, dispatches = [], []
    for f in frames:
        runner.frontend(f)
        due = runner.windows_due()
        if due:
            with SyncCounter(torch) as sc:
                wins = runner.solve_group(due) if len(due) > 1 else [runner.solve(due[0])]
            dispatches.append((wins, sc.count))
        torch.cuda.synchronize()
        now = kernels.launch_counts()
        per_frame.append({k: now[k] - prev[k] for k in now})
        prev = now
    totals = kernels.launch_counts()
    for k in range(1, n):
        missing = [name for name in PATH_KERNELS["batched"] if per_frame[k][name] < 1]
        _require(not missing, f"{label}, frame {k}: kernels {missing} never launched")

    seq = make_offline_runner(scene.cam, base, n, device=device)
    seq_reads = []
    for p in runner.packets:
        seq.add_packet(p)
        for s in seq.windows_due():
            with SyncCounter(torch) as sc:
                seq.solve(s)
            seq_reads.append(sc.count)
    torch.cuda.synchronize()
    _require([[w.start for w in wins] for wins, _ in dispatches] == [[0, 6]],
             f"{label}: dispatches {[[w.start for w in wins] for wins, _ in dispatches]}")
    for wins, reads in dispatches:
        ms = wins[0].solve_ms()
        its = [w.result.iterations for w in wins]
        print(f"{label}: dispatch of windows {[w.start for w in wins]}: {ms:.2f} ms (CUDA events), LM iterations "
              f"{its}, host reads {reads} ({reads / len(wins):.1f} per window); sequential replay of the same "
              f"windows: {[round(w.solve_ms(), 2) for w in seq.windows]} ms, host reads {seq_reads} "
              f"({sum(seq_reads) / len(seq_reads):.1f} per window) on {card}", flush=True)
        for w in wins:
            r = w.result
            _require(np.isfinite(float(r.error)) and float(r.error) < float(r.initial_error),
                     f"{label}: window {w.start} error {float(r.initial_error)} -> {float(r.error)}")
    a, b = runner.est, seq.est
    for f in ("X_valid", "motion_valid", "static_valid", "dyn_valid"):
        _require(bool(torch.equal(getattr(a, f), getattr(b, f))), f"{label}: {f} differs from the sequential run's")
    _require(bool(a.X_valid[:n].all()), f"{label}: the store misses frames")
    diff = float((a.X.t[:n] - b.X.t[:n]).abs().max())
    later = [w.start for wins, _ in dispatches for w in wins[1:]]
    shift = max(float((runner.map.X_init.t[s] - b.X.t[s]).abs().max()) for s in later)
    limit = 2 * shift + BATCHED_TOL_M
    print(f"{label}: camera translations against the sequential run: max |difference| {diff:.3g} m "
          f"(limit {limit:.3g}: anchor shift {shift:.3g} m at frames {later})", flush=True)
    _require(np.isfinite(diff) and diff <= limit, f"{label}: {diff} m from the sequential run")
    return dict(totals=totals)


# ------------------------------------------------------ slice 8: new paths
def run_ego_phase(torch, scene, frames, device, card) -> dict:
    """The frontend-only pipeline over the main path's frames in each
    alternate ego-motion mode; per frame the launches, host reads (sync
    debug mode) and whether the ego solve was valid."""
    import dataclasses

    from dynosam_tpu_torch import kernels
    from dynosam_tpu_torch.pipeline import DynoPipeline
    from dynosam_tpu_torch.testing.scenes import kitti_config

    out = {}
    for path, label, solver, two_point in EGO_MODES:
        base = kitti_config()
        fe = dataclasses.replace(base.frontend, ego_motion_solver=solver, camera_solver=dataclasses.replace(
            base.frontend.camera_solver, ransac_use_2point_mono=two_point))
        pipe = DynoPipeline(scene.cam, dataclasses.replace(base, frontend=fe), device=device)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        prev = kernels.launch_counts()
        per_frame, times, reads, ego_ok = [], [], [], []
        for f in frames:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with SyncCounter(torch) as sc:
                pipe.spin_once(f)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            reads.append(sc.count)
            now = kernels.launch_counts()
            per_frame.append({k: now[k] - prev[k] for k in now})
            prev = now
            ego_ok.append(bool(pipe.frontend_state.rel_prev_valid))
        packets = pipe.packets
        est = np.stack([p.X_world.t.double().cpu().numpy() for p in packets])
        gt = np.stack([x.t.double().cpu().numpy() for x in scene.X_gt[:len(packets)]])
        res = dict(per_frame=per_frame, totals=kernels.launch_counts(), times=times, ate=ate_rmse(est, gt),
                   finite=bool(np.isfinite(est).all()), n_motion=[int(p.objects.motion_valid.sum()) for p in packets],
                   n_static=[int(p.static_obs.valid.sum()) for p in packets])
        steady = reads[2:]
        valid = [k for k, ok in enumerate(ego_ok) if ok]
        print(f"{label}: host reads per frame {reads} (steady mean {sum(steady) / len(steady):.1f}, PyTorch's sync "
              f"debug mode); frames with a valid ego solve {valid} ({len(valid)} of {len(frames) - 1} after the "
              f"first) on {card}", flush=True)
        report_path(res, label, PATH_KERNELS[path], frames, card)
        out[path] = res
    return out


def _permute_ids(masks, rng):
    """Each (H, W) int32 host mask with its instance ids mapped to a fresh
    permutation of 11.. (the segmenter's unstable ids)."""
    out = []
    for m in masks:
        labels = [int(x) for x in np.unique(m) if x > 0]
        pm = np.zeros_like(m)
        for lab, new in zip(labels, rng.permutation(len(labels)) + 11):
            pm[m == lab] = new
        out.append(pm)
    return out


def run_masks_phase(torch, device, card, n: int = PIPELINE_FRAMES, size=(384, 1280)) -> dict:
    """The online pipeline with mask propagation and ByteTrack on host frames
    whose instance ids are permuted on every frame and whose first object is
    deleted on two non-adjacent frames."""
    import dataclasses
    import tempfile

    import functools

    from dynosam_tpu_torch import pipeline
    from dynosam_tpu_torch.eval.evaluator import evaluate_all
    from dynosam_tpu_torch.frontend import byte_tracker, tracker
    from dynosam_tpu_torch.frontend import frontend as fe
    from dynosam_tpu_torch.pipeline import run_and_log
    from dynosam_tpu_torch.testing.scenes import RenderedDataset, kitti_online_config, kitti_scene

    label = "masks"
    scene, frames = kitti_scene(device, n_frames=n, h=size[0], w=size[1])
    rendered = [f.mask.cpu().numpy() for f in frames]
    masks = _permute_ids(rendered, np.random.default_rng(5))
    lost_label = scene.object_labels[0]
    for k in MASK_DELETED:
        masks[k][rendered[k] == lost_label] = 0
    host = [f._replace(
        gray=f.gray.cpu(), depth=f.depth.cpu(), flow=f.flow.cpu(), mask=torch.as_tensor(m))
        for f, m in zip(frames, masks)]
    cfg = kitti_online_config()
    tr = dataclasses.replace(cfg.frontend.tracker, use_propogate_mask=True, use_byte_tracker=True)
    cfg = dataclasses.replace(cfg, frontend=dataclasses.replace(cfg.frontend, tracker=tr))

    relabelled, propagated = [], []
    relabel, propagate = byte_tracker.relabel_mask, tracker.propagate_mask

    def record_relabel(*a, **kw):
        relabelled.append(relabel(*a, **kw))
        return relabelled[-1]

    def record_propagate(*a, **kw):
        propagated.append(propagate(*a, **kw))
        return propagated[-1]

    # the recorders see every frame only if the step runs eagerly (a CUDA
    # graph replay runs no Python); a second run, graphed, must give the
    # same packets
    real_step = pipeline.frontend_step
    byte_tracker.relabel_mask, tracker.propagate_mask = record_relabel, record_propagate
    pipeline.frontend_step = functools.partial(real_step, _graphs=False)
    try:
        with tempfile.TemporaryDirectory() as out:
            with PipelineProbe(torch) as probe:
                eager = run_and_log(RenderedDataset(scene, host), cfg, out, device=device)
            evals = evaluate_all(out)
    finally:
        byte_tracker.relabel_mask, tracker.propagate_mask = relabel, propagate
        pipeline.frontend_step = real_step
    with tempfile.TemporaryDirectory() as out:
        before = fe.graph_counts()
        graphed = run_and_log(RenderedDataset(scene, host), cfg, out, device=device)
        after = fe.graph_counts()
    leaves = torch.utils._pytree.tree_leaves
    same = all(torch.equal(a, b) for p, q in zip(graphed.packets, eager.packets)
               for a, b in zip(leaves(tuple(p)), leaves(tuple(q))))
    print(f"{label}: the same run with the frontend step graphed: {after['replays'] - before['replays']} graph "
          f"replays, packets {'equal' if same else 'differ from'} the eager run's bit for bit", flush=True)
    _require(same and len(graphed.packets) == n and after["replays"] > before["replays"],
             f"{label}: the graphed run's packets differ from the eager run's")
    check_launches(probe, label, PATH_KERNELS["masks"], n)
    _require(len(relabelled) == n and len(propagated) == n - 1,
             f"{label}: {len(relabelled)} relabels and {len(propagated)} propagations over {n} frames")
    # each object's ids over the frames where its rendered box is off the
    # image border (a box truncated by the border shrinks against the
    # constant-velocity prediction, and ByteTrack, as the reference's,
    # re-identifies the sliver)
    ids = {lab: set() for lab in scene.object_labels}
    counted = {lab: 0 for lab in scene.object_labels}
    h, w = rendered[0].shape
    for k, (ren, rel) in enumerate(zip(rendered, relabelled)):
        for lab in scene.object_labels:
            ys, xs = np.nonzero(ren == lab)
            whole = xs.size and xs.min() > 0 and ys.min() > 0 and xs.max() < w - 1 and ys.max() < h - 1
            if whole and not (k in MASK_DELETED and lab == lost_label):
                ids[lab] |= set(int(x) for x in np.unique(rel[ren == lab]))
                counted[lab] += 1
    print(f"{label}: ByteTrack ids per rendered object {ids} over the frames where it is whole in view "
          f"{counted} (of {n}) on {card}", flush=True)
    _require(counted[lost_label] >= max(MASK_DELETED), f"{label}: object {lost_label} in view on {counted} frames")
    _require(all(len(v) == 1 for v in ids.values()) and len({min(v) for v in ids.values()}) == len(ids),
             f"{label}: ByteTrack ids {ids}")
    lost_id = min(ids[lost_label])
    for k in MASK_DELETED:
        prop = propagated[k - 1].cpu().numpy()
        truth = rendered[k] == lost_label
        restored = int(((prop == lost_id) & truth).sum())
        share = restored / max(int(truth.sum()), 1)
        stray = int(((prop == lost_id) & ~truth).sum())
        precision = restored / max(restored + stray, 1)
        print(f"{label}: frame {k}: object {lost_label} deleted from the mask; propagation restored {restored} of "
              f"its {int(truth.sum())} rendered pixels ({share:.3f}, limit {MASK_RESTORED}), {stray} elsewhere "
              f"(precision {precision:.4f}, limit {MASK_PRECISION})", flush=True)
        _require(share >= MASK_RESTORED and precision >= MASK_PRECISION,
                 f"{label}: frame {k} restored {share:.3f} of the object's pixels at precision {precision:.4f}")
    print(f"{label}: ms per spin {[round(t * 1e3, 1) for t in probe.times]}; {n / sum(probe.times):.2f} "
          f"frames/s over the spins (host clock, synchronised) on {card}", flush=True)
    fe_ate = evals["frontend"]["camera"]["ate_trans_rmse"]
    be_ate = evals["rgbd_motion_world_backend"]["camera"]["ate_trans_rmse"]
    print(f"{label}: camera ATE frontend {fe_ate:.5f} m (limit {ATE_LIMIT_M}), backend {be_ate:.5f} m "
          f"(limit {BACKEND_ATE_LIMIT_M})", flush=True)
    _require(np.isfinite(fe_ate) and fe_ate < ATE_LIMIT_M, f"{label}: frontend ATE {fe_ate} m")
    _require(np.isfinite(be_ate) and be_ate < BACKEND_ATE_LIMIT_M, f"{label}: backend ATE {be_ate} m")
    return dict(totals=probe.totals)


def distort_frames(torch, cam, dist, frames):
    """Frames as a distorted lens would see them: at each distorted pixel v,
    the rendered frame at u = U(v) (gray and flow bilinear, depth and mask
    nearest) and the flow D(u + flow(u)) - v."""
    from dynosam_tpu_torch.core.distortion import distort_points, pixel_grid, undistort_points
    from dynosam_tpu_torch.ops.klt import sample_channels

    h, w = frames[0].gray.shape
    grid = pixel_grid(h, w, frames[0].gray.device)
    src = undistort_points(grid, cam, dist)
    out = []
    for f in frames:
        gray, fx, fy, depth, mask = sample_channels(
            (f.gray, *f.flow.unbind(-1), f.depth, f.mask), ("bilinear",) * 3 + ("nearest",) * 2, src)
        flow = distort_points(src + torch.stack([fx, fy], -1), cam, dist) - grid
        out.append(f._replace(gray=gray.reshape(h, w), depth=depth.reshape(h, w), flow=flow.reshape(h, w, 2),
                              mask=mask.reshape(h, w)))
    return out


def run_rectify_phase(torch, scene, frames, device, card, k2_row) -> dict:
    """Distort the rendered frames, rectify them on the card through a
    DatasetProvider with `distortion` set, hold the rectifier's full-frame
    K2 call against its plain version, check the rectified frames against
    the render, and run the frontend-only pipeline on them."""
    from dynosam_tpu_torch.core.distortion import Distortion, undistort_rectify_map
    from dynosam_tpu_torch.frontend.frontend import to_device
    from dynosam_tpu_torch.frontend.rectify import make_rectifier
    from dynosam_tpu_torch.kernels import point_sample as ps
    from dynosam_tpu_torch.testing.scenes import RenderedDataset, kitti_config

    label = "rectify"
    cam = scene.cam
    h, w = frames[0].gray.shape
    dist = Distortion(RECTIFY_COEFFS, "radtan")
    distorted = distort_frames(torch, cam, dist, frames)
    rectify = make_rectifier(cam, dist, device=device)

    # the rectifier's K2 call at its shape: N = H * W map points, gray and
    # the two flow planes bilinear, depth nearest, read in place
    f = distorted[1]
    flat = undistort_rectify_map(cam, dist, device).reshape(-1, 2).contiguous()
    chans = (f.gray, *f.flow.unbind(-1), f.depth)
    modes = ("bilinear",) * 3 + ("nearest",)
    before = ps.launches
    got = ps.point_sample(chans, flat, modes)
    _require(ps.launches == before + 1, f"{label}: the full-frame call did not launch K2 once")
    want = ps.point_sample_plain(chans, flat, modes)
    torch.cuda.synchronize()
    rel = max(float((got[:, c] - want[:, c]).abs().max()) / max(float(want[:, c].abs().max()), 1e-9)
              for c in range(3))
    near = float((got[:, 3] - want[:, 3]).abs().max())
    n = flat.shape[0]
    ms = cuda_ms(torch, lambda: ps.point_sample(chans, flat, modes), 200)
    plain_ms = cuda_ms(torch, lambda: ps.point_sample_plain(chans, flat, modes), 20)
    # library yardstick: grid_sample of the three bilinear channels, stacked
    # once outside the timing (align_corners, border padding)
    stacked = torch.stack([f.gray, f.flow[..., 0], f.flow[..., 1]])[None]
    grid = torch.stack([flat[:, 0] / (w - 1) * 2 - 1, flat[:, 1] / (h - 1) * 2 - 1], -1)[None, None]
    lib = lambda: torch.nn.functional.grid_sample(  # noqa: E731
        stacked, grid, mode="bilinear", padding_mode="border", align_corners=True)
    lib_d = float((lib()[0, :, 0].t() - want[:, :3]).abs().max())
    library_ms = cuda_ms(torch, lib, 200)
    taps = distinct_taps(torch, flat[:, 0], flat[:, 1], h, w)
    # the pixels the map's taps touch in each of the four planes (flow's two
    # interleaved, 8 B a pixel), the points and the (N, 4) output
    nbytes = taps * (4 + 8 + 4) + n * 8 + n * 4 * 4
    b_ms, b_by = bound_ms(nbytes, 3 * n * FLOP_BILINEAR)
    print(f"{label}: K2 full-frame call, N {n} ({h}x{w}), gray and flow planes bilinear, depth nearest: "
          f"{ms * 1e3:.1f} us (plain {plain_ms * 1e3:.1f} us, grid_sample of the 3 bilinear channels "
          f"{library_ms * 1e3:.1f} us, agrees to {lib_d:.3g}; bound {b_ms * 1e3:.2f} us by {b_by}, {taps} pixels "
          f"read); bilinear max |d| / max |value| {rel:.3g} (tol {PS_TOL_REL}), nearest max |d| {near:.3g} "
          f"(tol 0) on {card}", flush=True)
    _require(np.isfinite(rel) and rel <= PS_TOL_REL, f"{label}: K2 full-frame bilinear samples disagree: {rel}")
    _require(near == 0.0, f"{label}: K2 full-frame nearest samples differ: {near}")
    k2_row.update(ms_rectify=ms, plain_ms_rectify=plain_ms, library_ms_rectify=library_ms,
                  bound_ms_rectify=b_ms, bound_by_rectify=b_by)
    rect_ms = cuda_ms(torch, lambda: rectify(f), 20)
    print(f"{label}: one frame's rectification (K2 call and flow undistortion): {rect_ms:.3f} ms (CUDA events) "
          f"on {card}", flush=True)

    # host frames, as a loader decodes them: gray, flow and depth are
    # rectified on the card, the mask on the host (ByteTrack relabels it
    # there)
    ds = RenderedDataset(scene, [to_device(x, "cpu") for x in distorted])
    ds.distortion, ds.device = dist, device
    rect = list(ds.frames())
    _require(all(r.gray.is_cuda and not r.mask.is_cuda for r in rect),
             f"{label}: a loader's frame was not rectified on the card with its mask on the host")
    sl = (slice(RECTIFY_MARGIN[0], h - RECTIFY_MARGIN[0]), slice(RECTIFY_MARGIN[1], w - RECTIFY_MARGIN[1]))
    g_err, d_ok, m_ok, fl_ok = [], [], [], []
    for r, f0 in zip(rect, frames):
        g_err.append(float((r.gray[sl] - f0.gray[sl]).abs().median()))
        d_ok.append(float(((r.depth[sl] - f0.depth[sl]).abs() <= RECTIFY_DEPTH_REL * f0.depth[sl]).float().mean()))
        m_ok.append(float((r.mask[sl].to(f0.mask.device) == f0.mask[sl]).float().mean()))
        fl_ok.append(float(((r.flow[sl] - f0.flow[sl]).norm(dim=-1) < RECTIFY_FLOW_PX).float().mean()))
    print(f"{label}: interior {sl[0].start}..{sl[0].stop} x {sl[1].start}..{sl[1].stop} of {len(rect)} frames: "
          f"median |gray - render| {max(g_err):.3g} (limit {RECTIFY_GRAY}), depth within {RECTIFY_DEPTH_REL:.0%} "
          f"on >= {min(d_ok):.4f}, "
          f"mask equal on >= {min(m_ok):.4f} (limit {RECTIFY_SHARE}), flow within {RECTIFY_FLOW_PX} px on >= "
          f"{min(fl_ok):.4f} (limit {RECTIFY_FLOW_SHARE})", flush=True)
    _require(max(g_err) <= RECTIFY_GRAY, f"{label}: gray {g_err}")
    _require(min(d_ok) >= RECTIFY_SHARE and min(m_ok) >= RECTIFY_SHARE, f"{label}: depth {d_ok}, mask {m_ok}")
    _require(min(fl_ok) >= RECTIFY_FLOW_SHARE, f"{label}: flow {fl_ok}")
    ds._rectifier = None
    res = run_main_path(torch, scene, ds.frames(), kitti_config(), device)
    report_path(res, label, PATH_KERNELS["rectify"], rect, card)
    return res


def textured_pair(h: int, w: int, d: int, seed: int = 0):
    """A textured left image and the right image of a rig with disparity d
    everywhere (`tests/test_stereo.py:11-23` at another size)."""
    from scipy.ndimage import gaussian_filter

    tex = gaussian_filter(np.random.default_rng(seed).uniform(0, 255, (h, w + 32)), 1.0).astype(np.float32)
    return tex[:, 16:16 + w].copy(), tex[:, 16 + d:16 + d + w].copy()


def run_stereo_phase(torch, device, card, size=(384, 1280)) -> dict:
    """The block matcher at KITTI width with D = 64 on a pair of known
    disparity: time, peak memory, accuracy and equality with the CPU run."""
    from dynosam_tpu_torch import kernels
    from dynosam_tpu_torch.core.camera import CameraParams, StereoParams
    from dynosam_tpu_torch.frontend.stereo import block_match, disparity_to_depth

    label = "stereo"
    h, w = size
    d, D = STEREO_DISPARITY, 64
    left, right = textured_pair(h, w, d)
    lt, rt = torch.as_tensor(left, device=device), torch.as_tensor(right, device=device)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    disp = block_match(lt, rt, max_disparity=D)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device) - base
    totals = kernels.launch_counts()
    ms = cuda_ms(torch, lambda: block_match(lt, rt, max_disparity=D), 10, warmup=1)
    cpu = block_match(torch.as_tensor(left), torch.as_tensor(right), max_disparity=D)
    got = disp.cpu()
    same_valid = bool(torch.equal(got > 0, cpu > 0))
    v = got > 0
    sub = float((got[v] - cpu[v]).abs().max()) if bool(v.any()) else 0.0
    inner = got[8:-8, D + 8:-8]
    hit = float(((inner - d).abs() < 1.0).float().mean())
    cam = CameraParams.create(718.0, 718.0, w / 2, h / 2, w, h)
    depth = disparity_to_depth(disp, StereoParams(cam, 0.54))[8:-8, D + 8:-8]
    true_depth = 718.0 * 0.54 / d
    med = float(depth[depth > 0].median())
    print(f"{label}: block_match {h}x{w}, D {D}, true disparity {d}: {ms:.2f} ms per call (CUDA events), peak "
          f"{peak / 2**20:.1f} MiB above the inputs on {card}", flush=True)
    print(f"{label}: {hit:.4f} of interior pixels within 1 px of the true disparity (limit {STEREO_HIT}); median "
          f"depth {med:.4f} m against {true_depth:.4f} m (limit {STEREO_DEPTH_REL:.0%}); against the CPU run: "
          f"valid pixels equal {same_valid}, max |d| {sub:.3g} px (tol {STEREO_CPU_TOL})", flush=True)
    _require(hit > STEREO_HIT, f"{label}: {hit} of pixels within 1 px")
    _require(abs(med - true_depth) / true_depth < STEREO_DEPTH_REL, f"{label}: median depth {med}")
    _require(same_valid and sub <= STEREO_CPU_TOL, f"{label}: differs from the CPU run ({same_valid}, {sub})")
    _require(not any(totals.values()), f"{label}: kernels launched {totals}")
    return dict(totals=totals)


def run_streaming_phase(torch, device, card, n: int = PIPELINE_FRAMES, size=(384, 1280)) -> dict:
    """The pipeline path's frames written in the KITTI layout, read back by
    `KittiDataset` (native decode) as they decode into the streaming runner,
    against `run_offline` on the same decoded frames."""
    import tempfile

    from dynosam_tpu_torch import kernels, throughput
    from dynosam_tpu_torch.data import native_loader
    from dynosam_tpu_torch.data.kitti import KittiDataset
    from dynosam_tpu_torch.testing.render import write_reference_layout
    from dynosam_tpu_torch.testing.scenes import kitti_pipeline_config, kitti_scene

    label = "streaming"
    _require(native_loader.available(), f"{label}: the native loader (native/libdynoloader.so) did not load")
    scene, frames = kitti_scene(device, n_frames=n, h=size[0], w=size[1])
    cfg = kitti_pipeline_config(n)
    per_frame = []
    step = throughput.frontend_step

    def counted_step(*a, **kw):
        before = kernels.launch_counts()
        out = step(*a, **kw)
        now = kernels.launch_counts()
        per_frame.append({k: now[k] - before[k] for k in now})
        return out

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_reference_layout(scene, root, frames=frames)
        write_s = time.perf_counter() - t0
        ds = KittiDataset(root)
        cam = ds.camera_params()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        throughput.frontend_step = counted_step
        try:
            t0 = time.perf_counter()
            streamed = throughput.run_streaming(ds.prefetched_frames(), cam, cfg, n, device=device)
            stream_s = time.perf_counter() - t0
        finally:
            throughput.frontend_step = step
        totals = kernels.launch_counts()
        decoded = list(KittiDataset(root).frames())
    off = throughput.run_offline(decoded, cam, cfg, device=device)
    print(f"{label}: {n} frames {size[1]}x{size[0]} written in the KITTI layout in {write_s:.1f} s, then decoded "
          f"(native, prefetch thread) into the streaming runner: {n / stream_s:.2f} frames/s with decode overlapped "
          f"(host clock, to the final synchronisation) on {card}", flush=True)
    _require(len(per_frame) == n, f"{label}: {len(per_frame)} frontend steps")
    for k in range(1, n):
        missing = [name for name in PATH_KERNELS["streaming"] if per_frame[k][name] < 1]
        _require(not missing, f"{label}, frame {k}: kernels {missing} never launched")
    stray = [name for name, c in totals.items() if name not in PATH_KERNELS["streaming"] + WINDOW_KERNELS and c > 0]
    _require(not stray, f"{label}: kernels {stray} launched off their path")
    a, b = streamed.est, off.est
    equal = all(bool(torch.equal(getattr(a, f), getattr(b, f))) if not isinstance(getattr(a, f), tuple)
                else all(bool(torch.equal(x, y)) for x, y in zip(getattr(a, f), getattr(b, f)))
                for f in type(a)._fields)
    masks_equal = all(bool(torch.equal(getattr(a, f), getattr(b, f)))
                      for f in ("X_valid", "motion_valid", "static_valid", "dyn_valid"))
    diff = float((a.X.t[:n] - b.X.t[:n]).abs().max())
    print(f"{label}: estimate store against run_offline on the decoded frames (same seed): equal {equal}, masks "
          f"equal {masks_equal}, max |camera translation difference| {diff:.3g} m; window errors "
          f"{[round(float(w.result.error), 6) for w in streamed.windows]} against "
          f"{[round(float(w.result.error), 6) for w in off.windows]}", flush=True)
    _require(equal, f"{label}: the store differs from run_offline's (masks equal {masks_equal}, {diff} m)")
    X = a.X.t[:n].double().cpu().numpy()
    gt = np.stack([x.t.double().cpu().numpy() for x in scene.X_gt[:n]])
    ate = ate_rmse(X, gt)
    print(f"{label}: backend camera ATE {ate:.5f} m (limit {BACKEND_ATE_LIMIT_M})", flush=True)
    _require(bool(a.X_valid[:n].all()) and np.isfinite(ate) and ate < BACKEND_ATE_LIMIT_M, f"{label}: ATE {ate} m")
    return dict(totals=totals)


# ------------------------------------------------------- slice 9: new paths
def _leaves(tree):
    if hasattr(tree, "_fields"):
        return [x for f in tree._fields for x in _leaves(getattr(tree, f))]
    return [tree]


def _max_leaf_diff(torch, a, b) -> float:
    """Largest |difference| over the leaves of two equal-structure trees
    (integer and bool leaves count 1 where they differ)."""
    out = 0.0
    for x, y in zip(_leaves(a), _leaves(b)):
        if x.is_floating_point():
            out = max(out, float((x - y).abs().max()) if x.numel() else 0.0)
        elif not torch.equal(x, y):
            out = max(out, 1.0)
    return out


def run_multi_sequence_phase(torch, device, card, main_per_frame) -> dict:
    """`MultiSequencePipeline` over S KITTI-width sequences in lockstep
    (12 frames 1280x384 each, `kitti_config`), then each sequence alone
    through `frontend_step` with the same frames and generators: frames/s
    summed over sequences and host reads per frame; fails unless K1-K3
    launch S times as often per steady frame as on the main path, each
    sequence's camera ATE is within ATE_LIMIT_M and its packets equal its
    single-sequence run."""
    from dynosam_tpu_torch import kernels
    from dynosam_tpu_torch.frontend.frontend import FrontendState, frontend_step
    from dynosam_tpu_torch.parallel.batch_eval import MultiSequencePipeline, frame_generator
    from dynosam_tpu_torch.testing.scenes import RenderedDataset, kitti_config, kitti_scene

    label = "multi-sequence"
    S = len(MULTI_SEEDS)
    cfg = kitti_config()
    cap = cfg.capacity
    caps = (cap.max_static_tracks, cap.max_dynamic_tracks, cap.max_objects)
    scenes = [kitti_scene(device, seed=seed) for seed in MULTI_SEEDS]
    datasets = [RenderedDataset(sc, fr) for sc, fr in scenes]
    n = len(scenes[0][1])
    pipe = MultiSequencePipeline(datasets, cfg.frontend, caps=caps, device=device)
    times, reads, per_frame, step = [], [], [], pipe.step

    def probed_step(*args):
        """The pipeline's lockstep step, timed between synchronisations,
        its host reads counted and its launches read after it."""
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        with SyncCounter(torch) as sc:
            out = step(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        reads.append(sc.count)
        now = kernels.launch_counts()
        per_frame.append({name: now[name] - before[name] for name in now})
        return out

    pipe.step = probed_step
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    packets = pipe.run(n)
    totals = kernels.launch_counts()
    steady = list(range(2, n))
    dt = sum(times[k] for k in steady)
    h, w = scenes[0][1][0].gray.shape
    print(f"{label}: {S} sequences x {n} frames {w}x{h} in lockstep; steady frames {steady[0]}..{steady[-1]}: "
          f"{S * len(steady) / dt:.2f} frames/s summed over sequences, {dt / len(steady) * 1e3:.1f} ms per "
          f"lockstep frame (host clock, synchronised), host reads per lockstep frame "
          f"{[reads[k] for k in steady]} on {card}", flush=True)
    for k in steady:
        lf = per_frame[k]
        print(f"{label}: frame {k} launches {lf} (main path {main_per_frame[k]})", flush=True)
        for name in PATH_KERNELS["multi_sequence"]:
            _require(lf[name] == S * main_per_frame[k][name],
                     f"{label}, frame {k}: {name} launched {lf[name]} times, not {S} x {main_per_frame[k][name]}")
    stray = [name for name, c in totals.items() if name not in PATH_KERNELS["multi_sequence"] and c > 0]
    _require(not stray, f"{label}: kernels {stray} launched off their path")

    worst = 0.0
    for s, ((scene, frames), ds) in enumerate(zip(scenes, datasets)):
        est = np.stack([p.X_world.t[s].double().cpu().numpy() for p in packets])
        gt = np.stack([x.t.double().cpu().numpy() for x in scene.X_gt[:n]])
        ate = ate_rmse(est, gt)
        state, prev_f, diff = FrontendState.create(*caps, device=device), None, 0.0
        for k, f in enumerate(frames):
            state, pkt, _, _ = frontend_step(state, prev_f if prev_f is not None else f, f, scene.cam, cfg.frontend,
                                             generator=frame_generator(k, s, device), first_frame=k == 0,
                                             device=device)
            prev_f = f
            one = type(pkt)(*(_index_tree(x, s) for x in packets[k]))
            diff = max(diff, _max_leaf_diff(torch, one, pkt))
        worst = max(worst, diff)
        print(f"{label}: sequence {s} (scene seed {MULTI_SEEDS[s]}): camera ATE {ate:.5f} m (limit {ATE_LIMIT_M}), "
              f"largest difference from its single-sequence run {diff:.3g}", flush=True)
        _require(np.isfinite(ate) and ate <= ATE_LIMIT_M, f"{label}: sequence {s} ATE {ate} m")
    _require(worst == 0.0, f"{label}: packets differ from the single-sequence runs by {worst}")
    return dict(totals=totals)


def _index_tree(tree, s):
    if hasattr(tree, "_fields"):
        return type(tree)(*(_index_tree(getattr(tree, f), s) for f in tree._fields))
    return tree[s]


def _window_map(torch, w):
    """A MeasurementMap holding exactly the window `w` (fields a window
    does not carry are zero or invalid)."""
    from dynosam_tpu_torch.backend.map import MeasurementMap

    W = w.frame_valid.shape[0]
    z = w.static_xyz.new_zeros
    return MeasurementMap(
        static_xyz=w.static_xyz, static_uv=z(*w.static_xyz.shape[:2], 2), static_valid=w.static_valid,
        dyn_xyz=w.dyn_xyz, dyn_uv=z(*w.dyn_xyz.shape[:2], 2), dyn_obj=w.dyn_obj, dyn_valid=w.dyn_valid,
        X_init=w.X_init, timestamps=z(W), frame_ids=torch.arange(W, dtype=torch.int32, device=w.dyn_obj.device),
        frame_valid=w.frame_valid, motion_init=w.motion_init, motion_valid=w.motion_valid,
        obj_pose_init=w.obj_pose_init, obj_label=torch.full_like(w.motion_valid, -1, dtype=torch.int32))


class CollectiveCounter:
    """Counts the `torch.distributed` collective calls made inside the
    block (all_reduce, batch_isend_irecv, all_gather)."""

    NAMES = ("all_reduce", "batch_isend_irecv", "all_gather_single", "all_gather_into_tensor")

    def __enter__(self):
        import torch.distributed as dist

        self._dist, self.count = dist, 0
        self._saved = {n: getattr(dist, n) for n in self.NAMES if hasattr(dist, n)}
        for n, fn in self._saved.items():
            setattr(dist, n, self._counted(fn))
        return self

    def _counted(self, fn):
        def wrap(*a, **k):
            self.count += 1
            return fn(*a, **k)
        return wrap

    def __exit__(self, *exc):
        for n, fn in self._saved.items():
            setattr(self._dist, n, fn)
        return False


def _timed(torch, fn):
    """(result, ms between CUDA events, host reads, collectives) of fn()."""
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with CollectiveCounter() as cc, SyncCounter(torch) as sc:
        start.record()
        out = fn()
        stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop), sc.count, cc.count


def run_distributed_phase(torch, device, card, pipeline_packets, golden_packets) -> dict:
    """The parallel layer on the card as a one-rank NCCL group
    (`multihost.initialize` with `device="cuda"`, `make_mesh(1)`):
    `distributed_schur_optimize` for both updaters on the pipeline path's
    first window (compacted as the backend compacts it) and on the
    window-10 simulator scenario, each against `lm_optimize_schur` on the
    same inputs; `distributed_optimize` on the golden full batch against
    `solver.lm_optimize` with Hutchinson's diagonal (probes seeded 0 on the
    card; the same LM iterations, error within DIST_ERR_RTOL, camera
    translations within DIST_X_TOL_M), the analytic-diagonal
    `solve_problem` printed beside both; `mp_worker` as one process on
    the card.  Prints ms per solve (CUDA events), host reads and
    collectives per LM iteration; fails unless every distributed solve
    matches within the float32 tolerances, the Schur solves' collectives
    per LM iteration are the one-block count (the error and the packed
    all_reduce; the frame-split count 7 is checked on the CPU), and the
    worker's verdict is ok."""
    import dataclasses
    import os
    import tempfile

    import torch.distributed as dist

    from dynosam_tpu_torch.backend import formulation as fm
    from dynosam_tpu_torch.backend.backend import prepare_window, solve_problem
    from dynosam_tpu_torch.backend.map import MeasurementMap, slice_window, update_map
    from dynosam_tpu_torch.backend.schur import lm_optimize_schur, world_motion_normal_product
    from dynosam_tpu_torch.backend.solver import LMConfig, lm_optimize
    from dynosam_tpu_torch.frontend.frontend import to_device
    from dynosam_tpu_torch.parallel import multihost
    from dynosam_tpu_torch.parallel.distributed_ba import distributed_optimize
    from dynosam_tpu_torch.parallel.mesh import make_mesh
    from dynosam_tpu_torch.parallel.schur_dist import distributed_schur_optimize
    from dynosam_tpu_torch.testing.gloo import free_port
    from dynosam_tpu_torch.testing.scenes import golden_config, kitti_pipeline_config
    from dynosam_tpu_torch.testing.simulator import Scenario, ScenarioConfig
    from dynosam_tpu_torch.utils.config import BackendConfig

    label = "distributed"
    from dynosam_tpu_torch import kernels

    kernels.reset_launch_counts()
    rank_dev = multihost.initialize(f"localhost:{free_port()}", 1, 0, device="cuda")
    _require(dist.get_backend() == "nccl" and rank_dev.type == "cuda",
             f"{label}: the group is {dist.get_backend()} on {rank_dev}, not NCCL on the card")
    mesh = make_mesh(1)
    print(f"{label}: one-rank {dist.get_backend()} group on {rank_dev}, mesh {tuple(mesh.mesh.shape)} "
          f"{mesh.mesh_dim_names}", flush=True)
    try:
        # the pipeline path's first window, compacted as the backend does
        pcfg = kitti_pipeline_config(PIPELINE_FRAMES)
        cap = pcfg.capacity
        m = MeasurementMap.create(10, cap.max_static_tracks, cap.max_dynamic_tracks, cap.max_objects, device=device)
        for k, p in enumerate(pipeline_packets[:10]):
            update_map(m, p, k)
        inputs = []
        for updater in (0, 1):
            bcfg = dataclasses.replace(pcfg.backend, backend_updater_enum=updater)
            prob = prepare_window(m, 0, 10, bcfg, m.X_init[0], torch.zeros((), dtype=torch.bool, device=device),
                                  updater=updater)
            inputs.append((f"pipeline window [0, 10) compacted to {tuple(prob.w.static_xyz.shape[1:2]) + tuple(prob.w.dyn_xyz.shape[1:2]) + tuple(prob.w.motion_valid.shape[1:2])}",
                           _window_map(torch, prob.w), bcfg, updater, LMConfig(max_iterations=bcfg.lm_max_iterations)))
        scfg = ScenarioConfig(n_frames=10)
        ms = MeasurementMap.create(10, scfg.ns, scfg.nd, scfg.no, device=device)
        for k, p in enumerate(Scenario(scfg).frontend_outputs()):
            update_map(ms, to_device(p, device), k)
        for updater in (0, 1):
            inputs.append(("simulator window-10 scenario", ms, BackendConfig(backend_updater_enum=updater), updater,
                           LMConfig(max_iterations=7)))
        for name, mm, bcfg, updater, lm in inputs:
            w = slice_window(mm, 0, 10)
            masks = fm.build_masks(w, bcfg)
            vals = fm.init_values(w, masks, bcfg) if updater == 0 else fm.init_values_world_pose(w, masks, bcfg)
            ref, ref_ms, ref_reads, _ = _timed(torch, lambda: lm_optimize_schur(vals, w, masks, bcfg, lm, w.X_init[0],
                                                                              formulation=updater))
            res, d_ms, d_reads, calls = _timed(torch, lambda: distributed_schur_optimize(
                mm, 10, bcfg, mesh=mesh, updater=updater, lm_cfg=lm))
            per_it = (calls - 1) / max(res.iterations, 1)    # the initial error's all_reduce first
            dx = float((res.values["X"].t - ref.values["X"].t).abs().max())
            n_motion = int(masks.motion_active.any(0).sum())
            print(f"{label}: {name}, updater {updater}: distributed {d_ms:.2f} ms, {res.iterations} LM iterations, "
                  f"host reads {d_reads}, collectives {calls} ({per_it:g} per LM iteration), error "
                  f"{float(res.initial_error):.6g} -> {float(res.error):.6g}; single-device {ref_ms:.2f} ms, "
                  f"{ref.iterations} LM iterations, host reads {ref_reads}, error -> {float(ref.error):.6g}; "
                  f"max |dX_t| {dx:.3g} m; objects with an active motion {n_motion} (CUDA events) on {card}",
                  flush=True)
            _require(abs(res.iterations - ref.iterations) <= 1, f"{label}: {name} {updater}: iterations "
                     f"{res.iterations} against {ref.iterations}")
            _require(abs(float(res.error) - float(ref.error)) <= DIST_ERR_RTOL * abs(float(ref.error)),
                     f"{label}: {name} {updater}: error {float(res.error)} against {float(ref.error)}")
            _require(dx <= DIST_X_TOL_M, f"{label}: {name} {updater}: camera translations differ by {dx} m")
            _require(per_it == 2, f"{label}: {name} {updater}: {per_it} collectives per LM iteration on one "
                                  f"frame block, not 2")

        # the golden full batch through the distributed LM-PCG, against the
        # single-device LM-PCG with the same pieces and Hutchinson's diagonal
        # (probes from a generator seeded 0 on the card, as every rank
        # draws them), with the analytic-diagonal solve beside both
        gcfg = golden_config(True).backend
        gcap = golden_config(True).capacity
        n = len(golden_packets)
        mg = MeasurementMap.create(n, gcap.max_static_tracks, gcap.max_dynamic_tracks, gcap.max_objects, device=device)
        for k, p in enumerate(golden_packets):
            update_map(mg, p, k)
        lm = LMConfig(max_iterations=gcfg.lm_max_iterations, cg_max_iterations=gcfg.cg_max_iterations)
        w = slice_window(mg, 0, n)
        masks = fm.build_masks(w, gcfg)
        anchor = w.X_init[0]
        solves = {
            "single-device Hutchinson": lambda: lm_optimize(
                lambda v: fm.world_motion_residuals(v, w, masks, gcfg, anchor),
                fm.world_motion_families(gcfg).robust, fm.init_values(w, masks, gcfg), lm,
                normal_fn=lambda v, sw, r: world_motion_normal_product(v, sw, r, w, masks, gcfg, anchor),
                generator=torch.Generator(device=device).manual_seed(0)),
            "distributed": lambda: distributed_optimize(mg, n, gcfg, mesh=mesh, lm_cfg=lm),
            "single-device analytic diagonal": lambda: solve_problem(
                prepare_window(mg, 0, n, gcfg, anchor, torch.zeros((), dtype=torch.bool, device=device)), gcfg, lm),
        }
        got = {}
        for name, solve in solves.items():
            res, ms_, reads, calls = _timed(torch, solve)
            got[name] = res
            per_it = f"{(calls - 1) / max(res.iterations, 1):g}" if calls else "0"
            print(f"{label}: golden full batch ({n} frames), LM-PCG, {name}: {ms_:.2f} ms, {res.iterations} LM "
                  f"iterations, {sum(res.cg_iterations)} CG iterations {res.cg_iterations}, host reads {reads}, "
                  f"collectives {calls} ({per_it} per LM iteration), error {float(res.initial_error):.6g} -> "
                  f"{float(res.error):.6g} (CUDA events) on {card}", flush=True)
        res, ref = got["distributed"], got["single-device Hutchinson"]
        dx = float((res.values["X"].t - ref.values["X"].t).abs().max())
        dx_an = float((res.values["X"].t - got["single-device analytic diagonal"].values["X"].t).abs().max())
        print(f"{label}: golden LM-PCG, distributed against single-device Hutchinson: max |dX_t| {dx:.3g} m; "
              f"against the analytic diagonal: {dx_an:.3g} m", flush=True)
        _require(res.iterations == ref.iterations and dx <= DIST_X_TOL_M
                 and abs(float(res.error) - float(ref.error)) <= DIST_ERR_RTOL * abs(float(ref.error)),
                 f"{label}: golden LM-PCG differs from the single-device Hutchinson solve: iterations "
                 f"{res.iterations}/{ref.iterations}, dX {dx} m, error {float(res.error)}/{float(ref.error)}")
    finally:
        dist.destroy_process_group()
    _require(not dist.is_initialized(), f"{label}: the group outlived the phase")

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "verdict.json")
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "dynosam_tpu_torch.parallel.mp_worker", "--process-id", "0",
                              "--num-processes", "1", "--port", str(free_port()), "--out", out, "--device", "cuda"],
                             cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=300)
        _require(run.returncode == 0, f"{label}: mp_worker failed:\n{run.stdout[-3000:]}")
        verdict = json.load(open(out))
    print(f"{label}: mp_worker, one process on the card ({time.perf_counter() - t0:.1f} s with start-up): "
          f"{json.dumps(verdict)}", flush=True)
    _require(verdict["ok"] and verdict["backend"] == "nccl" and verdict["device"].startswith("cuda"),
             f"{label}: mp_worker verdict {verdict}")
    return dict(totals=kernels.launch_counts())


def run_tools_phase(torch, scene, frames, device, card, pipeline_packets, golden_packets) -> dict:
    """`deterministic_replay` at atol 0 of one KITTI-width `frontend_step`
    (frame 1 from frame 0's state), of one window solve and of the golden
    full-batch LM-PCG on the card; `nan_debug` on the window solve with a
    NaN injected into one static measurement must raise and name the
    operator."""
    from dynosam_tpu_torch import kernels
    from dynosam_tpu_torch.backend import formulation as fm
    from dynosam_tpu_torch.backend.backend import prepare_window
    from dynosam_tpu_torch.backend.map import MeasurementMap, update_map
    from dynosam_tpu_torch.backend.schur import lm_optimize_schur
    from dynosam_tpu_torch.backend.solver import LMConfig
    from dynosam_tpu_torch.frontend.frontend import FrontendState, frontend_step
    from dynosam_tpu_torch.testing.scenes import kitti_config, kitti_pipeline_config
    from dynosam_tpu_torch.utils.debug import deterministic_replay, nan_debug

    label = "tools"
    cfg = kitti_config()
    cap = cfg.capacity
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    state0 = FrontendState.create(cap.max_static_tracks, cap.max_dynamic_tracks, cap.max_objects, device=device)

    def gen():
        return torch.Generator(device=device).manual_seed(0)

    state1 = frontend_step(state0, frames[0], frames[0], scene.cam, cfg.frontend, generator=gen(), first_frame=True,
                           device=device)[0]
    t0 = time.perf_counter()
    out = deterministic_replay(lambda: frontend_step(state1, frames[0], frames[1], scene.cam, cfg.frontend,
                                                     generator=gen(), device=device)[:2])
    print(f"{label}: deterministic_replay (atol 0) of frontend_step on frame 1 at {frames[1].gray.shape[1]}x"
          f"{frames[1].gray.shape[0]}: {len(out)} leaves "
          f"bit-identical ({time.perf_counter() - t0:.2f} s) on {card}", flush=True)

    pcfg = kitti_pipeline_config(PIPELINE_FRAMES)
    m = MeasurementMap.create(10, pcfg.capacity.max_static_tracks, pcfg.capacity.max_dynamic_tracks,
                              pcfg.capacity.max_objects, device=device)
    for k, p in enumerate(pipeline_packets[:10]):
        update_map(m, p, k)
    prob = prepare_window(m, 0, 10, pcfg.backend, m.X_init[0], torch.zeros((), dtype=torch.bool, device=device))
    lm = LMConfig(max_iterations=pcfg.backend.lm_max_iterations)

    def solve(w):
        masks = fm.build_masks(w, pcfg.backend)
        return lm_optimize_schur(fm.init_values(w, masks, pcfg.backend), w, masks, pcfg.backend, lm, w.X_init[0])

    t0 = time.perf_counter()
    out = deterministic_replay(lambda: solve(prob.w)[:2])
    print(f"{label}: deterministic_replay (atol 0) of the pipeline's first window solve: {len(out)} leaves "
          f"bit-identical ({time.perf_counter() - t0:.2f} s) on {card}", flush=True)

    from dynosam_tpu_torch.pipeline import run_from_packets
    from dynosam_tpu_torch.testing.scenes import golden_config

    t0 = time.perf_counter()
    out = deterministic_replay(lambda: run_from_packets(golden_packets, golden_config(True),
                                                        device=device).last_result[:2])
    print(f"{label}: deterministic_replay (atol 0) of the golden full-batch LM-PCG: {len(out)} leaves "
          f"bit-identical ({time.perf_counter() - t0:.2f} s) on {card}", flush=True)

    bad = prob.w.static_xyz.clone()
    bad[3, 0, 0] = float("nan")
    caught = None
    try:
        with nan_debug():
            solve(prob.w._replace(static_xyz=bad))
    except FloatingPointError as e:
        caught = str(e)
    print(f"{label}: nan_debug on the window solve with a NaN in one static measurement: {caught}", flush=True)
    _require(caught is not None and "aten." in caught, f"{label}: nan_debug did not name the operator ({caught})")
    torch.cuda.synchronize()
    return dict(totals=kernels.launch_counts())


# ------------------------------------------------------ slice 11: evaluation
class SpinLaunches:
    """Records the kernel launches of every `DynoPipeline.spin_once` inside
    the block (read from the wrappers' counters, no synchronisation)."""

    def __enter__(self):
        from dynosam_tpu_torch import kernels
        from dynosam_tpu_torch.pipeline import DynoPipeline

        self.per_spin, self._cls, self._spin = [], DynoPipeline, DynoPipeline.spin_once
        spin, per_spin = self._spin, self.per_spin

        def spin_once(pipe, images):
            before = kernels.launch_counts()
            out = spin(pipe, images)
            now = kernels.launch_counts()
            per_spin.append({k: now[k] - before[k] for k in now})
            return out

        DynoPipeline.spin_once = spin_once
        return self

    def __exit__(self, *exc):
        self._cls.spin_once = self._spin
        return False


def run_evaluation_phase(torch, device, card) -> dict:
    """The evaluation tools on the card: the experiment sweep's rows against
    the JAX package's committed sweep, the sliding-vs-batch study, then
    `run_experiments` and `kitti_semantic_to_motion` on a small layout."""
    import contextlib
    import io
    import os
    import tempfile

    from dynosam_tpu_torch import kernels
    from dynosam_tpu_torch.data.kitti import KittiDataset
    from dynosam_tpu_torch.scripts import experiment_sweep, kitti_semantic_to_motion, run_experiments, sliding_vs_batch

    label = "evaluation"
    jax_rows = json.loads((ROOT / "artifacts" / "experiments" / "results.json").read_text())["rows"]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        root = experiment_sweep.write_layout(os.path.join(work, "sweep", "0000"), SWEEP_FRAMES, SWEEP_OBJECTS, device)
        print(f"{label}: sweep layout, {SWEEP_FRAMES} frames 256x192 rendered on the card and written in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        rows = {}
        with SpinLaunches() as launches:
            for name, overrides in experiment_sweep.SWEEP:
                first = len(launches.per_spin)
                rows[name] = row = experiment_sweep.sweep_row(root, overrides, SWEEP_FRAMES,
                                                              os.path.join(work, name), device)
                spins = launches.per_spin[first:]
                _require(len(spins) == SWEEP_FRAMES, f"{label}, {name}: {len(spins)} frontend spins")
                for k in range(1, SWEEP_FRAMES):
                    missing = [n for n in PATH_KERNELS["evaluation"] if spins[k][n] < 1]
                    _require(not missing, f"{label}, {name}, frame {k}: kernels {missing} never launched")
                ref = jax_rows[name]
                print(f"{label}: sweep row {name}: {json.dumps(experiment_sweep.rounded(row))} (JAX on the CPU: "
                      f"fe_ate_trans {ref['fe_ate_trans']}, be_ate_trans {ref['be_ate_trans']}); wall "
                      f"{row['wall_s']:.2f} s on {card}", flush=True)
                for key in ("fe_ate_trans", "be_ate_trans"):
                    _require(np.isfinite(row[key]) and abs(row[key] - ref[key]) <= SWEEP_TOL_M,
                             f"{label}, {name}: {key} {row[key]} against JAX's {ref[key]} (band {SWEEP_TOL_M} m)")
        print(f"{label}: sweep wall seconds {[round(r['wall_s'], 2) for r in rows.values()]} "
              f"(sum {sum(r['wall_s'] for r in rows.values()):.1f} s) on {card}", flush=True)

        t0 = time.perf_counter()
        packets, X_gt, cap = sliding_vs_batch.simulator_stream(SVB_FRAMES)
        runs = sliding_vs_batch.compare(packets, cap, X_gt, device=device)
        print(f"{label}: sliding vs batch on the simulator's {SVB_FRAMES} frames "
              f"({time.perf_counter() - t0:.1f} s) on {card}:", flush=True)
        for line in sliding_vs_batch.summary_lines(runs):
            print(f"{label}:   {line}", flush=True)
        for name, r in runs.items():
            c = r["curve"]
            print(f"{label}:   {name} per-frame camera translation error (m): "
                  f"{[round(float(x), 5) for x in c]}", flush=True)
            _require(np.isfinite(c).all() and np.isfinite(r["error"]) and r["error"] < r["initial_error"],
                     f"{label}: {name}: curve {c}, error {r['initial_error']} -> {r['error']}")

        small = experiment_sweep.write_layout(os.path.join(work, "small", "0000"), EVAL_LAYOUT_FRAMES,
                                              SWEEP_OBJECTS, device)
        sets = {**experiment_sweep.BASE, "capacity.max_frames": EVAL_LAYOUT_FRAMES}
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):     # it prints the whole evaluation
            rc = run_experiments.main(["--dataset_path", small, "--output_path", os.path.join(work, "runs"),
                                       "--name", "small", "--device", str(device)]
                                      + [a for k, v in sets.items() for a in ("--set", f"{k}={v}")])
        results = os.path.join(work, "runs", "small", "results.json")
        _require(rc == 0 and os.path.exists(results), f"{label}: run_experiments gave {rc}, no {results}")
        cam = json.loads(Path(results).read_text())["rgbd_motion_world_backend"]["camera"]
        print(f"{label}: run_experiments on {EVAL_LAYOUT_FRAMES} frames: results.json written, backend camera "
              f"ATE {cam['ate_trans_rmse']:.5f} m ({time.perf_counter() - t0:.1f} s)", flush=True)

        os.rename(os.path.join(small, "motion"), os.path.join(small, "semantic"))
        out_dir = kitti_semantic_to_motion.write_motion_masks(small, 0.05, device)
        semantic = KittiDataset(small, prefer_motion_mask=False)
        back = KittiDataset(small)
        _require(back.mask_dir == out_dir, f"{label}: the loader reads masks from {back.mask_dir}")
        kept = set()
        for k in range(EVAL_LAYOUT_FRAMES):
            path = os.path.join(out_dir, f"{k:06d}.png")
            _require(os.path.exists(path), f"{label}: motion mask {path} missing")
            moving = kitti_semantic_to_motion.moving_labels(semantic.ground_truth(k), 0.05)
            mask = semantic.frame(k).mask.numpy()
            want = np.where(np.isin(mask, moving), mask, 0)
            got = back.frame(k).mask.numpy()
            _require(np.array_equal(got, want), f"{label}: motion mask {k} read back differs from the one written")
            kept |= set(np.unique(got[got > 0]).tolist())
        print(f"{label}: kitti_semantic_to_motion: {EVAL_LAYOUT_FRAMES} motion masks written and read back equal, "
              f"labels kept {sorted(kept)}", flush=True)
    totals = kernels.launch_counts()
    stray = [n for n, c in totals.items() if n not in PATH_KERNELS["evaluation"] + WINDOW_KERNELS and c > 0]
    _require(not stray, f"{label}: kernels {stray} launched off their path")
    return dict(totals=totals, rows=rows)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "dynosam_tpu_torch" / "csrc").is_dir():
        print("FAIL: run chip_smoke.py from the root of a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        return _run(torch)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1


def _run(torch) -> int:
    from dynosam_tpu_torch.kernels import build
    from dynosam_tpu_torch.testing.scenes import kitti_config, kitti_orb_config, kitti_scene

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(card, flush=True)     # as nvidia-smi gives it, on a line of its own
    print(f"card: {card} | torch.cuda.get_device_name: {name} | "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    lib_path = build.build(verbose=True)
    build.load()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    scene, frames = kitti_scene(device)
    torch.cuda.synchronize()
    print(f"render: 12 frames 1280x384 in {time.perf_counter() - t0:.1f} s", flush=True)

    rows = [
        check_lk(torch, frames, device, reps=200),
        check_point_sample(torch, frames, device, reps=500),
        check_response(torch, frames, device, reps=500),
        check_orb_sample(torch, frames, device, reps=200),
    ]
    t0 = time.perf_counter()
    calls = record_solver_calls(torch, device)
    print(f"solver kernels: {len(calls['K5'])} K5 and {len(calls['K6'])} K6 calls recorded from eager steps of the "
          f"main path's frames and the golden scene in {time.perf_counter() - t0:.1f} s", flush=True)
    rows += [check_refine_rounds(torch, calls["K5"], card, reps=50), check_ransac(torch, calls["K6"], card, reps=200)]
    del calls
    check_solver_graphs(torch, device, card)
    for r in rows:
        lib_us = "none" if r["library_ms"] is None else "%.1f us" % (r["library_ms"] * 1e3)
        print(f"{r['name']}: {r['ms'] * 1e3:.1f} us per call (plain {r['plain_ms'] * 1e3:.1f} us, "
              f"library {lib_us}, bound {r['bound_ms'] * 1e3:.2f} us by {r['bound_by']}; "
              f"{r.get('note', '')}) on {card}", flush=True)

    paths = {}
    for path, label, cfg in (("shi_tomasi", "main path", kitti_config()), ("orb", "ORB path", kitti_orb_config())):
        paths[path] = res = run_main_path(torch, scene, frames, cfg, device)
        report_path(res, label, PATH_KERNELS[path], frames, card)

    paths["pipeline"] = run_pipeline_path(torch, device, card)
    paths["golden"] = run_golden_phase(torch, device, card)
    paths["online"] = run_online_phase(torch, device, card)
    t0 = time.perf_counter()
    rows += check_window_kernels(torch, device, card, paths["online"]["window_calls"])
    print(f"window kernels checked in {time.perf_counter() - t0:.1f} s", flush=True)
    check_steady_spin_reads(torch, device, card)
    paths["world_pose"] = run_online_phase(torch, device, card, world_pose=True)
    paths["batched"] = run_batched_phase(torch, device, card)
    paths.update(run_ego_phase(torch, scene, frames, device, card))
    paths["masks"] = run_masks_phase(torch, device, card)
    paths["rectify"] = run_rectify_phase(torch, scene, scene.frames(), device, card, rows[1])
    paths["stereo"] = run_stereo_phase(torch, device, card)
    paths["streaming"] = run_streaming_phase(torch, device, card)
    t0 = time.perf_counter()
    paths["multi_sequence"] = run_multi_sequence_phase(torch, device, card, paths["shi_tomasi"]["per_frame"])
    paths["distributed"] = run_distributed_phase(torch, device, card, paths["pipeline"]["packets"],
                                                 paths["golden"]["packets"])
    paths["tools"] = run_tools_phase(torch, scene, frames, device, card, paths["pipeline"]["packets"],
                                     paths["golden"]["packets"])
    print(f"slice 9 phases: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    paths["evaluation"] = run_evaluation_phase(torch, device, card)
    print(f"slice 11 phase: {time.perf_counter() - t0:.1f} s", flush=True)

    for r in rows:
        by_path = {p: paths[p]["totals"][COUNTER[r["name"]]] for p in paths}
        r["launches"] = sum(by_path.values())
        r["launches_by_path"] = by_path
        r["launches_per_steady_frame"] = paths["shi_tomasi"]["per_frame"][-1][COUNTER[r["name"]]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "launches_by_path", "ms_flow", "ms_depth_mask",
            "ms_rectify", "plain_ms_rectify", "library_ms_rectify", "bound_ms_rectify", "bound_by_rectify",
            "device_ms", "ms_motion_only", "device_ms_motion_only", "plain_ms_motion_only", "bound_ms_motion_only",
            "bound_by_motion_only", "ms_objects", "device_ms_objects", "plain_ms_objects", "bound_ms_objects",
            "bound_by_objects", "device_ms_score", "device_ms_polish", "device_ms_score_objects",
            "device_ms_polish_objects", "launches_per_steady_frame")
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r} for r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
