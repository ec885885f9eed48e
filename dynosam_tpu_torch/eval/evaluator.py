"""Dataset evaluation: CSV logs -> metric tables (a copy of
`dynosam_tpu/eval/evaluator.py`; numpy, no plots).

Analog of `DatasetEvaluator` / `MotionErrorEvaluator` / `CameraPoseEvaluator`
(`dynosam_utils/dynosam_utils/evaluation/evaluation_lib.py:171-1086`): scan
an output folder for per-module `*_camera_pose_log.csv` /
`*_object_motion_log.csv` / `*_object_pose_log.csv` files, compute
ATE/RPE (camera) and AME/RME/RPE (objects) against the GT columns, and emit
a results dict (and JSON file) in the same spirit as the reference's
`results.json` + PDF tables.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict

import numpy as np

from ..utils.logger import read_pose_log
from . import metrics


def _read_object_log(path: str):
    """-> dict object_id -> (frame_ids, est (N,4,4), gt (N,4,4)|None)."""
    from scipy.spatial.transform import Rotation

    # rows are ragged: objects without GT in a frame log 9 columns, with GT
    # 16 — pad the short ones with NaN so both coexist in one file
    with open(path) as f:
        lines = [ln.strip() for ln in f.readlines()[1:] if ln.strip()]
    if not lines:
        return {}
    parsed = []
    for ln in lines:
        v = [float(x) for x in ln.split(",")]
        parsed.append(v + [np.nan] * (16 - len(v)))
    rows = np.asarray(parsed, np.float64)
    out = {}
    for obj in np.unique(rows[:, 1]).astype(int):
        sel = rows[rows[:, 1] == obj]
        frames = sel[:, 0].astype(int)

        def to_T(block):
            T = np.tile(np.eye(4), (block.shape[0], 1, 1))
            T[:, :3, 3] = block[:, :3]
            T[:, :3, :3] = Rotation.from_quat(block[:, 3:7]).as_matrix()
            return T

        has_gt = np.isfinite(sel[:, 9:16]).all(axis=1)
        if has_gt.any():
            # keep only GT-paired rows so est/gt stay aligned
            sel, frames = sel[has_gt], frames[has_gt]
            est = to_T(sel[:, 2:9])
            gt = to_T(sel[:, 9:16])
        else:
            est, gt = to_T(sel[:, 2:9]), None
        out[int(obj)] = (frames, est, gt)
    return out


def evaluate_module(output_dir: str, prefix: str) -> Dict:
    """Evaluate one module prefix (e.g. 'frontend',
    'rgbd_motion_world_backend')."""
    results: Dict = {"module": prefix}

    cam_log = os.path.join(output_dir, f"{prefix}_camera_pose_log.csv")
    if os.path.exists(cam_log):
        frames, est, gt = read_pose_log(cam_log)
        if gt is not None:
            a = metrics.ate(est, gt)
            r = metrics.rpe(est, gt)
            results["camera"] = {
                "ate_trans_rmse": a["trans"].rmse,
                "ate_rot_deg_rmse": a["rot"].rmse,
                "rpe_trans_rmse": r["trans"].rmse,
                "rpe_rot_deg_rmse": r["rot"].rmse,
                "n_frames": int(est.shape[0]),
            }

    mot_log = os.path.join(output_dir, f"{prefix}_object_motion_log.csv")
    pose_log = os.path.join(output_dir, f"{prefix}_object_pose_log.csv")
    if os.path.exists(mot_log):
        motions = _read_object_log(mot_log)
        poses = _read_object_log(pose_log) if os.path.exists(pose_log) else {}
        per_obj = {}
        for obj, (frames, H_est, H_gt) in motions.items():
            if H_gt is None:
                continue
            entry = {}
            a = metrics.ame(H_est, H_gt)
            entry["ame_trans_rmse"] = a["trans"].rmse
            entry["ame_rot_deg_rmse"] = a["rot"].rmse
            if obj in poses:
                pf, L_est, L_gt = poses[obj]
                if L_gt is not None:
                    # align motion rows with the pose at the previous frame
                    frame_to_L = {f: L_gt[i] for i, f in enumerate(pf)}
                    sel = [
                        i
                        for i, f in enumerate(frames)
                        if (f - 1) in frame_to_L
                    ]
                    if sel:
                        Lprev = np.stack([frame_to_L[frames[i] - 1] for i in sel])
                        r = metrics.rme(H_est[sel], H_gt[sel], Lprev)
                        entry["rme_trans_rmse"] = r["trans"].rmse
                        entry["rme_rot_deg_rmse"] = r["rot"].rmse
                    rp = metrics.rpe(L_est, L_gt)
                    entry["rpe_trans_rmse"] = rp["trans"].rmse
                    entry["rpe_rot_deg_rmse"] = rp["rot"].rmse
            entry["n_frames"] = int(H_est.shape[0])
            per_obj[obj] = entry
        if per_obj:
            results["objects"] = per_obj
            # mean over objects (the reference's summary tables)
            keys = set().union(*(set(v) for v in per_obj.values())) - {"n_frames"}
            results["objects_mean"] = {
                k: float(
                    np.mean([v[k] for v in per_obj.values() if k in v])
                )
                for k in keys
            }
    return results


def evaluate_all(output_dir: str, save_json: bool = True) -> Dict:
    """Discover module prefixes from the logs and evaluate each
    (`_search_for_datafiles`, `evaluation_lib.py:1047`)."""
    prefixes = set()
    for p in glob.glob(os.path.join(output_dir, "*_camera_pose_log.csv")):
        prefixes.add(os.path.basename(p)[: -len("_camera_pose_log.csv")])
    for p in glob.glob(os.path.join(output_dir, "*_object_motion_log.csv")):
        prefixes.add(os.path.basename(p)[: -len("_object_motion_log.csv")])
    results = {pfx: evaluate_module(output_dir, pfx) for pfx in sorted(prefixes)}
    if save_json:
        with open(os.path.join(output_dir, "results.json"), "w") as f:
            json.dump(results, f, indent=2, default=float)
    return results
