"""Multi-config experiment sweep (port of the JAX package's
`scripts/experiment_sweep.py`, the analog of the reference's TRO sweep
`dynosam_utils/src/run_experiments_tro.py` / `run_backends.py`): run the
dataset-dir -> pipeline -> evaluation path for a grid of backend
configurations and write one results table.

Renders a KITTI-layout dataset once (`testing/render.write_reference_layout`:
16 frames 192x256, fx 200, 2 yaw-only objects), then sweeps:

  * updater 0 (WorldMotion) vs 1 (WorldPose)
  * sliding window 10/4 vs full-batch
  * motion smoothing on vs off, and window 6/2

Writes `<out>/results.json` and `<out>/results.md`, whose heading names
the device: the card's name and power limit from `nvidia-smi`, or "CPU".

    python -m dynosam_tpu_torch.scripts.experiment_sweep [--frames 16] [--objects 2] \\
        [--out artifacts/experiments_torch] [--device cpu]

Runs on the CUDA card unless given `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# the checkout's root, under which the default output directory lies
ROOT = Path(__file__).resolve().parents[2]

SWEEP = [
    ("wm_sliding", {"backend.backend_updater_enum": 0}),
    ("wp_sliding", {"backend.backend_updater_enum": 1}),
    ("wm_fullbatch", {"backend.backend_updater_enum": 0,
                      "backend.use_full_batch_opt": True}),
    ("wp_fullbatch", {"backend.backend_updater_enum": 1,
                      "backend.use_full_batch_opt": True}),
    ("wm_nosmooth", {"backend.backend_updater_enum": 0,
                     "backend.use_smoothing_factor": False}),
    ("wm_window6", {"backend.backend_updater_enum": 0,
                    "backend.opt_window_size": 6,
                    "backend.opt_window_overlap": 2}),
]

BASE = {
    "capacity.max_static_tracks": 512,
    "capacity.max_dynamic_tracks": 512,
    "capacity.max_objects": 8,
    "frontend.tracker.max_features_per_frame": 300,
}

COLUMNS = ["fe_ate_trans", "be_ate_trans", "be_ate_rot_deg", "be_ame_trans", "be_ame_rot_deg", "wall_s"]
# the JAX script's rounding of each column in its tables
DIGITS = {"fe_ate_trans": 5, "be_ate_trans": 5, "be_ate_rot_deg": 4, "be_ame_trans": 5, "be_ame_rot_deg": 4,
          "wall_s": 1}


def write_layout(root: str, frames: int = 16, objects: int = 2, device=None) -> str:
    """Render the sweep's scene on `device` and write it to `root` in the
    KITTI layout."""
    from ..testing.render import RenderConfig, RenderedScene, write_reference_layout
    from ..utils.device import resolve_device

    sc = RenderedScene(RenderConfig(n_frames=frames, h=192, w=256, fx=200.0, n_objects=objects,
                                    yaw_only_objects=True), device=resolve_device(device))
    return write_reference_layout(sc, root)


def sweep_row(root: str, overrides: dict, frames: int, out: str, device=None) -> dict:
    """One row of the sweep: the layout at `root` through
    `run_experiments.run_experiment` (logs and `results.json` in `out`)
    under BASE, `max_frames` = `frames` and `overrides`.  The row has the
    JAX script's keys, unrounded; `wall_s` is the host time of the run and
    its evaluation (which reads the estimates back, so the card has
    finished)."""
    from .run_experiments import run_experiment

    ov = dict(BASE)
    ov["capacity.max_frames"] = frames
    ov.update(overrides)
    t0 = time.time()
    _, _, res = run_experiment(root, os.path.dirname(out), os.path.basename(out), overrides=ov, device=device)
    row = {"wall_s": time.time() - t0, "config": overrides}
    be_key = [k for k in res if k.endswith("backend")]
    if be_key:
        be = res[be_key[0]]
        row["be_ate_trans"] = be["camera"]["ate_trans_rmse"]
        row["be_ate_rot_deg"] = be["camera"]["ate_rot_deg_rmse"]
        if "objects_mean" in be:
            row["be_ame_trans"] = be["objects_mean"].get("ame_trans_rmse", float("nan"))
            row["be_ame_rot_deg"] = be["objects_mean"].get("ame_rot_deg_rmse", float("nan"))
    fe = res.get("frontend", {})
    if "camera" in fe:
        row["fe_ate_trans"] = fe["camera"]["ate_trans_rmse"]
    return row


def run_sweep(root: str, frames: int, device=None, log=None) -> dict:
    """{name: row} over SWEEP on the layout at `root`; each row's logs go
    to a temporary directory.  `log(name, row)` is called after each row."""
    rows = {}
    with tempfile.TemporaryDirectory(prefix="dyno_sweep_") as work:
        for name, overrides in SWEEP:
            rows[name] = sweep_row(root, overrides, frames, os.path.join(work, name), device)
            if log is not None:
                log(name, rows[name])
    return rows


def rounded(row: dict) -> dict:
    """A row with each column rounded as the JAX script rounds it."""
    return {k: round(v, DIGITS[k]) if k in DIGITS else v for k, v in row.items()}


def device_label(device) -> str:
    """The device a sweep ran on: the card's name and power limit as
    `nvidia-smi` gives them, or "CPU"."""
    import torch

    if torch.device(device).type != "cuda":
        return "CPU"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def write_results(rows: dict, out: str, frames: int, objects: int, device: str) -> str:
    """`results.json` and `results.md` of a sweep under `out`; returns the
    table's path."""
    os.makedirs(out, exist_ok=True)
    rows = {name: rounded(row) for name, row in rows.items()}
    with open(os.path.join(out, "results.json"), "w") as f:
        json.dump({"scene": {"frames": frames, "objects": objects, "size": "192x256", "yaw_only": True},
                   "device": device, "rows": rows}, f, indent=2)
    path = os.path.join(out, "results.md")
    with open(path, "w") as f:
        f.write(f"# Backend configuration sweep (rendered {frames}-frame scene), on {device}\n\n")
        f.write("Analog of the reference's TRO sweep (`run_experiments_tro.py`): updater / window / smoothing "
                "grid through the dataset-dir path of the PyTorch port "
                "(`python -m dynosam_tpu_torch.scripts.experiment_sweep`).\n\n")
        f.write("| config | " + " | ".join(COLUMNS) + " |\n")
        f.write("|---" * (len(COLUMNS) + 1) + "|\n")
        for name, row in rows.items():
            f.write(f"| {name} | " + " | ".join(str(row.get(c, "-")) for c in COLUMNS) + " |\n")
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dynosam_tpu_torch.scripts.experiment_sweep")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--objects", type=int, default=2)
    ap.add_argument("--out", default=str(ROOT / "artifacts" / "experiments_torch"))
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; raises without a card)")
    a = ap.parse_args(argv)

    from ..utils.device import resolve_device

    device = resolve_device(a.device)
    label = device_label(device)
    with tempfile.TemporaryDirectory(prefix="dyno_sweep_layout_") as work:
        root = write_layout(os.path.join(work, "0000"), a.frames, a.objects, device)
        rows = run_sweep(root, a.frames, device,
                         log=lambda name, row: print(f"{name}: {rounded(row)}", file=sys.stderr, flush=True))
    path = write_results(rows, a.out, a.frames, a.objects, label)
    print(json.dumps({"metric": "experiment_sweep", "rows": len(rows), "device": label, "artifact": path}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
