"""Dataset-dir -> CLI -> report demo (port of the JAX package's
`scripts/run_cli_demo.py`, the reference's canonical entry `dynosam_node` +
`eval_launch.py`): render a KITTI-layout dataset to disk, run the port's
CLI (`python -m dynosam_tpu_torch --dataset_path ... --output_path ...`)
on it, and copy the resulting `results.json` to `--out`.

    python -m dynosam_tpu_torch.scripts.run_cli_demo [--frames 16] [--objects 2] \\
        [--keep-dir DIR] [--out artifacts/cli_demo_torch] [--device cpu]

Runs on the CUDA card unless given `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

# the checkout's root, under which the default output directory lies
ROOT = Path(__file__).resolve().parents[2]


def run_demo(work: str, frames: int = 16, objects: int = 2, device="cuda") -> dict:
    """Write the demo's layout under `work/0000`, run the CLI into
    `work/out` and return its `results.json`."""
    from ..__main__ import main as cli_main
    from .experiment_sweep import write_layout

    root = write_layout(os.path.join(work, "0000"), frames, objects, device)
    print(f"dataset written to {root}", file=sys.stderr)
    out = os.path.join(work, "out")
    rc = cli_main([
        "--dataset_path", root,
        "--output_path", out,
        "--set", "capacity.max_static_tracks=512",
        "--set", "capacity.max_dynamic_tracks=512",
        "--set", "capacity.max_objects=8",
        "--set", f"capacity.max_frames={frames}",
        "--set", "frontend.tracker.max_features_per_frame=300",
        "--device", str(device),
    ])
    if rc != 0:
        raise RuntimeError(f"the CLI exited with {rc}")
    with open(os.path.join(out, "results.json")) as f:
        return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dynosam_tpu_torch.scripts.run_cli_demo")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--objects", type=int, default=2)
    ap.add_argument("--keep-dir", default="")
    ap.add_argument("--out", default=str(ROOT / "artifacts" / "cli_demo_torch"))
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; raises without a card)")
    a = ap.parse_args(argv)

    from ..utils.device import resolve_device

    device = resolve_device(a.device)
    work = a.keep_dir or tempfile.mkdtemp(prefix="dyno_cli_demo_")
    try:
        results = run_demo(work, a.frames, a.objects, device)
        os.makedirs(a.out, exist_ok=True)
        shutil.copy(os.path.join(work, "out", "results.json"), a.out)
    finally:
        if not a.keep_dir:
            shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({
        "metric": "cli_e2e_ate_trans_rmse",
        "frontend": results["frontend"]["camera"]["ate_trans_rmse"],
        "backend": results["rgbd_motion_world_backend"]["camera"]["ate_trans_rmse"],
        "artifact": os.path.join(a.out, "results.json"),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
