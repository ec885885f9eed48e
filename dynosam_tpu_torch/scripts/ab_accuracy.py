"""End-to-end accuracy A/B on the rendered sequence (port of the JAX
package's `scripts/ab_accuracy.py`).

Renders a KITTI-like synthetic sequence (1280x384, fx 718, one moving
object, N(0, flow_noise) px flow noise from numpy seed 0), runs the
frontend-only pipeline under config overrides given as `dotted.key=value`
arguments, and prints the ego ATE / object AME metrics.  Used for
solver-knob A/Bs (KLT warm start, refinement LM caps, ...) where the
question is "does the cheaper setting lose accuracy?".

    python -m dynosam_tpu_torch.scripts.ab_accuracy \\
        frontend.refinement_max_lm_iterations=5 [n_frames=16] [flow_noise=0.5] [--device cpu]

Runs on the CUDA card unless given `--device cpu`.
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np


def parse_assignments(items) -> tuple:
    """`key=value` arguments -> (config overrides (values as strings, the
    config coerces them), n_frames, flow_noise)."""
    overrides, n_frames, flow_noise = {}, 16, 0.5
    for a in items:
        k, v = a.split("=", 1)
        if k == "n_frames":
            n_frames = int(v)
        elif k == "flow_noise":
            flow_noise = float(v)
        else:
            overrides[k] = v
    return overrides, n_frames, flow_noise


def rendered_dataset(n_frames: int = 16, flow_noise: float = 0.5, device=None):
    """The A/B's sequence as a dataset with ground truth: the scene
    rendered on `device`, N(0, flow_noise) px added to each frame's flow."""
    import torch

    from ..testing.render import RenderConfig, RenderedScene
    from ..testing.scenes import RenderedDataset

    scene = RenderedScene(RenderConfig(n_frames=n_frames, h=384, w=1280, fx=718.0, bg_depth=14.0, obj_depth=9.0,
                                       cam_step=0.10, obj_step=0.18), device=device)
    rng = np.random.default_rng(0)
    frames = [f._replace(flow=f.flow + torch.as_tensor(rng.normal(0, flow_noise, tuple(f.flow.shape))
                                                       .astype(np.float32), device=f.flow.device))
              for f in scene.frames()]
    return RenderedDataset(scene, frames)


def ab_accuracy(overrides: dict, n_frames: int = 16, flow_noise: float = 0.5, device=None) -> dict:
    """The frontend's evaluation (`evaluate_all(...)["frontend"]`) of the
    frontend-only pipeline under `overrides` on `rendered_dataset`."""
    from ..eval.evaluator import evaluate_all
    from ..pipeline import run_and_log
    from ..utils.config import load_config
    from ..utils.device import resolve_device

    device = resolve_device(device)
    # frontend-only: the knobs A/B'd here are frontend knobs, and backend
    # solves triple the run time
    cfg = load_config(overrides={**overrides, "pipeline.use_backend": "false"})
    ds = rendered_dataset(n_frames, flow_noise, device)
    with tempfile.TemporaryDirectory() as td:
        run_and_log(ds, cfg, td, device=device)
        return evaluate_all(td)["frontend"]


def summary_line(overrides: dict, fe: dict) -> str:
    cam = fe["camera"]
    line = (f"overrides={overrides} -> ATE trans {cam['ate_trans_rmse']:.4f} m, "
            f"rot {cam.get('ate_rot_deg_rmse', float('nan')):.3f} deg, "
            f"RPE trans {cam.get('rpe_trans_rmse', float('nan')):.4f} m")
    if "objects_mean" in fe:
        line += f", AME trans {fe['objects_mean']['ame_trans_rmse']:.4f} m"
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dynosam_tpu_torch.scripts.ab_accuracy")
    ap.add_argument("assignments", nargs="*", help="dotted.key=value overrides, n_frames=N, flow_noise=S")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; raises without a card)")
    args = ap.parse_args(argv)
    overrides, n_frames, flow_noise = parse_assignments(args.assignments)
    print(summary_line(overrides, ab_accuracy(overrides, n_frames, flow_noise, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
