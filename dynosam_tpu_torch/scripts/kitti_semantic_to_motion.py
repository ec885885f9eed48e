"""Convert KITTI semantic-instance masks to motion masks (port of the JAX
package's `scripts/kitti_semantic_to_motion.py`, the analog of the
reference's `dynosam_utils/misc/KittiSemaniticToMotion.cc`): keep only the
instance labels whose ground-truth object motion moves at least
`--min_motion_m` per frame, writing `motion/%06d.png` (16-bit) beside the
`semantic/` masks.

    python -m dynosam_tpu_torch.scripts.kitti_semantic_to_motion --dataset_path DIR \\
        [--min_motion_m 0.05] [--device cpu]

The label selection runs on the CUDA card unless given `--device cpu`.
PNGs are written with the standard library's zlib
(`testing/render.py:_write_png`), so no image package is needed.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def moving_labels(gt, min_motion_m: float) -> list:
    """The object labels whose ground-truth motion at this frame
    translates at least `min_motion_m` (none without ground truth)."""
    if gt is None:
        return []
    return sorted(obj for obj, H in gt.object_motions.items() if np.linalg.norm(H[:3, 3]) >= min_motion_m)


def motion_masks(dataset_path: str, min_motion_m: float = 0.05, device=None):
    """Yield (frame index, (H, W) uint16 motion mask) of every frame of the
    KITTI layout at `dataset_path`: its semantic mask with every label
    that is not moving set to 0."""
    import torch

    from ..data.kitti import KittiDataset
    from ..utils.device import resolve_device

    device = resolve_device(device)
    ds = KittiDataset(dataset_path, prefer_motion_mask=False)
    for k in range(len(ds)):
        moving = torch.tensor(moving_labels(ds.ground_truth(k), min_motion_m), dtype=torch.int32, device=device)
        mask = ds.frame(k).mask.to(device)
        yield k, torch.where(torch.isin(mask, moving), mask, 0).cpu().numpy().astype(np.uint16)


def write_motion_masks(dataset_path: str, min_motion_m: float = 0.05, device=None) -> str:
    """Write `motion/%06d.png` for every frame; returns the directory."""
    from ..testing.render import _write_png
    from ..utils.device import resolve_device

    device = resolve_device(device)
    out_dir = os.path.join(dataset_path, "motion")
    os.makedirs(out_dir, exist_ok=True)
    for k, m in motion_masks(dataset_path, min_motion_m, device):
        _write_png(os.path.join(out_dir, f"{k:06d}.png"), m)
    return out_dir


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dynosam_tpu_torch.scripts.kitti_semantic_to_motion")
    ap.add_argument("--dataset_path", required=True)
    ap.add_argument("--min_motion_m", type=float, default=0.05,
                    help="minimum per-frame GT translation to count as moving")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; raises without a card)")
    args = ap.parse_args(argv)
    out_dir = write_motion_masks(args.dataset_path, args.min_motion_m, args.device)
    n = len([f for f in os.listdir(out_dir) if f.endswith(".png")])
    print(f"wrote {n} motion masks to {out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
