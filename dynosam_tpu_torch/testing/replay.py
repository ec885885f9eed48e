"""Replay the golden full-batch LM-PCG on the card and report how far the
runs differ (0 when the solve is deterministic).

    python3 -m dynosam_tpu_torch.testing.replay [--runs 3]

Renders the golden scene (`testing/scenes.py:golden_dataset`), runs its
frontend once, then solves the same packets `--runs` times through
`pipeline.run_from_packets` with the full-batch backend and prints the
largest camera-translation and motion-translation difference of each run
from the first, with the final errors.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from ..pipeline import DynoPipeline, run_from_packets
from .scenes import golden_config, golden_dataset


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    dev = torch.device(a.device)
    ds = golden_dataset(dev)
    cfg = golden_config(True)
    frontend = DynoPipeline(ds.camera_params(), dataclasses.replace(
        cfg, pipeline=dataclasses.replace(cfg.pipeline, use_backend=False)), device=dev)
    packets = [frontend.spin_once(f) for f in ds.frames()]
    runs = []
    for _ in range(a.runs):
        r = run_from_packets(packets, cfg, device=dev).last_result
        runs.append((r.values["X"].t, r.values["H"].t, float(r.error)))
    for i, (X, H, err) in enumerate(runs[1:], start=1):
        print(f"run {i} against run 0: max |dX_t| {float((X - runs[0][0]).abs().max()):.3g} m, "
              f"max |dH_t| {float((H - runs[0][1]).abs().max()):.3g} m, final error {runs[0][2]:.6g} / {err:.6g}",
              flush=True)


if __name__ == "__main__":
    main()
