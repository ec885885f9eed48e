"""Where the frontend-only pipeline of the port spends a frame.

    python3 -m dynosam_tpu_torch.testing.trace [--detector {shi_tomasi,orb}] [--frames 12] [--warmup 4]
                                               [--out chiprun_out] [--chrome]

Needs one NVIDIA card.  Renders the KITTI-width scene (`testing/scenes.py`),
runs the frontend-only pipeline with the chosen detector (`kitti_config`,
or `kitti_orb_config` for ORB) over the warm-up frames, then traces the
remaining frames with `torch.profiler` (CPU and CUDA activities) and prints,
per traced frame: host wall time and device busy time (kernels, copies and
fills on the card) of the traced run, the device's idle share in that run,
CUDA kernel launches, memcpy and synchronise calls (the host syncs), the
device time of the port's own kernels, then the operators that take the
most device and host time.  Every number comes from the one profiled run;
the profiler's own host cost is in its wall time.  With `--chrome` the
Chrome trace goes to `<out>/trace_frontend_torch.json`.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--detector", choices=("shi_tomasi", "orb"), default="shi_tomasi")
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--warmup", type=int, default=4)
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--chrome", action="store_true", help="also write the Chrome trace")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..pipeline import DynoPipeline
    from .scenes import kitti_config, kitti_orb_config, kitti_scene

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    device = torch.device("cuda", 0)
    scene, frames = kitti_scene(device, n_frames=args.frames)
    cfg = kitti_orb_config() if args.detector == "orb" else kitti_config()
    pipe = DynoPipeline(scene.cam, cfg, device=device)
    for f in frames[:args.warmup]:
        pipe.spin_once(f)
    torch.cuda.synchronize()

    traced = frames[args.warmup:]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in traced:
            pipe.spin_once(f)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / len(traced)

    events = prof.key_averages()
    dev_attr = "self_device_time_total" if hasattr(events[0], "self_device_time_total") else "self_cuda_time_total"
    # device activity: the kernels, copies and fills on the card's timeline
    # (operator rows of `key_averages` repeat their kernels' time)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.time_range.elapsed_us() for e in kernels)
    n_kernels = sum(1 for e in kernels if "memcpy" not in e.name.lower() and "memset" not in e.name.lower())
    n_dtoh = sum(e.count for e in events if e.key in ("cudaMemcpyAsync", "cudaStreamSynchronize")
                 or "DtoH" in e.key)
    n = len(traced)
    busy_ms = device_us / 1e3 / n
    print(f"card: {card}")
    print(f"{args.detector} detector: traced {n} steady frames after {args.warmup} warm-up frames, 1280x384")
    print(f"under the profiler: host wall {wall_ms:.2f} ms/frame; device busy "
          + (f"{busy_ms:.3f} ms/frame, idle share {1 - busy_ms / wall_ms:.3f}" if device_us > 0
             else "not measured (the profiler reported no device time)"))
    print(f"CUDA kernel launches {n_kernels / n:.0f}/frame; memcpy/sync calls {n_dtoh / n:.0f}/frame")
    port = {}
    for tag in ("lk_level_kernel", "point_sample_kernel", "shi_tomasi_kernel", "orb_sample_kernel"):
        mine = [e for e in kernels if tag in e.name]
        us = sum(e.time_range.elapsed_us() for e in mine)
        port[tag] = dict(launches_per_frame=len(mine) / n, device_us_per_launch=us / max(len(mine), 1),
                         device_us_per_frame=us / n)
        print(f"{tag}: {len(mine) / n:.1f} launches/frame, {us / max(len(mine), 1):.2f} us device time "
              f"per launch, {us / n:.2f} us/frame")
    print("top operators by device time:")
    print(events.table(sort_by=dev_attr, row_limit=20, max_name_column_width=60))
    print("top operators by host time:")
    print(events.table(sort_by="self_cpu_time_total", row_limit=20, max_name_column_width=60))
    if args.chrome:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / f"trace_frontend_torch_{args.detector}.json"))
    print(json.dumps({"card": card, "detector": args.detector, "frames": n, "wall_ms_per_frame": wall_ms,
                      "device_busy_ms_per_frame": busy_ms if device_us > 0 else None,
                      "idle_share": 1 - busy_ms / wall_ms if device_us > 0 else None,
                      "kernel_launches_per_frame": n_kernels / n,
                      "memcpy_or_sync_calls_per_frame": n_dtoh / n, "port_kernels": port}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
