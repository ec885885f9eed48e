"""Where the port's pipeline spends a frame.

    python3 -m dynosam_tpu_torch.testing.trace [--detector {shi_tomasi,orb}] [--frames 12] [--warmup 4]
                                               [--out chiprun_out] [--chrome]
    python3 -m dynosam_tpu_torch.testing.trace --pipeline [--frames 22] [--warmup 10]
    python3 -m dynosam_tpu_torch.testing.trace --full-batch
    python3 -m dynosam_tpu_torch.testing.trace --sequences N [--frames 12] [--warmup 4]

Needs one NVIDIA card.  Renders the KITTI-width scene (`testing/scenes.py`).

Frontend-only (default): runs the pipeline with the chosen detector
(`kitti_config`, or `kitti_orb_config` for ORB) over the warm-up frames,
then traces the remaining frames with `torch.profiler` (CPU and CUDA
activities) and prints, per traced frame: host wall time and device busy
time (kernels, copies and fills on the card) of the traced run, the
device's idle share in that run, CUDA kernel launches, memcpy and
synchronise calls (the host syncs), the device time of the port's own
kernels, then the operators that take the most device and host time.

`--pipeline`: the offline pipeline with the sliding-window backend
(`throughput.make_offline_runner` on `kitti_pipeline_config`; the frame
count must be 4 + a multiple of 6).  After the warm-up frames, each traced
frame's frontend step and, on the frames that complete a window, its
window solve are profiled apart: the same figures for the frontend frames
and for each window solve (with its CUDA graph launches, and each
synchronising call counted by the operators it was issued under), then
the operators of the window solves.

`--full-batch`: the golden run (`testing/scenes.py:golden_dataset`,
`golden_config`: 32 frames 160x120) through `DynoPipeline` with the
full-batch backend; the frontend spins run unprofiled, then the one
LM-PCG solve (`DynoPipeline.finish`) is profiled: the same figures for
the solve, its LM and CG iterations, launches per CG iteration, and its
operators.

`--sequences N`: the frontend-only trace above (Shi-Tomasi), then N
KITTI-width sequences (scenes rendered from seeds 0..N-1) stepped in
lockstep by `parallel/batch_eval.MultiSequencePipeline`: after the
warm-up frames, the remaining lockstep frames are traced as one run, and
the same figures are printed per lockstep frame beside the
single-sequence ones (host wall, device busy, idle share, launches, and
K1-K3's launches and device time), with the ratio of each to N times the
single sequence's.

Every number comes from a profiled run; the profiler's own host cost is in
its wall time.  With `--chrome` the Chrome trace of the last profiled
region goes to `<out>/trace_*_torch*.json`.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

PORT_KERNELS = ("lk_level_kernel", "point_sample_kernel", "shi_tomasi_kernel", "orb_sample_kernel")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def _stats(torch, prof, wall_ms: float, n: int) -> dict:
    """Per-unit (frame or window) figures of one profiled run over n units."""
    events = prof.key_averages()
    # device activity: the kernels, copies and fills on the card's timeline
    # (operator rows of `key_averages` repeat their kernels' time)
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.time_range.elapsed_us() for e in dev)
    n_kernels = sum(1 for e in dev if "memcpy" not in e.name.lower() and "memset" not in e.name.lower())
    n_sync = sum(e.count for e in events if e.key in ("cudaMemcpyAsync", "cudaStreamSynchronize")
                 or "DtoH" in e.key)
    busy = device_us / 1e3 / n if device_us > 0 else None
    port = {}
    for tag in PORT_KERNELS:
        mine = [e for e in dev if tag in e.name]
        us = sum(e.time_range.elapsed_us() for e in mine)
        port[tag] = dict(launches=len(mine) / n, device_us_per_launch=us / max(len(mine), 1),
                         device_us=us / n)
    n_graphs = sum(e.count for e in events if e.key == "cudaGraphLaunch")
    return dict(wall_ms=wall_ms / n, device_busy_ms=busy,
                idle_share=None if busy is None else 1 - busy / (wall_ms / n),
                kernel_launches=n_kernels / n, memcpy_or_sync_calls=n_sync / n, graph_launches=n_graphs / n,
                port_kernels=port)


def _host_reads(prof) -> dict:
    """The synchronising runtime calls of a profiled run (`SYNC_CALLS`),
    counted by the chain of operators open when each was issued
    (outermost first)."""
    reads = {}
    for e in prof.events():
        if e.name in SYNC_CALLS:
            chain, p = [], e.cpu_parent
            while p is not None:
                chain.append(p.name)
                p = p.cpu_parent
            key = f"{e.name} under {' > '.join(reversed(chain)) or 'no operator'}"
            reads[key] = reads.get(key, 0) + 1
    return reads


def _line(label: str, s: dict) -> str:
    busy = ("not measured (the profiler reported no device time)" if s["device_busy_ms"] is None
            else f"{s['device_busy_ms']:.3f} ms, idle share {s['idle_share']:.3f}")
    return (f"{label}: host wall {s['wall_ms']:.2f} ms; device busy {busy}; "
            f"CUDA kernel launches {s['kernel_launches']:.0f}; memcpy/sync calls {s['memcpy_or_sync_calls']:.0f}; "
            f"CUDA graph launches {s['graph_launches']:.0f}")


def _profiled(torch, profile, activities, fn):
    """(profiler, host wall ms) of fn() run to the end on the card."""
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return prof, wall


def _trace_frontend(torch, profile, acts, args, device, card) -> dict:
    from ..pipeline import DynoPipeline
    from .scenes import kitti_config, kitti_orb_config, kitti_scene

    scene, frames = kitti_scene(device, n_frames=args.frames)
    cfg = kitti_orb_config() if args.detector == "orb" else kitti_config()
    pipe = DynoPipeline(scene.cam, cfg, device=device)
    for f in frames[:args.warmup]:
        pipe.spin_once(f)
    torch.cuda.synchronize()
    traced = frames[args.warmup:]
    prof, wall = _profiled(torch, profile, acts, lambda: [pipe.spin_once(f) for f in traced])
    n = len(traced)
    s = _stats(torch, prof, wall, n)
    print(f"card: {card}")
    print(f"{args.detector} detector: traced {n} steady frames after {args.warmup} warm-up frames, 1280x384")
    print(_line("under the profiler, per frame", s))
    for tag, k in s["port_kernels"].items():
        print(f"{tag}: {k['launches']:.1f} launches/frame, {k['device_us_per_launch']:.2f} us device time "
              f"per launch, {k['device_us']:.2f} us/frame")
    _tables(torch, prof)
    if args.chrome:
        _chrome(prof, args.out, f"trace_frontend_torch_{args.detector}.json")
    return {"card": card, "detector": args.detector, "frames": n, "wall_ms_per_frame": s["wall_ms"],
            "device_busy_ms_per_frame": s["device_busy_ms"], "idle_share": s["idle_share"],
            "kernel_launches_per_frame": s["kernel_launches"],
            "memcpy_or_sync_calls_per_frame": s["memcpy_or_sync_calls"], "port_kernels": s["port_kernels"]}


def _trace_pipeline(torch, profile, acts, args, device, card) -> dict:
    from ..throughput import make_offline_runner
    from .scenes import kitti_pipeline_config, kitti_scene

    scene, frames = kitti_scene(device, n_frames=args.frames)
    runner = make_offline_runner(scene.cam, kitti_pipeline_config(args.frames), args.frames, device=device)
    for f in frames[:args.warmup]:
        runner.step(f)
    torch.cuda.synchronize()
    fe, windows = [], []
    prof = None
    for f in frames[args.warmup:]:
        prof, wall = _profiled(torch, profile, acts, lambda: runner.frontend(f))
        fe.append(_stats(torch, prof, wall, 1))
        start = runner.window_due()
        if start is not None:
            holder = []
            prof, wall = _profiled(torch, profile, acts, lambda: holder.append(runner.solve(start)))
            s = _stats(torch, prof, wall, 1)
            r = holder[0].result
            s.update(start=start, iterations=r.iterations, initial_error=float(r.initial_error),
                     error=float(r.error), frame=len(runner.packets) - 1, host_reads=_host_reads(prof))
            windows.append(s)
            print("window solve operators (top by device time, then host time):")
            _tables(torch, prof, rows=15)
    n = len(fe)
    mean = lambda key, rows: sum(r[key] for r in rows) / len(rows) if rows and all(  # noqa: E731
        r[key] is not None for r in rows) else None
    fe_mean = {k: mean(k, fe) for k in ("wall_ms", "device_busy_ms", "kernel_launches", "memcpy_or_sync_calls",
                                        "graph_launches")}
    fe_mean["idle_share"] = (None if fe_mean["device_busy_ms"] is None
                             else 1 - fe_mean["device_busy_ms"] / fe_mean["wall_ms"])
    print(f"card: {card}")
    print(f"pipeline (frontend + window-10 backend): {args.frames} frames 1280x384, traced frames "
          f"{args.warmup}..{args.frames - 1} after {args.warmup} warm-up frames")
    print(_line(f"frontend step, mean of {n} frames", fe_mean))
    solve_frames = {w["frame"] for w in windows}
    for w in windows:
        print(_line(f"window solve [{w['start']}, {w['start'] + 10}) at frame {w['frame']}, "
                    f"{w['iterations']} LM iterations, error {w['initial_error']:.4g} -> {w['error']:.4g}", w))
        for call, count in sorted(w["host_reads"].items()):
            print(f"  host reads: {count} x {call}")
        f_row = fe[w["frame"] - args.warmup]
        print(f"  frame {w['frame']} with its window solve: host wall {f_row['wall_ms'] + w['wall_ms']:.2f} ms, "
              f"against {fe_mean['wall_ms']:.2f} ms for a frontend-only frame")
    if args.chrome and prof is not None:
        _chrome(prof, args.out, "trace_pipeline_torch_last.json")
    return {"card": card, "mode": "pipeline", "frames": args.frames, "traced_frames": n,
            "frontend_per_frame": fe_mean, "windows": windows,
            "frames_with_a_solve": sorted(solve_frames)}


def _trace_sequences(torch, profile, acts, args, device, card) -> dict:
    from ..parallel.batch_eval import MultiSequencePipeline
    from .scenes import RenderedDataset, kitti_config, kitti_scene

    n = args.sequences
    cfg = kitti_config()
    cap = cfg.capacity
    datasets = [RenderedDataset(*kitti_scene(device, n_frames=args.frames, seed=s)) for s in range(n)]
    pipe = MultiSequencePipeline(datasets, cfg.frontend, caps=(cap.max_static_tracks, cap.max_dynamic_tracks,
                                                               cap.max_objects), device=device)
    prof, step, frame, t0 = profile(activities=acts), pipe.step, [0], [0.0]

    def traced_step(*a):
        """The lockstep step; the profiler runs from the first traced frame
        through the last."""
        if frame[0] == args.warmup:
            torch.cuda.synchronize()
            prof.start()
            t0[0] = time.perf_counter()
        out = step(*a)
        frame[0] += 1
        if frame[0] == args.frames:
            torch.cuda.synchronize()
            t0[0] = (time.perf_counter() - t0[0]) * 1e3
            prof.stop()
        return out

    pipe.step = traced_step
    pipe.run(args.frames)
    traced = args.frames - args.warmup
    s = _stats(torch, prof, t0[0], traced)
    print(f"{n} sequences in lockstep (MultiSequencePipeline): traced {traced} lockstep frames after "
          f"{args.warmup} warm-up frames, 1280x384 each")
    print(_line("under the profiler, per lockstep frame", s))
    for tag, k in s["port_kernels"].items():
        print(f"{tag}: {k['launches']:.1f} launches/lockstep frame, {k['device_us_per_launch']:.2f} us device time "
              f"per launch, {k['device_us']:.2f} us/lockstep frame")
    _tables(torch, prof, rows=15)
    if args.chrome:
        _chrome(prof, args.out, f"trace_sequences_{n}_torch.json")
    return {"card": card, "mode": "sequences", "sequences": n, "frames": traced, "wall_ms_per_frame": s["wall_ms"],
            "device_busy_ms_per_frame": s["device_busy_ms"], "idle_share": s["idle_share"],
            "kernel_launches_per_frame": s["kernel_launches"],
            "memcpy_or_sync_calls_per_frame": s["memcpy_or_sync_calls"], "port_kernels": s["port_kernels"]}


def _against_single(single: dict, multi: dict) -> None:
    """Each lockstep figure over N times the single sequence's."""
    n = multi["sequences"]
    for key in ("wall_ms_per_frame", "device_busy_ms_per_frame", "kernel_launches_per_frame",
                "memcpy_or_sync_calls_per_frame"):
        a, b = multi[key], single[key]
        ratio = "not measured" if a is None or b is None or b == 0 else f"{a / (n * b):.3f}"
        print(f"lockstep / ({n} x single) {key}: {ratio}")


def _trace_full_batch(torch, profile, acts, args, device, card) -> dict:
    from ..pipeline import DynoPipeline
    from .scenes import golden_config, golden_dataset

    ds = golden_dataset(device)
    pipe = DynoPipeline(ds.camera_params(), golden_config(True), device=device)
    for f in ds.frames():
        pipe.spin_once(f)
    torch.cuda.synchronize()
    prof, wall = _profiled(torch, profile, acts, pipe.finish)
    s = _stats(torch, prof, wall, 1)
    r = pipe.backend.last_result
    n_cg = sum(r.cg_iterations)
    print(f"card: {card}")
    print(_line(f"full-batch LM-PCG over {len(ds)} frames, {r.iterations} LM iterations, {n_cg} CG iterations, "
                f"error {float(r.initial_error):.4g} -> {float(r.error):.4g}", s))
    print(f"per CG iteration: {s['kernel_launches'] / n_cg:.1f} launches, {s['wall_ms'] / n_cg:.3f} ms host wall, "
          f"{(s['device_busy_ms'] or 0) / n_cg:.4f} ms device busy")
    _tables(torch, prof, rows=15)
    if args.chrome:
        _chrome(prof, args.out, "trace_full_batch_torch.json")
    return {"card": card, "mode": "full_batch", "lm_iterations": r.iterations, "cg_iterations": r.cg_iterations,
            "solve": s}


def _tables(torch, prof, rows: int = 20) -> None:
    events = prof.key_averages()
    dev_attr = ("self_device_time_total" if hasattr(events[0], "self_device_time_total")
                else "self_cuda_time_total")
    print("top operators by device time:")
    print(events.table(sort_by=dev_attr, row_limit=rows, max_name_column_width=60))
    print("top operators by host time:")
    print(events.table(sort_by="self_cpu_time_total", row_limit=rows, max_name_column_width=60))


def _chrome(prof, out_dir: str, name: str) -> None:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / name))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--detector", choices=("shi_tomasi", "orb"), default="shi_tomasi")
    ap.add_argument("--pipeline", action="store_true",
                    help="trace the offline pipeline with the sliding-window backend")
    ap.add_argument("--full-batch", action="store_true",
                    help="trace the golden run's full-batch LM-PCG solve")
    ap.add_argument("--sequences", type=int, default=None,
                    help="also trace N sequences in lockstep (MultiSequencePipeline)")
    ap.add_argument("--frames", type=int, default=None, help="default 12, or 22 with --pipeline")
    ap.add_argument("--warmup", type=int, default=None, help="default 4, or 10 with --pipeline")
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--chrome", action="store_true", help="also write the Chrome trace")
    args = ap.parse_args()
    if args.frames is None:
        args.frames = 22 if args.pipeline else 12
    if args.warmup is None:
        args.warmup = 10 if args.pipeline else 4

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    device = torch.device("cuda", 0)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if args.sequences:
        args.detector = "shi_tomasi"
        single = _trace_frontend(torch, profile, acts, args, device, card)
        multi = _trace_sequences(torch, profile, acts, args, device, card)
        _against_single(single, multi)
        print(json.dumps({"single": single, "sequences": multi}))
        return 0
    trace = _trace_full_batch if args.full_batch else _trace_pipeline if args.pipeline else _trace_frontend
    print(json.dumps(trace(torch, profile, acts, args, device, card)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
