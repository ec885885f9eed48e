"""Multi-process worker: one rank of an N-process distributed window solve
(port of `dynosam_tpu/parallel/mp_worker.py`).

    python -m dynosam_tpu_torch.parallel.mp_worker --process-id I \\
        --num-processes N --port P --out FILE [--window 8] [--updater 0] \\
        [--f32] [--device cuda|cpu]
    torchrun --nproc_per_node N -m dynosam_tpu_torch.parallel.mp_worker \\
        --out 'verdict_{rank}.json'

(without `--port`, the rank and size come from `DYNO_*` or torchrun's
environment; `{rank}` in `--out` becomes the rank.)

Each process:

  1. joins the process group at `localhost:P` (NCCL on `--device cuda`,
     the default; gloo on `--device cpu`);
  2. builds the SAME deterministic scenario, keeps only its own
     `local_frame_range` keyframe block and feeds it through
     `multihost.feed_measurement_map` (host-local data loading);
  3. runs the frame-split SPIKE direct-Schur solve over the global mesh
     (`multihost.global_mesh`);
  4. compares it with the single-process solve computed on its own device
     and writes a JSON verdict.

In float64 (the default) the two agree to 1e-6 (updater 0) and 2e-5
(updater 1, whose SPIKE interface solve carries ~1e-8 relative error at
the motion-pose factor's conditioning); float32 is held to 1e-3 on the
error only.
"""

from __future__ import annotations

import argparse
import json


def run_worker(process_id: int | None, num_processes: int | None, port: int | None, out_path: str | None,
               window: int = 8, updater: int = 0, x64: bool = True, device: str = "cuda") -> dict:
    import torch

    from ..backend import formulation as fm
    from ..backend.map import MeasurementMap, slice_window, update_map
    from ..backend.schur import lm_optimize_schur
    from ..backend.solver import LMConfig
    from ..core.lie import SE3
    from ..testing.simulator import Scenario, ScenarioConfig
    from ..utils.config import BackendConfig
    from . import multihost
    from .schur_dist import distributed_schur_optimize

    dev = multihost.initialize(None if port is None else f"localhost:{port}", num_processes, process_id,
                               device=device)
    dist = torch.distributed
    if not dist.is_initialized():
        raise RuntimeError("no process group: pass --port, or run under torchrun or with DYNO_* set")
    process_id, num_processes = dist.get_rank(), dist.get_world_size()

    sc = Scenario(ScenarioConfig(n_frames=window, n_static=48, n_objects=2, pts_per_object=24,
                                 ns=64, nd=64, no=4))
    m = MeasurementMap.create(window, 64, 64, 4)
    for k, pkt in enumerate(sc.frontend_outputs()):
        m = update_map(m, pkt, k)
    dtype = torch.float64 if x64 else torch.float32

    def put(x):
        if isinstance(x, SE3):
            return SE3(put(x.R), put(x.t))
        return x.to(dev, dtype) if x.is_floating_point() else x.to(dev)

    m = MeasurementMap(*(put(x) for x in m))
    cfg = BackendConfig(backend_updater_enum=updater)
    lm_cfg = LMConfig(max_iterations=4)

    # reference: the single-process direct solve on this rank's device
    w = slice_window(m, 0, window)
    masks = fm.build_masks(w, cfg)
    values = fm.init_values(w, masks, cfg) if updater == 0 else fm.init_values_world_pose(w, masks, cfg)
    ref = lm_optimize_schur(values, w, masks, cfg, lm_cfg, w.X_init[0], formulation=updater)
    ref_err = float(ref.error)

    # distributed: the global mesh, each rank feeding its own frames
    mesh = multihost.global_mesh()
    lo, hi = multihost.local_frame_range(mesh, window)
    m_local = MeasurementMap(*(x[lo:hi] for x in m))
    fed = multihost.feed_measurement_map(m_local, mesh)
    res = distributed_schur_optimize(fed, window, cfg, mesh=mesh, updater=updater, lm_cfg=lm_cfg)
    dist_err = float(res.error)           # replicated, as X is

    max_dx = float((res.values["X"].t - ref.values["X"].t).abs().max())
    derr = abs(dist_err - ref_err) / max(ref_err, 1e-30)
    tol = (1e-6 if updater == 0 else 2e-5) if x64 else 2e-2
    verdict = {
        "process_id": process_id, "num_processes": num_processes, "n_devices": dist.get_world_size(),
        "backend": dist.get_backend(), "device": str(dev), "updater": updater, "x64": x64,
        "ref_error": ref_err, "dist_error": dist_err, "max_abs_dX_t": max_dx, "rel_derr": derr,
        "iterations": [int(res.iterations), int(ref.iterations)],
        "ok": bool(max_dx < tol and derr < tol if x64 else derr < 1e-3),
    }
    if out_path:
        with open(out_path.format(rank=process_id), "w") as f:
            json.dump(verdict, f)
    return verdict


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--updater", type=int, default=0)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args()
    import torch

    try:
        v = run_worker(a.process_id, a.num_processes, a.port, a.out, window=a.window, updater=a.updater,
                       x64=not a.f32, device=a.device)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    print(json.dumps(v), flush=True)


if __name__ == "__main__":
    main()
