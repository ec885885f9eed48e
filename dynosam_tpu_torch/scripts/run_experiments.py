"""Experiment runner (port of the JAX package's `scripts/run_experiments.py`,
the analog of the reference's `eval_launch.py` -> `runner.py`): run the
full pipeline over one dataset with config overrides, write the CSV logs,
evaluate them, and write `results.json` (and `results.pdf` where
matplotlib is installed) per run.

    python -m dynosam_tpu_torch.scripts.run_experiments --dataset_path /data/kitti/0004 \\
        --data_provider_type 0 --output_path /tmp/out --name kitti0004 \\
        --set backend.opt_window_size=20 --set backend.use_full_batch_opt=true [--device cpu]

Any `--set group.key=value` overrides a DynoConfig field (the gflags
passthrough of the reference's runner).  Runs on the CUDA card unless
given `--device cpu`.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from typing import Optional


def parse_value(v: str):
    """An override's value: a bool ("true"/"false", any case), else an
    int, else a float, else the string."""
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


def parse_overrides(sets) -> dict:
    """`group.key=value` strings -> {"group.key": parsed value}."""
    out = {}
    for s in sets:
        k, v = s.split("=", 1)
        out[k] = parse_value(v)
    return out


def run_experiment(dataset_path: str, output_path: str, name: str = "run", data_provider_type: int = 0,
                   starting_frame: int = -1, ending_frame: int = -1, params_yaml: Optional[str] = None,
                   overrides: Optional[dict] = None, use_klt: bool = True, device=None):
    """One run: dataset -> `run_and_log` into `output_path/name` ->
    `evaluate_all` (which writes `results.json` there).  Returns (run
    directory, `PipelineResult`, evaluation results)."""
    from ..data.factory import create_dataset
    from ..eval.evaluator import evaluate_all
    from ..pipeline import run_and_log
    from ..utils.config import load_config
    from ..utils.device import resolve_device

    device = resolve_device(device)
    cfg = load_config(params_yaml, overrides or {})
    ds = create_dataset(data_provider_type, dataset_path, starting_frame=starting_frame,
                        ending_frame=ending_frame, device=device)
    out_dir = os.path.join(output_path, name)
    result = run_and_log(ds, cfg, out_dir, use_klt=use_klt, device=device)
    return out_dir, result, evaluate_all(out_dir)


def write_reports(out_dir: str, results: dict):
    """(`results.pdf` path, or None without matplotlib; `result_tables.tex`
    path) of one run."""
    from ..eval.plotting import make_report, write_result_tables

    pdf = make_report(out_dir, results) if importlib.util.find_spec("matplotlib") else None
    return pdf, write_result_tables(out_dir, results)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dynosam_tpu_torch.scripts.run_experiments")
    ap.add_argument("--dataset_path", required=True)
    ap.add_argument("--data_provider_type", type=int, default=0)
    ap.add_argument("--output_path", required=True)
    ap.add_argument("--name", default="run")
    ap.add_argument("--starting_frame", type=int, default=-1)
    ap.add_argument("--ending_frame", type=int, default=-1)
    ap.add_argument("--params_yaml", default=None)
    ap.add_argument("--no_backend", action="store_true")
    ap.add_argument("--use_flow_tracking", action="store_true",
                    help="use precomputed dense flow instead of KLT")
    ap.add_argument("--set", action="append", default=[],
                    help="config override group.key=value")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; raises without a card)")
    args = ap.parse_args(argv)

    overrides = parse_overrides(args.set)
    if args.no_backend:
        overrides["pipeline.use_backend"] = False
    out_dir, result, results = run_experiment(
        args.dataset_path, args.output_path, args.name, args.data_provider_type, args.starting_frame,
        args.ending_frame, args.params_yaml, overrides, use_klt=not args.use_flow_tracking, device=args.device)
    print(f"pipeline done: {result.fps:.2f} frames/s")
    pdf, tex = write_reports(out_dir, results)
    print(json.dumps(results, indent=2, default=float))
    print(f"report: {pdf or 'not written (no matplotlib)'}")
    print(f"tables: {tex}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
