"""CLI entry point: `python -m dynosam_tpu_torch --dataset_path ...` (port of
`dynosam_tpu/__main__.py`, with `--device`).

Loads a dataset, runs the full pipeline on the CUDA card (or the device
`--device` names), writes the CSV logs, evaluates them and prints a
summary.
"""

import argparse
import json
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="dynosam_tpu_torch")
    ap.add_argument("--dataset_path", required=True)
    ap.add_argument("--data_provider_type", type=int, default=0,
                    help="KITTI=0, VKITTI=1, CLUSTER=2, OMD=3, ARIA=4")
    ap.add_argument("--output_path", default=None)
    ap.add_argument("--starting_frame", type=int, default=-1)
    ap.add_argument("--ending_frame", type=int, default=-1)
    ap.add_argument("--params_yaml", default=None)
    ap.add_argument("--no_backend", action="store_true")
    ap.add_argument("--use_flow_tracking", action="store_true")
    ap.add_argument("--show_dyno_args", action="store_true",
                    help="print the resolved config and exit")
    ap.add_argument("--set", action="append", default=[],
                    help="config override group.key=value")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; raises without a card)")
    args = ap.parse_args(argv)

    from dynosam_tpu_torch.utils.config import load_config

    overrides = {}
    for s in args.set:
        k, v = s.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        if v in ("true", "false"):
            v = v == "true"
        overrides[k] = v
    if args.no_backend:
        overrides["pipeline.use_backend"] = False
    cfg = load_config(args.params_yaml, overrides)

    if args.show_dyno_args:
        import dataclasses
        print(json.dumps(dataclasses.asdict(cfg), indent=2, default=str))
        return 0

    from dynosam_tpu_torch.data.factory import create_dataset
    from dynosam_tpu_torch.pipeline import DynoPipeline, run_and_log
    from dynosam_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    ds = create_dataset(args.data_provider_type, args.dataset_path,
                        starting_frame=args.starting_frame, ending_frame=args.ending_frame)
    if args.output_path:
        result = run_and_log(ds, cfg, args.output_path, use_klt=not args.use_flow_tracking, device=device)
        from dynosam_tpu_torch.eval.evaluator import evaluate_all

        results = evaluate_all(args.output_path)
        print(json.dumps(results, indent=2, default=float))
    else:
        pipe = DynoPipeline(ds.camera_params(), cfg, use_klt=not args.use_flow_tracking, device=device)
        result = pipe.run(ds.prefetched_frames())
    print(f"done: {len(result.packets)} frames at {result.fps:.2f} frames/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
