"""The evaluation tools of the port (the counterparts of the JAX
package's `scripts/`), each run as a module:

    python -m dynosam_tpu_torch.scripts.run_experiments --dataset_path DIR --output_path OUT [--set k=v ...]
    python -m dynosam_tpu_torch.scripts.experiment_sweep [--frames 16] [--out artifacts/experiments_torch]
    python -m dynosam_tpu_torch.scripts.sliding_vs_batch [--frames 24] [--packets FILE] [--out FILE.pdf]
    python -m dynosam_tpu_torch.scripts.ab_accuracy [dotted.key=value ...] [n_frames=16] [flow_noise=0.5]
    python -m dynosam_tpu_torch.scripts.run_cli_demo [--frames 16] [--out artifacts/cli_demo_torch]
    python -m dynosam_tpu_torch.scripts.kitti_semantic_to_motion --dataset_path DIR [--min_motion_m 0.05]

(the batched-frontend trace is `python3 -m dynosam_tpu_torch.testing.trace
--sequences N`).  Each runs on the CUDA card unless given `--device cpu`
and raises without a card.  Each keeps its computation in a function
that returns rows or curves, apart from the code that writes files and
plots.  PNGs are written by `testing/render.py:_write_png` (16-bit
capable) and plots import matplotlib where they draw, so the tools run
where neither cv2 nor matplotlib is installed.
"""
