"""Hand-written Hopper kernels of the port, each behind a wrapper with a
launch counter and a plain PyTorch version beside it.

| Id | Wrapper                         | Replaces (TPU Pallas kernel)                          |
|----|---------------------------------|-------------------------------------------------------|
| K1 | `lk.lk_level`                   | `dynosam_tpu/ops/pallas/lk.py:lk_level`                |
| K2 | `point_sample.point_sample`     | `dynosam_tpu/ops/pallas/point_sample.py:point_sample`  |
| K3 | `response.shi_tomasi_response`  | `dynosam_tpu/ops/pallas/response.py:shi_tomasi_response_pallas` |
| K4 | `orb_sample.orb_orientation_descriptors` | `dynosam_tpu/ops/pallas/orb_sample.py:orb_orientation_descriptors` |

and two kernels with no Pallas counterpart, each the device-side form of a
fused JAX program that the port had run as host loops of small operators:

| Id | Wrapper           | Stands for (JAX)                                                     |
|----|-------------------|----------------------------------------------------------------------|
| K5 | `refine.rounds`   | the refinements' `while_loop`s, `dynosam_tpu/frontend/refine.py:57`, `:186` |
| K6 | `ransac.ransac`   | `dynosam_tpu/ops/ransac.py:165` (`ransac_rigid`), `:314` (`ransac_pose_3d2d`) |
| K7 | `window.build`    | the window LM's normal system, `dynosam_tpu/backend/schur.py:611` inside `:1463` |
| K8 | `window.step`     | its damped Schur reduction, `dynosam_tpu/backend/schur.py:1072` |
| K9 | `window.update`   | its back-substitution, trial and LM decisions, `dynosam_tpu/backend/schur.py:1463` |

K3 runs on the Shi-Tomasi detector path, K4 on the ORB detector path
(`TrackerConfig(feature_detector_type="orb")`); K1 and K2 on both; K5 and
K6 wherever the frontend refines or solves a 3-D motion RANSAC; K7-K9 on
every LM iteration of a WorldMotion direct-Schur window solve
(`backend/schur.py:_WindowLM`).
"""

from __future__ import annotations

from . import lk, orb_sample, point_sample, ransac, refine, response, window

_MODULES = {"lk": lk, "point_sample": point_sample, "response": response, "orb_sample": orb_sample,
            "refine": refine, "ransac": ransac,
            "window_build": window.BUILD, "window_step": window.STEP, "window_update": window.UPDATE}


def reset_launch_counts() -> None:
    for m in _MODULES.values():
        m.launches = 0


def launch_counts() -> dict:
    return {name: m.launches for name, m in _MODULES.items()}


def set_launch_counts(counts: dict) -> None:
    for name, n in counts.items():
        _MODULES[name].launches = n


def add_launch_counts(counts: dict) -> None:
    """Add launches made on the wrappers' behalf (a CUDA graph replay of
    captured launches, `utils/graphs.py`)."""
    for name, n in counts.items():
        _MODULES[name].launches += n
