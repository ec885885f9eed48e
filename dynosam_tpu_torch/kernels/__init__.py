"""Hand-written Hopper kernels of the port, each behind a wrapper with a
launch counter and a plain PyTorch version beside it.

| Id | Wrapper                         | Replaces (TPU Pallas kernel)                          |
|----|---------------------------------|-------------------------------------------------------|
| K1 | `lk.lk_level`                   | `dynosam_tpu/ops/pallas/lk.py:lk_level`                |
| K2 | `point_sample.point_sample`     | `dynosam_tpu/ops/pallas/point_sample.py:point_sample`  |
| K3 | `response.shi_tomasi_response`  | `dynosam_tpu/ops/pallas/response.py:shi_tomasi_response_pallas` |

K4 (`ops/pallas/orb_sample.py`, ORB mode only) is not ported yet.
"""

from __future__ import annotations

from . import lk, point_sample, response

_MODULES = {"lk": lk, "point_sample": point_sample, "response": response}


def reset_launch_counts() -> None:
    for m in _MODULES.values():
        m.launches = 0


def launch_counts() -> dict:
    return {name: m.launches for name, m in _MODULES.items()}
