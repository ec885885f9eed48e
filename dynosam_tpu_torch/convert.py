"""State and config hand-over between the JAX package and the port.

The system has no weights: what carries across frames is the SLAM state
(slot pools, landmarks, object table, poses) and the config.  These
functions take plain Python/numpy forms, never JAX objects, so the port
still imports nothing of JAX:

* `config_from_dict` — the result of `dataclasses.asdict` on a JAX config;
* `camera_from_numpy` — intrinsics from any mapping / NamedTuple of scalars;
* `frontend_state_from_numpy` / `tracker_state_from_numpy` — a state whose
  leaves are numpy arrays (e.g. `jax.tree.map(np.asarray, state)`), matched
  by field name; fields the port does not carry (the ORB descriptors
  `s_desc`) are ignored;
* `frontend_output_to_numpy` — any packet / state of the port to numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.camera import CameraParams
from .core.lie import SE3
from .frontend.frontend import FrontendState
from .frontend.tracker import TrackerState
from .utils.config import DynoConfig, _update_dataclass


def config_from_dict(d: dict, cls=DynoConfig):
    """Rebuild a config dataclass (default `DynoConfig`) from a nested dict."""
    return _update_dataclass(cls(), d)


def camera_from_numpy(params) -> CameraParams:
    """Intrinsics from a mapping or NamedTuple with fx, fy, cx, cy, width,
    height (numpy scalars or 0-d arrays)."""
    get = params.get if isinstance(params, dict) else (lambda k: getattr(params, k))
    return CameraParams.create(
        float(np.asarray(get("fx"))), float(np.asarray(get("fy"))),
        float(np.asarray(get("cx"))), float(np.asarray(get("cy"))),
        int(get("width")), int(get("height")),
    )


def _leaf(v, device) -> torch.Tensor:
    return torch.as_tensor(np.array(np.asarray(v))).to(device)


def _se3(v, device) -> SE3:
    return SE3(_leaf(v.R, device), _leaf(v.t, device))


def tracker_state_from_numpy(src, device="cpu") -> TrackerState:
    return TrackerState(*(_leaf(getattr(src, f), device) for f in TrackerState._fields))


def frontend_state_from_numpy(src, device="cpu") -> FrontendState:
    vals = []
    for f in FrontendState._fields:
        v = getattr(src, f)
        if f == "tracker":
            vals.append(tracker_state_from_numpy(v, device))
        elif hasattr(v, "R") and hasattr(v, "t"):
            vals.append(_se3(v, device))
        else:
            vals.append(_leaf(v, device))
    return FrontendState(*vals)


def frontend_output_to_numpy(tree):
    """Every tensor of a (nested) NamedTuple of the port as a numpy array,
    the structure kept."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(frontend_output_to_numpy(x) for x in tree))
    return tree
