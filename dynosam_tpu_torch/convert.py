"""State and config hand-over between the JAX package and the port.

The system has no weights: what carries across frames is the SLAM state
(slot pools, landmarks, object table, poses) and the config.  These
functions take plain Python/numpy forms, never JAX objects, so the port
still imports nothing of JAX:

* `config_from_dict` — the result of `dataclasses.asdict` on a JAX config;
* `camera_from_numpy` — intrinsics from any mapping / NamedTuple of scalars;
* `frontend_state_from_numpy` / `tracker_state_from_numpy` — a state whose
  leaves are numpy arrays (e.g. `jax.tree.map(np.asarray, state)`), matched
  by field name, the ORB descriptors `s_desc` included;
* `frontend_output_from_numpy`, `measurement_map_from_numpy`,
  `window_data_from_numpy` and `est_store_from_numpy` — the JAX packet and
  backend state (numpy leaves), matched by field name;
* `frontend_output_to_numpy` / `lm_result_to_numpy` — any packet, state or
  LM result of the port to numpy.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from .backend.backend import EstimateStore
from .backend.map import MeasurementMap, WindowData
from .core.camera import CameraParams
from .core.lie import SE3
from .core.types import DynamicObs, FrontendOutput, ObjectObs, StaticObs
from .frontend.frontend import FrontendState
from .frontend.tracker import TrackerState
from .utils.config import DynoConfig, _update_dataclass
from .utils.device import resolve_device


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


def tracker_state_from_numpy(src, device=None) -> TrackerState:
    """The tracker state on `device`: the CUDA card unless the caller asks
    for another (raises without a card, as the entry points do)."""
    device = resolve_device(device)
    return TrackerState(*(_leaf(getattr(src, f), device) for f in TrackerState._fields))


def frontend_state_from_numpy(src, device=None) -> FrontendState:
    """The frontend state on `device`, resolved as `tracker_state_from_numpy`."""
    device = resolve_device(device)
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


def _tuple_from_numpy(cls, src, device, nested=()):
    """`cls` (a NamedTuple of the port) from `src`, field by field: SE3
    leaves from objects with R and t, the `nested` fields recursively,
    everything else as a tensor."""
    nested = dict(nested)
    vals = []
    for f in cls._fields:
        v = getattr(src, f)
        if f in nested:
            vals.append(_tuple_from_numpy(nested[f], v, device))
        elif hasattr(v, "R") and hasattr(v, "t"):
            vals.append(_se3(v, device))
        else:
            vals.append(_leaf(v, device))
    return cls(*vals)


def frontend_output_from_numpy(src, device=None) -> FrontendOutput:
    """A JAX `FrontendOutput` packet (numpy leaves) as the port's, on
    `device` resolved as `tracker_state_from_numpy`."""
    return _tuple_from_numpy(FrontendOutput, src, resolve_device(device), nested=(
        ("static_obs", StaticObs), ("dynamic_obs", DynamicObs), ("objects", ObjectObs)))


def measurement_map_from_numpy(src, device=None) -> MeasurementMap:
    return _tuple_from_numpy(MeasurementMap, src, resolve_device(device))


def window_data_from_numpy(src, device=None) -> WindowData:
    """A JAX `WindowData`; its traced `start` becomes a Python int."""
    w = _tuple_from_numpy(WindowData, src, resolve_device(device))
    return w._replace(start=int(np.asarray(src.start)))


def est_store_from_numpy(src, device=None, updater: int = 0) -> EstimateStore:
    """A JAX `EstimateStore`, or a JAX `throughput.EstStore` (its P holds
    the object motions H under `updater` 0, the poses L under 1; the
    other field is identity), as the port's store."""
    if not hasattr(src, "H"):
        P = src.P
        ident = SimpleNamespace(R=np.broadcast_to(np.eye(3, dtype=P.R.dtype), P.R.shape), t=np.zeros_like(P.t))
        key = "H" if updater == 0 else "L"
        src = SimpleNamespace(**{f: P if f == key else ident if f in ("H", "L") else getattr(src, f)
                                 for f in EstimateStore._fields})
    return _tuple_from_numpy(EstimateStore, src, resolve_device(device))


def frontend_output_to_numpy(tree):
    """Every tensor of a (nested) NamedTuple or dict of the port as a numpy
    array, the structure kept."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(frontend_output_to_numpy(x) for x in tree))
    if isinstance(tree, dict):
        return {k: frontend_output_to_numpy(v) for k, v in tree.items()}
    return tree


def lm_result_to_numpy(result):
    """An `LMResult` of the port (values dict included) with numpy leaves."""
    return frontend_output_to_numpy(result)
