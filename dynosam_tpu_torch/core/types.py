"""Slot-pool measurement and packet types (port of `dynosam_tpu/core/types.py`).

Every per-feature quantity lives in a fixed-capacity slot array with a
validity mask; tracklet ids are pool-slot indices and object ids are slots
in [0, O).  Integer ids stay int32, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .lie import SE3, se3_identity

BACKGROUND = 0
INVALID_ID = -1


class StaticObs(NamedTuple):
    uv: torch.Tensor      # (NS, 2)
    xyz: torch.Tensor     # (NS, 3) camera frame
    valid: torch.Tensor   # (NS,) bool

    @staticmethod
    def empty(ns: int, dtype=torch.float32, device=None) -> "StaticObs":
        return StaticObs(
            uv=torch.zeros((ns, 2), dtype=dtype, device=device),
            xyz=torch.zeros((ns, 3), dtype=dtype, device=device),
            valid=torch.zeros((ns,), dtype=torch.bool, device=device),
        )


class DynamicObs(NamedTuple):
    uv: torch.Tensor      # (ND, 2)
    xyz: torch.Tensor     # (ND, 3) camera frame
    obj: torch.Tensor     # (ND,) int32 object slot, INVALID_ID if none
    valid: torch.Tensor   # (ND,) bool

    @staticmethod
    def empty(nd: int, dtype=torch.float32, device=None) -> "DynamicObs":
        return DynamicObs(
            uv=torch.zeros((nd, 2), dtype=dtype, device=device),
            xyz=torch.zeros((nd, 3), dtype=dtype, device=device),
            obj=torch.full((nd,), INVALID_ID, dtype=torch.int32, device=device),
            valid=torch.zeros((nd,), dtype=torch.bool, device=device),
        )


class ObjectObs(NamedTuple):
    motion: SE3                 # (O,) ^w H_k
    motion_valid: torch.Tensor  # (O,) bool
    pose: SE3                   # (O,) ^w L_k
    pose_valid: torch.Tensor    # (O,) bool
    label: torch.Tensor         # (O,) int32 global instance label

    @staticmethod
    def empty(no: int, dtype=torch.float32, device=None) -> "ObjectObs":
        return ObjectObs(
            motion=se3_identity((no,), dtype, device),
            motion_valid=torch.zeros((no,), dtype=torch.bool, device=device),
            pose=se3_identity((no,), dtype, device),
            pose_valid=torch.zeros((no,), dtype=torch.bool, device=device),
            label=torch.full((no,), INVALID_ID, dtype=torch.int32, device=device),
        )


class FrontendOutput(NamedTuple):
    """One frame of frontend output (the reference's RGBDInstanceOutputPacket)."""

    frame_id: torch.Tensor   # () int32
    timestamp: torch.Tensor  # () float
    X_world: SE3             # () ^w X_k
    static_obs: StaticObs
    dynamic_obs: DynamicObs
    objects: ObjectObs

    @staticmethod
    def empty(ns: int, nd: int, no: int, dtype=torch.float32, device=None):
        return FrontendOutput(
            frame_id=torch.tensor(INVALID_ID, dtype=torch.int32, device=device),
            timestamp=torch.tensor(0.0, dtype=dtype, device=device),
            X_world=se3_identity((), dtype, device),
            static_obs=StaticObs.empty(ns, dtype, device),
            dynamic_obs=DynamicObs.empty(nd, dtype, device),
            objects=ObjectObs.empty(no, dtype, device),
        )


def stack_outputs(outputs: list) -> FrontendOutput:
    """Stack per-frame FrontendOutputs along a new axis 0 into (F, ...)
    tensors (the NamedTuple structure, `SE3` leaves included, is kept)."""
    def stack(*xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.stack(xs)
        return type(xs[0])(*(stack(*f) for f in zip(*xs)))

    return stack(*outputs)
