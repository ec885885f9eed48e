"""Robust IRLS weights (port of `dynosam_tpu/ops/robust.py`, Huber only —
the kernel the frontend refiners use)."""

from __future__ import annotations

import torch


def huber_weight(r_norm: torch.Tensor, k: float) -> torch.Tensor:
    """gtsam Huber: w = 1 if |r| <= k else k / |r| (weight on squared error)."""
    safe = torch.clamp(r_norm, min=1e-30)
    return torch.where(r_norm <= k, torch.ones_like(r_norm), k / safe)


def robust_sqrt_weights(residual_whitened: torch.Tensor, k: float, kind: str = "huber"):
    """(..., D) whitened residual -> (...,) sqrt IRLS weights."""
    norm = torch.linalg.vector_norm(residual_whitened, dim=-1)
    if kind == "huber":
        w = huber_weight(norm, k)
    elif kind == "none":
        w = torch.ones_like(norm)
    else:
        raise NotImplementedError(
            f"robust kind {kind!r} waits for the backend slice (ROADMAP.md item 12)"
        )
    return torch.sqrt(w)
