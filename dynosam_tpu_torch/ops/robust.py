"""Robust IRLS weights (port of `dynosam_tpu/ops/robust.py`): gtsam's
m-estimators on the whitened residual norm, applied as square-root weights
onto whitened residuals."""

from __future__ import annotations

import torch


def huber_weight(r_norm: torch.Tensor, k: float) -> torch.Tensor:
    """gtsam Huber: w = 1 if |r| <= k else k / |r| (weight on squared error)."""
    safe = torch.clamp(r_norm, min=1e-30)
    return torch.where(r_norm <= k, torch.ones_like(r_norm), k / safe)


def tukey_weight(r_norm: torch.Tensor, c: float) -> torch.Tensor:
    """gtsam Tukey: w = (1 - (|r| / c)^2)^2 inside c, 0 outside."""
    w = torch.square(1.0 - torch.square(r_norm / c))
    return torch.where(r_norm <= c, w, torch.zeros_like(w))


def cauchy_weight(r_norm: torch.Tensor, k: float) -> torch.Tensor:
    """gtsam Cauchy: w = 1 / (1 + (|r| / k)^2)."""
    return 1.0 / (1.0 + torch.square(r_norm / k))


def whiten(residual: torch.Tensor, sigma) -> torch.Tensor:
    """Isotropic whitening: r / sigma (the last axis is the residual's)."""
    return residual / sigma


_WEIGHTS = {"huber": huber_weight, "tukey": tukey_weight, "cauchy": cauchy_weight}


def robust_sqrt_weights(residual_whitened: torch.Tensor, k: float, kind: str = "huber"):
    """(..., D) whitened residual -> (...,) sqrt IRLS weights."""
    norm = torch.linalg.vector_norm(residual_whitened, dim=-1)
    if kind == "none":
        return torch.ones_like(norm)
    if kind not in _WEIGHTS:
        raise ValueError(f"unknown robust kind {kind}")
    return torch.sqrt(_WEIGHTS[kind](norm, k))
