"""LM building blocks shared by the solvers (port of the parts of
`dynosam_tpu/backend/solver.py` the frontend refiners use; the
matrix-free LM-PCG engine waits for the backend slices).

Values are dicts of tensors and `SE3` leaves; SE3 leaves retract on the
manifold with 6-dof tangents, plain tensors add."""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..core.lie import SE3, se3_retract


class RobustSpec(NamedTuple):
    """Robust kernel of one residual family."""

    kind: str = "none"   # none | huber
    k: float = 1.0


def robust_loss(r: torch.Tensor, spec: RobustSpec) -> torch.Tensor:
    """rho(|r|) per factor block (...,): the quantity gtsam sums as error."""
    sq = torch.sum(r * r, dim=-1)
    if spec.kind == "none":
        return 0.5 * sq
    if spec.kind == "huber":
        k = spec.k
        norm = torch.sqrt(torch.clamp(sq, min=1e-30))
        return torch.where(norm <= k, 0.5 * sq, k * norm - 0.5 * k * k)
    raise NotImplementedError(
        f"robust kind {spec.kind!r} waits for the backend slice (ROADMAP.md item 12)"
    )


def total_error(residuals: Sequence[torch.Tensor], specs: Sequence[RobustSpec], batch_dims: int = 0):
    """Sum of robust losses over all families; the first `batch_dims` axes
    of every residual are kept (independent problems)."""
    total = None
    for r, s in zip(residuals, specs):
        loss = robust_loss(r, s)
        e = loss.reshape(*loss.shape[:batch_dims], -1).sum(-1)
        total = e if total is None else total + e
    return total


class LMConfig(NamedTuple):
    max_iterations: int = 30
    initial_lambda: float = 1e-5
    lambda_factor: float = 10.0
    max_lambda: float = 1e7
    min_lambda: float = 1e-10
    rel_error_tol: float = 1e-5
    abs_error_tol: float = 1e-5
    cg_max_iterations: int = 200
    cg_tol: float = 1e-6
    diag_floor: float = 1e-6


class LMResult(NamedTuple):
    values: dict
    error: torch.Tensor
    initial_error: torch.Tensor
    iterations: torch.Tensor
    lam: torch.Tensor
    converged: torch.Tensor


def zero_delta(values: dict) -> dict:
    """Tangent dict of zeros mirroring `values` (SE3 -> (..., 6))."""
    out = {}
    for k, v in values.items():
        if isinstance(v, SE3):
            out[k] = torch.zeros((*v.batch_shape, 6), dtype=v.dtype, device=v.t.device)
        else:
            out[k] = torch.zeros_like(v)
    return out


def retract_tree(values: dict, delta: dict) -> dict:
    """Apply a tangent dict: SE3 leaves retract, tensors add."""
    return {
        k: se3_retract(v, delta[k]) if isinstance(v, SE3) else v + delta[k]
        for k, v in values.items()
    }
