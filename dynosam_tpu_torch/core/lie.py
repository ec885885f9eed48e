"""Batched SO(3)/SE(3) Lie-group operations (port of `dynosam_tpu/core/lie.py`).

Conventions are the reference's (gtsam Pose3): SE(3) tangents are
``xi = [omega (3), v (3)]``, ``retract(a, xi) = a * Exp(xi)``,
``local(a, b) = Log(a^-1 b)``, poses act on points as ``R @ x + t``.

Every function is dtype-preserving and broadcasts over leading batch dims.
Small-angle branches are `torch.where` selections between a Taylor series
and the closed form, with the inputs of BOTH branches sanitised so that
neither produces inf/NaN (an unselected NaN still poisons gradients).
The 3x3 products are broadcast multiply + sum, as in the JAX package, so
the f32 arithmetic matches it operation for operation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Small-angle crossover, as in the JAX package.
_SMALL = 1e-4
# cos(pi - 0.15): switch so3_log to the diagonal extraction near pi.
_COS_NEAR_PI = -0.98877108


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3) as broadcast multiply + reduce."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3) as broadcast multiply + reduce."""
    return torch.sum(A * x[..., None, :], dim=-1)


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


# --------------------------------------------------------------------------
# so(3)
# --------------------------------------------------------------------------


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def so3_vee(W: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) skew -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sq_theta(w: torch.Tensor):
    """(theta^2, small mask, sanitised theta bounded away from 0)."""
    sq = torch.sum(w * w, dim=-1)
    small = sq < _SMALL * _SMALL
    th_safe = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    return sq, small, th_safe


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: (..., 3) axis-angle -> (..., 3, 3) rotation."""
    sq, small, th = _sq_theta(w)
    sq = sq[..., None, None]
    small = small[..., None, None]
    th = th[..., None, None]
    W = so3_hat(w)
    W2 = _mm(W, W)
    sq_safe = torch.where(small, torch.ones_like(sq), sq)
    a = torch.where(small, 1.0 - sq / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - sq / 24.0, (1.0 - torch.cos(th)) / sq_safe)
    return _eye3(w) + a * W + b * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 3) axis-angle; small-angle, generic and
    near-pi regimes, each on sanitised inputs."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_th = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    antisym = so3_vee(R - R.transpose(-1, -2))

    small = cos_th > 1.0 - 1e-6
    near_pi = cos_th < _COS_NEAR_PI
    generic = (~small) & (~near_pi)
    zero = torch.zeros_like(cos_th)

    cos_g = torch.where(generic, cos_th, zero)
    th_g = torch.arccos(cos_g)
    scale_g = th_g / (2.0 * torch.sin(th_g))
    scale_s = 0.5 + (3.0 - trace) / 12.0
    w_gs = torch.where(small, scale_s, scale_g)[..., None] * antisym

    cos_p = torch.where(near_pi, cos_th, zero)
    th_p = torch.arccos(cos_p)
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    w2 = (th_p * th_p / (1.0 - cos_p))[..., None] * (diag - cos_p[..., None])
    w_abs = torch.sqrt(torch.clamp(w2, min=0.0) + 1e-12)
    sign_src = torch.where(
        torch.abs(antisym) > 1e-7, torch.sign(antisym), torch.ones_like(antisym)
    )
    w_pi = w_abs * sign_src
    return torch.where(near_pi[..., None], w_pi, w_gs).to(R.dtype)


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian V of SO(3) (SE(3) exp uses t = V(w) v)."""
    sq, small, th = _sq_theta(w)
    sq = sq[..., None, None]
    small = small[..., None, None]
    th = th[..., None, None]
    W = so3_hat(w)
    W2 = _mm(W, W)
    sq_safe = torch.where(small, torch.ones_like(sq), sq)
    b = torch.where(small, 0.5 - sq / 24.0, (1.0 - torch.cos(th)) / sq_safe)
    c = torch.where(
        small, 1.0 / 6.0 - sq / 120.0, (th - torch.sin(th)) / (sq_safe * th)
    )
    return _eye3(w) + b * W + c * W2


def so3_left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian of SO(3)."""
    sq, small, th = _sq_theta(w)
    sq = sq[..., None, None]
    small = small[..., None, None]
    th = th[..., None, None]
    W = so3_hat(w)
    W2 = _mm(W, W)
    sq_safe = torch.where(small, torch.ones_like(sq), sq)
    half = th * 0.5
    cot_term = torch.where(
        small,
        1.0 / 12.0 + sq / 720.0,
        (1.0 - half * torch.cos(half) / torch.sin(half)) / sq_safe,
    )
    return _eye3(w) - 0.5 * W + cot_term * W2


# --------------------------------------------------------------------------
# SE(3)
# --------------------------------------------------------------------------


class SE3(NamedTuple):
    """Batched rigid transform: rotation ``R (...,3,3)``, translation ``t (...,3)``."""

    R: torch.Tensor
    t: torch.Tensor

    def inverse(self) -> "SE3":
        return se3_inverse(self)

    def compose(self, other: "SE3") -> "SE3":
        return se3_compose(self, other)

    def apply(self, pts: torch.Tensor) -> torch.Tensor:
        return se3_apply(self, pts)

    def retract(self, xi: torch.Tensor) -> "SE3":
        return se3_retract(self, xi)

    def log(self) -> torch.Tensor:
        return se3_log(self)

    @property
    def batch_shape(self):
        return self.t.shape[:-1]

    @property
    def dtype(self):
        return self.t.dtype

    def to(self, *args, **kwargs) -> "SE3":
        return SE3(self.R.to(*args, **kwargs), self.t.to(*args, **kwargs))

    def __getitem__(self, idx) -> "SE3":
        return SE3(self.R[idx], self.t[idx])


def se3_identity(batch_shape=(), dtype=torch.float32, device=None) -> SE3:
    eye = torch.eye(3, dtype=dtype, device=device)
    R = eye.expand(*batch_shape, 3, 3).clone()
    t = torch.zeros((*batch_shape, 3), dtype=dtype, device=device)
    return SE3(R, t)


def se3_exp(xi: torch.Tensor) -> SE3:
    """xi = [omega, v] (..., 6) -> SE3 (gtsam Pose3::Expmap ordering)."""
    w, v = xi[..., :3], xi[..., 3:]
    return SE3(so3_exp(w), _mv(so3_left_jacobian(w), v))


def se3_log(g: SE3) -> torch.Tensor:
    """SE3 -> xi = [omega, v] (..., 6)."""
    w = so3_log(g.R)
    v = _mv(so3_left_jacobian_inv(w), g.t)
    return torch.cat([w, v], dim=-1)


def se3_inverse(g: SE3) -> SE3:
    Rt = g.R.transpose(-1, -2)
    return SE3(Rt, -_mv(Rt, g.t))


def se3_compose(a: SE3, b: SE3) -> SE3:
    return SE3(_mm(a.R, b.R), _mv(a.R, b.t) + a.t)


def se3_between(a: SE3, b: SE3) -> SE3:
    """a^-1 * b."""
    return se3_compose(se3_inverse(a), b)


def se3_local(a: SE3, b: SE3) -> torch.Tensor:
    """Log(a^-1 b)."""
    return se3_log(se3_between(a, b))


def se3_retract(a: SE3, xi: torch.Tensor) -> SE3:
    return se3_compose(a, se3_exp(xi))


def se3_apply(g: SE3, pts: torch.Tensor) -> torch.Tensor:
    """Transform points (..., 3); pose batch dims broadcast against points."""
    return _mv(g.R, pts) + g.t


def se3_where(mask: torch.Tensor, a: SE3, b: SE3) -> SE3:
    """Per-batch selection between two SE3 batches (mask over batch dims)."""
    return SE3(
        torch.where(mask[..., None, None], a.R, b.R),
        torch.where(mask[..., None], a.t, b.t),
    )
