"""Variable-projection (Schur-eliminated) WorldMotion formulation (port of
`dynosam_tpu/backend/varpro.py`; experimental and off by default there and
here).

Landmarks are eliminated in closed form given the poses and motions, and
the outer LM optimises only {X_k, H_k^j}:

  * static points: the per-point normal matrix is (sum_k w_k) I, so the
    optimum is the weighted mean of the per-frame world back-projections;
  * dynamic points: per tracklet a block-tridiagonal system along frames
    (scalar-diagonal blocks, rotation couplings), solved for all tracklets
    at once by a block-Thomas elimination over the frames.

The outer problem's J^T W J product and gradient go through the closed
forms by forward- and reverse-mode AD (`torch.func.jvp`/`vjp`, the JAX
package's `jax.linearize`), and its diagonal is Hutchinson's
(`solver.lm_optimize` with `gn_diag_fn=None`).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core.lie import SE3, se3_apply
from ..utils.config import BackendConfig
from .formulation import WindowMasks, select_motions, world_motion_gn_diag, world_motion_residuals
from .map import WindowData
from .solver import retract_tree, zero_delta


def optimal_static_points(X: SE3, w: WindowData, masks: WindowMasks) -> torch.Tensor:
    """sp*_i = weighted mean over frames of X_k(z_{k,i})  (NS, 3)."""
    world = se3_apply(X[:, None], w.static_xyz)                 # (W, NS, 3)
    wgt = masks.static_obs.to(world.dtype)
    num = torch.einsum("kn,knd->nd", wgt, world)
    return num / torch.clamp(wgt.sum(0), min=1e-9)[:, None]


def _chain_blocks(X: SE3, H_all: SE3, w: WindowData, masks: WindowMasks, cfg: BackendConfig):
    """Per-tracklet block-tridiagonal normal system: (A (W, ND, 3, 3),
    B (W, ND, 3, 3), rhs (W, ND, 3)), B[k] coupling (m_{k-1}, m_k).  The
    ternary weight is capped at 1e3 x the observation weight (the JAX
    package's float32 guard: the chain stays effectively rigid while the
    observations keep anchoring it; the outer residuals use the true
    sigmas)."""
    dtype, dev = w.dyn_xyz.dtype, w.dyn_xyz.device
    a = masks.dyn_obs.to(dtype) / cfg.dynamic_point_noise_sigma ** 2
    b_val = min(1.0 / cfg.motion_ternary_factor_noise_sigma ** 2, 1e3 / cfg.dynamic_point_noise_sigma ** 2)
    b = torch.cat([torch.zeros_like(a[:1]), masks.ternary[1:].to(dtype)], dim=0) * b_val   # (W, ND)
    eye = torch.eye(3, dtype=dtype, device=dev)
    rhs = a[..., None] * se3_apply(X[:, None], w.dyn_xyz)       # observation part

    # ternary k: e = m_{k-1} - S_k^T m_k + S_k^T t_k (S = R_H), constant c_k = S_k^T t_k
    S = H_all.R
    St = S.transpose(-1, -2)
    c = torch.einsum("knij,knj->kni", St, H_all.t)
    b_next = torch.cat([b[1:], torch.zeros_like(b[:1])], dim=0)
    A = (a + b + b_next)[..., None, None] * eye + 1e-8 * eye
    rhs = rhs - torch.cat([b[1:, :, None] * c[1:], torch.zeros_like(c[:1])], dim=0)
    rhs = rhs + b[..., None] * torch.einsum("knij,knj->kni", S, c)
    return A, -(b[..., None, None] * St), rhs


def optimal_dynamic_points(X: SE3, H_all: SE3, w: WindowData, masks: WindowMasks,
                           cfg: BackendConfig) -> torch.Tensor:
    """All tracklet chains solved: dp* (W, ND, 3), by forward elimination
    over the frames and back substitution (a batch of ND 3x3 solves per
    step)."""
    A, B, rhs = _chain_blocks(X, H_all, w, masks, cfg)
    W, ND = rhs.shape[:2]
    D = torch.eye(3, dtype=A.dtype, device=A.device).expand(ND, 3, 3) * 1e12
    y = torch.zeros_like(rhs[0])
    Ds, ys = [], []
    for k in range(W):
        Bt = B[k].transpose(-1, -2)
        D_new = A[k] - Bt @ torch.linalg.solve(D, B[k])
        y = rhs[k] - (Bt @ torch.linalg.solve(D, y[..., None]))[..., 0]
        D = D_new
        Ds.append(D)
        ys.append(y)
    m = torch.zeros_like(rhs[0])
    out = [None] * W
    for k in reversed(range(W)):
        r = ys[k] - (B[k + 1] @ m[..., None])[..., 0] if k + 1 < W else ys[k]
        m = torch.linalg.solve(Ds[k], r[..., None])[..., 0]
        out[k] = m
    return torch.stack(out)


def _selected_motions(H: SE3, w: WindowData, masks: WindowMasks) -> SE3:
    return select_motions(H, w.dyn_obj, masks.ternary | masks.dyn_obs)[0]


def world_motion_varpro_residuals(values: dict, w: WindowData, masks: WindowMasks, cfg: BackendConfig,
                                  anchor: Optional[SE3] = None) -> list:
    """The WorldMotion residuals over {X, H} with the landmarks eliminated
    in line."""
    X: SE3 = values["X"]
    H: SE3 = values["H"]
    sp = optimal_static_points(X, w, masks)
    dp = optimal_dynamic_points(X, _selected_motions(H, w, masks), w, masks, cfg)
    return world_motion_residuals({"X": X, "H": H, "sp": sp, "dp": dp}, w, masks, cfg, anchor)


def recover_points(X: SE3, H: SE3, w: WindowData, masks: WindowMasks, cfg: BackendConfig) -> dict:
    """The full value dict {X, H, sp, dp} with the landmarks at their
    closed-form optimum (each tracklet takes its own frame's object
    motion, as the JAX package's write-back does)."""
    idx = w.dyn_obj.clamp(0, H.batch_shape[1] - 1).long()
    H_all = SE3(torch.gather(H.R, 1, idx[..., None, None].expand(-1, -1, 3, 3)),
                torch.gather(H.t, 1, idx[..., None].expand(-1, -1, 3)))
    return {"X": X, "H": H, "sp": optimal_static_points(X, w, masks),
            "dp": optimal_dynamic_points(X, H_all, w, masks, cfg)}


def varpro_gn_diag(values: dict, sqrt_w: list, w: WindowData, masks: WindowMasks, cfg: BackendConfig) -> dict:
    """Jacobi diagonal of the reduced {X, H} problem from the full
    problem's analytic one (it over-damps the reduced problem slightly)."""
    d = world_motion_gn_diag(recover_points(values["X"], values["H"], w, masks, cfg), sqrt_w, w, masks, cfg)
    return {"X": d["X"], "H": d["H"]}


def linearized_normal_product(residual_fn: Callable) -> Callable:
    """`normal_fn` for `solver.lm_optimize` by AD: at `values` with the
    IRLS weights frozen, J^T W J d as `vjp(jvp(d))` and g = J^T W r0 of
    the weighted residuals of `residual_fn` over the retraction."""
    def normal_fn(values: dict, sqrt_w: list, res0: list):
        def f(delta):
            return [s[..., None] * r for s, r in zip(sqrt_w, residual_fn(retract_tree(values, delta)))]

        d0 = zero_delta(values)
        wr0, vjp_fn = torch.func.vjp(f, d0)

        def JtJ_mv(d: dict) -> dict:
            return vjp_fn(torch.func.jvp(f, (d0,), ({k: d[k] for k in d0},))[1])[0]

        return JtJ_mv, vjp_fn(wr0)[0]

    return normal_fn
