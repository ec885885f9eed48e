"""Frontend nonlinear refinement stages (port of `dynosam_tpu/frontend/refine.py`).

* Joint optical-flow + pose (the reference's OpticalFlowAndPoseOptimizer):
  per-track flow variables + one pose, Huber(0.001), sigmas flow 10.0 and
  prior 3.33.
* Motion-only 3D refinement (MotionOnlyRefinementOptimizer): per-track
  landmark pairs + one motion H, projection sigma 2.0, ternary sigma
  0.001, Huber(1e-4).

Both run the optimise -> chi^2 outlier removal -> re-optimise cycle (up to
`outlier_rounds` extra rounds, ending early once no new outlier appears;
the pose restarts from its initial value each round while flows /
landmarks carry over).  Both are batched over a leading B of independent
problems with per-problem loop semantics (the JAX package `vmap`s them).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..backend.small_schur import lm_optimize_eliminated
from ..backend.solver import LMConfig, RobustSpec
from ..core.camera import (
    CameraParams,
    backproject,
    project_jacobian_point,
    project_jacobian_pose,
)
from ..core.lie import SE3, se3_apply, se3_inverse, se3_where, so3_hat
from ..ops import factors


class FlowPoseResult(NamedTuple):
    pose: SE3               # (B,) refined ^wX_k
    flow: torch.Tensor      # (B, N, 2) refined flow
    inliers: torch.Tensor   # (B, N) bool
    error: torch.Tensor     # (B,)


def _outlier_rounds(solve, start, valid, outlier_rounds, keys):
    """The JAX `while_loop` over outlier rounds, batched with per-problem
    semantics.  `solve(active, carried)` -> (LMResult, outliers); `carried`
    is a dict of the block values carried between rounds."""
    bsz = valid.shape[0]
    dev = valid.device
    active = valid.clone()
    carried = dict(start)
    res = None
    n_new = torch.zeros((bsz,), dtype=torch.int64, device=dev)
    it = torch.zeros((bsz,), dtype=torch.int64, device=dev)
    while True:
        run = (it == 0) | ((n_new > 0) & (it <= outlier_rounds))
        if not bool(run.any()):
            break
        r, outliers = solve(active, carried)
        if res is None:
            res = r
        else:
            vals = {}
            for k, v in r.values.items():
                old = res.values[k]
                vals[k] = se3_where(run, v, old) if isinstance(v, SE3) else torch.where(
                    run.reshape(-1, *([1] * (v.dim() - 1))), v, old
                )
            res = r._replace(values=vals, error=torch.where(run, r.error, res.error))
        m = run[:, None]
        active = torch.where(m, active & ~outliers, active)
        for k in keys:
            carried[k] = torch.where(m[..., None], r.values[k], carried[k])
        n_new = torch.where(run, outliers.sum(-1), n_new)
        it = torch.where(run, it + 1, it)
    return active, carried, res


def optimize_flow_and_pose(
    cam: CameraParams,
    X_init: SE3,
    X_prev: SE3,
    kp_prev: torch.Tensor,
    depth_prev: torch.Tensor,
    flow_init: torch.Tensor,
    valid: torch.Tensor,
    flow_sigma: float = 10.0,
    flow_prior_sigma: float = 3.33,
    k_huber: float = 0.001,
    max_iterations: int = 10,
    outlier_rounds: int = 4,
) -> FlowPoseResult:
    """Jointly refine flows and poses.  X_init (B,), X_prev () shared,
    kp_prev/flow_init (B, N, 2), depth_prev/valid (B, N)."""
    dt = kp_prev.dtype
    p_world = se3_apply(X_prev, backproject(cam, kp_prev, depth_prev))
    bsz, n = kp_prev.shape[:2]
    I2 = torch.eye(2, dtype=dt, device=kp_prev.device).expand(bsz, n, 2, 2)
    zero = torch.zeros((), dtype=dt, device=kp_prev.device)

    def resid_with(active):
        amask = active[..., None]

        def resid(values):
            flow, X = values["flow"], values["X"]
            r_proj, z = factors.flow_projection_residual(
                flow, X[:, None], kp_prev, depth_prev, X_prev, cam
            )
            r_proj = torch.where(amask & (z > 0.01)[..., None], r_proj / flow_sigma, zero)
            r_prior = torch.where(amask, (flow - flow_init) / flow_prior_sigma, zero)
            return [r_proj, r_prior]

        return resid

    def jac_with(active):
        def jac(values):
            X = values["X"]
            p_cam = se3_apply(se3_inverse(X)[:, None], p_world)
            z = p_cam[..., 2]
            gate = (active & (z > 0.01))[..., None, None]
            z_safe = torch.where(z > 0.01, z, torch.ones_like(z))
            p_safe = torch.cat([p_cam[..., :2], z_safe[..., None]], dim=-1)
            Jpose = project_jacobian_pose(cam, p_safe)          # (B, N, 2, 6)
            B_proj = torch.where(gate, I2 / flow_sigma, zero)
            G_proj = torch.where(gate, -Jpose / flow_sigma, zero)
            B_prior = torch.where(active[..., None, None], I2 / flow_prior_sigma, zero)
            G_prior = torch.zeros((bsz, n, 2, 6), dtype=dt, device=kp_prev.device)
            return [B_proj, B_prior], [G_proj, G_prior]

        return jac

    specs = [RobustSpec("huber", k_huber), RobustSpec()]
    cfg = LMConfig(max_iterations=max_iterations)
    chi2_gate = 9.210340   # chi^2(2, 0.99) on the whitened flow-projection error

    def solve(active, carried):
        resid = resid_with(active)
        res = lm_optimize_eliminated(
            resid, specs, {"flow": carried["flow"], "X": X_init}, cfg,
            block_keys=("flow",), glob_key="X", jacobian_fn=jac_with(active),
        )
        r_final = resid(res.values)[0]
        outliers = active & (torch.sum(r_final * r_final, dim=-1) > chi2_gate)
        return res, outliers

    active, carried, res = _outlier_rounds(
        solve, {"flow": flow_init}, valid, outlier_rounds, ("flow",)
    )
    return FlowPoseResult(
        pose=res.values["X"], flow=carried["flow"], inliers=active, error=res.error
    )


class MotionRefineResult(NamedTuple):
    motion: SE3             # (B,) refined ^w H_k
    inliers: torch.Tensor   # (B, N)
    error: torch.Tensor     # (B,)


def optimize_motion_only(
    cam: CameraParams,
    H_init: SE3,
    X_prev: SE3,
    X_cur: SE3,
    m_prev_world: torch.Tensor,
    uv_prev: torch.Tensor,
    uv_cur: torch.Tensor,
    valid: torch.Tensor,
    landmark_motion_sigma: float = 0.001,
    projection_sigma: float = 2.0,
    k_huber: float = 0.0001,
    max_iterations: int = 10,
    outlier_rounds: int = 4,
) -> MotionRefineResult:
    """Refine object motions with fixed camera poses.  H_init (B,), X_prev
    and X_cur () shared, m_prev_world (B, N, 3), uv_prev/uv_cur (B, N, 2)."""
    dt, dev = m_prev_world.dtype, m_prev_world.device
    bsz, n = m_prev_world.shape[:2]
    m_cur_init = se3_apply(H_init[:, None], m_prev_world)
    # both reprojection terms as one stacked computation: (2, 1, 1) poses
    Xs = SE3(
        torch.stack([X_prev.R, X_cur.R])[:, None, None],
        torch.stack([X_prev.t, X_cur.t])[:, None, None],
    )
    uvs = torch.stack([uv_prev, uv_cur])
    zero = torch.zeros((), dtype=dt, device=dev)
    I3 = torch.eye(3, dtype=dt, device=dev).expand(bsz, n, 3, 3)
    Z23 = torch.zeros((bsz, n, 2, 3), dtype=dt, device=dev)
    G26 = torch.zeros((bsz, n, 2, 6), dtype=dt, device=dev)

    def resid_with(active):
        amask = active[..., None]

        def resid(values):
            mp, mc, H = values["mp"], values["mc"], values["H"]
            rp, zz = factors.reprojection_residual(Xs, torch.stack([mp, mc]), uvs, cam)
            rp = torch.where(amask[None] & (zz > 0.01)[..., None], rp / projection_sigma, zero)
            r_tern = factors.landmark_motion_ternary_residual(mp, mc, H[:, None])
            r_tern = torch.where(amask, r_tern / landmark_motion_sigma, zero)
            return [rp[0], rp[1], r_tern]

        return resid

    def jac_with(active):
        def jac(values):
            mp, mc, H = values["mp"], values["mc"], values["H"]
            p_cam = se3_apply(se3_inverse(Xs), torch.stack([mp, mc]))
            z = p_cam[..., 2]
            gate = (active[None] & (z > 0.01))[..., None, None]
            z_safe = torch.where(z > 0.01, z, torch.ones_like(z))
            p_safe = torch.cat([p_cam[..., :2], z_safe[..., None]], dim=-1)
            Jp = project_jacobian_point(cam, p_safe)            # (2, B, N, 2, 3)
            JR = torch.sum(Jp[..., :, None, :] * Xs.R[..., None, :, :], dim=-1)
            PB = torch.where(gate, JR / projection_sigma, zero)
            B_prev = torch.cat([PB[0], Z23], dim=-1)
            B_cur = torch.cat([Z23, PB[1]], dim=-1)
            amask = active[..., None, None]
            Rt = H.R.transpose(-1, -2)[:, None].expand(bsz, n, 3, 3)
            B_tern = torch.where(amask, torch.cat([I3, -Rt], dim=-1) / landmark_motion_sigma, zero)
            q = se3_apply(se3_inverse(H)[:, None], mc)
            G_tern = torch.where(amask, torch.cat([-so3_hat(q), I3], dim=-1) / landmark_motion_sigma, zero)
            return [B_prev, B_cur, B_tern], [G26, G26, G_tern]

        return jac

    specs = [RobustSpec("huber", k_huber)] * 3
    cfg = LMConfig(max_iterations=max_iterations)
    chi2_gate = 11.344867   # chi^2(3, 0.99) on the whitened ternary error

    def solve(active, carried):
        resid = resid_with(active)
        res = lm_optimize_eliminated(
            resid, specs, {"mp": carried["mp"], "mc": carried["mc"], "H": H_init}, cfg,
            block_keys=("mp", "mc"), glob_key="H", jacobian_fn=jac_with(active),
        )
        r_final = resid(res.values)[2]
        outliers = active & (torch.sum(r_final * r_final, dim=-1) > chi2_gate)
        return res, outliers

    active, _, res = _outlier_rounds(
        solve, {"mp": m_prev_world, "mc": m_cur_init}, valid, outlier_rounds, ("mp", "mc")
    )
    return MotionRefineResult(motion=res.values["H"], inliers=active, error=res.error)
