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

`rounds_start` sets a cycle up and `run_rounds`, the wrapper of kernel K5,
runs it to its end.  On CUDA tensors that is one launch of K5
(`kernels/refine.py`, `csrc/refine.cu`), which runs every problem's rounds
and LM iterations on the device with no host read, over the arguments
`pack` lays out; `unpack` reads its outputs back.  On CPU tensors it is
K5's plain version, `rounds_plain`: device stretches over a dict of
tensors, per round `round_head` (the LM head), `round_iteration` (one LM
iteration) and `round_tail` (outliers and the next round's flag), driven by
the host loop `rounds_schedule`, which reads the flags.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..backend.small_schur import EliminatedProblem, lm_head, lm_iteration, lm_result, lm_schedule
from ..backend.solver import LMConfig, RobustSpec
from ..core.camera import (
    CameraParams,
    backproject,
    project_jacobian_point,
    project_jacobian_pose,
)
from ..core.lie import SE3, se3_apply, se3_inverse, se3_where, so3_hat
from ..kernels import refine as refine_kernel
from ..ops import factors


class FlowPoseResult(NamedTuple):
    pose: SE3               # (B,) refined ^wX_k
    flow: torch.Tensor      # (B, N, 2) refined flow
    inliers: torch.Tensor   # (B, N) bool
    error: torch.Tensor     # (B,)


class MotionRefineResult(NamedTuple):
    motion: SE3             # (B,) refined ^w H_k
    inliers: torch.Tensor   # (B, N)
    error: torch.Tensor     # (B,)


class FlowPose(NamedTuple):
    """The settings of a joint flow + pose refinement; its tensors are the
    dict `flow_pose_inputs` makes."""

    cam: CameraParams
    flow_sigma: float = 10.0
    flow_prior_sigma: float = 3.33
    k_huber: float = 0.001
    max_iterations: int = 10
    outlier_rounds: int = 4

    keys = ("flow",)
    glob = "X"
    chi2_gate = 9.210340   # chi^2(2, 0.99) on the whitened flow-projection error
    gated = 0              # the residual family the gate reads

    def problem(self, P: dict, active: torch.Tensor) -> EliminatedProblem:
        cam, flow_sigma, flow_prior_sigma = self.cam, self.flow_sigma, self.flow_prior_sigma
        kp_prev, depth_prev, X_prev, flow_init, p_world = (
            P["kp_prev"], P["depth_prev"], P["X_prev"], P["flow_init"], P["p_world"])
        dt = kp_prev.dtype
        bsz, n = kp_prev.shape[:2]
        I2 = torch.eye(2, dtype=dt, device=kp_prev.device).expand(bsz, n, 2, 2)
        zero = torch.zeros((), dtype=dt, device=kp_prev.device)
        amask = active[..., None]

        def resid(values):
            flow, X = values["flow"], values["X"]
            r_proj, z = factors.flow_projection_residual(
                flow, X[:, None], kp_prev, depth_prev, X_prev, cam
            )
            r_proj = torch.where(amask & (z > 0.01)[..., None], r_proj / flow_sigma, zero)
            r_prior = torch.where(amask, (flow - flow_init) / flow_prior_sigma, zero)
            return [r_proj, r_prior]

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

        return EliminatedProblem(resid, jac, (RobustSpec("huber", self.k_huber), RobustSpec()),
                                 LMConfig(max_iterations=self.max_iterations), self.keys, self.glob)

    def values(self, P: dict, carried: dict) -> dict:
        return {"flow": carried["flow"], "X": P["X_init"]}

    def result(self, R: dict) -> FlowPoseResult:
        return FlowPoseResult(pose=R["res"]["X"], flow=R["carried"]["flow"], inliers=R["active"],
                              error=R["error"])


class MotionOnly(NamedTuple):
    """The settings of a motion-only 3D refinement; its tensors are the
    dict `motion_only_inputs` makes."""

    cam: CameraParams
    landmark_motion_sigma: float = 0.001
    projection_sigma: float = 2.0
    k_huber: float = 0.0001
    max_iterations: int = 10
    outlier_rounds: int = 4

    keys = ("mp", "mc")
    glob = "H"
    chi2_gate = 11.344867   # chi^2(3, 0.99) on the whitened ternary error
    gated = 2

    def problem(self, P: dict, active: torch.Tensor) -> EliminatedProblem:
        cam, projection_sigma, landmark_motion_sigma = self.cam, self.projection_sigma, self.landmark_motion_sigma
        m_prev_world, uvs = P["m_prev_world"], P["uvs"]
        dt, dev = m_prev_world.dtype, m_prev_world.device
        bsz, n = m_prev_world.shape[:2]
        # both reprojection terms as one stacked computation: (2, 1, 1) poses
        Xs = SE3(P["Xs_R"], P["Xs_t"])
        zero = torch.zeros((), dtype=dt, device=dev)
        I3 = torch.eye(3, dtype=dt, device=dev).expand(bsz, n, 3, 3)
        Z23 = torch.zeros((bsz, n, 2, 3), dtype=dt, device=dev)
        G26 = torch.zeros((bsz, n, 2, 6), dtype=dt, device=dev)
        amask = active[..., None]

        def resid(values):
            mp, mc, H = values["mp"], values["mc"], values["H"]
            rp, zz = factors.reprojection_residual(Xs, torch.stack([mp, mc]), uvs, cam)
            rp = torch.where(amask[None] & (zz > 0.01)[..., None], rp / projection_sigma, zero)
            r_tern = factors.landmark_motion_ternary_residual(mp, mc, H[:, None])
            r_tern = torch.where(amask, r_tern / landmark_motion_sigma, zero)
            return [rp[0], rp[1], r_tern]

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
            amask4 = active[..., None, None]
            Rt = H.R.transpose(-1, -2)[:, None].expand(bsz, n, 3, 3)
            B_tern = torch.where(amask4, torch.cat([I3, -Rt], dim=-1) / landmark_motion_sigma, zero)
            q = se3_apply(se3_inverse(H)[:, None], mc)
            G_tern = torch.where(amask4, torch.cat([-so3_hat(q), I3], dim=-1) / landmark_motion_sigma, zero)
            return [B_prev, B_cur, B_tern], [G26, G26, G_tern]

        return EliminatedProblem(resid, jac, (RobustSpec("huber", self.k_huber),) * 3,
                                 LMConfig(max_iterations=self.max_iterations), self.keys, self.glob)

    def values(self, P: dict, carried: dict) -> dict:
        return {"mp": carried["mp"], "mc": carried["mc"], "H": P["H_init"]}

    def result(self, R: dict) -> MotionRefineResult:
        return MotionRefineResult(motion=R["res"]["H"], inliers=R["active"], error=R["error"])


def flow_pose_inputs(cam: CameraParams, X_init: SE3, X_prev: SE3, kp_prev: torch.Tensor,
                     depth_prev: torch.Tensor, flow_init: torch.Tensor) -> dict:
    """The tensors of a `FlowPose` refinement (`optimize_flow_and_pose`'s
    arguments and the back-projected previous points)."""
    p_world = se3_apply(X_prev, backproject(cam, kp_prev, depth_prev))
    return dict(X_init=X_init, X_prev=X_prev, kp_prev=kp_prev, depth_prev=depth_prev, flow_init=flow_init,
                p_world=p_world)


def motion_only_inputs(H_init: SE3, X_prev: SE3, X_cur: SE3, m_prev_world: torch.Tensor,
                       uv_prev: torch.Tensor, uv_cur: torch.Tensor) -> dict:
    """The tensors of a `MotionOnly` refinement (`optimize_motion_only`'s
    arguments, the moved landmarks and both poses stacked)."""
    return dict(H_init=H_init, m_prev_world=m_prev_world, m_cur_init=se3_apply(H_init[:, None], m_prev_world),
                Xs_R=torch.stack([X_prev.R, X_cur.R])[:, None, None],
                Xs_t=torch.stack([X_prev.t, X_cur.t])[:, None, None],
                uvs=torch.stack([uv_prev, uv_cur]))


def _round_flags(R: dict, outlier_rounds: int) -> dict:
    run = (R["it"] == 0) | ((R["n_new"] > 0) & (R["it"] <= outlier_rounds))
    return {**R, "run": run, "more": run.any()}


def rounds_start(kind, valid: torch.Tensor, start: dict) -> dict:
    """The rounds' state before the first: active rows, the carried block
    values (`start`), new-outlier and round counters, and the flags (`run`
    (B,), `more` (0-d), which the host reads) of the JAX `while_loop` over
    outlier rounds, batched with per-problem semantics."""
    bsz = valid.shape[0]
    dev = valid.device
    return _round_flags(dict(active=valid.clone(), carried=dict(start),
                             n_new=torch.zeros((bsz,), dtype=torch.int64, device=dev),
                             it=torch.zeros((bsz,), dtype=torch.int64, device=dev)), kind.outlier_rounds)


def round_head(kind, P: dict, R: dict) -> dict:
    """The LM head of a round: the global restarts from its initial value,
    the blocks from the carried ones."""
    return lm_head(kind.values(P, R["carried"]), kind.problem(P, R["active"]))


def round_iteration(kind, P: dict, R: dict, L: dict, first: bool) -> dict:
    return lm_iteration(L, kind.problem(P, R["active"]), first)


def round_tail(kind, P: dict, R: dict, L: dict, first: bool) -> dict:
    """The round's outliers under the chi^2 gate, its result merged into
    the problems it ran (`first`: nothing to merge with) and the next
    round's flags."""
    prob = kind.problem(P, R["active"])
    r = lm_result(L, prob)
    active, run = R["active"], R["run"]
    r_final = prob.residual_fn(r.values)[kind.gated]
    outliers = active & (torch.sum(r_final * r_final, dim=-1) > kind.chi2_gate)
    if first:
        res, error = r.values, r.error
    else:
        res = {}
        for k, v in r.values.items():
            old = R["res"][k]
            res[k] = se3_where(run, v, old) if isinstance(v, SE3) else torch.where(
                run.reshape(-1, *([1] * (v.dim() - 1))), v, old
            )
        error = torch.where(run, r.error, R["error"])
    m = run[:, None]
    carried = dict(R["carried"])
    for k in kind.keys:
        carried[k] = torch.where(m[..., None], r.values[k], carried[k])
    return _round_flags(dict(
        active=torch.where(m, active & ~outliers, active),
        carried=carried,
        n_new=torch.where(run, outliers.sum(-1), R["n_new"]),
        it=torch.where(run, R["it"] + 1, R["it"]),
        res=res, error=error,
    ), kind.outlier_rounds)


def rounds_schedule(run: Callable, more: Callable, max_iterations: int) -> None:
    """The host loop over outlier rounds and their LM iterations:
    `run(name, first)` runs the stretch `name` ("head", "iteration",
    "tail"); `more(name)` reads the flag of the rounds ("rounds") or of
    the round's LM ("lm")."""
    first = True
    while more("rounds"):
        run("head", False)
        lm_schedule(lambda first_it: run("iteration", first_it), lambda: more("lm"), max_iterations)
        run("tail", first)
        first = False


def _pose12(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.cat([R.reshape(*R.shape[:-2], 9), t], dim=-1).contiguous()


def pack(kind, P: dict, R0: dict):
    """K5's arguments (`csrc/refine.cu` states the layout): (kind id, float
    settings, int settings, tensors).  Tensors: per-row inputs (B, N, C),
    the blocks' start (B, N, b), the global's start as 12 floats (B, 12: R
    row-major, then t), the shared poses (MotionOnly: both camera poses,
    24; FlowPose: X_prev, 12) and the active rows (B, N) bool."""
    lm = LMConfig(max_iterations=kind.max_iterations)
    cam = kind.cam
    if kind.glob == "X":
        kid, s0, s1 = refine_kernel.FLOW_POSE, kind.flow_sigma, kind.flow_prior_sigma
        rows = torch.cat([P["kp_prev"], P["depth_prev"][..., None], P["flow_init"], P["p_world"]], dim=-1)
        start = R0["carried"]["flow"]
        glob0 = _pose12(P["X_init"].R, P["X_init"].t)
        shared = _pose12(P["X_prev"].R, P["X_prev"].t)
    else:
        kid, s0, s1 = refine_kernel.MOTION_ONLY, kind.projection_sigma, kind.landmark_motion_sigma
        rows = torch.cat([P["uvs"][0], P["uvs"][1]], dim=-1)
        start = torch.cat([R0["carried"]["mp"], R0["carried"]["mc"]], dim=-1)
        glob0 = _pose12(P["H_init"].R, P["H_init"].t)
        shared = _pose12(P["Xs_R"].reshape(2, 3, 3), P["Xs_t"].reshape(2, 3)).reshape(24)
    # the sigmas' reciprocals last: a tensor divided by a Python number is, on
    # the card, a product with the reciprocal taken in double
    fparams = (cam.fx, cam.fy, cam.cx, cam.cy, s0, s1, kind.k_huber, 0.5 * kind.k_huber * kind.k_huber,
               kind.chi2_gate, lm.initial_lambda, lm.lambda_factor, lm.max_lambda, lm.min_lambda,
               lm.rel_error_tol, lm.abs_error_tol, lm.diag_floor, 1.0 / s0, 1.0 / s1)
    iparams = (kind.max_iterations, kind.outlier_rounds)
    return kid, fparams, iparams, (rows.contiguous(), start.contiguous(), glob0, shared, R0["active"].contiguous())


def unpack(kind, out) -> dict:
    """The rounds' final state, as `rounds_plain` returns it, from K5's
    outputs: carried blocks (B, N, b), active (B, N), the global (B, 12),
    error (B,), n_new and it (B,)."""
    carried, active, glob, error, n_new, it = out
    d = 2 if kind.glob == "X" else 3
    blocks = {key: carried[..., i * d:(i + 1) * d] for i, key in enumerate(kind.keys)}
    g = SE3(glob[:, :9].reshape(-1, 3, 3), glob[:, 9:])
    R = dict(active=active, carried=blocks, n_new=n_new, it=it, res={**blocks, kind.glob: g}, error=error)
    return _round_flags(R, kind.outlier_rounds)


def run_rounds(kind, P: dict, R0: dict) -> dict:
    """K5's wrapper: the rounds from `R0` (`rounds_start`) to their end.
    On CUDA tensors one launch of K5, which raises if it cannot build or
    launch; on CPU tensors the plain version, `rounds_plain`."""
    if R0["active"].device.type == "cpu":
        return rounds_plain(kind, P, R0)
    kid, fparams, iparams, tensors = pack(kind, P, R0)
    return unpack(kind, refine_kernel.rounds(kid, fparams, iparams, *tensors))


def rounds_plain(kind, P: dict, R0: dict) -> dict:
    """K5's plain version: the rounds from `R0` as the host loops of
    `rounds_schedule` over `round_head`, `round_iteration` and
    `round_tail` (on any device)."""
    s = {"R": R0}

    def run(name, first):
        if name == "head":
            s["L"] = round_head(kind, P, s["R"])
        elif name == "iteration":
            s["L"] = round_iteration(kind, P, s["R"], s["L"], first)
        else:
            s["R"] = round_tail(kind, P, s["R"], s["L"], first)

    rounds_schedule(run, lambda name: bool(s["R" if name == "rounds" else "L"]["more"]), kind.max_iterations)
    return s["R"]


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
    kind = FlowPose(cam, flow_sigma, flow_prior_sigma, k_huber, max_iterations, outlier_rounds)
    P = flow_pose_inputs(cam, X_init, X_prev, kp_prev, depth_prev, flow_init)
    return kind.result(run_rounds(kind, P, rounds_start(kind, valid, {"flow": flow_init})))


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
    kind = MotionOnly(cam, landmark_motion_sigma, projection_sigma, k_huber, max_iterations, outlier_rounds)
    P = motion_only_inputs(H_init, X_prev, X_cur, m_prev_world, uv_prev, uv_cur)
    return kind.result(run_rounds(kind, P, rounds_start(kind, valid, {"mp": m_prev_world, "mc": P["m_cur_init"]})))
