"""Synthetic dynamic-SLAM scenario (port of `dynosam_tpu/testing/simulator.py`).

Ground-truth camera and object trajectories with constant SE(3) motions,
noisy tracked points, and `FrontendOutput` packets that drive the backend
with no vision involved.  The draws from numpy's generator come in the JAX
package's order, so a seed gives the same scenario in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..core.lie import SE3, se3_apply, se3_compose, se3_exp, se3_inverse
from ..core.types import DynamicObs, FrontendOutput, ObjectObs, StaticObs


@dataclasses.dataclass
class ScenarioConfig:
    n_frames: int = 12
    n_static: int = 120
    n_objects: int = 2
    pts_per_object: int = 40
    # capacities (slot pool sizes); must be >= counts above
    ns: int = 160
    nd: int = 128
    no: int = 4
    point_noise: float = 0.01
    odom_rot_noise: float = 0.002
    odom_trans_noise: float = 0.01
    seed: int = 0
    camera_step: float = 0.5


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float32))


def _matrix(g: SE3) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = g.R.numpy()
    T[:3, 3] = g.t.numpy()
    return T


class Scenario:
    """Ground-truth trajectories and noisy frontend packets, on the CPU."""

    def __init__(self, cfg: ScenarioConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        F, O = cfg.n_frames, cfg.n_objects

        # camera: integrate a constant twist with rotational jitter
        twist = np.array([0.002, 0.02, 0.001, cfg.camera_step, 0.0, 0.02])
        X = [np.eye(4)]
        for _ in range(1, F):
            d = twist + rng.normal(size=6) * np.array([1e-3] * 3 + [0.0] * 3)
            X.append(X[-1] @ _matrix(se3_exp(_f32(d))))
        self.X_gt = SE3(_f32([T[:3, :3] for T in X]), _f32([T[:3, 3] for T in X]))

        # objects: a constant world motion each, points around a centroid
        self.H_gt = []            # per object, (F,) motions (identity at k=0)
        self.obj_points_w = []    # per object, (F, P, 3) world points
        for j in range(O):
            axis = rng.normal(size=3)
            axis /= np.linalg.norm(axis)
            H_body = se3_exp(_f32(np.concatenate([axis * 0.03, [0.4 + 0.2 * j, 0.1, 0.0]])))
            centroid = np.array([6.0 + 4.0 * j, (-1.0) ** j * 2.0, 1.0])
            pts = [_f32(centroid + rng.normal(size=(cfg.pts_per_object, 3)) * 0.8)]
            Hs = [SE3(torch.eye(3), torch.zeros(3))]
            for _ in range(1, F):
                pts.append(se3_apply(H_body, pts[-1]))
                Hs.append(H_body)
            self.obj_points_w.append(torch.stack(pts))
            self.H_gt.append(Hs)

        self.static_w = _f32(rng.uniform([-10, -8, -2], [30, 8, 6], size=(cfg.n_static, 3)))

        # noisy odometry (accumulating drift)
        self.X_odo = [self.X_gt[0]]
        for k in range(1, F):
            rel = se3_compose(se3_inverse(self.X_gt[k - 1]), self.X_gt[k])
            noise = se3_exp(_f32(np.concatenate([rng.normal(size=3) * cfg.odom_rot_noise,
                                                 rng.normal(size=3) * cfg.odom_trans_noise])))
            self.X_odo.append(se3_compose(self.X_odo[-1], se3_compose(rel, noise)))
        self.rng = rng

    def frontend_outputs(self) -> List[FrontendOutput]:
        """Noisy measurement packets for every frame (static tracks in slots
        [0, n_static), object j's in [j P, (j + 1) P))."""
        cfg = self.cfg
        P = cfg.pts_per_object
        out = []
        for k in range(cfg.n_frames):
            Xinv = se3_inverse(self.X_gt[k])
            local = se3_apply(Xinv, self.static_w)
            local = local + _f32(self.rng.normal(size=tuple(local.shape)) * cfg.point_noise)
            s_xyz = torch.zeros((cfg.ns, 3))
            s_xyz[:cfg.n_static] = local
            s_valid = torch.zeros(cfg.ns, dtype=torch.bool)
            s_valid[:cfg.n_static] = True

            d_xyz = torch.zeros((cfg.nd, 3))
            d_obj = torch.full((cfg.nd,), -1, dtype=torch.int32)
            d_valid = torch.zeros(cfg.nd, dtype=torch.bool)
            for j in range(cfg.n_objects):
                loc = se3_apply(Xinv, self.obj_points_w[j][k])
                loc = loc + _f32(self.rng.normal(size=tuple(loc.shape)) * cfg.point_noise)
                d_xyz[j * P:(j + 1) * P] = loc
                d_obj[j * P:(j + 1) * P] = j
                d_valid[j * P:(j + 1) * P] = True

            # frontend motions (ground truth) and propagated object poses
            # L_k = H^k L_0, L_0 at the initial centroid
            mo_R, po_R = torch.eye(3).repeat(cfg.no, 1, 1), torch.eye(3).repeat(cfg.no, 1, 1)
            mo_t, po_t = torch.zeros((cfg.no, 3)), torch.zeros((cfg.no, 3))
            mo_valid, po_valid = torch.zeros(cfg.no, dtype=torch.bool), torch.zeros(cfg.no, dtype=torch.bool)
            for j in range(cfg.n_objects):
                if k > 0:
                    mo_R[j], mo_t[j], mo_valid[j] = self.H_gt[j][k].R, self.H_gt[j][k].t, True
                Lk = SE3(torch.eye(3), torch.mean(self.obj_points_w[j][0], dim=0))
                for kk in range(1, k + 1):
                    Lk = se3_compose(self.H_gt[j][kk], Lk)
                po_R[j], po_t[j], po_valid[j] = Lk.R, Lk.t, True
            label = torch.tensor([j + 1 if j < cfg.n_objects else -1 for j in range(cfg.no)], dtype=torch.int32)
            out.append(FrontendOutput(
                frame_id=torch.tensor(k, dtype=torch.int32),
                timestamp=torch.tensor(k * 0.1, dtype=torch.float32),
                X_world=self.X_odo[k],
                static_obs=StaticObs(uv=torch.zeros((cfg.ns, 2)), xyz=s_xyz, valid=s_valid),
                dynamic_obs=DynamicObs(uv=torch.zeros((cfg.nd, 2)), xyz=d_xyz, obj=d_obj, valid=d_valid),
                objects=ObjectObs(motion=SE3(mo_R, mo_t), motion_valid=mo_valid, pose=SE3(po_R, po_t),
                                  pose_valid=po_valid, label=label),
            ))
        return out
