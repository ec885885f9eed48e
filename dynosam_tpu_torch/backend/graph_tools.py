"""Factor-graph inspection utilities (port of
`dynosam_tpu/backend/graph_tools.py`; numpy-facing, same file formats).

Analog of `factor_graph_tools::*` (`backend/FactorGraphTools.hpp:44-260`,
`src/backend/FactorGraphTools.cc`):

  * chi-squared outlier factor detection (`determineFactorOutliers`,
    `FactorGraphTools.hpp:69-99`: a factor is an outlier when its
    Gaussian-whitened squared error exceeds the chi2 quantile of its
    dimension at 0.99 confidence),
  * graph composition statistics (`DebugInfo`,
    `backend/BackendDefinitions.hpp:175-224`: per-family factor/variable
    counts),
  * normal-equation sparsity statistics (`SparsityStats` :257) computed
    from the masked factor grids without materializing the Hessian.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from .formulation import WindowMasks
from .solver import RobustSpec


# chi2 quantiles at 0.99 confidence by residual dimension
_CHI2_99 = {1: 6.634897, 2: 9.210340, 3: 11.344867, 6: 16.811894}


def _np(tree):
    """A tensor, SE3 or NamedTuple of tensors with numpy leaves."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_np(x) for x in tree))
    return np.asarray(tree)


def factor_outliers(
    residuals: Sequence[torch.Tensor], specs: Sequence[RobustSpec]
) -> List[torch.Tensor]:
    """Per-family boolean outlier masks (`determineFactorOutliers`,
    `FactorGraphTools.hpp:69-99`): outlier iff the Gaussian-whitened
    (robust kernel stripped) squared error exceeds chi2(dim, 0.99) —
    0.5 |r|^2 > 0.5 * chi2_quantile in gtsam's error convention.  Only
    robust families are tested, matching the reference's template filter."""
    out = []
    for r, s in zip(residuals, specs):
        if s.kind == "none":
            out.append(torch.zeros(r.shape[:-1], dtype=torch.bool, device=r.device))
        else:
            gate = _CHI2_99.get(r.shape[-1], 11.344867)
            # only count factors that are actually active (nonzero residual
            # rows — masked rows are exactly zero)
            active = torch.any(r != 0.0, dim=-1)
            out.append(active & (torch.sum(r * r, dim=-1) > gate))
    return out


@dataclasses.dataclass
class DebugInfo:
    """Graph composition counts (the reference logs these per update)."""

    num_poses: int
    num_motions: int
    num_static_points: int
    num_dynamic_points: int
    num_static_factors: int
    num_dynamic_factors: int
    num_motion_factors: int
    num_smoothing_factors: int
    num_odometry_factors: int

    @staticmethod
    def from_masks(masks: WindowMasks) -> "DebugInfo":
        m = _np(masks)
        return DebugInfo(
            num_poses=int(m.frame.sum()),
            num_motions=int(m.motion_active.sum()),
            num_static_points=int((m.static_obs.sum(0) > 0).sum()),
            num_dynamic_points=int(m.dyn_obs.sum()),
            num_static_factors=int(m.static_obs.sum()),
            num_dynamic_factors=int(m.dyn_obs.sum()),
            num_motion_factors=int(m.ternary.sum()),
            num_smoothing_factors=int(m.smoothing.sum()),
            num_odometry_factors=int(m.odometry.sum()),
        )


@dataclasses.dataclass
class SparsityStats:
    """Normal-equation block sparsity, computed from masks analytically."""

    total_variable_dims: int
    total_residual_dims: int
    nnz_offdiag_blocks: int
    total_offdiag_blocks: int

    @property
    def fill_ratio(self) -> float:
        if self.total_offdiag_blocks == 0:
            return 0.0
        return self.nnz_offdiag_blocks / self.total_offdiag_blocks


def sparsity_stats(masks: WindowMasks) -> SparsityStats:
    m = _np(masks)
    W = m.frame.shape[0]
    NS = m.static_obs.shape[1]
    ND = m.dyn_obs.shape[1]
    O = m.motion_active.shape[1]

    n_vars = (
        6 * int(m.frame.sum())
        + 6 * int(m.motion_active.sum())
        + 3 * int((m.static_obs.sum(0) > 0).sum())
        + 3 * int(m.dyn_obs.sum())
    )
    n_res = (
        6  # anchor
        + 6 * int(m.odometry.sum())
        + 3 * int(m.static_obs.sum())
        + 3 * int(m.dyn_obs.sum())
        + 3 * int(m.ternary.sum())
        + 6 * int(m.smoothing.sum())
    )
    # off-diagonal variable-pair blocks coupled by at least one factor
    nnz = (
        int(m.odometry.sum())                  # X_{k-1} ~ X_k
        + int(m.static_obs.sum())              # X_k ~ sp_i
        + int(m.dyn_obs.sum())                 # X_k ~ dp_{k,i}
        + 3 * int(m.ternary.sum())             # dp_{k-1}~dp_k, dp~H x2
        + int(m.smoothing.sum())               # H_{k-1} ~ H_k
    )
    n_var_blocks = (
        int(m.frame.sum())
        + int(m.motion_active.sum())
        + int((m.static_obs.sum(0) > 0).sum())
        + int(m.dyn_obs.sum())
    )
    total_pairs = n_var_blocks * (n_var_blocks - 1) // 2
    return SparsityStats(
        total_variable_dims=n_vars,
        total_residual_dims=n_res,
        nnz_offdiag_blocks=nnz,
        total_offdiag_blocks=total_pairs,
    )


# ---------------------------------------------------------------------------
# graph save / viz (`NonlinearFactorGraphManager::writeDynosamGraphFile`,
# `src/backend/FactorGraphTools.cc:316-380`, and gtsam saveGraph-style dot
# output, `FactorGraphTools.hpp:291-358`)
# ---------------------------------------------------------------------------

def _key(kind: str, *idx) -> str:
    """Human-readable key replacing the reference's Cantor-paired gtsam
    symbols (`core/types.py` §2.15): x<k> pose, h<k>_<o> motion/object pose,
    s<i> static landmark, d<k>_<i> dynamic landmark."""
    return kind + "_".join(str(int(i)) for i in idx)


def _se3_line(R: np.ndarray, t: np.ndarray) -> str:
    # row-major rotation + translation (12 numbers), reference-style plain text
    return " ".join(f"{v:.9g}" for v in np.concatenate([R.reshape(-1), t]))


def write_dynosam_graph_file(
    path: str,
    values: Dict,
    masks: WindowMasks,
    pose_key: str = "h",
    dyn_obj=None,
) -> int:
    """Write the masked factor grids as a typed plain-text graph file — the
    analog of `writeDynosamGraphFile` (`FactorGraphTools.cc:316-380`:
    `TAG <keys...> <measurement>` factor lines then `TAG <key> <value>`
    value lines).  Returns the number of factor lines written.

    `pose_key` labels the per-object variable family ("h" WorldMotion
    motions, "l" WorldPose object poses); `dyn_obj` is the (ND,) tracklet ->
    object-slot grid (`WindowData.dyn_obj`, (W, ND)) keying motion factors.
    """
    m = _np(masks)
    X = _np(values["X"])
    H = _np(values.get("H", values.get("L")))
    sp = _np(values["sp"])
    dp = _np(values["dp"])
    W = m.frame.shape[0]
    n = 0
    with open(path, "w") as f:
        # ---- factors ----
        f.write(f"SE3_PRIOR_FACTOR {_key('x', 0)}\n")
        n += 1
        for k in range(1, W):
            if m.odometry[k]:
                f.write(
                    f"SE3_BETWEEN_FACTOR {_key('x', k - 1)} {_key('x', k)}\n"
                )
                n += 1
        ks, js = np.nonzero(m.static_obs)
        for k, j in zip(ks, js):
            f.write(
                f"POSE_TO_POINT_FACTOR {_key('x', k)} {_key('s', j)}\n"
            )
            n += 1
        ks, js = np.nonzero(m.dyn_obs)
        for k, j in zip(ks, js):
            f.write(
                f"POSE_TO_POINT_FACTOR {_key('x', k)} {_key('d', k, j)}\n"
            )
            n += 1
        obj_of = _np(dyn_obj) if dyn_obj is not None else None
        ks, js = np.nonzero(m.ternary)
        for k, j in zip(ks, js):
            o = int(obj_of[k, j]) if obj_of is not None else 0
            f.write(
                "SE3_MOTION_FACTOR "
                f"{_key('d', k - 1, j)} {_key('d', k, j)} {_key(pose_key, k, o)}\n"
            )
            n += 1
        ks, os_ = np.nonzero(m.smoothing[1:])
        for k, o in zip(ks, os_):
            f.write(
                "SE3_BETWEEN_FACTOR "
                f"{_key(pose_key, k, o)} {_key(pose_key, k + 1, o)}\n"
            )
            n += 1
        # ---- values ----
        for k in range(W):
            if m.frame[k]:
                f.write(
                    f"SE3_POSE_VALUE {_key('x', k)} "
                    f"{_se3_line(X.R[k], X.t[k])}\n"
                )
        for k in range(W):
            for o in range(m.motion_active.shape[1]):
                if m.motion_active[k, o]:
                    f.write(
                        f"SE3_MOTION_VALUE {_key(pose_key, k, o)} "
                        f"{_se3_line(H.R[k, o], H.t[k, o])}\n"
                    )
        live_s = m.static_obs.sum(0) > 0
        for j in np.nonzero(live_s)[0]:
            f.write(
                f"POINT3_STATIC_VALUE {_key('s', j)} "
                + " ".join(f"{v:.9g}" for v in sp[j])
                + "\n"
            )
        ks, js = np.nonzero(m.dyn_obs)
        for k, j in zip(ks, js):
            f.write(
                f"POINT3_DYNAMIC_VALUE {_key('d', k, j)} "
                + " ".join(f"{v:.9g}" for v in dp[k, j])
                + "\n"
            )
    return n


def save_graph_dot(
    path: str, masks: WindowMasks, pose_key: str = "h", dyn_obj=None
) -> None:
    """Graphviz dot of the factor graph (gtsam `saveGraph` analog,
    `FactorGraphTools.hpp:291-358`): variables as ellipses coloured by
    family, factors as small filled boxes, landmark grids collapsed to one
    node per tracklet to keep the drawing readable."""
    m = _np(masks)
    W = m.frame.shape[0]
    O = m.motion_active.shape[1]
    lines = [
        "graph dynosam {",
        "  rankdir=LR;",
        '  node [fontsize=9];',
    ]
    for k in range(W):
        if m.frame[k]:
            lines.append(
                f'  x{k} [shape=ellipse, style=filled, fillcolor="#aec6e8"];'
            )
    for k in range(W):
        for o in range(O):
            if m.motion_active[k, o]:
                lines.append(
                    f'  {pose_key}{k}_{o} '
                    '[shape=ellipse, style=filled, fillcolor="#ffbb78"];'
                )
    # collapse landmarks: one node per static tracklet / dynamic tracklet
    live_s = np.nonzero(m.static_obs.sum(0) > 0)[0]
    for j in live_s:
        lines.append(f'  s{j} [shape=point, color="#2ca02c"];')
    live_d = np.nonzero(m.dyn_obs.sum(0) > 0)[0]
    for j in live_d:
        lines.append(f'  d{j} [shape=point, color="#d62728"];')
    fid = 0

    def factor(*keys):
        nonlocal fid
        lines.append(f"  f{fid} [shape=box, width=0.08, height=0.08, style=filled, fillcolor=black, label=\"\"];")
        for kk in keys:
            lines.append(f"  f{fid} -- {kk};")
        fid += 1

    for k in range(1, W):
        if m.odometry[k]:
            factor(f"x{k-1}", f"x{k}")
    for j in live_s:
        for k in np.nonzero(m.static_obs[:, j])[0]:
            factor(f"x{k}", f"s{j}")
    for j in live_d:
        ks = np.nonzero(m.dyn_obs[:, j])[0]
        for k in ks:
            factor(f"x{k}", f"d{j}")
    obj_of = _np(dyn_obj) if dyn_obj is not None else None
    for j in np.nonzero(m.ternary.sum(0) > 0)[0]:
        for k in np.nonzero(m.ternary[:, j])[0]:
            o = int(obj_of[k, j]) if obj_of is not None else 0
            factor(f"d{j}", f"{pose_key}{k}_{o}")
    for k, o in zip(*np.nonzero(m.smoothing[1:])):
        factor(f"{pose_key}{k}_{o}", f"{pose_key}{k+1}_{o}")
    lines.append("}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
