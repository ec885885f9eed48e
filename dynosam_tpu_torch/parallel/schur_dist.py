"""Distributed direct reduced (Schur) window solve on `torch.distributed`
(port of `dynosam_tpu/parallel/schur_dist.py`, its explicit-collective
path, both formulations).

The window's LM runs on every rank of a (frames x tracks) mesh with
hand-placed collectives; the LM schedule is the single-device one
(`backend/schur.py:lm_optimize_schur` with per-rank `overrides`).

Domain decomposition (F frame blocks of S = W / F frames, T track blocks):

  * X and the per-object poses (H or L), and every pose-family quantity,
    are replicated: tiny, and recomputing them on every rank deletes all
    small-tensor communication;
  * dynamic grids split (frames x tracks); frame block f owns the motion
    factor slots s <-> current frame f S + s.  Slot 0 needs the LEFT
    neighbour's last dp row; the boundary factor the RIGHT neighbour owns
    is recomputed locally from its first dp row (the ghost slot S);
  * the static family is split the same way for its residuals and
    Jacobians (local S frames, local static slots); the landmark Hessian,
    its rhs and the camera coupling rows are summed over the frame group
    once per trial step;
  * the object one-hot table is mask-derived, built once in the prologue.

Collectives per LM iteration with F > 1 (each one `torch.distributed`
call, the torch form of JAX's `ppermute` / `psum` / `all_gather`):

  1. dp ghost exchange: the left and right boundary rows in ONE batched
     point-to-point call (JAX: two `ppermute`s);
  2. error all_reduce (the frame- and track-split families);
  3. packed all_reduce over the frame group of the static family's
     landmark Hessian, rhs and coupling rows;
  4. left-ghost exchange of the per-lambda chain quantities of the
     previous frame block's last row;
  5. SPIKE all_gather of the chain boundary rows and spikes (one packed
     buffer);
  6. packed all_reduce over the whole group of every contracted small
     quantity (camera and pose blocks, Schur corrections);
  7. back-substitution ghost exchange of the right neighbour's first row.

The SPIKE halo of the capacitance chain needs no exchange here: the
right neighbour's first coupling block is formed from this block's own
last row and its ghost slot (`b_next` in the step).  JAX's code sends
that halo, and the two dp ghosts apart, as `ppermute`s: 9 in all, where
its section comment (`dynosam_tpu/parallel/schur_dist.py:318-394`) lists
7.  With F = 1 only the two all_reduces (error, packed) remain: the
ghosts and the frame sum have no peer, as in JAX's `F > 1` branches.

Shared core, `spike_chain_solve_local`: the per-tracklet chain systems
run along the frame axis.  Each frame block eliminates its interior with
the local block-Thomas solve, the per-block boundary rows ("spikes") are
gathered over the frame group, every rank solves the small per-chain
interface system (6F unknowns per chain, `torch.linalg.solve`) and
corrects its interior locally.  The track axis needs no communication.

Not ported (ROADMAP.md, the port rules): the legacy GSPMD branch
(`DYNO_DIST_GSPMD=1`) and the ternary-scalar mode of the SPIKE solve that
only that branch uses.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..backend.formulation import (
    _first_valid_world_point,
    build_masks,
    object_onehot,
    odometry_measurements,
    pose_key,
    pose_sigmas,
    select_motions,
    world_motion_families,
    world_pose_families,
)
from ..backend.map import MeasurementMap, WindowData
from ..backend.schur import (
    _anchor_jacobian,
    _band_blocks,
    _between_jacobians,
    _damp_blocks,
    _floor_consts,
    _inv3,
    _pair_blocks,
    _place,
    _pose_direct_blocks,
    _pose_point_jacobians,
    _static_blocks,
    assemble_reduced,
    chain_solve,
    chain_solve_scalar,
    lm_optimize_schur,
)
from ..backend.solver import LMConfig, LMResult, robust_loss
from ..core.lie import SE3, se3_apply, se3_identity, so3_hat
from ..ops import factors
from ..utils.config import BackendConfig
from .mesh import (
    FRAME_AXIS,
    TRACK_AXIS,
    ShardedMap,
    all_gather_rows,
    all_reduce_packed,
    exchange,
    make_mesh,
    mesh_coords,
    shard_map_data,
)


def frame_chain(mesh: DeviceMesh) -> SimpleNamespace:
    """This rank's place on its frame chain: the frame group, the global
    ranks of its left and right neighbours (None at the ends), its block
    index and the number of blocks."""
    fi, ti, F, _ = mesh_coords(mesh)
    grid = mesh.mesh
    return SimpleNamespace(
        group=mesh.get_group(FRAME_AXIS), fi=fi, F=F,
        left=int(grid[fi - 1, ti]) if fi > 0 else None,
        right=int(grid[fi + 1, ti]) if fi < F - 1 else None,
    )


# --------------------------------------------------------------------------
# Frame-split SPIKE chain solve
# --------------------------------------------------------------------------


def spike_chain_solve_local(A, B, rhs, chain, alpha=None, b_next=None):
    """SPIKE solve of this rank's block of the (W, N) block-tridiagonal
    chains: A, B (S, n, 3, 3) with B[0] the coupling to the LEFT block's
    last row, rhs (S, n, 3, M); requires S >= 2.  `alpha` (S, n) selects
    the scalar-diagonal interior solve (`chain_solve_scalar`, the Woodbury
    capacitance chain; `A` is then unused), else the generic block-Thomas
    (`chain_solve`).  `b_next`, the right block's B[0], is fetched by one
    halo exchange unless the caller can form it; the boundary rows travel
    in one all_gather."""
    S, n = B.shape[:2]
    F, fi = chain.F, chain.fi
    B0 = B[0]
    B_int = torch.cat([torch.zeros_like(B[:1]), B[1:]], dim=0)
    if b_next is None:
        _, b_next = exchange(chain.group, chain.left, chain.right, to_left=B0)

    # the two spike columns: row 0 couples to the left block's last row
    # (B0^T), row S-1 to the right block's first row (b_next)
    M = rhs.shape[-1]
    v_col = _place(B0.transpose(-1, -2)[None], 0, S - 1)
    w_col = _place(b_next[None], S - 1, 0)
    rhs_aug = torch.cat([rhs, v_col, w_col], dim=-1)
    Y = chain_solve_scalar(alpha, B_int, rhs_aug) if alpha is not None else chain_solve(A, B_int, rhs_aug)

    bb = all_gather_rows(torch.stack([Y[0], Y[S - 1]])[None], chain.group, F)   # (F, 2, n, 3, M+6)
    y, V, Wm = Y[..., :M], Y[..., M:M + 3], Y[..., M + 3:]
    yb, Vb, Wb = bb[..., :M], bb[..., M:M + 3], bb[..., M + 3:]

    # per-chain interface system over u = [f_0, l_0, ..., f_{F-1}, l_{F-1}]:
    #   f_b + V0_b l_{b-1} + W0_b f_{b+1} = y0_b,  l_b + V1_b l_{b-1} + W1_b f_{b+1} = y1_b
    K = torch.eye(6 * F, dtype=B.dtype, device=B.device).repeat(n, 1, 1)
    for b in range(F):
        for r in range(2):
            row = slice(6 * b + 3 * r, 6 * b + 3 * r + 3)
            if b > 0:
                K[:, row, 6 * b - 3:6 * b] = Vb[b, r]
            if b < F - 1:
                K[:, row, 6 * b + 6:6 * b + 9] = Wb[b, r]
    u = torch.linalg.solve(K, yb.permute(2, 0, 1, 3, 4).reshape(n, 6 * F, M)).reshape(n, F, 2, 3, M)
    zero = torch.zeros_like(u[:, 0, 0])
    x_last_prev = u[:, fi - 1, 1] if fi > 0 else zero
    x_first_next = u[:, fi + 1, 0] if fi < F - 1 else zero
    return y - V @ x_last_prev[None] - Wm @ x_first_next[None]


def spike_chain_solve(A, B, rhs, mesh: DeviceMesh):
    """The (W, N) chains A, B, rhs (held whole by every rank; B[0] zero)
    solved with W split over frames and N over tracks: returns this rank's
    block (W/F, N/T, 3, M) of the solution.  The counterpart of the JAX
    package's `make_spike_chain_solver(mesh)(A, B, rhs)`."""
    fi, ti, F, T = mesh_coords(mesh)
    W, N = B.shape[:2]
    S, n = W // F, N // T
    if W % F or S < 2 or N % T:
        raise ValueError(f"chains ({W}, {N}) do not split into >=2-frame blocks over a ({F}, {T}) mesh")

    def blk(x):
        return x[fi * S:(fi + 1) * S, ti * n:(ti + 1) * n]

    return spike_chain_solve_local(blk(A), blk(B), blk(rhs), frame_chain(mesh))


# --------------------------------------------------------------------------
# Distributed window optimization
# --------------------------------------------------------------------------


def _couple(Brow: torch.Tensor, oh: torch.Tensor, Rdot: torch.Tensor) -> torch.Tensor:
    """`schur._couple` over this block's rows: (S, ND, 3, 6), (S, ND, O),
    (S, ND, 3, 6W) -> (S, O, 6, W, 6)."""
    out = torch.einsum("kdia,kdo,kdic->koac", Brow, oh, Rdot)
    return out.reshape(Brow.shape[0], oh.shape[-1], 6, Rdot.shape[-1] // 6, 6)


def distributed_schur_optimize(m, window: int, cfg: BackendConfig, mesh: DeviceMesh | None = None,
                               updater: int = 0, lm_cfg: LMConfig | None = None) -> LMResult:
    """The direct reduced LM solve of frames [0, window) of `m` over the
    mesh, with the frame-split SPIKE chain elimination.

    `m` is the whole map (held by every rank) or this rank's blocks in the
    solve's layout (`multihost.feed_measurement_map`, a `ShardedMap` of
    exactly `window` frames).  `window` must split into blocks of at least
    2 frames over the frame axis, and the track pools over the tracks
    axis.  Returns the `LMResult` with X and the object poses whole, sp
    this rank's static slots and dp its (frame, track) block
    (`gather_values` assembles them).  A one-rank mesh runs the same
    program."""
    mesh = mesh or make_mesh()
    nb = mesh.size(0)
    if window % nb != 0 or window // nb < 2:
        raise ValueError(f"window {window} must split into >=2-frame blocks over the {nb}-way frame axis")
    lm_cfg = lm_cfg or LMConfig(max_iterations=cfg.lm_max_iterations)
    if isinstance(m, ShardedMap):
        if m.layout != "compute" or m.n_frames != window:
            raise ValueError("a fed map must be in the compute layout with exactly `window` frames "
                             "(multihost.feed_measurement_map)")
        local = m.local
    else:
        local = shard_map_data(MeasurementMap(*(x[:window] for x in m)), mesh, layout="compute").local
    return _optimize_schur_explicit(local, window, cfg, lm_cfg, mesh, updater)


def gather_values(values: dict, mesh: DeviceMesh) -> dict:
    """The whole values dict on every rank from a distributed solve's:
    sp gathered over tracks, dp over the (frames x tracks) grid."""
    _, _, F, T = mesh_coords(mesh)
    sp = all_gather_rows(values["sp"], mesh.get_group(TRACK_AXIS), T)
    dp = values["dp"]
    S, ndl = dp.shape[:2]
    full = all_gather_rows(dp[None], None, F * T)                     # (F*T, S, ndl, 3), rank order
    dp = full.reshape(F, T, S, ndl, 3).permute(0, 2, 1, 3, 4).reshape(F * S, T * ndl, 3)
    return {**values, "sp": sp, "dp": dp}


def _local_masks(w: WindowData, cfg: BackendConfig, mesh: DeviceMesh, window: int):
    """Window masks from this rank's blocks: the dynamic object ids and
    validity of every block travel in one all_gather over the whole group
    (once per solve), then `build_masks` runs on the whole dynamic grid.
    Returns (masks with whole dynamic grids, this rank's track slice)."""
    fi, ti, F, T = mesh_coords(mesh)
    S, ndl = w.dyn_obj.shape
    ids = torch.stack([w.dyn_obj.to(torch.int32), w.dyn_valid.to(torch.int32)])     # (2, S, ndl)
    full = all_gather_rows(ids[None], None, F * T)                                   # (F*T, 2, S, ndl)
    full = full.reshape(F, T, 2, S, ndl).permute(2, 0, 3, 1, 4).reshape(2, window, T * ndl)
    w_full = w._replace(dyn_obj=full[0], dyn_valid=full[1].bool())
    return build_masks(w_full, cfg), full[0], slice(ti * ndl, (ti + 1) * ndl)


def _optimize_schur_explicit(w: WindowData, W_: int, cfg: BackendConfig, lm_cfg: LMConfig,
                             mesh: DeviceMesh, updater: int) -> LMResult:
    """The window solve on this rank's blocks `w` (a `WindowData` in the
    compute layout: static grids (W, NS/T), dynamic grids (S, ND/T)), with
    the collectives of the module docstring."""
    fi, ti, F, T = mesh_coords(mesh)
    chain = frame_chain(mesh)
    S = W_ // F
    start = fi * S
    dtype, dev = w.dyn_xyz.dtype, w.dyn_xyz.device
    O = w.motion_valid.shape[1]
    nc = 6 * W_
    pk = pose_key(updater)
    spec = (world_motion_families(cfg) if updater == 0 else world_pose_families(cfg)).robust
    n_fam = len(spec)
    sig_s, sig_d = cfg.static_point_noise_sigma, cfg.dynamic_point_noise_sigma
    sig_t = cfg.motion_ternary_factor_noise_sigma
    pose_sigma, smooth_sigma = pose_sigmas(cfg, dtype, dev)
    _, tiny = _floor_consts(dtype)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)

    # ---- prologue (once per solve): masks, one-hot table, initial values
    masks, obj_full, tsl = _local_masks(w, cfg, mesh, W_)
    fsl = slice(start, start + S)
    dyn_obj_t = obj_full[:, tsl]                                    # (W, ndl) this rank's tracks
    tern_t = masks.ternary[:, tsl]
    dyn_obs = masks.dyn_obs[fsl, tsl]                               # (S, ndl)
    static_obs = masks.static_obs                                   # (W, nsl)
    static_obs_loc = static_obs[fsl]
    active_t = tern_t | torch.cat([tern_t[1:], torch.zeros_like(tern_t[:1])], dim=0)
    # padded by one row on each side: row -1 (the pose formulation's
    # previous frame at block 0) and row W (the last block's ghost slot)
    obj_pad = _place(dyn_obj_t, 1, 1)
    act_pad = _place(active_t, 1, 1)
    tern_ext = _place(tern_t, 0, 1)[start:start + S + 1]            # (S+1, ndl): slot S = ghost
    onehot_full = object_onehot(torch.where(active_t, dyn_obj_t, -1), O).to(dtype)   # (W, ndl, O)
    oh_loc = onehot_full[fsl]
    act_full_T = onehot_full.sum(-1).T                              # (ndl, W)
    eye_rows = (torch.arange(W_, device=dev)[None, :] == torch.arange(start, start + S, device=dev)[:, None]).to(dtype)
    dn_rows = (torch.arange(W_, device=dev)[None, :] == torch.arange(start - 1, start + S - 1, device=dev)[:, None]).to(dtype)
    static_xyz_loc = w.static_xyz[fsl]
    X_init, anchor = w.X_init, w.X_init[0]
    odo_meas = odometry_measurements(w)

    X0 = w.X_init
    if updater == 0:
        P0 = (se3_identity(w.motion_init.batch_shape, dtype, dev) if cfg.init_H_with_identity
              else w.motion_init)
    else:
        P0 = w.obj_pose_init
    dp0 = se3_apply(X0[fsl][:, None], w.dyn_xyz)
    values = {"X": X0, pk: P0, "sp": _first_valid_world_point(w.static_xyz, static_obs, X0),
              "dp": torch.where(dyn_obs[..., None], dp0, torch.zeros_like(dp0))}

    def pad_pose(Pm: SE3) -> SE3:
        return SE3(_place(Pm.R, 1, 1) + _place(eye3.expand(1, O, 3, 3), 0, W_ + 1)
                   + _place(eye3.expand(1, O, 3, 3), W_ + 1, 0), _place(Pm.t, 1, 1))

    def select_rows(Pp: SE3, row0: int, n: int) -> SE3:
        """Object-selected pose per (row, track) for global rows row0 ..
        row0+n-1 of the padded table (identity where no object is active)."""
        a = row0 + 1
        return select_motions(SE3(Pp.R[a:a + n], Pp.t[a:a + n]), obj_pad[a:a + n], act_pad[a:a + n])[0]

    def embed(part, shift: int = 0):
        """Place this block's rows at their global rows (zeros elsewhere) so
        a sum over ranks assembles the whole array; shift -1 lands factor
        row k on frame k-1 (block 0's slot 0 is the empty factor row)."""
        z = _place(part, start, W_ - start - S)
        return z if shift == 0 else torch.cat([z[1:], torch.zeros_like(z[:1])], dim=0)

    def error_local(res):
        return (robust_loss(res[3], spec[3]).sum() + robust_loss(res[4][:S], spec[4]).sum()
                + robust_loss(res[2], spec[2]).sum())

    # ---- residuals (one dp ghost exchange; the ghosts ride the list) ------
    def residual_fn(v):
        X, Pm, sp, dp = v["X"], v[pk], v["sp"], v["dp"]
        r_anchor = factors.prior_residual(X[0], anchor)[None, :] / cfg.initial_pose_prior_sigma
        r_odo = factors.between_residual(X[:-1], X[1:], odo_meas) / pose_sigma
        r_odo = torch.where(masks.odometry[1:, None], r_odo, zero)
        X_loc = X[fsl]
        r_static = factors.pose_to_point_residual(X_loc[:, None], sp[None], static_xyz_loc)
        r_static = torch.where(static_obs_loc[..., None], r_static / sig_s, zero)
        r_dyn = factors.pose_to_point_residual(X_loc[:, None], dp, w.dyn_xyz)
        r_dyn = torch.where(dyn_obs[..., None], r_dyn / sig_d, zero)

        dp_l, dp_r = exchange(chain.group, chain.left, chain.right, to_left=dp[0], to_right=dp[-1])
        dp_prev = torch.cat([dp_l[None], dp], dim=0)
        dp_cur = torch.cat([dp, dp_r[None]], dim=0)
        Pp = pad_pose(Pm)
        if updater == 0:
            r_stiff = factors.landmark_motion_ternary_residual(dp_prev, dp_cur, select_rows(Pp, start, S + 1))
            r_smooth = factors.motion_smoothing_residual(Pm[:-1], Pm[1:]) / smooth_sigma
            pose_fams = [torch.where(masks.smoothing[1:, ..., None], r_smooth, zero)]
        else:
            r_stiff = factors.landmark_motion_pose_residual(
                dp_prev, dp_cur, select_rows(Pp, start - 1, S + 1), select_rows(Pp, start, S + 1))
            r_ps = factors.landmark_pose_smoothing_residual(Pm[:-2], Pm[1:-1], Pm[2:]) / smooth_sigma
            triple = masks.smoothing[1:-1] & masks.smoothing[2:]
            pose_fams = [torch.where(triple[..., None], r_ps, zero)]
            if cfg.use_object_kinematic_factor:
                r_kin = factors.object_kinematic_residual(w.motion_init[1:], Pm[:-1], Pm[1:]) / cfg.object_kinematic_sigma
                kin = masks.smoothing[1:] & w.motion_valid[1:]
                pose_fams.append(torch.where(kin[..., None], r_kin, zero))
        r_stiff = torch.where(tern_ext[..., None], r_stiff / sig_t, zero)
        return [r_anchor, r_odo, r_static, r_dyn, r_stiff, *pose_fams, dp_l, dp_r]

    def error_fn(res):
        tot = error_local(res).reshape(1)
        torch.distributed.all_reduce(tot)
        repl = sum(robust_loss(res[i], spec[i]).sum() for i in (0, 1, *range(5, n_fam)))
        return tot[0] + repl

    # ---- build: every partial local (sums deferred to the step) ----------
    # The stable (Woodbury) scheme of `backend/schur.py`: the motion factor
    # in square-root form; slot s <-> the factor with current frame
    # start + s, the ghost slot S (owned by the right neighbour) supplies
    # s and R for the boundary quantities.
    mi_proxy = SimpleNamespace(motion_init=w.motion_init, motion_valid=w.motion_valid)

    def build_fn(v, sqrt_w, res0):
        X, Pm, sp, dp = v["X"], v[pk], v["sp"], v["dp"]
        r_anchor, r_odo, r_static, r_dyn, r_stiff = res0[:5]
        dp_l, dp_r = res0[-2], res0[-1]
        wgt_static = sqrt_w[2] ** 2 * static_obs_loc.to(dtype)
        wgt_dyn = sqrt_w[3] ** 2 * dyn_obs.to(dtype)
        sqw_t = sqrt_w[4] * tern_ext.to(dtype)                    # (S+1, ndl)
        wt = sqw_t ** 2

        # anchor and odometry: replicated camera blocks
        wgt_odo = masks.odometry[1:].to(dtype)
        Ja, Jb = _between_jacobians(X[:-1], X[1:], odo_meas, pose_sigma)
        J_anchor = _anchor_jacobian(X[0], anchor, cfg)
        diag = (_place(torch.einsum("k,kra,krb->kab", wgt_odo, Ja, Ja), 0, 1)
                + _place(torch.einsum("k,kra,krb->kab", wgt_odo, Jb, Jb), 1, 0)
                + _place((J_anchor.T @ J_anchor)[None], 0, W_ - 1))
        Hcc0 = _band_blocks(diag, torch.einsum("k,kra,krb->kab", wgt_odo, Ja, Jb))
        g_cam0 = (_place(torch.einsum("k,kra,kr->ka", wgt_odo, Ja, r_odo), 0, 1)
                  + _place(torch.einsum("k,kra,kr->ka", wgt_odo, Jb, r_odo), 1, 0)
                  + _place((J_anchor.T @ r_anchor[0])[None], 0, W_ - 1))

        dp_cur = torch.cat([dp, dp_r[None]], dim=0)
        Pp = pad_pose(Pm)
        if updater == 0:
            Jsa, Jsb = _between_jacobians(Pm[:-1], Pm[1:], se3_identity((), dtype, dev), smooth_sigma)
            Dmm_sm, Omm1, g_mot_sm = _pair_blocks(masks.smoothing[1:].to(dtype), Jsa, Jsb, res0[5])
            Omm2 = Dmm_sm.new_zeros((max(W_ - 2, 0), O, 6, 6))
            Hk = select_rows(Pp, start, S + 1)
            y = torch.einsum("...ba,...b->...a", Hk.R, dp_cur - Hk.t)      # H^-1 m_cur
            G_ext = torch.cat([-so3_hat(y), eye3.expand(*y.shape, 3)], dim=-1)
            st_R = Hk.R
        else:
            r_kin = res0[6] if cfg.use_object_kinematic_factor else None
            Dmm_sm, Omm1, Omm2, g_mot_sm = _pose_direct_blocks(Pm, mi_proxy, masks, cfg, res0[5], r_kin)
            dp_prev = torch.cat([dp_l[None], dp], dim=0)
            Lpv, Lcv = select_rows(Pp, start - 1, S + 1), select_rows(Pp, start, S + 1)
            st_R = Lcv.R @ Lpv.R.transpose(-1, -2)                         # rel = L_cur L_prev^-1
            q = torch.einsum("...ba,...b->...a", Lpv.R, dp_prev - Lpv.t)   # L_prev^-1 m_prev
            G_ext = torch.cat([-(Lcv.R @ so3_hat(q)), Lcv.R], dim=-1)

        X_loc = X[fsl]
        Jx_s, Jp_s = _pose_point_jacobians(X_loc, sp[None].expand(S, *sp.shape), sig_s)
        Jx_d, Jp_d = _pose_point_jacobians(X_loc, dp, sig_d)
        T_loc = wt[:S] / sig_t ** 2
        dd_t = torch.einsum("kd,kdo,kda->koa", T_loc, oh_loc, torch.sum(G_ext[:S] ** 2, dim=2))
        Hll_s, Us, b_sp = _static_blocks(wgt_static, Jx_s, Jp_s, r_static)
        return {
            "part": {
                "Dcam": embed(torch.einsum("kn,knra,knrb->kab", wgt_dyn, Jx_d, Jx_d)
                              + torch.einsum("kn,knra,knrb->kab", wgt_static, Jx_s, Jx_s)),
                "g_pts": embed(torch.einsum("kn,knra,knr->ka", wgt_dyn, Jx_d, r_dyn)
                               + torch.einsum("kn,knra,knr->ka", wgt_static, Jx_s, r_static)),
                # the motion factor's share of the pose diagonal (damping only)
                "ddiag_t": embed(dd_t) if updater == 0 else embed(dd_t, -1) + embed(dd_t),
            },
            "loc": {
                "Hll_s": Hll_s, "Us": Us, "b_sp": b_sp,
                "ch_c": wgt_dyn / sig_d ** 2 + tiny, "ch_T": T_loc, "ch_Tn": wt[1:] / sig_t ** 2,
                "Rc": torch.einsum("kd,kra,kdrb->kdab", wgt_dyn, Jp_d, Jx_d),
                "b_dp": -torch.einsum("kd,kra,kdr->kda", wgt_dyn, Jp_d, r_dyn),
                "st_s": sqw_t / sig_t, "st_R": st_R, "st_G": G_ext, "st_phi": sqw_t[..., None] * r_stiff,
            },
            "repl": {"Hcc0": Hcc0, "g_cam0": g_cam0, "Dmm_sm": Dmm_sm, "Omm1": Omm1, "Omm2": Omm2,
                     "g_mot_sm": g_mot_sm},
        }

    # ---- step: Woodbury elimination, SPIKE chains, one packed sum --------
    def step_fn(sys, lam):
        loc, repl = sys["loc"], sys["repl"]
        floor = lm_cfg.diag_floor
        alpha_z = loc["ch_c"] + loc["ch_T"] + loc["ch_Tn"]
        inv_c = 1.0 / (loc["ch_c"] + lam * torch.clamp(alpha_z, min=floor))

        # static family: the frame sums of the landmark blocks and the
        # coupling rows (this block's rows embedded) in one all_reduce
        Us_loc = loc["Us"]                                          # (S, nsl, 6, 3)
        nsl = Us_loc.shape[1]
        if F > 1:
            red = all_reduce_packed({"Hll": loc["Hll_s"], "b_sp": loc["b_sp"], "Us": embed(Us_loc)}, chain.group)
            # `_static_blocks` adds its tiny floor once per rank: keep one
            Hll, b_sp, Us = red["Hll"] - (F - 1) * tiny * eye3, red["b_sp"], red["Us"]
        else:
            Hll, b_sp, Us = loc["Hll_s"], loc["b_sp"], Us_loc
        Us_cols = Us.transpose(-1, -2).permute(1, 2, 0, 3).reshape(nsl, 3, nc)
        Ys = _inv3(_damp_blocks(Hll, lam, floor)) @ torch.cat([Us_cols, b_sp[..., None]], dim=-1)
        Yc_s, yb_s = Ys[..., :nc], Ys[..., nc]
        d_cc_s = torch.einsum("knam,nmq->kaq", Us_loc, Yc_s)         # this block's camera rows
        d_bc_s = torch.einsum("knam,nm->ka", Us_loc, yb_s)

        s_ext = loc["st_s"]
        s_loc = s_ext[:S]
        Rt_ext = loc["st_R"].transpose(-1, -2)
        Rt_loc = Rt_ext[:S]
        RcC = loc["Rc"] * inv_c[..., None, None]                    # (S, ndl, 3, 6)
        bzoC = loc["b_dp"] * inv_c[..., None]
        ndl = s_ext.shape[1]

        # left ghosts: the previous block's last-row chain quantities
        gbuf = torch.cat([RcC[-1].reshape(ndl, 18), bzoC[-1], inv_c[-1][:, None], s_ext[S - 1][:, None],
                          Rt_ext[S - 1].reshape(ndl, 9)], dim=-1)
        gl, _ = exchange(chain.group, chain.left, chain.right, to_right=gbuf)
        RcC_prev = torch.cat([gl[:, :18].reshape(1, ndl, 3, 6), RcC[:-1]], dim=0)
        bzoC_prev = torch.cat([gl[None, :, 18:21], bzoC[:-1]], dim=0)
        inv_c_prev = torch.cat([gl[None, :, 21], inv_c[:-1]], dim=0)
        s_prev = torch.cat([gl[None, :, 22], s_loc[:-1]], dim=0)
        R_prevT = torch.cat([gl[:, 23:32].reshape(1, ndl, 3, 3), Rt_loc[:-1]], dim=0)

        # capacitance chain M (`schur.schur_step`, the stable branch)
        alpha_M = 1.0 + s_loc * s_loc * (inv_c_prev + inv_c)
        Bcol = s_loc[..., None, None] * loc["st_G"][:S]
        Bcol_k = (Bcol[:, :, :, None, :] * eye_rows[:, None, None, :, None]).reshape(S, ndl, 3, nc)
        coef = -(s_prev * s_loc * inv_c_prev)[..., None, None]
        b_next_coef = -(s_ext[S - 1] * s_ext[S] * inv_c[-1])[..., None, None]
        if updater == 0:
            B_M = coef * R_prevT
            b_next = b_next_coef * Rt_ext[S - 1]
            AU_prev = s_loc[..., None, None] * RcC_prev
            AU_cur = -s_loc[..., None, None] * (Rt_loc @ RcC)
            phi_hat = s_loc[..., None] * (bzoC_prev - torch.einsum("kdab,kdb->kda", Rt_loc, bzoC)) + loc["st_phi"][:S]
            Bcol_nc = Bcol_k
        else:
            R_loc = loc["st_R"][:S]
            B_M = coef * Rt_loc
            b_next = b_next_coef * Rt_ext[S]
            AU_prev = -s_loc[..., None, None] * (R_loc @ RcC_prev)
            AU_cur = s_loc[..., None, None] * RcC
            phi_hat = s_loc[..., None] * (bzoC - torch.einsum("kdab,kdb->kda", R_loc, bzoC_prev)) + loc["st_phi"][:S]
            Bcol_nc = (Bcol[:, :, :, None, :] * dn_rows[:, None, None, :, None]).reshape(S, ndl, 3, nc) - Bcol_k
        AU_nc = (AU_prev[:, :, :, None, :] * dn_rows[:, None, None, :, None]
                 + AU_cur[:, :, :, None, :] * eye_rows[:, None, None, :, None]).reshape(S, ndl, 3, nc)
        rhs_M = torch.cat([AU_nc, Bcol_nc, phi_hat[..., None]], dim=-1)
        if F > 1:
            Z = spike_chain_solve_local(None, B_M, rhs_M, chain, alpha=alpha_M, b_next=b_next)
        else:
            Z = chain_solve_scalar(alpha_M, B_M, rhs_M)
        Z_U = Z[..., :nc]
        Nh = Z[..., nc:2 * nc].reshape(S, ndl, 3, W_, 6)
        Z_phi = Z[..., -1]

        dcc_diag = torch.einsum("kdia,kd,kdib->kab", loc["Rc"], inv_c, loc["Rc"])
        d_cc1 = (dcc_diag[:, :, None, :] * eye_rows[:, None, :, None]).reshape(S, 6, nc)
        d_cc2 = AU_nc.reshape(-1, nc).T @ Z_U.reshape(-1, nc)
        d_bc1 = torch.einsum("kdia,kdi->ka", loc["Rc"], bzoC)
        d_bc2 = torch.einsum("kdic,kdi->c", AU_nc, Z_phi)

        Rdot = (Nh * act_full_T[None, :, None, :, None]).reshape(S, ndl, 3, nc)
        C_hh = _couple(Bcol, oh_loc, Rdot)
        bphi = torch.einsum("kdia,kdi,kdo->koa", Bcol, Z_phi, oh_loc)
        if updater == 0:
            d_mm, d_bm = -embed(C_hh), embed(bphi)
        else:
            # B~'s rows live at pose frames k-1 (+) and k (-)
            d_mm, d_bm = embed(C_hh) - embed(C_hh, -1), embed(bphi, -1) - embed(bphi)
        pkd = all_reduce_packed({
            **sys["part"],
            "d_cc": embed(d_cc1 + d_cc_s).reshape(nc, nc) - d_cc2,
            "d_bc": embed(d_bc1 + d_bc_s).reshape(nc) - d_bc2,
            "d_cm": embed(_couple(AU_cur, oh_loc, Rdot)) + embed(_couple(AU_prev, oh_loc, Rdot), -1),
            "d_mm": d_mm, "d_bm": d_bm,
        })

        # replicated assembly and Cholesky (the same on every rank)
        eyeW = torch.eye(W_, dtype=dtype, device=dev)
        eye6 = torch.eye(6, dtype=dtype, device=dev)
        Hcc = repl["Hcc0"] + torch.einsum("kab,kl->kalb", pkd["Dcam"], eyeW)
        cam_diag = torch.diagonal(torch.diagonal(Hcc, dim1=0, dim2=2), dim1=0, dim2=1)
        Hcc = Hcc + torch.einsum("ka,kl,ab->kalb", lam * torch.clamp(cam_diag, min=floor), eyeW, eye6)
        diag_full = torch.diagonal(repl["Dmm_sm"], dim1=-2, dim2=-1) + pkd["ddiag_t"]
        Dmm = repl["Dmm_sm"] + torch.diag_embed(lam * torch.clamp(diag_full, min=floor))
        d_cm = pkd["d_cm"].permute(0, 2, 3, 1, 4).reshape(nc, W_, O, 6)
        proxy = SimpleNamespace(Omm1=repl["Omm1"], Omm2=repl["Omm2"], b_cam=-(repl["g_cam0"] + pkd["g_pts"]),
                                b_mot=-repl["g_mot_sm"])
        Hred, bred = assemble_reduced(proxy, Hcc, Dmm, pkd["d_cc"], pkd["d_bc"], d_cm, pkd["d_mm"], pkd["d_bm"])
        L, info = torch.linalg.cholesky_ex(Hred)
        sol = torch.cholesky_solve(bred[:, None], L)[:, 0]
        delta_p = torch.where(info == 0, sol, torch.full_like(sol, float("nan")))
        dc = delta_p[:nc]
        dm = delta_p[nc:].reshape(W_, O, 6)

        # back-substitution (one ghost exchange: the right block's first v row)
        d_sp = yb_s - torch.einsum("nmq,q->nm", Yc_s, dc)
        dm_sel = torch.einsum("gdo,gob->gdb", onehot_full, dm)
        v = Z_phi - torch.einsum("kdic,c->kdi", Z_U, dc) + torch.einsum("kdigb,gdb->kdi", Nh, dm_sel)
        _, v_r = exchange(chain.group, chain.left, chain.right, to_left=v[0])
        v_next = torch.cat([v[1:], v_r[None]], dim=0)
        s_next = s_ext[1:]
        if updater == 0:
            Atv = -s_loc[..., None] * torch.einsum("kdab,kdb->kda", loc["st_R"][:S], v) + s_next[..., None] * v_next
        else:
            Atv = s_loc[..., None] * v - s_next[..., None] * torch.einsum("kdab,kdb->kda", Rt_ext[1:], v_next)
        r1 = loc["b_dp"] - torch.einsum("kdia,ka->kdi", loc["Rc"], dc.reshape(W_, 6)[fsl])
        d_dp = (r1 - Atv) * inv_c[..., None]
        return {"X": dc.reshape(W_, 6), "P": dm, "sp": d_sp, "dp": d_dp}

    return lm_optimize_schur(values, None, None, cfg, lm_cfg, anchor, formulation=updater,
                             overrides={"residual_fn": residual_fn, "error_fn": error_fn,
                                        "build_fn": build_fn, "step_fn": step_fn})
