"""Direct block-eliminated LM for "N small blocks + one global" problems
(port of `dynosam_tpu/backend/small_schur.py`).

Each residual row i couples only track i's block variables (flow (2,) or a
landmark pair (6,)) with one global SE3.  The damped normal equations are
solved exactly per LM iteration by per-track elimination:

    S  = V - sum_i W_i^T U_i^-1 W_i,   dg = S^-1 (gg - sum_i W_i^T U_i^-1 gb_i)
    db_i = U_i^-1 (gb_i - W_i dg)      (signs as in the JAX package)

The port runs a leading batch dimension B of independent problems (the JAX
package `vmap`s the ego and per-object refiners into one batch).  The LM
loop keeps the JAX `while_loop` semantics per problem: a problem whose
loop condition is false keeps its state while the others iterate.
Jacobians come from the caller's closed forms (`jacobian_fn`).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..core.lie import SE3, se3_retract, se3_where
from ..ops.linalg import inv_spd
from ..ops.robust import robust_sqrt_weights
from .solver import LMConfig, LMResult, RobustSpec, total_error


def _sel(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-problem select: mask (B,) against tensors with leading B."""
    return torch.where(mask.reshape(-1, *([1] * (a.dim() - 1))), a, b)


def lm_optimize_eliminated(
    residual_fn: Callable,
    specs: Sequence[RobustSpec],
    values: dict,
    cfg: LMConfig,
    block_keys: Sequence[str],
    glob_key: str,
    jacobian_fn: Callable,
) -> LMResult:
    """LM over `values` = {block keys: (B, N, d_k) tensors, glob_key: SE3 (B,)}.

    `residual_fn(values)` returns a list of (B, N, d_r) residuals (whitened,
    masked); `jacobian_fn(values)` returns (B_list, G_list) with
    B_list[r] (B, N, d_r, b) w.r.t. the concatenated block tangent and
    G_list[r] (B, N, d_r, 6) w.r.t. the global's right-retraction tangent.
    Outer loop as in the JAX package: IRLS weights frozen per
    linearisation, accept/reject on the robust cost, linearisation reused
    after a rejected step, non-finite trial errors rejected."""
    specs = tuple(specs)
    block_keys = tuple(block_keys)
    blocks0 = {k: values[k] for k in block_keys}
    glob0 = values[glob_key]
    first = blocks0[block_keys[0]]
    bsz, n = first.shape[0], first.shape[1]
    dims = [blocks0[k].shape[-1] for k in block_keys]
    b = sum(dims)
    g = 6
    dtype, dev = first.dtype, first.device

    def res_of(blocks, glob):
        return residual_fn({**blocks, glob_key: glob})

    def err_of(res):
        return total_error(res, specs, batch_dims=1)

    def linearize(blocks, glob, res0):
        sqrt_w = [
            robust_sqrt_weights(r, s.k, s.kind) if s.kind != "none"
            else torch.ones(r.shape[:-1], dtype=r.dtype, device=r.device)
            for r, s in zip(res0, specs)
        ]
        B_list, G_list = jacobian_fn({**blocks, glob_key: glob})
        wr0 = torch.cat([w[..., None] * r for w, r in zip(sqrt_w, res0)], dim=-1)
        Bm = torch.cat([w[..., None, None] * jb for w, jb in zip(sqrt_w, B_list)], dim=2)
        Gm = torch.cat([w[..., None, None] * jg for w, jg in zip(sqrt_w, G_list)], dim=2)
        # broadcast multiply + sum: the contractions are tiny (D <= 7)
        U = torch.sum(Bm[..., :, :, None] * Bm[..., :, None, :], dim=2)      # (B, N, b, b)
        Wm = torch.sum(Bm[..., :, :, None] * Gm[..., :, None, :], dim=2)     # (B, N, b, g)
        V = torch.sum(Gm[..., :, :, None] * Gm[..., :, None, :], dim=(1, 2))  # (B, g, g)
        gb = torch.sum(Bm * wr0[..., None], dim=2)                           # (B, N, b)
        gg = torch.sum(Gm * wr0[..., None], dim=(1, 2))                      # (B, g)
        return U, Wm, V, gb, gg

    eye_b = torch.eye(b, dtype=dtype, device=dev)
    eye_g = torch.eye(g, dtype=dtype, device=dev)

    def step(lin, lam, floor):
        U, Wm, V, gb, gg = lin
        lam_t = lam.to(dtype)
        du = torch.diagonal(U, dim1=-2, dim2=-1)                              # (B, N, b)
        U_d = U + (lam_t[:, None, None] * torch.clamp(du, min=floor) + 1e-8)[..., :, None] * eye_b
        dv = torch.diagonal(V, dim1=-2, dim2=-1)                              # (B, g)
        V_d = V + (lam_t[:, None] * torch.clamp(dv, min=floor) + 1e-8)[..., :, None] * eye_g
        Ui = inv_spd(U_d)                                                    # (B, N, b, b)
        # WtUi[g, c] = sum_b Wm[b, g] Ui[b, c]
        WtUi = torch.sum(Wm[..., :, :, None] * Ui[..., :, None, :], dim=-3)   # (B, N, g, b)
        S = V_d - torch.sum(WtUi[..., :, :, None] * Wm[..., None, :, :], dim=(1, 3))
        rhs = gg - torch.sum(WtUi * gb[..., None, :], dim=(1, 3))
        dg = -torch.sum(inv_spd(S) * rhs[:, None, :], dim=-1)                # (B, g)
        t1 = gb + torch.sum(Wm * dg[:, None, None, :], dim=-1)               # (B, N, b)
        db = -torch.sum(Ui * t1[..., None, :], dim=-1)                       # (B, N, b)
        return db, dg

    def split(db):
        out, o = {}, 0
        for k, d in zip(block_keys, dims):
            out[k] = db[..., o:o + d]
            o += d
        return out

    res_c = list(res_of(blocks0, glob0))
    err_init = err_of(res_c)
    blocks, glob = dict(blocks0), glob0
    err = err_init
    lam = torch.full((bsz,), cfg.initial_lambda, dtype=torch.float32, device=dev)
    it = torch.zeros((bsz,), dtype=torch.int32, device=dev)
    done = torch.zeros((bsz,), dtype=torch.bool, device=dev)
    rebuild = torch.ones((bsz,), dtype=torch.bool, device=dev)
    lin_c = None
    for _ in range(cfg.max_iterations):
        run = (it < cfg.max_iterations) & ~done
        if not bool(run.any()):
            break
        lin_new = linearize(blocks, glob, res_c)
        lin = lin_new if lin_c is None else tuple(
            _sel(rebuild, a, c) for a, c in zip(lin_new, lin_c)
        )
        db, dg = step(lin, lam, cfg.diag_floor)
        new_blocks = {k: blocks[k] + v for k, v in split(db).items()}
        new_glob = se3_retract(glob, dg)
        new_res = list(res_of(new_blocks, new_glob))
        new_err = err_of(new_res)
        new_err = torch.where(torch.isfinite(new_err), new_err, torch.full_like(new_err, float("inf")))
        accept = new_err < err

        blocks_out = {k: _sel(accept, new_blocks[k], blocks[k]) for k in block_keys}
        glob_out = se3_where(accept, new_glob, glob)
        res_out = [_sel(accept, a, c) for a, c in zip(new_res, res_c)]
        err_out = torch.where(accept, new_err, err)
        lam_out = torch.where(
            accept,
            torch.clamp(lam / cfg.lambda_factor, min=cfg.min_lambda),
            torch.clamp(lam * cfg.lambda_factor, max=cfg.max_lambda),
        )
        rel_ok = torch.abs(err - err_out) < cfg.rel_error_tol * torch.clamp(err, min=1e-30)
        abs_ok = torch.abs(err - err_out) < cfg.abs_error_tol
        done_out = (accept & (rel_ok | abs_ok)) | (lam_out >= cfg.max_lambda)

        # problems whose loop already ended keep their state
        blocks = {k: _sel(run, blocks_out[k], blocks[k]) for k in block_keys}
        glob = se3_where(run, glob_out, glob)
        res_c = [_sel(run, a, c) for a, c in zip(res_out, res_c)]
        lin_c = lin if lin_c is None else tuple(_sel(run, a, c) for a, c in zip(lin, lin_c))
        rebuild = torch.where(run, accept, rebuild)
        lam = torch.where(run, lam_out, lam)
        err = torch.where(run, err_out, err)
        it = torch.where(run, it + 1, it)
        done = torch.where(run, done_out, done)
    return LMResult(
        values={**blocks, glob_key: glob},
        error=err,
        initial_error=err_init,
        iterations=it,
        lam=lam,
        converged=done,
    )
