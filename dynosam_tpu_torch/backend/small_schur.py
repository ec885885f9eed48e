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

from typing import Callable, NamedTuple, Sequence

import torch

from ..core.lie import SE3, se3_retract, se3_where
from ..ops.linalg import inv_spd
from ..ops.robust import robust_sqrt_weights
from .solver import LMConfig, LMResult, RobustSpec, total_error


def _sel(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-problem select: mask (B,) against tensors with leading B."""
    return torch.where(mask.reshape(-1, *([1] * (a.dim() - 1))), a, b)


class EliminatedProblem(NamedTuple):
    """The pieces of one `lm_optimize_eliminated` problem that are not
    device state: `residual_fn(values)` and `jacobian_fn(values)` as
    there, the robust kinds, the LM settings and the keys."""

    residual_fn: Callable
    jacobian_fn: Callable
    specs: tuple
    cfg: LMConfig
    block_keys: tuple
    glob_key: str


def _split_values(values: dict, p: EliminatedProblem):
    return {k: values[k] for k in p.block_keys}, values[p.glob_key]


def lm_head(values: dict, p: EliminatedProblem) -> dict:
    """The LM state before the first iteration: blocks, global, residuals,
    error, lambda, counters and flags; `run` (B,) marks the problems the
    next iteration advances and `more` (0-d) whether any does, the flag
    the host loop reads."""
    blocks, glob = _split_values(values, p)
    first = blocks[p.block_keys[0]]
    bsz, dev = first.shape[0], first.device
    res_c = list(p.residual_fn({**blocks, p.glob_key: glob}))
    err = total_error(res_c, p.specs, batch_dims=1)
    s = dict(blocks=blocks, glob=glob, res=res_c, err=err, err_init=err,
             lam=torch.full((bsz,), p.cfg.initial_lambda, dtype=torch.float32, device=dev),
             it=torch.zeros((bsz,), dtype=torch.int32, device=dev),
             done=torch.zeros((bsz,), dtype=torch.bool, device=dev),
             rebuild=torch.ones((bsz,), dtype=torch.bool, device=dev))
    return _with_flags(s, p)


def _with_flags(s: dict, p: EliminatedProblem) -> dict:
    run = (s["it"] < p.cfg.max_iterations) & ~s["done"]
    return {**s, "run": run, "more": run.any()}


def lm_iteration(s: dict, p: EliminatedProblem, first: bool) -> dict:
    """One LM iteration over the problems `s["run"]` marks (the others keep
    their state); `first`: the iteration after `lm_head`, which has no
    earlier linearisation to fall back on."""
    cfg, specs, block_keys = p.cfg, p.specs, p.block_keys
    blocks, glob, res_c, err, lam, run = s["blocks"], s["glob"], s["res"], s["err"], s["lam"], s["run"]
    dims = [blocks[k].shape[-1] for k in block_keys]
    b = sum(dims)
    g = 6
    dtype, dev = blocks[block_keys[0]].dtype, blocks[block_keys[0]].device

    def res_of(blk, gl):
        return p.residual_fn({**blk, p.glob_key: gl})

    def linearize(blk, gl, res0):
        sqrt_w = [
            robust_sqrt_weights(r, sp.k, sp.kind) if sp.kind != "none"
            else torch.ones(r.shape[:-1], dtype=r.dtype, device=r.device)
            for r, sp in zip(res0, specs)
        ]
        B_list, G_list = p.jacobian_fn({**blk, p.glob_key: gl})
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

    lin_new = linearize(blocks, glob, res_c)
    lin_c = None if first else s["lin"]
    lin = lin_new if lin_c is None else tuple(
        _sel(s["rebuild"], a, c) for a, c in zip(lin_new, lin_c)
    )
    db, dg = step(lin, lam, cfg.diag_floor)
    new_blocks = {k: blocks[k] + v for k, v in split(db).items()}
    new_glob = se3_retract(glob, dg)
    new_res = list(res_of(new_blocks, new_glob))
    new_err = total_error(new_res, specs, batch_dims=1)
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
    return _with_flags(dict(
        blocks={k: _sel(run, blocks_out[k], blocks[k]) for k in block_keys},
        glob=se3_where(run, glob_out, glob),
        res=[_sel(run, a, c) for a, c in zip(res_out, res_c)],
        err=torch.where(run, err_out, err),
        err_init=s["err_init"],
        lam=torch.where(run, lam_out, lam),
        it=torch.where(run, s["it"] + 1, s["it"]),
        done=torch.where(run, done_out, s["done"]),
        rebuild=torch.where(run, accept, s["rebuild"]),
        lin=lin if lin_c is None else tuple(_sel(run, a, c) for a, c in zip(lin, lin_c)),
    ), p)


def lm_result(s: dict, p: EliminatedProblem) -> LMResult:
    return LMResult(
        values={**s["blocks"], p.glob_key: s["glob"]},
        error=s["err"],
        initial_error=s["err_init"],
        iterations=s["it"],
        lam=s["lam"],
        converged=s["done"],
    )


def lm_schedule(run: Callable, more: Callable, max_iterations: int) -> None:
    """The LM's host loop after its head: up to `max_iterations` times,
    read the `more` flag and stop when it is false, else run one iteration
    (`run(first)`).  Eager or as CUDA graph replays
    (`frontend/frontend.py:_FrameGraphs`)."""
    for i in range(max_iterations):
        if not more():
            break
        run(i == 0)


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
    after a rejected step, non-finite trial errors rejected.  The host
    reads one flag per iteration (`lm_head`, `lm_iteration`,
    `lm_schedule`)."""
    p = EliminatedProblem(residual_fn, jacobian_fn, tuple(specs), cfg, tuple(block_keys), glob_key)
    s = lm_head(values, p)

    def run(first):
        s.update(lm_iteration(s, p, first))

    lm_schedule(run, lambda: bool(s["more"]), cfg.max_iterations)
    return lm_result(s, p)
