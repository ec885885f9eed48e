"""Levenberg-Marquardt over manifold value dicts (port of
`dynosam_tpu/backend/solver.py`): the blocks the frontend refiners and the
direct-Schur window solve share, and the LM-PCG engine of long windows and
full-batch solves.

Values are dicts of tensors and `SE3` leaves; SE3 leaves retract on the
manifold with 6-dof tangents, plain tensors add.

The JAX LM-PCG builds ``J^T W J v`` as ``vjp(jvp(v))`` from
`jax.linearize` once per LM iteration.  Here the caller's `normal_fn`
builds the family Jacobian blocks in closed form once per linearisation
and returns the product and the gradient ``g = J^T W r``; the PCG runs on
the tangent raveled into one vector (as `jax.flatten_util` would) in
chunks of `PCG_CHUNK` iterations, frozen on the device once its exit test
fails, so the host reads once per chunk and the LM once per iteration.

Without an analytic diagonal (`gn_diag_fn=None`, the varpro solve) the
damping and the preconditioner come from Hutchinson's estimate over
Rademacher probes, which the caller passes in or which a `torch.Generator`
draws (the JAX package draws them from `fold_in(PRNGKey(seed), it)`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import torch

from ..core.lie import SE3, se3_retract
from ..ops.robust import robust_sqrt_weights


class RobustSpec(NamedTuple):
    """Robust kernel of one residual family."""

    kind: str = "none"   # none | huber | tukey | cauchy
    k: float = 1.0


def robust_loss(r: torch.Tensor, spec: RobustSpec) -> torch.Tensor:
    """rho(|r|) per factor block (...,): the quantity gtsam sums as error."""
    sq = torch.sum(r * r, dim=-1)
    if spec.kind == "none":
        return 0.5 * sq
    norm = torch.sqrt(torch.clamp(sq, min=1e-30))
    k2 = spec.k * spec.k
    if spec.kind == "huber":
        return torch.where(norm <= spec.k, 0.5 * sq, spec.k * norm - 0.5 * k2)
    if spec.kind == "cauchy":
        return 0.5 * k2 * torch.log1p(sq / k2)
    if spec.kind == "tukey":
        inside = (k2 / 6.0) * (1.0 - (1.0 - sq / k2) ** 3)
        return torch.where(norm <= spec.k, inside, torch.full_like(inside, k2 / 6.0))
    raise ValueError(spec.kind)


def total_error(residuals: Sequence[torch.Tensor], specs: Sequence[RobustSpec], batch_dims: int = 0):
    """Sum of robust losses over all families; the first `batch_dims` axes
    of every residual are kept (independent problems)."""
    total = None
    for r, s in zip(residuals, specs):
        loss = robust_loss(r, s)
        e = loss.reshape(*loss.shape[:batch_dims], -1).sum(-1)
        total = e if total is None else total + e
    return total


def sqrt_weights(res: list, specs) -> list:
    """IRLS square-root weights of each family at its residuals."""
    return [robust_sqrt_weights(r, s.k, s.kind) if s.kind != "none"
            else torch.ones(r.shape[:-1], dtype=r.dtype, device=r.device)
            for r, s in zip(res, specs)]


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
    cg_iterations: Optional[list] = None   # LM-PCG: CG iterations of each LM iteration


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


def tree_add(a, b):
    return {k: a[k] + b[k] for k in a} if isinstance(a, dict) else a + b


def tree_sub(a, b):
    return {k: a[k] - b[k] for k in a} if isinstance(a, dict) else a - b


def tree_scale(a, s):
    return {k: v * s for k, v in a.items()} if isinstance(a, dict) else a * s


def tree_mul(a, b):
    return {k: a[k] * b[k] for k in a}


def tree_dot(a, b):
    if isinstance(a, dict):
        return sum(torch.sum(a[k] * b[k]) for k in a)
    return torch.sum(a * b)


class Raveler:
    """Tangent dict <-> one flat vector, leaves in dict order (the layout
    of `jax.flatten_util.ravel_pytree` for a flat dict)."""

    def __init__(self, template: dict):
        self.keys = list(template)
        self.shapes = [template[k].shape for k in self.keys]
        self.sizes = [template[k].numel() for k in self.keys]

    def ravel(self, d: dict) -> torch.Tensor:
        return torch.cat([d[k].reshape(-1) for k in self.keys])

    def unravel(self, v: torch.Tensor) -> dict:
        return {k: x.view(s) for k, x, s in zip(self.keys, torch.split(v, self.sizes), self.shapes)}


# --------------------------------------------------------------------------
# PCG
# --------------------------------------------------------------------------

PCG_CHUNK = 8


def pcg(A_mv, b, M_inv_mv, x0, max_iters: int, tol: float):
    """Preconditioned CG (tensors or dicts of tensors).  Returns (x, n_iters,
    final |r|^2), n_iters a 0-d int32 tensor.

    The JAX `while_loop` tests ``(i < max_iters) & (|r|^2 > thr) & (gamma >
    0)`` before every body.  Here each iteration evaluates that test on the
    device and keeps x, r, z, p, gamma and i where it fails, so the result,
    iteration count included, is the loop's own; the host reads the test
    once per `PCG_CHUNK` iterations to stop early."""
    r = tree_sub(b, A_mv(x0))
    z = M_inv_mv(r)
    gamma = tree_dot(r, z)
    threshold = tol * tol * torch.clamp(tree_dot(b, b), min=1e-30)
    x, p = x0, z
    i = torch.zeros((), dtype=torch.int32, device=gamma.device)

    def keep(act, new, old):
        if isinstance(new, dict):
            return {k: torch.where(act, new[k], old[k]) for k in new}
        return torch.where(act, new, old)

    def running():
        return (i < max_iters) & (tree_dot(r, r) > threshold) & (gamma > 0)

    done = 0
    while done < max_iters:
        for _ in range(min(PCG_CHUNK, max_iters - done)):
            act = running()
            Ap = A_mv(p)
            alpha = gamma / torch.clamp(tree_dot(p, Ap), min=1e-30)
            x_n = tree_add(x, tree_scale(p, alpha))
            r_n = tree_sub(r, tree_scale(Ap, alpha))
            z_n = M_inv_mv(r_n)
            gamma_n = tree_dot(r_n, z_n)
            beta = gamma_n / torch.clamp(gamma, min=1e-30)
            p_n = tree_add(z_n, tree_scale(p, beta))
            x, r, z, p = keep(act, x_n, x), keep(act, r_n, r), keep(act, z_n, z), keep(act, p_n, p)
            gamma = torch.where(act, gamma_n, gamma)
            i = i + act.to(torch.int32)
        done += PCG_CHUNK
        if done >= max_iters or not bool(running()):     # the chunk's one host read
            break
    return x, i, tree_dot(r, r)


HUTCHINSON_PROBES = 8      # the JAX package's n_samples


def rademacher_probes(template: dict, n_samples: int, generator: torch.Generator) -> list:
    """`n_samples` tangent dicts shaped as `template`, entries +-1 drawn
    from `generator`."""
    return [{k: (torch.randint(0, 2, v.shape, generator=generator, device=v.device) * 2 - 1).to(v.dtype)
             for k, v in template.items()} for _ in range(n_samples)]


def hutchinson_diag(A_mv: Callable, probes: Sequence[dict]) -> dict:
    """Stochastic estimate of diag(A): the mean of z * A z over the
    Rademacher probes z (tangent dicts)."""
    acc = None
    for z in probes:
        t = tree_mul(z, A_mv(z))
        acc = t if acc is None else tree_add(acc, t)
    return tree_scale(acc, 1.0 / len(probes))


# --------------------------------------------------------------------------
# Levenberg-Marquardt (LM-PCG)
# --------------------------------------------------------------------------


def lm_optimize(residual_fn: Callable, specs: Sequence[RobustSpec], values: dict, cfg: LMConfig, *,
                normal_fn: Callable, gn_diag_fn: Optional[Callable] = None,
                probes: Optional[Callable] = None, generator: Optional[torch.Generator] = None,
                error_fn: Optional[Callable] = None) -> LMResult:
    """Minimise sum_f rho_f(|r_f(x)|) over the manifold dict `values`.

    residual_fn(values) -> list of whitened, mask-zeroed residuals, one per
    family of `specs`; normal_fn(values, sqrt_w, residuals) -> (JtJ_mv, g):
    the product d -> J^T W J d on tangent dicts and g = J^T W r, at
    `values` with the IRLS weights frozen; gn_diag_fn(values, sqrt_w) ->
    diag(J^T W J) as a tangent dict (damping and Jacobi preconditioner).
    Without `gn_diag_fn` the diagonal is `hutchinson_diag` of J^T W J
    over the probes of LM iteration `it`: `probes(it)` (a list of tangent
    dicts), else `HUTCHINSON_PROBES` drawn from `generator` (a fresh one
    seeded 0 when None), drawn anew each iteration as the JAX package
    does.

    The loop is the JAX package's: accept on the true robust cost, lambda
    down by `lambda_factor` on accept and up on reject, gtsam-style
    convergence.  A rejected step keeps its linearisation (the JAX loop
    recomputes the same one).  The host reads the accept and done flags
    and the CG count once per LM iteration, besides PCG's reads.
    `error_fn(res)` replaces the robust total of the families (the
    distributed solve sums its ranks' shares)."""
    specs = tuple(specs)
    if error_fn is None:
        def error_fn(r):
            return total_error(r, specs)
    res = residual_fn(values)
    err = error_fn(res)
    err_init = err
    dev = err.device
    if gn_diag_fn is None and probes is None and generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    lam = torch.full((), cfg.initial_lambda, dtype=torch.float32, device=dev)
    vals, it, done, lin, cg_iters = values, 0, False, None, []
    rav = Raveler(zero_delta(values))

    def floored(d: dict) -> torch.Tensor:
        return rav.ravel({k: torch.clamp(torch.abs(v), min=cfg.diag_floor) for k, v in d.items()})

    while it < cfg.max_iterations and not done:
        if lin is None:
            sqrt_w = sqrt_weights(res, specs)
            JtJ_mv, g = normal_fn(vals, sqrt_w, res)
            lin = (JtJ_mv, -rav.ravel(g), None if gn_diag_fn is None else floored(gn_diag_fn(vals, sqrt_w)))
        JtJ_mv, b, diag = lin
        if diag is None:
            zs = probes(it) if probes is not None else rademacher_probes(zero_delta(vals), HUTCHINSON_PROBES, generator)
            diag = floored(hutchinson_diag(JtJ_mv, zs))
        delta, n_cg, _ = pcg(lambda d: rav.ravel(JtJ_mv(rav.unravel(d))) + lam * (diag * d), b,
                             lambda r: r / (diag * (1.0 + lam)), torch.zeros_like(b),
                             cfg.cg_max_iterations, cfg.cg_tol)
        new_vals = retract_tree(vals, rav.unravel(delta))
        new_res = residual_fn(new_vals)
        new_err = error_fn(new_res)
        accept = new_err < err
        err_out = torch.where(accept, new_err, err)
        lam_out = torch.where(accept, torch.clamp(lam / cfg.lambda_factor, min=cfg.min_lambda),
                              torch.clamp(lam * cfg.lambda_factor, max=cfg.max_lambda))
        change = torch.abs(err - err_out)
        converged = accept & ((change < cfg.rel_error_tol * torch.clamp(err, min=1e-30))
                              | (change < cfg.abs_error_tol))
        done_t = converged | (lam_out >= cfg.max_lambda)
        flags = torch.stack([accept.to(torch.int32), done_t.to(torch.int32), n_cg])
        accepted, done, n = flags.tolist()                  # the iteration's one host read
        done = bool(done)
        cg_iters.append(n)
        if accepted:
            vals, res, lin = new_vals, new_res, None
        err, lam, it = err_out, lam_out, it + 1
    return LMResult(values=vals, error=err, initial_error=err_init, iterations=it, lam=lam,
                    converged=done, cg_iterations=cg_iters)


# --------------------------------------------------------------------------
# Dense reference solver (tests / tiny problems)
# --------------------------------------------------------------------------


def dense_normal_solve(residual_fn: Callable, specs: Sequence[RobustSpec], values: dict, lam: float = 0.0):
    """One damped Gauss-Newton step solved densely, J built by
    `torch.func.jacfwd` (O(n^2) memory): the oracle the matrix-free and
    Schur steps are checked against.  Returns (retracted values, J); J's
    columns run over the tangent leaves in sorted key order, the layout of
    `jax.flatten_util.ravel_pytree`."""
    res0 = residual_fn(values)
    sqrt_w = sqrt_weights(res0, specs)
    d0 = zero_delta(values)
    rav = Raveler({k: d0[k] for k in sorted(d0)})

    def rows(dflat):
        rs = residual_fn(retract_tree(values, rav.unravel(dflat)))
        return torch.cat([(w[..., None] * r).reshape(-1) for w, r in zip(sqrt_w, rs)])

    x0 = rav.ravel(d0)
    J = torch.func.jacfwd(rows)(x0)
    A = J.T @ J
    A = A + lam * torch.diag(torch.clamp(torch.diagonal(A), min=1e-6))
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    dx = torch.linalg.solve(A + 1e-10 * eye, -(J.T @ rows(x0)))
    return retract_tree(values, rav.unravel(dx)), J
