"""The port's LM-PCG engine (`dynosam_tpu_torch/backend/solver.py:pcg`,
`lm_optimize`, `formulation.world_motion_gn_diag` and the closed-form
product `schur.world_motion_normal_product`) against the JAX package.

Tolerances (float32):

* `pcg` on a 40-unknown SPD system with a Jacobi preconditioner: the same
  iteration count (the chunked exit test is the `while_loop`'s) and the
  solution within 1e-5 of its max-abs, stopped by the tolerance and by
  `max_iters` inside and at the end of a chunk;
* `world_motion_gn_diag`: each leaf within 1e-4 of its max-abs;
* J^T W J d and g = J^T W r0 against `jax.linearize` +
  `jax.linear_transpose` of the whitened, IRLS-weighted residuals: each
  leaf within 1e-4 of its max-abs, at values moved off the initial ones
  (there the dynamic residuals are float32 noise, `test_torch_schur.py`);
* the full-batch LM-PCG (`use_full_batch_opt`, `use_schur=False`) on the
  8-frame scenario against jitted JAX: final errors within rtol 1e-2 and
  camera translations within 1e-4 m.  That is the float32 floor
  `tests/f32_spread.py` item 5 measures for this solve: a 1e-7 relative
  perturbation of the static measurements moves the JAX solve's final
  error by up to 0.52 % and its translations by up to 6.8e-5 m, the
  port's by up to 0.33 % and 5.2e-5 m (the port's result does not move
  with the CPU thread count here); unperturbed, port and JAX differ by
  0.19 % and 1.8e-5 m.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu.backend import formulation as jfm
from dynosam_tpu.backend import solver as jsolver
from dynosam_tpu.core import lie as jlie
from dynosam_tpu.ops.robust import robust_sqrt_weights
from dynosam_tpu.testing.simulator import ScenarioConfig
from dynosam_tpu_torch.backend import formulation as tfm
from dynosam_tpu_torch.backend import schur as tschur
from dynosam_tpu_torch.backend import solver as tsolver
from dynosam_tpu_torch.backend.backend import lm_config

from test_torch_schur import _window, rel_err, to_port

torch.set_num_threads(2)


@pytest.mark.parametrize("max_iters,tol", [(100, 1e-6), (8, 1e-12), (13, 1e-12)])
def test_pcg_matches_jax(max_iters, tol):
    rng = np.random.default_rng(5)
    n = 40
    Q = rng.normal(size=(n, n))
    A = (Q @ Q.T + n * np.diag(rng.uniform(0.1, 10, n))).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    d = np.diag(A).copy()
    jA, jb, jd = jnp.asarray(A), jnp.asarray(b), jnp.asarray(d)
    jx, ji, _ = jax.jit(lambda b_: jsolver.pcg(lambda v: {"a": jA @ v["a"]}, {"a": b_},
                                               lambda r: {"a": r["a"] / jd}, {"a": jnp.zeros_like(b_)},
                                               max_iters, tol))(jb)
    tA, td = torch.as_tensor(A), torch.as_tensor(d)
    tx, ti, _ = tsolver.pcg(lambda v: {"a": tA @ v["a"]}, {"a": torch.as_tensor(b)},
                            lambda r: {"a": r["a"] / td}, {"a": torch.zeros(n)}, max_iters, tol)
    assert int(ti) == int(ji) <= max_iters
    assert rel_err(jx["a"], tx["a"]) <= 1e-5
    # the flat-vector form the LM uses gives the same
    fx, fi, _ = tsolver.pcg(lambda v: tA @ v, torch.as_tensor(b), lambda r: r / td, torch.zeros(n),
                            max_iters, tol)
    assert int(fi) == int(ti) and torch.equal(fx, tx["a"])


def _moved(jw, jmk, jc):
    """Initial values moved off (X by 1e-2, H by 5e-2 in the tangent, dp by
    2e-2 m) as `test_torch_schur.build_problem` moves them."""
    jv0 = jfm.init_values(jw, jmk, jc)
    rng = np.random.default_rng(3)
    W, O = jmk.motion_active.shape
    jv = dict(jv0)
    jv["X"] = jlie.se3_retract(jv0["X"], jnp.asarray(rng.normal(0, 0.01, (W, 6)), jnp.float32))
    jv["H"] = jlie.se3_exp(jnp.asarray(rng.normal(0, 0.05, (W, O, 6)), jnp.float32))
    jv["dp"] = jv0["dp"] + jnp.asarray(rng.normal(0, 0.02, jv0["dp"].shape), jnp.float32)
    return jv


@pytest.fixture(scope="module")
def linearised():
    """The window-10 scenario at moved values: both packages' diagonal,
    product on a random tangent, and gradient."""
    jw, tw, jc, tc, jmk, tmk = _window(ScenarioConfig(n_frames=10))
    jv = _moved(jw, jmk, jc)
    tv = to_port(jv)
    specs = jfm.world_motion_families(jc).robust
    rng = np.random.default_rng(8)
    W, O = jmk.motion_active.shape
    shapes = {"X": (W, 6), "H": (W, O, 6), "sp": jv["sp"].shape, "dp": jv["dp"].shape}
    d = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}

    @jax.jit
    def jax_side(v, dd):
        anchor = jw.X_init[0]
        res = jfm.world_motion_residuals(v, jw, jmk, jc, anchor)
        sw = [robust_sqrt_weights(r, s.k, s.kind) if s.kind != "none" else jnp.ones(r.shape[:-1])
              for r, s in zip(res, specs)]

        def f(delta):
            rs = jfm.world_motion_residuals(jsolver.retract_tree(v, delta), jw, jmk, jc, anchor)
            return [w[..., None] * r for w, r in zip(sw, rs)]

        d0 = jsolver.zero_delta(v)
        wr0, jvp = jax.linearize(f, d0)
        vjp = jax.linear_transpose(jvp, d0)
        return jfm.world_motion_gn_diag(v, sw, jw, jmk, jc), vjp(jvp(dd))[0], vjp(wr0)[0]

    jdiag, jprod, jg = jax_side(jv, {k: jnp.asarray(x) for k, x in d.items()})
    anchor = tw.X_init[0]
    tres = tfm.world_motion_residuals(tv, tw, tmk, tc, anchor)
    tsw = tsolver.sqrt_weights(tres, tfm.world_motion_families(tc).robust)
    JtJ_mv, tg = tschur.world_motion_normal_product(tv, tsw, tres, tw, tmk, tc, anchor)
    tprod = JtJ_mv({k: torch.as_tensor(x) for k, x in d.items()})
    tdiag = tfm.world_motion_gn_diag(tv, tsw, tw, tmk, tc)
    return dict(j=(jdiag, jprod, jg), t=(tdiag, tprod, tg))


@pytest.mark.parametrize("quantity", ["gn_diag", "JtJ_product", "gradient"])
def test_linearisation_matches_jax(linearised, quantity):
    i = ("gn_diag", "JtJ_product", "gradient").index(quantity)
    j, t = linearised["j"][i], linearised["t"][i]
    for k in ("X", "H", "sp", "dp"):
        assert np.asarray(j[k]).shape == tuple(t[k].shape), k
        assert np.abs(np.asarray(j[k])).max() > 0, k
        assert rel_err(j[k], t[k]) <= 1e-4, (quantity, k, rel_err(j[k], t[k]))


def _full_batch_window(lm_iters):
    kw = dict(use_full_batch_opt=True, use_schur=False, lm_max_iterations=lm_iters)
    return _window(ScenarioConfig(n_frames=8), kw)


def solve_full_batch():
    """(JAX LMResult, port LMResult) of the full-batch LM-PCG on the
    8-frame scenario, 30 LM iterations at most."""
    jw, tw, jc, tc, jmk, tmk = _full_batch_window(30)
    specs = jfm.world_motion_families(jc).robust
    anchor = jw.X_init[0]
    lm = jsolver.LMConfig(max_iterations=30, cg_max_iterations=jc.cg_max_iterations, cg_tol=jc.cg_tol)
    jres = jax.jit(lambda v: jsolver.lm_optimize(
        lambda x: jfm.world_motion_residuals(x, jw, jmk, jc, anchor), specs, v, lm,
        gn_diag_fn=lambda x, sw: jfm.world_motion_gn_diag(x, sw, jw, jmk, jc)))(jfm.init_values(jw, jmk, jc))
    tanchor = tw.X_init[0]
    tres = tsolver.lm_optimize(
        lambda x: tfm.world_motion_residuals(x, tw, tmk, tc, tanchor), tfm.world_motion_families(tc).robust,
        tfm.init_values(tw, tmk, tc), lm_config(tc),
        gn_diag_fn=lambda x, sw: tfm.world_motion_gn_diag(x, sw, tw, tmk, tc),
        normal_fn=lambda x, sw, r: tschur.world_motion_normal_product(x, sw, r, tw, tmk, tc, tanchor))
    return jres, tres


@pytest.fixture(scope="module")
def full_batch():
    return solve_full_batch()


def test_full_batch_lm_pcg_matches_jax(full_batch):
    jres, tres = full_batch
    assert float(tres.initial_error) == pytest.approx(float(jres.initial_error), rel=1e-5)
    assert float(tres.error) < 1e-3 * float(tres.initial_error)
    assert float(tres.error) == pytest.approx(float(jres.error), rel=1e-2)
    assert len(tres.cg_iterations) == tres.iterations
    assert all(0 < n <= 100 for n in tres.cg_iterations)
    np.testing.assert_allclose(tres.values["X"].t.numpy(), np.asarray(jres.values["X"].t), rtol=0, atol=1e-4)


def test_lm_optimize_raises_without_the_analytic_diagonal():
    """gn_diag_fn=None is the Hutchinson path (varpro), not ported."""
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md item 12"):
        tsolver.lm_optimize(lambda v: [], (), {}, tsolver.LMConfig(), normal_fn=lambda v, sw, r: None)
