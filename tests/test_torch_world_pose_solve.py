"""The port's WorldPose solves (updater 1) against the JAX package:
`lm_optimize_schur(formulation=1)` on the window-10 simulator scenario of
`tests/test_torch_schur.py`, with the isotropic anchor and with a full
`anchor_prior_L`, and the LM-PCG of updater 1 (`world_pose_normal_product`,
`world_pose_gn_diag`) over the 8-frame scenario, 15 LM iterations.

Tolerance: the final error and the camera translations stay within twice
the float32 floor measured here, as `tests/f32_spread.py` measures
WorldMotion's: the spread of JAX's solve and of the port's (2 CPU threads)
when the static and dynamic measurements move by one part in 1e7, over
`DRAWS` draws, summed.  The ~1e10-conditioned windows with Huber k 1e-4 amplify
float32 rounding that far, so a tighter bound would test the order of
float32 sums, not the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu.backend import formulation as jfm
from dynosam_tpu.backend import schur as jschur
from dynosam_tpu.backend import solver as jsolver
from dynosam_tpu.testing.simulator import ScenarioConfig
from dynosam_tpu_torch.backend import formulation as tfm
from dynosam_tpu_torch.backend import schur as tschur
from dynosam_tpu_torch.backend import solver as tsolver
from dynosam_tpu_torch.backend.backend import lm_config

from test_torch_schur import _window

torch.set_num_threads(2)

DRAWS = 2


@pytest.fixture(scope="module")
def problem():
    jw, tw, jc, tc, jmk, tmk = _window(ScenarioConfig(n_frames=10))
    return dict(jw=jw, tw=tw, jc=jc, tc=tc, jmk=jmk, tmk=tmk)


def _jiggle(w, rng):
    """The window with its static and dynamic measurements scaled by
    (1 + 1e-7 N(0, 1)), in numpy float32 (`test_jiggle_in_numpy_equals_jnp`
    holds it to the `jnp` form's bits)."""
    def j(x):
        x = np.asarray(x)
        return jnp.asarray(x * (np.float32(1) + np.float32(1e-7) * rng.standard_normal(x.shape).astype(np.float32)))

    return w._replace(static_xyz=j(w.static_xyz), dyn_xyz=j(w.dyn_xyz))


def test_jiggle_in_numpy_equals_jnp(problem):
    """`_jiggle`'s numpy float32 product has the bits of the `jnp` form
    it replaces, `x * (1 + 1e-7 * jnp.asarray(draw, float32))`, on the
    windows the solves perturb (window 10 and the 8-frame full batch),
    over `DRAWS` draws."""
    full = _window(ScenarioConfig(n_frames=8), dict(use_full_batch_opt=True, use_schur=False,
                                                        lm_max_iterations=15))[0]
    for jw in (problem["jw"], full):
        rng, ref = np.random.default_rng(0), np.random.default_rng(0)
        for _ in range(DRAWS):
            got = _jiggle(jw, rng)
            for name in ("static_xyz", "dyn_xyz"):
                x = getattr(jw, name)
                want = x * (1 + 1e-7 * jnp.asarray(ref.standard_normal(x.shape), jnp.float32))
                assert getattr(got, name).dtype == want.dtype == jnp.float32
                assert np.array_equal(np.asarray(getattr(got, name)), np.asarray(want)), name


def _spread(runs):
    """(relative error spread, translation spread) of runs[1:] against runs[0]."""
    e0, t0 = runs[0]
    return (max(abs(e / e0 - 1) for e, _ in runs[1:]), max(float(np.abs(t - t0).max()) for _, t in runs[1:]))


def _floor_and_diff(jax_solve, port_solve, jw, tw):
    """JAX and port solves of the window and of `DRAWS` perturbed copies:
    (JAX spread, port spread, port-vs-JAX difference) of (final error,
    camera translations), and (JAX result, port result) of the window
    itself for the checks that read them."""
    rng = np.random.default_rng(0)
    jruns, truns = [], []
    for draw in range(DRAWS + 1):
        w = _jiggle(jw, rng) if draw else jw
        r = jax_solve(w)
        jruns.append((float(r.error), np.asarray(r.values["X"].t)))
        t = port_solve(tw._replace(static_xyz=torch.as_tensor(np.array(w.static_xyz)),
                                   dyn_xyz=torch.as_tensor(np.array(w.dyn_xyz))))
        truns.append((float(t.error), t.values["X"].t.numpy()))
        if not draw:
            first = (r, t)
    diff = (abs(truns[0][0] / jruns[0][0] - 1), float(np.abs(truns[0][1] - jruns[0][1]).max()))
    return _spread(jruns), _spread(truns), diff, first


@pytest.mark.parametrize("prior", ["isotropic", "anchor_prior_L"])
def test_lm_optimize_schur_pose_matches_jax(problem, prior):
    """7 LM iterations from the initial values; `anchor_prior_L` is a
    full (6, 6) factor (a random SPD information around 1/sigma^2).  The
    port's final error and camera translations stay within twice the sum
    of the two packages' measured float32 spreads of JAX's."""
    p = problem
    jw, jmk, jc = p["jw"], p["jmk"], p["jc"]
    tw, tmk, tc = p["tw"], p["tmk"], p["tc"]
    L = None
    if prior == "anchor_prior_L":
        rng = np.random.default_rng(21)
        Q = rng.normal(size=(6, 6))
        L = np.linalg.cholesky((Q @ Q.T / 6 + np.eye(6)) / 1e-8).astype(np.float32)

    @jax.jit
    def jax_solve(w):
        return jschur.lm_optimize_schur(jfm.init_values_world_pose(w, jmk, jc), w, jmk, jc,
                                        jsolver.LMConfig(max_iterations=7), w.X_init[0], formulation=1,
                                        anchor_prior_L=None if L is None else jnp.asarray(L))

    def port_solve(w):
        return tschur.lm_optimize_schur(tfm.init_values_world_pose(w, tmk, tc), w, tmk, tc,
                                        tsolver.LMConfig(max_iterations=7), w.X_init[0], formulation=1,
                                        anchor_prior_L=None if L is None else torch.as_tensor(L))

    (je, jt), (te, tt), (de, dt), (jres, tres) = _floor_and_diff(jax_solve, port_solve, jw, tw)
    assert float(tres.initial_error) == pytest.approx(float(jres.initial_error), rel=1e-5)
    assert float(tres.error) < float(tres.initial_error)
    assert abs(tres.iterations - int(jres.iterations)) <= 1
    assert de <= 2 * (je + te), (de, je, te)
    assert dt <= 2 * (jt + tt), (dt, jt, tt)


def test_world_pose_full_batch_lm_pcg_matches_jax():
    """The LM-PCG of updater 1 (`world_pose_normal_product`,
    `world_pose_gn_diag`) over the 8-frame scenario, 15 LM iterations: it
    lowers the error by three orders, and its final error and camera
    translations stay within twice the measured float32 spreads of
    JAX's."""
    kw = dict(use_full_batch_opt=True, use_schur=False, lm_max_iterations=15)
    jw, tw, jc, tc, jmk, tmk = _window(ScenarioConfig(n_frames=8), kw)
    specs = jfm.world_pose_families(jc).robust
    lm = jsolver.LMConfig(max_iterations=15, cg_max_iterations=jc.cg_max_iterations, cg_tol=jc.cg_tol)

    @jax.jit
    def jax_solve(w):
        anchor = w.X_init[0]
        return jsolver.lm_optimize(lambda x: jfm.world_pose_residuals(x, w, jmk, jc, anchor), specs,
                                   jfm.init_values_world_pose(w, jmk, jc), lm,
                                   gn_diag_fn=lambda x, sw: jfm.world_pose_gn_diag(x, sw, w, jmk, jc))

    def port_solve(w):
        anchor = w.X_init[0]
        return tsolver.lm_optimize(
            lambda x: tfm.world_pose_residuals(x, w, tmk, tc, anchor), tfm.world_pose_families(tc).robust,
            tfm.init_values_world_pose(w, tmk, tc), lm_config(tc),
            gn_diag_fn=lambda x, sw: tfm.world_pose_gn_diag(x, sw, w, tmk, tc),
            normal_fn=lambda x, sw, r: tschur.world_pose_normal_product(x, sw, r, w, tmk, tc, anchor))

    (je, jt), (te, tt), (de, dt), (_, tres) = _floor_and_diff(jax_solve, port_solve, jw, tw)
    assert float(tres.error) < 1e-3 * float(tres.initial_error)
    assert len(tres.cg_iterations) == tres.iterations
    assert de <= 2 * (je + te), (de, je, te)
    assert dt <= 2 * (jt + tt), (dt, jt, tt)
