"""The port's remaining public helpers against the JAX package's, on the
same numpy inputs:

* `core/lie.py`: `se3_adjoint`, `se3_from_matrix`, `se3_matrix` and the
  `SE3` methods (`identity`, `exp`, `from_matrix`, `between`, `local`,
  `adjoint`, `matrix`, `@` with a pose and with points), float64 on both
  sides (`jax.enable_x64()`), within 1e-12;
* `core/camera.py`: `backproject_to_world` and the KITTI
  `disparity_to_depth` in float64 within 1e-12, `in_image` exactly, with
  points on each border;
* `ops/robust.py`: `whiten` in float64 within 1e-12;
* `core/types.py`: `stack_outputs` of simulator packets, every leaf equal;
* `frontend/tracker.py`: `format_tracker_report`, the same string;
* `backend/solver.py`: `dense_normal_solve` on the point-and-pose problem
  of `tests/test_small_schur.py:13`, in float64: the values and J equal
  JAX's within 1e-9, and one step of the port's `lm_optimize_eliminated`
  (no damping) equals the dense step with the elimination's own 1e-8
  Tikhonov term within 1e-9 and `dense_normal_solve`'s (1e-10) within 5e-8.  The Schur step's cross-check
  against it is `test_torch_schur.py::test_schur_step_equals_dense_solve_float64`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu.core import camera as jcam
from dynosam_tpu.core import lie as jlie
from dynosam_tpu_torch.core import camera as tcam
from dynosam_tpu_torch.core import lie as tlie


def _xi(rng, *shape, scale=0.5):
    return rng.normal(size=(*shape, 6)) * scale


def _pair(xi):
    """The same pose batch in float64 as JAX's SE3 and the port's."""
    j = jlie.se3_exp(jnp.asarray(xi))
    return j, tlie.SE3(torch.as_tensor(np.array(j.R)), torch.as_tensor(np.array(j.t)))


def _close(got, want, tol=1e-12):
    if isinstance(want, jlie.SE3):
        _close(got.R, want.R, tol)
        _close(got.t, want.t, tol)
        return
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)


# name -> (JAX side, port side), each of (a, b, points, xi, matrices): a
# and b pose batches of its package, the rest float64 numpy
LIE_CASES = {
    "se3_adjoint": (lambda a, b, p, xi, T: jlie.se3_adjoint(a), lambda a, b, p, xi, T: tlie.se3_adjoint(a)),
    "se3_from_matrix": (lambda a, b, p, xi, T: jlie.se3_from_matrix(jnp.asarray(T)),
                        lambda a, b, p, xi, T: tlie.se3_from_matrix(torch.as_tensor(T))),
    "se3_matrix": (lambda a, b, p, xi, T: jlie.se3_matrix(a), lambda a, b, p, xi, T: tlie.se3_matrix(a)),
    "SE3.identity": (lambda a, b, p, xi, T: jlie.SE3.identity((2, 3), jnp.float64),
                     lambda a, b, p, xi, T: tlie.SE3.identity((2, 3), torch.float64)),
    "SE3.exp": (lambda a, b, p, xi, T: jlie.SE3.exp(jnp.asarray(xi)),
                lambda a, b, p, xi, T: tlie.SE3.exp(torch.as_tensor(xi))),
    "SE3.from_matrix": (lambda a, b, p, xi, T: jlie.SE3.from_matrix(jnp.asarray(T)),
                        lambda a, b, p, xi, T: tlie.SE3.from_matrix(torch.as_tensor(T))),
    "SE3.between": (lambda a, b, p, xi, T: a.between(b), lambda a, b, p, xi, T: a.between(b)),
    "SE3.local": (lambda a, b, p, xi, T: a.local(b), lambda a, b, p, xi, T: a.local(b)),
    "SE3.adjoint": (lambda a, b, p, xi, T: a.adjoint(), lambda a, b, p, xi, T: a.adjoint()),
    "SE3.matrix": (lambda a, b, p, xi, T: a.matrix(), lambda a, b, p, xi, T: a.matrix()),
    "SE3 @ SE3": (lambda a, b, p, xi, T: a @ b, lambda a, b, p, xi, T: a @ b),
    "SE3 @ points": (lambda a, b, p, xi, T: a @ jnp.asarray(p), lambda a, b, p, xi, T: a @ torch.as_tensor(p)),
}


@pytest.mark.parametrize("name", list(LIE_CASES))
def test_se3_helpers_match_jax_f64(name):
    rng = np.random.default_rng(11)
    xa, xb, xi = _xi(rng, 7), _xi(rng, 7), _xi(rng, 7)
    pts = rng.normal(size=(7, 3)) * 4
    jfn, tfn = LIE_CASES[name]
    with jax.enable_x64():
        (ja, ta), (jb, tb) = _pair(xa), _pair(xb)
        mats = np.array(jlie.se3_matrix(jb))
        want = jax.jit(jfn)(ja, jb, pts, xi, mats)
    got = tfn(ta, tb, pts, xi, mats)
    _close(got, want)
    if name == "SE3 @ points":
        assert torch.equal(got, tlie.se3_apply(ta, torch.as_tensor(pts)))
    if name == "SE3 @ SE3":
        assert torch.equal(got.t, tlie.se3_compose(ta, tb).t)
    if name == "SE3.identity":
        assert got.batch_shape == (2, 3)


# intrinsics exact in float32, which is how the JAX package stores them
JCAM = jcam.CameraParams.create(718.75, 718.5, 607.25, 185.125, 1241, 376)
TCAM = tcam.CameraParams.create(718.75, 718.5, 607.25, 185.125, 1241, 376)


def test_backproject_to_world_matches_jax_f64():
    rng = np.random.default_rng(12)
    uv = rng.uniform(0, 1200, (50, 2))
    depth = rng.uniform(0.5, 40, 50)
    xi = _xi(rng, 50)
    with jax.enable_x64():
        jpose, tpose = _pair(xi)
        want = jax.jit(lambda *a: jcam.backproject_to_world(JCAM, *a))(jnp.asarray(uv), jnp.asarray(depth), jpose)
    got = tcam.backproject_to_world(TCAM, torch.as_tensor(uv), torch.as_tensor(depth), tpose)
    _close(got, want)


@pytest.mark.parametrize("border", [0.0, 3.0, 12.5])
def test_in_image_matches_jax_exactly(border):
    """Random pixels and every border's edge: the lower bound inclusive,
    the upper exclusive, as JAX's."""
    rng = np.random.default_rng(13)
    w, h = TCAM.width, TCAM.height
    edges = np.array([border, w - border, h - border, border - 1e-3, w - border - 1e-3, h - border - 1e-3, 0.0, -1.0])
    uv = np.concatenate([rng.uniform(-20, w + 20, (200, 2)), np.stack(np.meshgrid(edges, edges), -1).reshape(-1, 2)])
    uv = uv.astype(np.float32)
    want = np.asarray(jax.jit(lambda x: jcam.in_image(JCAM, x, border))(jnp.asarray(uv)))
    got = tcam.in_image(TCAM, torch.as_tensor(uv), border)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < len(uv)


@pytest.mark.parametrize("scale", [1.0, 256.0])
def test_disparity_to_depth_matches_jax_f64(scale):
    """The KITTI form (disparity, fx * baseline, scale), zero and negative
    disparities included."""
    rng = np.random.default_rng(14)
    disp = rng.uniform(-5, 80, (24, 30)) * scale
    disp[::5, ::3] = 0.0
    with jax.enable_x64():
        want = jax.jit(lambda d: jcam.disparity_to_depth(d, 387.5744, scale))(jnp.asarray(disp))
    got = tcam.disparity_to_depth(torch.as_tensor(disp), 387.5744, scale)
    _close(got, want)
    assert (got[torch.as_tensor(disp) <= 0] == 0).all()


def test_whiten_matches_jax_f64():
    from dynosam_tpu.ops import robust as jrobust
    from dynosam_tpu_torch.ops import robust as trobust

    rng = np.random.default_rng(15)
    r = rng.normal(size=(40, 3))
    sigma = rng.uniform(0.01, 2, (40, 1))
    with jax.enable_x64():
        for s in (0.05, sigma):
            _close(trobust.whiten(torch.as_tensor(r), s if np.isscalar(s) else torch.as_tensor(s)),
                   jax.jit(jrobust.whiten)(jnp.asarray(r), s if np.isscalar(s) else jnp.asarray(s)))


def test_stack_outputs_matches_jax_exactly():
    """Four simulator packets stacked by either package: every leaf equal,
    leaves in JAX's pytree order, with a new leading axis."""
    from dynosam_tpu.core.types import stack_outputs as jstack
    from dynosam_tpu.testing.simulator import ScenarioConfig
    from dynosam_tpu_torch.convert import frontend_output_from_numpy
    from dynosam_tpu_torch.core.types import FrontendOutput, stack_outputs
    from dynosam_tpu_torch.utils.serialization import _leaves

    from test_torch_schur import jax_packets

    jp = jax_packets(ScenarioConfig(n_frames=4, n_static=20, n_objects=2, pts_per_object=12, ns=24, nd=32, no=4))
    tp = [frontend_output_from_numpy(jax.tree.map(np.asarray, p), device="cpu") for p in jp]
    got = stack_outputs(tp)
    want = jax.tree.leaves(jax.jit(jstack)(jp))
    assert isinstance(got, FrontendOutput) and isinstance(got.X_world, tlie.SE3)
    assert got.frame_id.shape == (4,) and got.X_world.R.shape == (4, 3, 3)
    assert len(_leaves(got)) == len(want)
    for a, b in zip(_leaves(got), want):
        assert a.shape == b.shape and a.dtype == torch.from_numpy(np.array(b)).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _reports(rng, no, with_objects):
    """The same random tracker report as JAX's and the port's TrackOutputs."""
    from dynosam_tpu.frontend import tracker as jtr
    from dynosam_tpu_torch.frontend import tracker as ttr

    scalars = rng.integers(0, 500, 6).astype(np.int32)
    cols = rng.integers(0, 40, (7, no)).astype(np.int32)
    cols[0, ::3] = 0
    cols[2, ::3] = 0                                    # slots with nothing to report
    jpo = jtr.PerObjectStatus(*(jnp.asarray(c) for c in cols)) if with_objects else None
    tpo = ttr.PerObjectStatus(*(torch.as_tensor(c) for c in cols)) if with_objects else None
    return (jtr.TrackOutputs(*(jnp.asarray(s) for s in scalars), per_object=jpo),
            ttr.TrackOutputs(*(torch.as_tensor(s) for s in scalars), per_object=tpo))


@pytest.mark.parametrize("case", ["no objects", "slot indices", "labels"])
def test_format_tracker_report_matches_jax(case):
    from dynosam_tpu.frontend.tracker import format_tracker_report as jfmt
    from dynosam_tpu_torch.frontend.tracker import format_tracker_report as tfmt

    rng = np.random.default_rng(16)
    no = 8
    jrep, trep = _reports(rng, no, case != "no objects")
    labels = np.where(rng.random(no) < 0.3, -1, rng.integers(1, 60, no)).astype(np.int32)
    if case == "labels":
        want, got = jfmt(jrep, jnp.asarray(labels)), tfmt(trep, torch.as_tensor(labels))
    else:
        want, got = jfmt(jrep), tfmt(trep)
    assert got == want
    n_obj = got.count("\n")                            # one line per reported object
    assert n_obj == 0 if case == "no objects" else 0 < n_obj < no


def _small_problem(rng, n=24):
    """`tests/test_small_schur.py:13`'s problem in float64: N points and one
    pose, r_i = X^-1 p_i - meas_i, with a prior on the points; the values
    and residuals of both packages and the port's closed-form Jacobians
    (points' block, then the pose's right-retraction tangent)."""
    gt_pts = rng.uniform(-4, 4, size=(n, 3))
    gt_xi = rng.normal(size=(6,)) * 0.2
    init_pts = gt_pts + rng.normal(size=(n, 3)) * 0.05
    d_xi = rng.normal(size=(6,)) * 0.05
    noise = rng.normal(size=(n, 3)) * 0.001
    with jax.enable_x64():
        gt_X = jlie.se3_exp(jnp.asarray(gt_xi))
        meas = np.array(jlie.se3_apply(jlie.se3_inverse(gt_X), jnp.asarray(gt_pts))) + noise
        jX = jlie.se3_retract(gt_X, jnp.asarray(d_xi))
        jinit = {"p": jnp.asarray(init_pts), "X": jX}
    tX = tlie.SE3(torch.as_tensor(np.array(jX.R)), torch.as_tensor(np.array(jX.t)))
    tinit = {"p": torch.as_tensor(init_pts), "X": tX}
    tmeas, tgt = torch.as_tensor(meas), torch.as_tensor(gt_pts)

    def jres(v):
        return [(jlie.se3_apply(jlie.se3_inverse(v["X"]), v["p"]) - meas) / 0.01, (v["p"] - gt_pts) / 5.0]

    def tres(v):
        X = v["X"]
        p = v["p"]
        lead = p.shape[:-2]
        meas_b, gt_b = tmeas.expand(*lead, n, 3), tgt.expand(*lead, n, 3)
        Xb = tlie.SE3(X.R[..., None, :, :], X.t[..., None, :]) if lead else X
        return [(tlie.se3_apply(tlie.se3_inverse(Xb), p) - meas_b) / 0.01, (p - gt_b) / 5.0]

    def tjac(v):
        """(B, N, 3, 3) point blocks and (B, N, 3, 6) pose blocks: for
        q = R^T (p - t), d/dp = R^T and d/dxi of Exp(xi)^-1 q = [hat(q) | -I]."""
        X, p = v["X"], v["p"]
        Rt = X.R.transpose(-1, -2)[:, None].expand(*p.shape[:2], 3, 3)
        q = torch.einsum("bnij,bnj->bni", Rt, p - X.t[:, None])
        eye = torch.eye(3, dtype=p.dtype).expand(*p.shape[:2], 3, 3)
        G = torch.cat([tlie.so3_hat(q), -eye], dim=-1) / 0.01
        return [Rt / 0.01, eye / 5.0], [G, torch.zeros_like(G)]

    return jres, jinit, tres, tinit, tjac


def test_dense_normal_solve_matches_jax_and_the_eliminated_step_f64():
    from dynosam_tpu.backend import solver as jsolver
    from dynosam_tpu_torch.backend import small_schur as tss
    from dynosam_tpu_torch.backend import solver as tsolver

    jres, jinit, tres, tinit, tjac = _small_problem(np.random.default_rng(17))
    with jax.enable_x64():
        jsolve = jax.jit(lambda v, lam: jsolver.dense_normal_solve(jres, [jsolver.RobustSpec()] * 2, v, lam=lam))
        jvals, jJ = jsolve(jinit, 0.0)
        jvals_d, _ = jsolve(jinit, 1e-2)
    specs = [tsolver.RobustSpec()] * 2
    tvals, tJ = tsolver.dense_normal_solve(tres, specs, tinit)
    tvals_d, _ = tsolver.dense_normal_solve(tres, specs, tinit, lam=1e-2)
    assert tJ.shape == jJ.shape == (2 * 24 * 3, 24 * 3 + 6)
    np.testing.assert_allclose(tJ.numpy(), np.asarray(jJ), rtol=0, atol=1e-9 * float(np.abs(jJ).max()))
    for got, want in ((tvals, jvals), (tvals_d, jvals_d)):
        _close(got["p"], want["p"], 1e-9)
        _close(got["X"], want["X"], 1e-9)

    # one undamped step of the block-eliminated LM is the same GN step: it
    # adds 1e-8 to the diagonal where the dense solve adds 1e-10, which
    # moves the step by ~1e-8 along the weakest mode (the points' 1/5
    # prior, eigenvalue ~0.04), so it is held to the dense step with its
    # own term to 1e-9, and to `dense_normal_solve`'s to 5e-8
    batched = {"p": tinit["p"][None], "X": tlie.SE3(tinit["X"].R[None], tinit["X"].t[None])}
    el = tss.lm_optimize_eliminated(tres, specs, batched, tsolver.LMConfig(max_iterations=1, initial_lambda=0.0),
                                    block_keys=("p",), glob_key="X", jacobian_fn=tjac)
    assert int(el.iterations[0]) == 1 and float(el.error[0]) < float(el.initial_error[0])
    r = torch.cat([x.reshape(-1) for x in tres(tinit)])
    dx = torch.linalg.solve(tJ.T @ tJ + 1e-8 * torch.eye(tJ.shape[1], dtype=tJ.dtype), -(tJ.T @ r))
    own = {"X": tlie.se3_retract(tinit["X"], dx[:6]), "p": tinit["p"] + dx[6:].reshape(-1, 3)}   # sorted keys
    for want, tol in ((own, 1e-9), (tvals, 5e-8)):
        np.testing.assert_allclose(el.values["p"][0].numpy(), want["p"].numpy(), rtol=0, atol=tol)
        np.testing.assert_allclose(el.values["X"].t[0].numpy(), want["X"].t.numpy(), rtol=0, atol=tol)
        np.testing.assert_allclose(el.values["X"].R[0].numpy(), want["X"].R.numpy(), rtol=0, atol=tol)
