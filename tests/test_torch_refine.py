"""Port parity for the frontend refiners (`frontend/refine.py`), the
block-eliminated LM (`backend/small_schur.py`) and the LM pieces of
`backend/solver.py` they use.

The JAX package solves one problem per call (and `vmap`s); the port runs a
leading batch of independent problems, so each batched port call is held
against one JAX call per problem.  The JAX solver takes its Jacobians from
`jax.linearize`; the port from closed forms.  Same inputs from a numpy seed.
"""

import jax.numpy as jnp
import numpy as np
import torch

from dynosam_tpu.backend import small_schur as jss
from dynosam_tpu.backend import solver as jsol
from dynosam_tpu.core import lie as jlie
from dynosam_tpu.core.camera import CameraParams as JCam
from dynosam_tpu.core.camera import backproject as jbackproject
from dynosam_tpu.core.camera import project as jproject
from dynosam_tpu.frontend import refine as jref
from dynosam_tpu_torch import convert
from dynosam_tpu_torch.backend import small_schur as tss
from dynosam_tpu_torch.backend import solver as tsol
from dynosam_tpu_torch.core import lie as tlie
from dynosam_tpu_torch.frontend import refine as tref

torch.set_num_threads(2)

T = lambda a, dt=np.float32: torch.as_tensor(np.array(np.asarray(a), dt))  # noqa: E731
JCAM = JCam.create(200.0, 200.0, 160.0, 120.0, 320, 240)
TCAM = convert.camera_from_numpy(JCAM._asdict())


def _jse3(xi):
    return jlie.se3_exp(jnp.asarray(xi, jnp.float32))


def _tse3_stack(js):
    return tlie.SE3(torch.stack([T(x.R) for x in js]), torch.stack([T(x.t) for x in js]))


def test_robust_loss_and_total_error_match(rng):
    """Huber and plain losses, summed per problem (f32, rtol 1e-6)."""
    r = rng.normal(0, 0.01, (3, 40, 2)).astype(np.float32)
    for spec in (tsol.RobustSpec(), tsol.RobustSpec("huber", 0.005)):
        jspec = jsol.RobustSpec(spec.kind, spec.k)
        np.testing.assert_allclose(tsol.robust_loss(T(r), spec).numpy(),
                                   np.asarray(jsol.robust_loss(jnp.asarray(r), jspec)), rtol=1e-6)
        want = [float(jsol.total_error([jnp.asarray(r[b])], [jspec])) for b in range(3)]
        np.testing.assert_allclose(tsol.total_error([T(r)], [spec], batch_dims=1).numpy(), want, rtol=1e-5)


def test_zero_delta_and_retract_tree_match(rng):
    """Tangent trees: SE3 leaves retract on the manifold, tensors add (f32,
    1e-6)."""
    X = _jse3(rng.normal(0, 0.3, 6))
    p = rng.normal(size=(5, 3)).astype(np.float32)
    d = {"X": rng.normal(0, 0.1, 6).astype(np.float32), "p": rng.normal(size=(5, 3)).astype(np.float32)}
    jz = jsol.zero_delta({"X": X, "p": jnp.asarray(p)})
    tz = tsol.zero_delta({"X": tlie.SE3(T(X.R), T(X.t)), "p": T(p)})
    assert tz["X"].shape == np.asarray(jz["X"]).shape == (6,) and not tz["X"].any() and not tz["p"].any()
    jr = jsol.retract_tree({"X": X, "p": jnp.asarray(p)}, {k: jnp.asarray(v) for k, v in d.items()})
    tr = tsol.retract_tree({"X": tlie.SE3(T(X.R), T(X.t)), "p": T(p)}, {k: T(v) for k, v in d.items()})
    np.testing.assert_allclose(tr["X"].R.numpy(), np.asarray(jr["X"].R), atol=1e-6)
    np.testing.assert_allclose(tr["X"].t.numpy(), np.asarray(jr["X"].t), atol=1e-6)
    np.testing.assert_allclose(tr["p"].numpy(), np.asarray(jr["p"]), atol=1e-6)


def _ego_problem(rng, n=80):
    X_prev = _jse3([0.01, -0.02, 0.005, 0.1, 0.0, 0.05])
    X_true = jlie.se3_compose(X_prev, _jse3([0.004, 0.01, -0.003, 0.02, 0.01, 0.12]))
    kp = rng.uniform([20, 20], [300, 220], (n, 2)).astype(np.float32)
    depth = rng.uniform(4, 10, n).astype(np.float32)
    p_w = jlie.se3_apply(X_prev, jbackproject(JCAM, jnp.asarray(kp), jnp.asarray(depth)))
    uv1, _ = jproject(JCAM, X_true, p_w)
    flow = np.asarray(uv1) - kp + rng.normal(0, 0.4, (n, 2)).astype(np.float32)
    bad = rng.random(n) < 0.15
    flow[bad] += rng.uniform(-15, 15, (bad.sum(), 2)).astype(np.float32)
    valid = rng.random(n) > 0.1
    X_init = jlie.se3_compose(X_true, _jse3(rng.normal(0, 0.01, 6)))
    return X_init, X_prev, kp, depth, flow.astype(np.float32), valid


def test_optimize_flow_and_pose_batched_matches_jax(rng):
    """Joint flow + pose refinement with the 4-round outlier cycle: two
    problems in one port batch, each against its own JAX solve.  The same
    inlier set, pose within 2e-4 (rotation) / 2e-3 m, flows within 1e-2 px
    (f32 LM over ~10 iterations with another Jacobian route)."""
    probs = [_ego_problem(rng) for _ in range(2)]
    refs = [jref.optimize_flow_and_pose(JCAM, X0, Xp, jnp.asarray(kp), jnp.asarray(d), jnp.asarray(f),
                                        jnp.asarray(v), max_iterations=10, outlier_rounds=4)
            for X0, Xp, kp, d, f, v in probs]
    X_prev = probs[0][1]
    assert all(np.array_equal(np.asarray(p[1].R), np.asarray(X_prev.R)) for p in probs)
    got = tref.optimize_flow_and_pose(
        TCAM, _tse3_stack([p[0] for p in probs]), tlie.SE3(T(X_prev.R), T(X_prev.t)),
        torch.stack([T(p[2]) for p in probs]), torch.stack([T(p[3]) for p in probs]),
        torch.stack([T(p[4]) for p in probs]), torch.stack([T(p[5], bool) for p in probs]),
        max_iterations=10, outlier_rounds=4,
    )
    for b, ref in enumerate(refs):
        np.testing.assert_array_equal(got.inliers[b].numpy(), np.asarray(ref.inliers))
        np.testing.assert_allclose(got.pose.R[b].numpy(), np.asarray(ref.pose.R), atol=2e-4)
        np.testing.assert_allclose(got.pose.t[b].numpy(), np.asarray(ref.pose.t), atol=2e-3)
        v = probs[b][5]
        np.testing.assert_allclose(got.flow[b].numpy()[v], np.asarray(ref.flow)[v], atol=1e-2)


def _motion_problem(rng, n=60):
    X_prev = _jse3([0.0, 0.01, 0.0, 0.0, 0.0, 0.0])
    X_cur = jlie.se3_compose(X_prev, _jse3([0.0, 0.002, 0.0, 0.1, 0.01, 0.02]))
    H = _jse3([0.0, 0.0, 0.005, 0.25, 0.02, 0.0])
    m_prev = np.c_[rng.uniform(-2.5, 2.5, (n, 2)), rng.uniform(5, 8, n)].astype(np.float32)
    m_cur = jlie.se3_apply(H, jnp.asarray(m_prev))
    uv_prev, _ = jproject(JCAM, X_prev, jnp.asarray(m_prev))
    uv_cur, _ = jproject(JCAM, X_cur, m_cur)
    uv_prev = np.asarray(uv_prev) + rng.normal(0, 0.3, (n, 2)).astype(np.float32)
    uv_cur = np.asarray(uv_cur) + rng.normal(0, 0.3, (n, 2)).astype(np.float32)
    bad = rng.random(n) < 0.1
    uv_cur[bad] += rng.uniform(-20, 20, (bad.sum(), 2)).astype(np.float32)
    m_noisy = m_prev + rng.normal(0, 0.0005, m_prev.shape).astype(np.float32)
    valid = rng.random(n) > 0.1
    H_init = jlie.se3_compose(H, _jse3(rng.normal(0, 0.005, 6)))
    return H_init, X_prev, X_cur, m_noisy, uv_prev.astype(np.float32), uv_cur.astype(np.float32), valid


def test_optimize_motion_only_batched_matches_jax(rng):
    """Motion-only 3D refinement (landmark pairs + one motion, Huber,
    chi^2 outlier cycle): two problems per port batch against two JAX
    solves.  Motion within 2e-4 (rotation) / 2e-3 m; inliers agree on at
    least 95 % of rows (the chi^2 gate on a 0.001 sigma ternary residual
    sits close to some rows)."""
    probs = [_motion_problem(rng) for _ in range(2)]
    X_prev, X_cur = probs[0][1], probs[0][2]
    refs = [jref.optimize_motion_only(JCAM, H0, X_prev, X_cur, jnp.asarray(m), jnp.asarray(up),
                                      jnp.asarray(uc), jnp.asarray(v), max_iterations=10, outlier_rounds=4)
            for H0, _, _, m, up, uc, v in probs]
    got = tref.optimize_motion_only(
        TCAM, _tse3_stack([p[0] for p in probs]), tlie.SE3(T(X_prev.R), T(X_prev.t)),
        tlie.SE3(T(X_cur.R), T(X_cur.t)), torch.stack([T(p[3]) for p in probs]),
        torch.stack([T(p[4]) for p in probs]), torch.stack([T(p[5]) for p in probs]),
        torch.stack([T(p[6], bool) for p in probs]), max_iterations=10, outlier_rounds=4,
    )
    for b, ref in enumerate(refs):
        assert (got.inliers[b].numpy() == np.asarray(ref.inliers)).mean() >= 0.95
        np.testing.assert_allclose(got.motion.R[b].numpy(), np.asarray(ref.motion.R), atol=2e-4)
        np.testing.assert_allclose(got.motion.t[b].numpy(), np.asarray(ref.motion.t), atol=2e-3)


def test_lm_optimize_eliminated_matches_jax(rng):
    """The block-eliminated LM on a toy block + global problem: per-point
    3D blocks p_i with a prior, and one SE3 mapping them onto observations
    (Huber).  The port's closed-form Jacobians against JAX's linearize:
    points within 1e-4, pose within 1e-4, final error to 1e-3 relative."""
    n = 50
    Tt = _jse3([0.05, -0.03, 0.02, 0.3, -0.1, 0.2])
    p0 = rng.normal(0, 2, (n, 3)).astype(np.float32)
    obs_p = p0 + rng.normal(0, 0.01, p0.shape).astype(np.float32)
    obs_q = np.asarray(jlie.se3_apply(Tt, jnp.asarray(p0))) + rng.normal(0, 0.01, p0.shape).astype(np.float32)
    obs_q[:4] += 1.0                                                        # outliers for Huber
    T_init = jlie.se3_compose(Tt, _jse3(rng.normal(0, 0.02, 6)))
    s1, s2 = 0.02, 0.05

    def jres(v):
        return [(v["p"] - obs_p) / s1, (jlie.se3_apply(v["T"], v["p"]) - obs_q) / s2]

    jspecs = [jsol.RobustSpec(), jsol.RobustSpec("huber", 1.0)]
    ref = jss.lm_optimize_eliminated(jres, jspecs, {"p": jnp.asarray(p0), "T": T_init},
                                     jsol.LMConfig(max_iterations=15), block_keys=("p",), glob_keys=("T",))

    tobs_p, tobs_q = T(obs_p)[None], T(obs_q)[None]

    def tres(v):
        return [(v["p"] - tobs_p) / s1, (tlie.se3_apply(v["T"][:, None], v["p"]) - tobs_q) / s2]

    def tjac(v):
        R = v["T"].R[:, None].expand(1, n, 3, 3)
        eye = torch.eye(3).expand(1, n, 3, 3)
        # d/dxi T Exp(xi) p = R [-hat(p) | I]
        G = torch.cat([R @ -tlie.so3_hat(v["p"]), R], dim=-1) / s2
        return [eye / s1, R / s2], [torch.zeros(1, n, 3, 6), G]

    got = tss.lm_optimize_eliminated(
        tres, [tsol.RobustSpec(), tsol.RobustSpec("huber", 1.0)],
        {"p": T(p0)[None], "T": tlie.SE3(T(T_init.R)[None], T(T_init.t)[None])},
        tsol.LMConfig(max_iterations=15), block_keys=("p",), glob_key="T", jacobian_fn=tjac,
    )
    np.testing.assert_allclose(got.values["p"][0].numpy(), np.asarray(ref.values["p"]), atol=1e-4)
    np.testing.assert_allclose(got.values["T"].R[0].numpy(), np.asarray(ref.values["T"].R), atol=1e-4)
    np.testing.assert_allclose(got.values["T"].t[0].numpy(), np.asarray(ref.values["T"].t), atol=1e-4)
    np.testing.assert_allclose(float(got.error[0]), float(ref.error), rtol=1e-3)
    assert float(got.error[0]) < float(got.initial_error[0])
