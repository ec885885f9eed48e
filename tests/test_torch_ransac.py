"""Port parity for the geometric solvers: `ops/homography.py`,
`ops/ransac.py` and the closed-form inverses of `ops/linalg.py`.

The JAX package draws RANSAC hypotheses from `jax.random`; torch cannot
reproduce those streams, so each RANSAC test draws the indices with the JAX
package's own `sample_valid_indices` and injects them into the port
(`idx=`).  Same inputs from a numpy seed on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu.core.camera import CameraParams as JCam
from dynosam_tpu.core.lie import SE3 as JSE3
from dynosam_tpu.ops import homography as jhom
from dynosam_tpu.ops import linalg as jlin
from dynosam_tpu.ops import ransac as jran
from dynosam_tpu_torch import convert
from dynosam_tpu_torch.core.lie import SE3
from dynosam_tpu_torch.ops import homography as thom
from dynosam_tpu_torch.ops import linalg as tlin
from dynosam_tpu_torch.ops import ransac as tran

torch.set_num_threads(2)

T = lambda a, dt=np.float32: torch.as_tensor(np.array(np.asarray(a), dt))  # noqa: E731


def _rot(rng, scale):
    w = rng.normal(0, scale, 3)
    th = np.linalg.norm(w)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _plane_homography_pairs(rng, n=120, outlier_frac=0.25):
    """Points on a plane seen by two cameras: an exact homography plus
    gross outliers."""
    Hm = np.array([[1.02, 0.01, 3.0], [-0.015, 0.99, -2.0], [1e-5, -2e-5, 1.0]])
    p = rng.uniform([0, 0], [320, 240], (n, 2))
    ph = np.c_[p, np.ones(n)] @ Hm.T
    q = ph[:, :2] / ph[:, 2:]
    q += rng.normal(0, 0.3, q.shape)
    bad = rng.random(n) < outlier_frac
    q[bad] += rng.uniform(-40, 40, (bad.sum(), 2))
    valid = rng.random(n) > 0.1
    return p.astype(np.float32), q.astype(np.float32), valid


def test_linalg_inverses_match(rng):
    """Closed-form 3x3 and SPD inverses against the JAX package (f32,
    rtol 1e-4: adjugate and block-Schur forms, summed in another order)."""
    A = rng.normal(size=(20, 3, 3)).astype(np.float32) + 3 * np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(tlin.inv3(T(A)).numpy(), np.asarray(jlin.inv3(jnp.asarray(A))),
                               rtol=1e-4, atol=1e-5)
    for d in (2, 3, 6, 8):
        M = rng.normal(size=(10, d, d))
        S = (M @ M.transpose(0, 2, 1) + d * np.eye(d)).astype(np.float32)
        np.testing.assert_allclose(tlin.inv_spd(T(S)).numpy(), np.asarray(jlin.inv_spd(jnp.asarray(S))),
                                   rtol=1e-4, atol=1e-5)


def test_homography_fit_and_transfer_match(rng):
    """Weighted DLT ("eigh" and "solve") and the transfer error: 1e-3
    relative on H (f32 normal equations of Hartley-normalised points)."""
    p, q, valid = _plane_homography_pairs(rng, outlier_frac=0.0)
    w = valid.astype(np.float32)
    for method in ("eigh", "solve"):
        Hj = np.asarray(jhom.homography_from_points(jnp.asarray(p), jnp.asarray(q), jnp.asarray(w), method=method))
        Ht = thom.homography_from_points(T(p), T(q), T(w), method=method).numpy()
        np.testing.assert_allclose(Ht, Hj, rtol=1e-3, atol=1e-6)
    ej = np.asarray(jhom.transfer_error(jnp.asarray(Hj), jnp.asarray(p), jnp.asarray(q)))
    et = thom.transfer_error(T(Hj), T(p), T(q)).numpy()
    np.testing.assert_allclose(et, ej, rtol=1e-4, atol=1e-4)


def test_ransac_homography_with_jax_indices(rng):
    """Same hypotheses (JAX's draw injected) -> the same inlier set and the
    same H to 1e-3 relative."""
    p, q, valid = _plane_homography_pairs(rng)
    key = jax.random.PRNGKey(3)
    ref = jhom.ransac_homography(key, jnp.asarray(p), jnp.asarray(q), jnp.asarray(valid), iters=128, threshold=3.0)
    idx = np.asarray(jran.sample_valid_indices(key, jnp.asarray(valid), 128, 4))
    got = thom.ransac_homography(T(p), T(q), T(valid, bool), iters=128, threshold=3.0, idx=T(idx, np.int64))
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    assert int(got.n_inliers) == int(ref.n_inliers)
    np.testing.assert_allclose(got.H.numpy(), np.asarray(ref.H), rtol=1e-3, atol=1e-6)


def test_sample_valid_indices_draws_valid_slots():
    """The port's generator-driven draw only returns valid slots, covers
    them all, and is reproducible from the generator's seed."""
    valid = torch.zeros(200, dtype=torch.bool)
    valid[::7] = True
    g = torch.Generator().manual_seed(5)
    idx = tran.sample_valid_indices(valid[None], 400, 3, g)
    assert idx.shape == (1, 400, 3)
    assert bool(valid[idx].all())
    assert set(idx.unique().tolist()) == set(valid.nonzero()[:, 0].tolist())
    again = tran.sample_valid_indices(valid[None], 400, 3, torch.Generator().manual_seed(5))
    assert torch.equal(idx, again)


def test_procrustes_and_minimal_match(rng):
    """Weighted Arun and the triad minimal solver (f32, 1e-4)."""
    R = _rot(rng, 0.3)
    t = rng.normal(0, 1, 3)
    src = rng.normal(0, 2, (30, 3))
    dst = src @ R.T + t + rng.normal(0, 0.01, (30, 3))
    w = rng.random(30)
    Tj = jran.procrustes(jnp.asarray(src, jnp.float32), jnp.asarray(dst, jnp.float32), jnp.asarray(w, jnp.float32))
    Tt = tran.procrustes(T(src), T(dst), T(w))
    np.testing.assert_allclose(Tt.R.numpy(), np.asarray(Tj.R), atol=1e-4)
    np.testing.assert_allclose(Tt.t.numpy(), np.asarray(Tj.t), atol=1e-4)
    s3 = rng.normal(0, 2, (16, 3, 3))
    s3[0, 2] = s3[0, 0] + 2.0 * (s3[0, 1] - s3[0, 0])          # collinear set
    d3 = s3 @ R.T + t
    Hj, okj = jran.rigid_from_minimal(jnp.asarray(s3, jnp.float32), jnp.asarray(d3, jnp.float32))
    Ht, okt = tran.rigid_from_minimal(T(s3), T(d3))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    ok = np.asarray(okj)
    np.testing.assert_allclose(Ht.R.numpy()[ok], np.asarray(Hj.R)[ok], atol=1e-4)
    np.testing.assert_allclose(Ht.t.numpy()[ok], np.asarray(Hj.t)[ok], atol=1e-4)


def _pnp_problem(rng, n=160, outlier_frac=0.2):
    cam = JCam.create(200.0, 200.0, 160.0, 120.0, 320, 240)
    R = _rot(rng, 0.05)
    t = rng.normal(0, 0.2, 3)
    X = JSE3(jnp.asarray(R, jnp.float32), jnp.asarray(t, jnp.float32))       # ^w X_c
    uv = rng.uniform([10, 10], [310, 230], (n, 2))
    z = rng.uniform(4, 12, n)
    p_cam = np.stack([(uv[:, 0] - 160) / 200 * z, (uv[:, 1] - 120) / 200 * z, z], -1)
    p_w = p_cam @ R.T + t
    uv_obs = uv + rng.normal(0, 0.3, uv.shape)
    bad = rng.random(n) < outlier_frac
    uv_obs[bad] += rng.uniform(-30, 30, (bad.sum(), 2))
    valid = rng.random(n) > 0.15
    f = lambda a: a.astype(np.float32)  # noqa: E731
    return cam, X, f(p_w), f(uv_obs), f(p_cam), valid


@pytest.mark.parametrize("score_cap", [None, 96])
def test_ransac_pose_3d2d_with_jax_indices(rng, score_cap):
    """PnP RANSAC (3-point triad hypotheses, reprojection scoring, 5 GN
    polish steps) with JAX's indices injected: the same inlier set and
    status, pose within 1e-4 (rotation) / 1e-3 m.  With `score_cap` the
    indices address the compacted valid rows on both sides."""
    cam, _, p_w, uv, p_cam, valid = _pnp_problem(rng)
    key = jax.random.PRNGKey(11)
    ref = jran.ransac_pose_3d2d(key, jnp.asarray(p_w), jnp.asarray(uv), jnp.asarray(p_cam),
                                jnp.asarray(valid), cam, iters=200, threshold_px=2.0,
                                min_inliers=10, score_cap=score_cap)
    v = valid
    if score_cap is not None:
        order = np.argsort(~valid, kind="stable")[:score_cap]
        v = valid[order]
    idx = np.asarray(jran.sample_valid_indices(key, jnp.asarray(v), 200, 3))
    got = tran.ransac_pose_3d2d(T(p_w)[None], T(uv)[None], T(p_cam)[None], T(valid, bool)[None],
                                convert.camera_from_numpy(cam._asdict()), iters=200,
                                threshold_px=2.0, min_inliers=10, score_cap=score_cap,
                                idx=T(idx, np.int64)[None])
    assert int(got.status[0]) == int(ref.status) == tran.STATUS_VALID
    np.testing.assert_array_equal(got.inliers[0].numpy(), np.asarray(ref.inliers))
    np.testing.assert_allclose(got.pose.R[0].numpy(), np.asarray(ref.pose.R), atol=1e-4)
    np.testing.assert_allclose(got.pose.t[0].numpy(), np.asarray(ref.pose.t), atol=1e-3)


def test_ransac_rigid_3d3d_batched_with_jax_indices(rng):
    """3d3d RANSAC, two problems in one batch (the JAX package vmaps):
    each matches its own JAX solve; a problem with too few valid rows
    reports STATUS_FEW_MATCHES and the identity pose."""
    probs, idxs, refs = [], [], []
    for b in range(2):
        R = _rot(rng, 0.2)
        t = rng.normal(0, 1, 3)
        src = rng.normal(0, 3, (90, 3))
        dst = src @ R.T + t + rng.normal(0, 0.01, src.shape)
        dst[rng.random(90) < 0.3] += rng.normal(0, 2, 3)
        valid = np.ones(90, bool) if b == 0 else np.arange(90) < 4
        key = jax.random.PRNGKey(20 + b)
        refs.append(jran.ransac_rigid(key, jnp.asarray(src, jnp.float32), jnp.asarray(dst, jnp.float32),
                                      jnp.asarray(valid), iters=150, threshold=0.1))
        idxs.append(np.asarray(jran.sample_valid_indices(key, jnp.asarray(valid), 150, 3)))
        probs.append((src, dst, valid))
    src, dst, valid = (np.stack(x) for x in zip(*probs))
    got = tran.ransac_rigid(T(src), T(dst), T(valid, bool), iters=150, threshold=0.1,
                            idx=T(np.stack(idxs), np.int64))
    for b, ref in enumerate(refs):
        assert int(got.status[b]) == int(ref.status)
        np.testing.assert_array_equal(got.inliers[b].numpy(), np.asarray(ref.inliers))
        np.testing.assert_allclose(got.pose.R[b].numpy(), np.asarray(ref.pose.R), atol=1e-4)
        np.testing.assert_allclose(got.pose.t[b].numpy(), np.asarray(ref.pose.t), atol=1e-3)
    assert int(got.status[1]) == tran.STATUS_FEW_MATCHES
    np.testing.assert_array_equal(got.pose.R[1].numpy(), np.eye(3, dtype=np.float32))
    assert isinstance(got.pose, SE3)


@pytest.fixture(scope="module")
def half_kitti_object_solves():
    """Every object RANSAC the JAX frontend-only pipeline runs on a
    half-KITTI scene (640x192, fx 359, 3 objects, 0.5 px flow noise, 8
    frames): its inputs, the hypothesis indices its key draws, and its
    status.  A recording wrapper replaces `ransac_pose_3d2d` in the JAX
    frontend for a fresh jit of `frontend_step` (object calls only: the ego
    call has a `score_cap`); `jax.debug.callback` hands the values out of
    the vmap over object slots, in no fixed order."""
    import dynosam_tpu.frontend.frontend as jfe
    import dynosam_tpu.pipeline as jpl
    from dynosam_tpu.testing.render import RenderConfig, RenderedScene
    from dynosam_tpu.utils import config as jcfg

    rec, real = [], jran.ransac_pose_3d2d

    def recording(key, p_world, uv, xyz_cur, valid, cam, iters=500, threshold_px=2.0,
                  refine_steps=5, min_inliers=5, score_cap=None):
        res = real(key, p_world, uv, xyz_cur, valid, cam, iters=iters, threshold_px=threshold_px,
                   refine_steps=refine_steps, min_inliers=min_inliers, score_cap=score_cap)
        if score_cap is None:
            idx = jran.sample_valid_indices(key, valid, iters, 3)
            jax.debug.callback(lambda *a: rec.append([np.asarray(x) for x in a]),
                               p_world, uv, xyz_cur, valid, idx, res.status)
        return res

    scene = RenderedScene(RenderConfig(n_frames=8, h=192, w=640, fx=359.0, n_objects=3, bg_depth=14.0,
                                       obj_depth=9.0, cam_step=0.10, obj_step=0.18))
    fr = np.random.default_rng(0)
    frames = [f._replace(flow=f.flow + jnp.asarray(fr.normal(0, 0.5, f.flow.shape), jnp.float32))
              for f in scene.frames()]
    cfg = jcfg.DynoConfig(
        frontend=jcfg.FrontendConfig(tracker=jcfg.TrackerConfig(max_features_per_frame=1000)),
        capacity=jcfg.CapacityConfig(max_static_tracks=2048, max_dynamic_tracks=4096, max_objects=16),
        pipeline=jcfg.PipelineConfig(use_backend=False),
    )
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfe, "ransac_pose_3d2d", recording)
        mp.setattr(jpl, "frontend_step", jax.jit(jfe.frontend_step.__wrapped__,
                                                 static_argnames=("cfg", "use_klt", "first_frame")))
        pipe = jpl.DynoPipeline(scene.cam, cfg)
        for f in frames:
            jax.block_until_ready(pipe.spin_once(f))
    solves = [r for r in rec if r[3].sum() >= 5]          # the rest report FEW_MATCHES on both sides
    stack = lambda j, dt: torch.as_tensor(np.stack([r[j] for r in solves]).astype(dt))  # noqa: E731
    return dict(
        cam=convert.camera_from_numpy(scene.cam._asdict()),
        args=lambda dt: (stack(0, dt), stack(1, dt), stack(2, dt), stack(3, bool)),
        idx=stack(4, np.int64), jax_status=np.array([int(r[5]) for r in solves]),
        n_valid=np.array([int(r[3].sum()) for r in solves]),
    )


def test_object_ransac_status_matches_jax_on_half_kitti(half_kitti_object_solves):
    """The port's float32 object RANSAC on the JAX frontend's own inputs and
    hypothesis indices returns the JAX status on >= 2/3 of the solves.
    Exact agreement is out of reach: each polish step inverts a normal
    matrix of condition number 3e5-4e6 in float32 (fault F1, ROADMAP), so
    the status of a marginal solve follows the summation order (18 of 21
    agree in this batched call; solved one at a time, 17 to 19 of 21,
    moving with torch's thread count)."""
    s = half_kitti_object_solves
    got = tran.ransac_pose_3d2d(*s["args"](np.float32), s["cam"], iters=500, threshold_px=2.0,
                                min_inliers=5, idx=s["idx"])
    agree = got.status.numpy() == s["jax_status"]
    assert len(agree) >= 15
    assert agree.mean() >= 2 / 3, (got.status.numpy(), s["jax_status"])


def test_fault_f1_float64_polish_keeps_every_object_motion(half_kitti_object_solves):
    """Witness of fault F1: the JAX package drops at least a third of the
    object motions of the half-KITTI scene (STATUS_INVALID), while the same
    solves in float64 (the port's RANSAC is dtype-generic) are all valid
    with every valid correspondence an inlier."""
    s = half_kitti_object_solves
    assert (s["jax_status"] == tran.STATUS_INVALID).mean() >= 1 / 3
    got = tran.ransac_pose_3d2d(*s["args"](np.float64), s["cam"], iters=500, threshold_px=2.0,
                                min_inliers=5, idx=s["idx"])
    assert (got.status.numpy() == tran.STATUS_VALID).all()
    np.testing.assert_array_equal(got.n_inliers.numpy(), s["n_valid"])


def test_polish_jacobian_matches_jax_jacfwd(rng):
    """The port's analytic pose Jacobian of the projection, which its
    RANSAC polish uses, equals what the JAX polish takes from `jax.jacfwd`
    of pi((T Exp(xi))^-1 p_w) at xi = 0 (f32, 1e-4 relative)."""
    from dynosam_tpu.core import lie as jlie
    from dynosam_tpu.core.camera import project_local as j_project_local
    from dynosam_tpu_torch.core.camera import project_jacobian_pose

    cam, _, p_w, _, _, _ = _pnp_problem(rng, n=40)
    X = jlie.se3_exp(jnp.asarray(rng.normal(0, 0.1, 6), jnp.float32))
    res_fn = lambda xi: j_project_local(  # noqa: E731
        cam, jlie.se3_apply(jlie.se3_inverse(jlie.se3_retract(X, xi)), jnp.asarray(p_w)))[0]
    want = np.asarray(jax.jacfwd(res_fn)(jnp.zeros(6, jnp.float32)))       # (N, 2, 6)
    p_cam = np.asarray(jlie.se3_apply(jlie.se3_inverse(X), jnp.asarray(p_w)))
    got = project_jacobian_pose(convert.camera_from_numpy(cam._asdict()), T(p_cam)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
