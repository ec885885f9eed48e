"""Port parity for `ops/epipolar.py` (2d2d relative pose) against
`dynosam_tpu/ops/epipolar.py` on the pairs of `tests/test_epipolar.py`
(640x480 camera, 0.2 px noise, 30 or 20 outliers).

Parity is held in float64 (`jax.enable_x64()` on the JAX side, float64
tensors on the port's): the RANSACs take JAX's hypothesis indices
(`sample_valid_indices` under the same key), and E, the relative poses,
the depths and the scale agree to 1e-8 and the inlier sets exactly.  In
float32, the precision both packages run, an 8-point minimal set's normal
matrix has an eigenvalue gap down to ~4e-8 of its largest, so the two
sides' null vectors (LAPACK through different drivers) may differ by up
to ~0.7 of a unit-norm E, as far from the float64 solution on either side;
the float32 case therefore holds both sides, on the same draws, to the
accuracy band of `tests/test_epipolar.py` (rotation within 0.01 rad, unit
translation within 0.97 of the truth) rather than to each other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_epipolar import make_pair

from dynosam_tpu.core import lie as jlie
from dynosam_tpu.ops import epipolar as jep
from dynosam_tpu.ops.ransac import sample_valid_indices as j_sample
from dynosam_tpu_torch.core.camera import CameraParams
from dynosam_tpu_torch.core.lie import SE3, so3_log
from dynosam_tpu_torch.ops import epipolar as tep

torch.set_num_threads(2)

CAM = CameraParams.create(320.0, 320.0, 320.0, 240.0, 640, 480)


def _t(x):
    return torch.as_tensor(np.array(np.asarray(x)))


def _f64(x):
    return jnp.asarray(np.asarray(x, np.float64))


def _same_up_to_sign(a, b, atol):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, np.sign(np.sum(a * b)) * b, atol=atol)


def _pair(seed, **kw):
    jcam, rel, uv1, uv2, out_idx = make_pair(np.random.default_rng(seed), **kw)
    return jcam, rel, np.asarray(uv1, np.float64), np.asarray(uv2, np.float64), out_idx


def test_essential_and_sampson_match_jax_in_f64():
    jcam, rel, uv1, uv2, _ = _pair(0)
    idx = np.stack([np.random.default_rng(5 + k).permutation(120)[:8] for k in range(16)])   # distinct points

    def jax_side(uv1, uv2):
        pj, qj = jep.normalize_points(jcam, uv1), jep.normalize_points(jcam, uv2)
        Ej = jep.essential_from_points(pj, qj)
        return pj, qj, Ej, jep.essential_from_points(pj[idx], qj[idx]), jep.sampson_error(Ej, pj, qj)

    with jax.enable_x64():
        pj, qj, Ej, Ebj, ej = jax.jit(jax_side)(_f64(uv1), _f64(uv2))
    p, q = tep.normalize_points(CAM, _t(uv1)), tep.normalize_points(CAM, _t(uv2))
    np.testing.assert_allclose(p.numpy(), np.asarray(pj), rtol=1e-15, atol=1e-15)
    Et = tep.essential_from_points(p, q)
    _same_up_to_sign(Et.numpy(), Ej, 1e-9)
    np.testing.assert_allclose(tep.sampson_error(_t(Ej), p, q).numpy(), np.asarray(ej), rtol=1e-9, atol=1e-18)
    assert float(tep.sampson_error(Et, p, q).median()) < 1e-6
    Ebt = tep.essential_from_points(p[idx], q[idx])
    for k in range(16):
        _same_up_to_sign(Ebt[k].numpy(), Ebj[k], 1e-6)


def test_decompose_and_triangulate_match_jax_in_f64():
    jcam, rel, uv1, uv2, _ = _pair(1)
    valid = np.ones(120, bool)

    def jax_side(uv1, uv2, relj):
        pj, qj = jep.normalize_points(jcam, uv1), jep.normalize_points(jcam, uv2)
        Ej = jep.essential_from_points(pj, qj)
        Rj = jep.decompose_essential(Ej, pj, qj, jnp.asarray(valid))
        return pj, qj, Ej, Rj, jep.triangulate_depth_ref(relj, pj, qj)

    with jax.enable_x64():
        relj = jlie.SE3(_f64(rel.R), _f64(rel.t))
        pj, qj, Ej, Rj, lam_j = jax.jit(jax_side)(_f64(uv1), _f64(uv2), relj)
    p, q = _t(pj), _t(qj)
    Rt = tep.decompose_essential(_t(Ej), p, q, torch.as_tensor(valid))
    np.testing.assert_allclose(Rt.R.numpy(), np.asarray(Rj.R), atol=1e-8)
    np.testing.assert_allclose(Rt.t.numpy(), np.asarray(Rj.t), atol=1e-8)
    lam_t = tep.triangulate_depth_ref(SE3(_t(relj.R), _t(relj.t)), p, q)
    np.testing.assert_allclose(lam_t.numpy(), np.asarray(lam_j), rtol=1e-9)


# JAX's hypothesis draw under one `jax.jit` (called eagerly, each primitive
# compiles on its own; its integer draws are the same either way)
_sample = jax.jit(j_sample, static_argnums=(2, 3))


def _ransac_both(solver, jcam, rel, uv1, uv2, valid, key, dtype, iters):
    n_min = 8 if solver == "essential" else 2
    idx = _t(_sample(key, jnp.asarray(valid), iters, n_min))
    kw = dict(iters=iters, threshold=2e-6)
    if solver == "essential":
        j = jax.jit(lambda *a: jep.ransac_essential(*a, jcam, **kw))(key, dtype(uv1), dtype(uv2), jnp.asarray(valid))
        t = tep.ransac_essential(_t(dtype(uv1)), _t(dtype(uv2)), torch.as_tensor(valid), CAM, idx=idx, **kw)
    else:
        R = dtype(rel.R)
        j = jax.jit(lambda *a: jep.ransac_translation_given_rot(*a, jcam, R, **kw))(
            key, dtype(uv1), dtype(uv2), jnp.asarray(valid))
        t = tep.ransac_translation_given_rot(_t(dtype(uv1)), _t(dtype(uv2)), torch.as_tensor(valid), CAM, _t(R),
                                             idx=idx, **kw)
    return j, t


@pytest.mark.parametrize("solver", ["essential", "two_point"])
def test_ransac_matches_jax_on_its_draws_in_f64(solver):
    """Both RANSACs score JAX's minimal sets: in float64 the same inliers
    and the same relative pose."""
    jcam, rel, uv1, uv2, _ = _pair(2, outliers=30)
    valid = np.ones(120, bool)
    valid[::17] = False
    with jax.enable_x64():
        j, t = _ransac_both(solver, jcam, rel, uv1, uv2, valid, jax.random.PRNGKey(3), _f64, 64)
        j = jax.tree.map(np.asarray, j)
    np.testing.assert_array_equal(t.inliers.numpy(), j.inliers)
    assert int(t.n_inliers) == int(j.n_inliers) >= 70
    np.testing.assert_allclose(t.rel_pose.R.numpy(), j.rel_pose.R, atol=1e-8)
    np.testing.assert_allclose(t.rel_pose.t.numpy(), j.rel_pose.t, atol=1e-8)
    np.testing.assert_allclose(t.E.numpy(), j.E, atol=1e-8)


@pytest.mark.parametrize("solver", ["essential", "two_point"])
def test_ransac_in_f32_meets_the_jax_band(solver):
    """In float32 both sides, on the same 300 draws (the iteration count of
    `tests/test_epipolar.py`), recover the relative pose within its band and
    reject the outliers."""
    jcam, rel, uv1, uv2, out_idx = _pair(2, outliers=30)
    valid = np.ones(120, bool)
    j, t = _ransac_both(solver, jcam, rel, uv1, uv2, valid, jax.random.PRNGKey(3),
                        lambda x: jnp.asarray(np.asarray(x, np.float32)), 300)
    t_gt = np.asarray(rel.t) / np.linalg.norm(np.asarray(rel.t))
    R_gt = torch.as_tensor(np.asarray(rel.R, np.float64))
    for res, R, tt, inl in ((j, np.asarray(j.rel_pose.R), np.asarray(j.rel_pose.t), np.asarray(j.inliers)),
                            (t, t.rel_pose.R.numpy(), t.rel_pose.t.numpy(), t.inliers.numpy())):
        assert int(res.n_inliers) >= 80
        assert inl[out_idx].sum() <= 8
        dR = so3_log(R_gt.t() @ torch.tensor(R, dtype=torch.float64))
        assert float(torch.linalg.vector_norm(dR)) < 0.01
        assert float(t_gt @ tt) > 0.97


@pytest.mark.parametrize("n_good", [7, 8, 3])
def test_scale_from_depth_matches_jax(n_good):
    """The median ratio of measured to triangulated depth (numpy's median
    for odd and even counts, in float32 on both sides); fewer than 5 good
    depths give (1, False)."""
    rng = np.random.default_rng(4)
    jcam, rel, uv1, uv2, _ = make_pair(rng, n=12)
    t_norm = float(np.linalg.norm(np.asarray(rel.t)))
    unit = jlie.SE3(rel.R, rel.t / t_norm)
    pj, qj = jep.normalize_points(jcam, uv1), jep.normalize_points(jcam, uv2)
    depth = np.asarray(jep.triangulate_depth_ref(rel, pj, qj)) * rng.uniform(0.95, 1.05, 12).astype(np.float32)
    valid = np.zeros(12, bool)
    valid[:n_good] = True
    sj, okj = jax.jit(jep.scale_from_depth)(unit, pj, qj, jnp.asarray(depth), jnp.asarray(valid))
    st, okt = tep.scale_from_depth(SE3(_t(unit.R), _t(unit.t)), _t(pj), _t(qj), torch.as_tensor(depth),
                                   torch.as_tensor(valid))
    assert bool(okt) == bool(okj) == (n_good >= 5)
    np.testing.assert_allclose(float(st), float(sj), rtol=1e-5)
