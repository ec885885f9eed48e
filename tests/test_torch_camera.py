"""Port parity: `dynosam_tpu_torch.core.camera` against `dynosam_tpu.core.camera`
in f32 and f64.  Pixel outputs at 1e-3 px (f32) / 1e-9 px (f64); the
Jacobians at 1e-4 relative (f32) / 1e-10 (f64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu.core import camera as jcam
from dynosam_tpu.core import lie as jlie
from dynosam_tpu_torch.core import camera as tcam
from dynosam_tpu_torch.core import lie as tlie

torch.set_num_threads(2)

K = dict(fx=320.0, fy=310.0, cx=320.0, cy=240.0, width=640, height=480)


def _run(dtype, rng):
    uv = rng.uniform(0, [640, 480], size=(100, 2))
    depth = rng.uniform(1.0, 30.0, size=(100,))
    pts = rng.uniform([-5, -5, 2], [5, 5, 30], size=(40, 3))
    xi = rng.normal(size=(6,)) * 0.3
    jd = jnp.float64 if dtype == np.float64 else jnp.float32
    pj = jcam.CameraParams.create(dtype=jd, **K)
    pose_j = jlie.se3_exp(jnp.asarray(xi, jd))

    def jax_outs(uv, depth, pts, pose):        # under one `jax.jit`
        return [
            jcam.backproject(pj, uv, depth),
            jcam.project_local(pj, pts)[0],
            jcam.project(pj, pose, pts)[0],
            jcam.project_jacobian_point(pj, pts),
            jcam.project_jacobian_pose(pj, pts),
        ]

    outs_j = jax.jit(jax_outs)(jnp.asarray(uv, jd), jnp.asarray(depth, jd), jnp.asarray(pts, jd), pose_j)
    outs_j = [np.asarray(o) for o in outs_j]
    pt = tcam.CameraParams.create(**K)
    T = lambda a: torch.as_tensor(np.asarray(a, dtype))
    pose_t = tlie.se3_exp(T(xi))
    outs_t = [
        tcam.backproject(pt, T(uv), T(depth)),
        tcam.project_local(pt, T(pts))[0],
        tcam.project(pt, pose_t, T(pts))[0],
        tcam.project_jacobian_point(pt, T(pts)),
        tcam.project_jacobian_pose(pt, T(pts)),
    ]
    return outs_j, [o.numpy() for o in outs_t]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_camera_matches_jax(rng, dtype):
    if dtype == np.float64:
        with jax.enable_x64():
            a, b = _run(dtype, rng)
    else:
        a, b = _run(dtype, rng)
    tol = 1e-3 if dtype == np.float32 else 1e-9
    for x, y in zip(a[:3], b[:3]):
        assert y.dtype == dtype
        np.testing.assert_allclose(x, y, atol=tol)
    rtol = 1e-4 if dtype == np.float32 else 1e-10
    for x, y in zip(a[3:], b[3:]):
        np.testing.assert_allclose(x, y, rtol=rtol, atol=rtol)


def test_project_local_guards_zero_depth():
    """|z| < eps is clamped to +-eps, as in the JAX package."""
    pt = tcam.CameraParams.create(**K)
    uv, z = tcam.project_local(pt, torch.tensor([[1.0, 1.0, 0.0], [1.0, 1.0, -1e-12]]))
    assert torch.all(torch.isfinite(uv))
    assert uv[0, 0] > 0 and uv[1, 0] < 0
