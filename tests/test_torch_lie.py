"""Port parity: `dynosam_tpu_torch.core.lie` against `dynosam_tpu.core.lie`.

Same numpy inputs through both, in f32 and f64 (JAX under
`jax.enable_x64()`), including the small-angle and near-pi branches.
Tolerances: f32 1e-5 absolute on unit-scale outputs (both evaluate the
same operations; only fused-op rounding differs); f64 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu.core import lie as jlie
from dynosam_tpu_torch.core import lie as tlie

torch.set_num_threads(2)

TOL = {np.float32: 1e-5, np.float64: 1e-12}


def _tangents(rng, n, scale):
    xi = rng.normal(size=(n, 6)) * scale
    wn = np.linalg.norm(xi[:, :3], axis=-1, keepdims=True)
    xi[:, :3] *= np.where(wn > 2.8, 2.8 / wn, 1.0)
    return xi


def _both(fn_j, fn_t, *arrays, dtype):
    """Run fn on JAX (under one `jax.jit`) and torch with the same arrays;
    return numpy pairs."""
    if dtype == np.float64:
        with jax.enable_x64():
            out_j = jax.jit(fn_j)(*(jnp.asarray(a, jnp.float64) for a in arrays))
            out_j = jax.tree.map(np.asarray, out_j)
    else:
        out_j = jax.tree.map(np.asarray, jax.jit(fn_j)(*(jnp.asarray(a, jnp.float32) for a in arrays)))
    out_t = fn_t(*(torch.as_tensor(np.asarray(a, dtype)) for a in arrays))
    if isinstance(out_t, tuple):
        out_t = tuple(o.numpy() for o in out_t)
    else:
        out_t = out_t.numpy()
    return out_j, out_t


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e-6])
def test_so3_exp_log_match(rng, dtype, scale):
    w = rng.normal(size=(64, 3)) * scale
    a, b = _both(jlie.so3_exp, tlie.so3_exp, w, dtype=dtype)
    np.testing.assert_allclose(a, b, atol=TOL[dtype])
    R = np.asarray(b, dtype)
    a, b = _both(jlie.so3_log, tlie.so3_log, R, dtype=dtype)
    np.testing.assert_allclose(a, b, atol=TOL[dtype] * (10 if scale == 1.0 else 1))
    assert b.dtype == dtype


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_so3_log_near_pi_match(rng, dtype):
    axis = rng.normal(size=(32, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    R = np.asarray(tlie.so3_exp(torch.as_tensor(axis * (np.pi - 1e-3))), dtype)
    a, b = _both(jlie.so3_log, tlie.so3_log, R, dtype=dtype)
    # the near-pi branch takes a sqrt of (R_ii - cos th): f32 loses ~3 digits
    np.testing.assert_allclose(a, b, atol=2e-3 if dtype == np.float32 else 1e-9)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("scale", [1.0, 1e-5])
def test_left_jacobians_match(rng, dtype, scale):
    w = rng.normal(size=(32, 3)) * scale
    a, b = _both(jlie.so3_left_jacobian, tlie.so3_left_jacobian, w, dtype=dtype)
    np.testing.assert_allclose(a, b, atol=TOL[dtype])
    a, b = _both(jlie.so3_left_jacobian_inv, tlie.so3_left_jacobian_inv, w, dtype=dtype)
    np.testing.assert_allclose(a, b, atol=TOL[dtype] * 10)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_se3_ops_match(rng, dtype):
    xa, xb = _tangents(rng, 48, 1.0), _tangents(rng, 48, 1.0)
    pts = rng.normal(size=(48, 3)) * 5.0

    def chain(lie):
        def f(xa, xb, pts):
            a, b = lie.se3_exp(xa), lie.se3_exp(xb)
            ab = lie.se3_compose(a, b)
            loc = lie.se3_local(a, b)
            ret = lie.se3_retract(a, xb * 0.1)
            moved = lie.se3_apply(lie.se3_inverse(ab), pts)
            return ab.R, ab.t, loc, ret.R, ret.t, moved, lie.se3_log(a)
        return f

    a, b = _both(chain(jlie), chain(tlie), xa, xb, pts, dtype=dtype)
    scale = 1.0 if dtype == np.float64 else 10.0
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, atol=TOL[dtype] * scale * 10)


def test_se3_small_angle_gradients_are_finite():
    """The sanitised where-branches keep autograd finite at w = 0."""
    xi = torch.zeros(6, requires_grad=True)
    g = tlie.se3_exp(xi)
    loss = g.R.sum() + g.t.sum() + tlie.se3_log(g).sum()
    loss.backward()
    assert torch.all(torch.isfinite(xi.grad))
