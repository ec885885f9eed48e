"""The port's WorldPose formulation (updater 1) against the JAX package on
the window-10 simulator scenario of `tests/test_torch_schur.py`:
`formulation.world_pose_residuals`, `world_pose_gn_diag`,
`schur.world_pose_normal_product`, the closed-form pose-family Jacobians,
`build_normal_system_pose`, `schur_step(formulation=1)` and the updater-1
accessors (the solves are `tests/test_torch_world_pose_solve.py`).

Tolerances (float32 unless stated):

* residuals: 1e-5 of each family's max-abs; GN diagonal, J^T W J d and
  g = J^T W r0 (against `jax.linearize` + `jax.linear_transpose`): 1e-4;
  NormalSystem fields: 1e-4; triplet and kinematic Jacobians against
  `jax.jacfwd`: 1e-5 (the JAX log's small-angle branch differentiates
  its own polynomial);
* one Schur step, float64 (JAX under `jax_enable_x64`): 1e-5 of each
  delta's max-abs; float32: 5e-3 at lambda 1e-4 and 5e-2 at 1e-7 (the
  measured difference is 3.8e-3 and 2.1e-2: the window is ~1e10
  conditioned, and 1e-7 changes of the inputs move the float32 step by
  30 % and more);
* the accessors on one shared estimate store: H_k = L_k L_{k-1}^-1 within
  1e-5, validity equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu.backend import backend as jbe
from dynosam_tpu.backend import formulation as jfm
from dynosam_tpu.backend import schur as jschur
from dynosam_tpu.backend import solver as jsolver
from dynosam_tpu.core import lie as jlie
from dynosam_tpu.ops import factors as jfactors
from dynosam_tpu.ops.robust import robust_sqrt_weights
from dynosam_tpu.testing.simulator import ScenarioConfig
from dynosam_tpu.utils import config as jcfg
from dynosam_tpu_torch.backend import backend as tbe
from dynosam_tpu_torch.backend import formulation as tfm
from dynosam_tpu_torch.backend import schur as tschur
from dynosam_tpu_torch.backend import solver as tsolver
from dynosam_tpu_torch.core.lie import SE3
from dynosam_tpu_torch.utils import config as tcfg

from test_torch_schur import _window, assert_moved_dp_equals_jnp, moved, rel_err, to_port

torch.set_num_threads(2)


def _jax_sqrt_w(res, specs):
    return [robust_sqrt_weights(r, s.k, s.kind) if s.kind != "none" else jnp.ones(r.shape[:-1], r.dtype)
            for r, s in zip(res, specs)]


def _moved(jw, jmk, jc, check_dp=False):
    """WorldPose initial values moved off (`test_torch_schur.moved`: X by
    1e-2, L by 5e-2 in the tangent, dp by 2e-2 m): at the initial values
    the dynamic residuals are float32 rounding noise, and so are their
    Huber weights.  `check_dp`: also hold the numpy dp offset to the `jnp`
    sum's bits."""
    jv0 = jfm.init_values_world_pose(jw, jmk, jc)
    jv = moved(jv0, jmk, "L")
    if check_dp:
        assert_moved_dp_equals_jnp(jv0, jmk, jv["dp"])
    return jv


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "kinematic"])
def linearised(request):
    """Both packages' residuals, GN diagonal, product on a random tangent,
    gradient and normal system at moved values, with and without the
    kinematic family."""
    kw = dict(use_object_kinematic_factor=request.param)
    jw, tw, jc, tc, jmk, tmk = _window(ScenarioConfig(n_frames=10), kw)
    jv = _moved(jw, jmk, jc)
    tv = to_port(jv)
    specs = jfm.world_pose_families(jc).robust
    rng = np.random.default_rng(8)
    W, O = jmk.motion_active.shape
    d = {k: rng.normal(0, 1, s).astype(np.float32)
         for k, s in {"X": (W, 6), "L": (W, O, 6), "sp": jv["sp"].shape, "dp": jv["dp"].shape}.items()}

    @jax.jit
    def jax_side(v, dd):
        anchor = jw.X_init[0]
        res = jfm.world_pose_residuals(v, jw, jmk, jc, anchor)
        sw = _jax_sqrt_w(res, specs)

        def f(delta):
            rs = jfm.world_pose_residuals(jsolver.retract_tree(v, delta), jw, jmk, jc, anchor)
            return [s[..., None] * r for s, r in zip(sw, rs)]

        d0 = jsolver.zero_delta(v)
        wr0, jvp = jax.linearize(f, d0)
        vjp = jax.linear_transpose(jvp, d0)
        sys = jschur.build_normal_system_pose(v, sw, jw, jmk, jc, anchor, res)
        return res, jfm.world_pose_gn_diag(v, sw, jw, jmk, jc), vjp(jvp(dd))[0], vjp(wr0)[0], sys

    jres, jdiag, jprod, jg, jsys = jax_side(jv, {k: jnp.asarray(x) for k, x in d.items()})
    anchor = tw.X_init[0]
    tres = tfm.world_pose_residuals(tv, tw, tmk, tc, anchor)
    tsw = tsolver.sqrt_weights(tres, tfm.world_pose_families(tc).robust)
    JtJ_mv, tg = tschur.world_pose_normal_product(tv, tsw, tres, tw, tmk, tc, anchor)
    return dict(
        kinematic=request.param,
        res=(jres, tres), diag=(jdiag, tfm.world_pose_gn_diag(tv, tsw, tw, tmk, tc)),
        product=(jprod, JtJ_mv({k: torch.as_tensor(x) for k, x in d.items()})), gradient=(jg, tg),
        system=(jsys, tschur.build_normal_system_pose(tv, tsw, tw, tmk, tc, anchor, tres)),
    )


def test_world_pose_residuals_match_jax(linearised):
    jres, tres = linearised["res"]
    assert len(tres) == len(jres) == (7 if linearised["kinematic"] else 6)
    for i, (a, b) in enumerate(zip(jres, tres)):
        assert np.asarray(a).shape == tuple(b.shape), i
        assert np.abs(np.asarray(a)).max() > 0, i
        assert rel_err(a, b) <= 1e-5, (i, rel_err(a, b))


@pytest.mark.parametrize("quantity", ["diag", "product", "gradient"])
def test_world_pose_linearisation_matches_jax(linearised, quantity):
    j, t = linearised[quantity]
    for k in ("X", "L", "sp", "dp"):
        assert np.asarray(j[k]).shape == tuple(t[k].shape), k
        assert np.abs(np.asarray(j[k])).max() > 0, k
        assert rel_err(j[k], t[k]) <= 1e-4, (quantity, k, rel_err(j[k], t[k]))


def test_normal_system_pose_fields_match(linearised):
    jsys, tsys = linearised["system"]
    for f in tsys._fields:
        a, b = np.asarray(getattr(jsys, f)), getattr(tsys, f)
        assert a.shape == tuple(b.shape), f
        assert rel_err(a, b) <= 1e-4, (f, rel_err(a, b))
    assert np.abs(np.asarray(jsys.Omm2)).max() > 0
    for f in ("Ad", "Bd", "Rpp", "Rpc", "Rcp", "Rcc"):
        assert not np.asarray(getattr(jsys, f)).any(), f


def test_pose_family_jacobians_match_jax_jacfwd():
    """The pose-smoothing triplet and kinematic Jacobians (closed forms
    through the SE(3) right Jacobian inverse) against `jax.jacfwd` on
    random pose chains L_a, L_b = Exp(h) L_a, L_c = Exp(h + e) L_b with
    residual angles up to about 1 rad, and e = 0 (constant motion, zero
    smoothing residual) on every other row."""
    rng = np.random.default_rng(12)
    n = 24
    xa, h, e, e2 = (rng.normal(0, s_, (n, 6)).astype(np.float32) for s_ in (0.5, 0.3, 0.3, 0.3))
    e[::2] = 0.0
    ja = jlie.se3_exp(jnp.asarray(xa))
    jb = jlie.se3_compose(jlie.se3_exp(jnp.asarray(h)), ja)
    jc_ = jlie.se3_compose(jlie.se3_exp(jnp.asarray(h + e)), jb)
    jh = jlie.se3_exp(jnp.asarray(h + e2))
    ta, tb, tc_, th = (to_port(p) for p in (ja, jb, jc_, jh))
    sigma = np.asarray([0.01] * 3 + [0.02] * 3, np.float32)
    z6 = jnp.zeros(6, jnp.float32)

    def triplet(Ra, ta_, Rb, tb_, Rc, tc2):
        f = lambda a, b, c: jfactors.landmark_pose_smoothing_residual(  # noqa: E731
            jlie.se3_retract(jlie.SE3(Ra, ta_), a), jlie.se3_retract(jlie.SE3(Rb, tb_), b),
            jlie.se3_retract(jlie.SE3(Rc, tc2), c)) / sigma
        return jax.jacfwd(f, argnums=(0, 1, 2))(z6, z6, z6)

    def kinematic(RH, tH, Ra, ta_, Rb, tb_):
        f = lambda a, b: jfactors.object_kinematic_residual(  # noqa: E731
            jlie.SE3(RH, tH), jlie.se3_retract(jlie.SE3(Ra, ta_), a), jlie.se3_retract(jlie.SE3(Rb, tb_), b)) / 0.1
        return jax.jacfwd(f, argnums=(0, 1))(z6, z6)

    jt = jax.jit(jax.vmap(triplet))(ja.R, ja.t, jb.R, jb.t, jc_.R, jc_.t)
    tt = tschur._triplet_jacobians(ta, tb, tc_, torch.as_tensor(sigma))
    jk = jax.jit(jax.vmap(kinematic))(jh.R, jh.t, ja.R, ja.t, jb.R, jb.t)
    tk = tschur._kinematic_jacobians(th, ta, tb, 0.1)
    for j, t in list(zip(jt, tt)) + list(zip(jk, tk)):
        assert rel_err(j, t) <= 1e-5, rel_err(j, t)


@pytest.fixture(scope="module")
def problem():
    jw, tw, jc, tc, jmk, tmk = _window(ScenarioConfig(n_frames=10))
    return dict(jw=jw, tw=tw, jc=jc, tc=tc, jmk=jmk, tmk=tmk)


def _system(jw, jmk, jc, v):
    anchor = jw.X_init[0]
    res = jfm.world_pose_residuals(v, jw, jmk, jc, anchor)
    return jschur.build_normal_system_pose(v, _jax_sqrt_w(res, jfm.world_pose_families(jc).robust), jw, jmk, jc,
                                           anchor, res)


def _port_system(tw, tmk, tc, tv):
    anchor = tw.X_init[0]
    res = tfm.world_pose_residuals(tv, tw, tmk, tc, anchor)
    return tschur.build_normal_system_pose(tv, tsolver.sqrt_weights(res, tfm.world_pose_families(tc).robust), tw,
                                           tmk, tc, anchor, res)


@pytest.fixture(scope="module")
def systems(problem):
    """Both packages' WorldPose normal systems at the moved values."""
    p = problem
    jv = _moved(p["jw"], p["jmk"], p["jc"])
    jsys = jax.jit(lambda v: _system(p["jw"], p["jmk"], p["jc"], v))(jv)
    return jsys, _port_system(p["tw"], p["tmk"], p["tc"], to_port(jv))


_jax_step = jax.jit(lambda s, l_: jschur.schur_step(s, l_, 1e-6, formulation=1))


@pytest.mark.parametrize("lam,tol", [(1e-4, 5e-3), (1e-7, 5e-2)])
def test_schur_step_pose_matches_jax(systems, lam, tol):
    jsys, tsys = systems
    jd = _jax_step(jsys, jnp.float32(lam))
    td = tschur.schur_step(tsys, torch.tensor(lam), 1e-6, formulation=1)
    for k in ("X", "P", "sp", "dp"):
        assert torch.isfinite(td[k]).all(), k
        assert rel_err(jd[k], td[k]) <= tol, (k, rel_err(jd[k], td[k]))


def _f64(tree):
    if isinstance(tree, torch.Tensor):
        return tree.double() if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: _f64(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_f64(x) for x in tree))
    return tree


def test_schur_step_pose_float64_matches_jax(problem):
    """In float64 (JAX under `jax_enable_x64`) the WorldPose build and step
    agree with JAX's to 1e-5 at lambda 1e-4 and 1e-7: the algebra of the
    stable elimination with the WorldPose band orientation, apart from
    float32 rounding."""
    p = problem
    jax.config.update("jax_enable_x64", True)
    try:
        cast = lambda t: jax.tree.map(  # noqa: E731
            lambda a: a.astype(jnp.float64) if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating) else a, t)
        jw = cast(p["jw"])
        jv = _moved(jw, p["jmk"], p["jc"], check_dp=True)
        tw = _f64(p["tw"])
        tsys = _port_system(tw, p["tmk"], p["tc"], to_port(jv))
        assert tsys.Hcc.dtype == torch.float64
        jstep = jax.jit(lambda v, lam: jschur.schur_step(_system(jw, p["jmk"], p["jc"], v), lam, 1e-6, formulation=1))
        for lam in (1e-4, 1e-7):
            jd = jstep(jv, jnp.asarray(lam, jnp.float64))
            td = tschur.schur_step(tsys, torch.tensor(lam, dtype=torch.float64), 1e-6, formulation=1)
            for k in ("X", "P", "sp", "dp"):
                assert rel_err(jd[k], td[k]) <= 1e-5, (lam, k, rel_err(jd[k], td[k]))
    finally:
        jax.config.update("jax_enable_x64", False)


def test_updater_1_accessors_match_jax():
    """On one estimate store (random object poses with gaps), the updater-1
    accessors: object motions H_k = L_k L_{k-1}^-1, valid where both poses
    are (identity at frame 0), and object poses = L."""
    scfg = ScenarioConfig(n_frames=12)
    F, O = scfg.n_frames, scfg.no
    rng = np.random.default_rng(6)
    L = jlie.se3_exp(jnp.asarray(rng.normal(0, 1.0, (F, O, 6)), jnp.float32))
    mv = rng.random((F, O)) < 0.7
    mk = lambda mod: mod.DynoConfig(  # noqa: E731
        backend=mod.BackendConfig(backend_updater_enum=1),
        capacity=mod.CapacityConfig(max_static_tracks=scfg.ns, max_dynamic_tracks=scfg.nd, max_objects=O,
                                    max_frames=F))
    jb = jbe.RGBDBackend(mk(jcfg).backend, mk(jcfg).capacity)
    tb = tbe.RGBDBackend(mk(tcfg).backend, mk(tcfg).capacity, device="cpu")
    jb.est = dataclasses.replace(jb.est, L=L, motion_valid=jnp.asarray(mv))
    tb.est = tb.est._replace(L=to_port(L), motion_valid=torch.as_tensor(mv))
    (jH, jv), (tH, tv) = jb.object_motions(), tb.object_motions()
    assert np.array_equal(np.asarray(jv), tv.numpy()) and not tv[0].any()
    assert tv.sum() > 0
    np.testing.assert_allclose(tH.R.numpy(), np.asarray(jH.R), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tH.t.numpy(), np.asarray(jH.t), rtol=0, atol=1e-5)
    (jL, jlv), (tL, tlv) = jb.object_poses(), tb.object_poses()
    assert isinstance(tL, SE3) and torch.equal(tL.t, to_port(L).t)
    assert np.array_equal(np.asarray(jlv), tlv.numpy())
