"""The port's window solve (`dynosam_tpu_torch/backend/schur.py`: the
WorldMotion normal system, the stable Woodbury Schur step and the LM
driver) against the JAX package on a window-10 simulator scenario, and a
port-only float64 check against a dense solve.

Tolerances (float32 unless stated):

* NormalSystem fields: 1e-4 of each field's max-abs; the pose-family
  Jacobians (closed forms) against `jax.jacfwd`: 1e-5;
* one Schur step at lambda 1e-4 and 1e-7: X, H, sp and dp deltas within
  1e-3 of their max-abs;
* 7 LM iterations: final error within rtol 3e-2 of JAX's, iterations
  within 1, camera translations within 2e-3 m.  Float32 rounding alone
  moves this solve that far (`tests/f32_spread.py`): the JAX solve's final
  error by up to 1.6 % and its translations by up to 9.3e-4 m when its
  static measurements move by one part in 1e7, the port's by up to 1.2 %
  and 3.5e-4 m between CPU thread counts; the ~1e10-conditioned window
  with Huber k 1e-4 (every observation in its linear regime) amplifies
  rounding that far, so a tighter bound would test the order of float32
  sums, not the port;
* float64: one step equals the dense solve of the same damped normal
  equations to 3e-6 (`tests/f64_check.py` item 2 does this for JAX).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu.backend import formulation as jfm
from dynosam_tpu.backend import map as jmap
from dynosam_tpu.backend import schur as jschur
from dynosam_tpu.backend.solver import LMConfig as JLMConfig
from dynosam_tpu.core import lie as jlie
from dynosam_tpu.ops import factors as jfactors
from dynosam_tpu.ops.robust import robust_sqrt_weights
from dynosam_tpu.testing.simulator import Scenario, ScenarioConfig
from dynosam_tpu.utils.config import BackendConfig as JBackendConfig
from dynosam_tpu_torch import convert
from dynosam_tpu_torch.backend import formulation as tfm
from dynosam_tpu_torch.backend import map as tmap
from dynosam_tpu_torch.backend import schur as tschur
from dynosam_tpu_torch.backend.solver import LMConfig, dense_normal_solve, retract_tree
from dynosam_tpu_torch.core.lie import SE3
from dynosam_tpu_torch.ops import factors as tfactors
from dynosam_tpu_torch.utils.config import BackendConfig

torch.set_num_threads(2)


def to_port(tree):
    """A JAX value (SE3, array, dict of them) as the port's CPU tensors."""
    if isinstance(tree, dict):
        return {k: to_port(v) for k, v in tree.items()}
    if isinstance(tree, jlie.SE3):
        return SE3(torch.as_tensor(np.array(tree.R)), torch.as_tensor(np.array(tree.t)))
    return torch.as_tensor(np.array(tree))


def rel_err(a, b):
    a = np.asarray(a)
    return float(np.abs(a - b.numpy()).max() / max(np.abs(a).max(), 1e-30))


def clone(tree):
    """A port tree (NamedTuples, SE3, tensors) with every tensor copied."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(clone(x) for x in tree))
    return tree


_JAX_TYPES = {"SE3": jlie.SE3, "MeasurementMap": jmap.MeasurementMap, "WindowData": jmap.WindowData,
              "WindowMasks": jfm.WindowMasks}


def to_jax(tree):
    """A port map, window or mask tree as the JAX package's same NamedTuple,
    every leaf a JAX copy of the port's array (`jnp.asarray` would share a
    CPU tensor's memory, which the port's `update_map` writes in place), a
    window's Python `start` as the int32 scalar JAX's `slice_window` makes."""
    if isinstance(tree, torch.Tensor):
        return jnp.array(tree.numpy())
    if isinstance(tree, int):
        return jnp.asarray(tree, jnp.int32)
    return _JAX_TYPES[type(tree).__name__](*(to_jax(x) for x in tree))


@functools.lru_cache(maxsize=None)
def _scenario(key):
    sc = Scenario(ScenarioConfig(*key))
    return sc, tuple(jax.tree.map(np.asarray, p) for p in sc.frontend_outputs())


def scenario(scfg):
    """The JAX `Scenario` of `scfg` and its packets as numpy trees (read-only
    arrays), built once per process.  Read the scenario's ground truth
    only: its packets are drawn (`frontend_outputs` draws the noise from
    the scenario's generator, so a second call would give other packets)."""
    return _scenario(dataclasses.astuple(scfg))


def scenario_packets(scfg):
    """The JAX simulator's packets of `scfg` as numpy trees (`scenario`)."""
    return scenario(scfg)[1]


def jax_packets(scfg):
    """`scenario_packets(scfg)` as JAX packets."""
    return [jax.tree.map(jnp.asarray, p) for p in scenario_packets(scfg)]


def port_packets(scfg):
    """`scenario_packets(scfg)` as the port's CPU packets."""
    return [convert.frontend_output_from_numpy(p, device="cpu") for p in scenario_packets(scfg)]


@functools.lru_cache(maxsize=None)
def _port_map(key):
    scfg = ScenarioConfig(*key)
    tm = tmap.MeasurementMap.create(scfg.n_frames, scfg.ns, scfg.nd, scfg.no, device="cpu")
    for k, p in enumerate(_scenario(key)[1]):
        tmap.update_map(tm, convert.frontend_output_from_numpy(p, device="cpu"), k)
    return tm


def port_map(scfg):
    """The JAX simulator's packets of `scfg` in the port's map (a copy of
    one built once per process).  The port's `update_map` gives the JAX
    map's bits (`tests/test_torch_backend_map.py`), so `to_jax` of it is
    the map JAX's `update_map` builds."""
    return clone(_port_map(dataclasses.astuple(scfg)))


@functools.lru_cache(maxsize=None)
def _window_cached(key, kw):
    scfg = ScenarioConfig(*key)
    tw = tmap.slice_window(_port_map(key), 0, scfg.n_frames)
    jc, tc = JBackendConfig(**dict(kw)), BackendConfig(**dict(kw))
    tmk = tfm.build_masks(tw, tc)
    return to_jax(tw), tw, jc, tc, to_jax(tmk), tmk


def _window(scfg, cfg_kw=None):
    """(JAX window, port window, JAX config, port config, JAX masks, port
    masks) of the whole scenario `scfg`, the backend configs built from
    `cfg_kw`.  Built once per process and shared by every module that
    imports this one: the map, window and masks through the port from the
    JAX simulator's packets (bit-equal to JAX's own,
    `tests/test_torch_backend_map.py::test_port_built_windows_equal_jax_bits`);
    the port's tensors are copies for each caller."""
    jw, tw, jc, tc, jmk, tmk = _window_cached(dataclasses.astuple(scfg), tuple(sorted((cfg_kw or {}).items())))
    return jw, clone(tw), jc, tc, jmk, clone(tmk)


def moved(jv0, jmk, key="H"):
    """Initial values moved off (X by 1e-2 in the tangent, `key` (H, or
    WorldPose's L) by 5e-2, dp by 2e-2 m): at the initial values the
    dynamic residuals are float32 rounding noise, X^-1 (X z) - z, and so
    are their Huber weights.  H is drawn afresh, L retracted from its
    initial value.  The dp offset is added in numpy in the points' dtype
    (`test_moved_dp_in_numpy_equals_jnp` holds it to the `jnp` sum's bits)."""
    rng = np.random.default_rng(3)
    W, O = jmk.motion_active.shape
    dtype = np.asarray(jv0["dp"]).dtype
    jv = dict(jv0)
    jv["X"] = jlie.se3_retract(jv0["X"], jnp.asarray(rng.normal(0, 0.01, (W, 6)), dtype))
    xi = jnp.asarray(rng.normal(0, 0.05, (W, O, 6)), dtype)
    jv[key] = jlie.se3_exp(xi) if key == "H" else jlie.se3_retract(jv0[key], xi)
    jv["dp"] = jnp.asarray(np.asarray(jv0["dp"]) + rng.normal(0, 0.02, jv0["dp"].shape).astype(dtype))
    return jv


def build_problem():
    """A window-10 scenario (2 objects, default sigmas) and both packages'
    normal systems at values moved off the initial ones (`moved`)."""
    jw, tw, jc, tc, jmk, tmk = _window(ScenarioConfig(n_frames=10))
    jv0, tv0 = jfm.init_values(jw, jmk, jc), tfm.init_values(tw, tmk, tc)
    jv = moved(jv0, jmk)
    tv = to_port(jv)

    @jax.jit
    def jax_system(v):
        anchor = jw.X_init[0]
        res = jfm.world_motion_residuals(v, jw, jmk, jc, anchor)
        sw = [robust_sqrt_weights(r, s.k, s.kind) if s.kind != "none" else jnp.ones(r.shape[:-1])
              for r, s in zip(res, jfm.world_motion_families(jc).robust)]
        return jschur.build_normal_system(v, sw, jw, jmk, jc, anchor, res)

    jsys = jax_system(jv)
    tres = tfm.world_motion_residuals(tv, tw, tmk, tc, tw.X_init[0])
    tsys = tschur.build_normal_system(tv, tschur.sqrt_weights(tres, tfm.world_motion_families(tc).robust),
                                      tw, tmk, tc, tw.X_init[0], tres)
    return dict(jw=jw, tw=tw, jc=jc, tc=tc, jmk=jmk, tmk=tmk, jv=jv0, tv=tv0, jsys=jsys, tsys=tsys)


@pytest.fixture(scope="module")
def problem():
    return build_problem()


def test_normal_system_fields_match(problem):
    jsys, tsys = problem["jsys"], problem["tsys"]
    for f in tsys._fields:
        a, b = np.asarray(getattr(jsys, f)), getattr(tsys, f)
        assert a.shape == tuple(b.shape), f
        assert rel_err(a, b) <= 1e-4, (f, rel_err(a, b))
    # the JAX fields the port leaves out are zero on this path
    for f in ("Omm2", "Ad", "Bd", "Rpp", "Rpc", "Rcp", "Rcc"):
        assert not np.asarray(getattr(jsys, f)).any(), f


def test_pose_family_jacobians_match_jax_jacfwd():
    """Odometry (between), smoothing and anchor (prior) Jacobians, the port's
    closed forms through the SE(3) right Jacobian inverse, against
    `jax.jacfwd` at 1e-5 of their max-abs on random poses: residual angles
    up to about 1 rad, and identical poses (zero smoothing residual)."""
    rng = np.random.default_rng(11)
    n = 24
    xa = rng.normal(0, 0.5, (n, 6)).astype(np.float32)
    xb = xa + rng.normal(0, 1e-3, (n, 6)).astype(np.float32) * (np.arange(n) % 2)[:, None]
    xz = rng.normal(0, 0.3, (n, 6)).astype(np.float32)
    ja, jb, jz = (jlie.se3_exp(jnp.asarray(x)) for x in (xa, xb, xz))
    ta, tb, tz = (to_port(p) for p in (ja, jb, jz))
    sigma = np.asarray([0.05] * 3 + [0.1] * 3, np.float32)
    z6 = jnp.zeros(6, jnp.float32)

    def jax_pair(res):
        def one(Ra, ta_, Rb, tb_, ZR, Zt):
            f = lambda a, b: res(jlie.se3_retract(jlie.SE3(Ra, ta_), a),  # noqa: E731
                                 jlie.se3_retract(jlie.SE3(Rb, tb_), b), jlie.SE3(ZR, Zt))
            return jax.jacfwd(f, argnums=(0, 1))(z6, z6)
        return jax.jit(jax.vmap(one))(ja.R, ja.t, jb.R, jb.t, jz.R, jz.t)

    tsigma = torch.as_tensor(sigma)
    identity = SE3(torch.eye(3), torch.zeros(3))
    cases = [
        (jax_pair(lambda a, b, Z: jfactors.between_residual(a, b, Z) / sigma),
         tschur._between_jacobians(ta, tb, tz, tsigma)),
        (jax_pair(lambda a, b, Z: jfactors.motion_smoothing_residual(a, b) / sigma),
         tschur._between_jacobians(ta, tb, identity, tsigma)),
    ]
    for (j0, j1), (t0, t1) in cases:
        assert t0.dtype == torch.float32
        assert rel_err(j0, t0) <= 1e-5 and rel_err(j1, t1) <= 1e-5, (rel_err(j0, t0), rel_err(j1, t1))
    j_anchor = jax.jit(jax.jacfwd(lambda a: jfactors.prior_residual(jlie.se3_retract(ja[0], a), jz[0]) / 1e-4))(z6)
    t_anchor = tschur._right_jacobian_inv(tfactors.prior_residual(ta[0], tz[0])) / 1e-4
    assert rel_err(j_anchor, t_anchor) <= 1e-5


_jax_step = jax.jit(lambda sys, lam: jschur.schur_step(sys, lam, 1e-6, formulation=0))


@pytest.mark.parametrize("lam", [1e-4, 1e-7])
def test_schur_step_matches_jax(problem, lam):
    jd = _jax_step(problem["jsys"], jnp.asarray(lam, jnp.float32))
    td = tschur.schur_step(problem["tsys"], torch.tensor(lam, dtype=torch.float32), 1e-6)
    for k in ("X", "P", "sp", "dp"):
        assert torch.isfinite(td[k]).all(), k
        assert rel_err(jd[k], td[k]) <= 1e-3, (k, rel_err(jd[k], td[k]))


def test_lm_optimize_schur_matches_jax(problem):
    p = problem
    jres = jax.jit(lambda v: jschur.lm_optimize_schur(v, p["jw"], p["jmk"], p["jc"], JLMConfig(max_iterations=7),
                                                      p["jw"].X_init[0]))(p["jv"])
    tres = tschur.lm_optimize_schur(p["tv"], p["tw"], p["tmk"], p["tc"], LMConfig(max_iterations=7),
                                    p["tw"].X_init[0])
    assert float(tres.initial_error) == pytest.approx(float(jres.initial_error), rel=1e-5)
    assert float(tres.error) < float(tres.initial_error)
    assert float(tres.error) == pytest.approx(float(jres.error), rel=3e-2)
    assert abs(tres.iterations - int(jres.iterations)) <= 1
    np.testing.assert_allclose(tres.values["X"].t.numpy(), np.asarray(jres.values["X"].t), rtol=0, atol=2e-3)
    assert tres.lam.dtype == torch.float32


def test_failed_cholesky_gives_a_rejected_step_not_an_exception(problem, monkeypatch):
    """An indefinite reduced system makes `cholesky_ex` fail: the step is
    NaN (as JAX's `cho_factor` gives), and the LM rejects it, raises lambda
    and keeps its values instead of raising."""
    p = problem
    bad_t = p["tsys"]._replace(Hcc=-p["tsys"].Hcc)
    bad_j = p["jsys"]._replace(Hcc=-p["jsys"].Hcc)
    td = tschur.schur_step(bad_t, torch.tensor(1e-4), 1e-6)
    jd = _jax_step(bad_j, jnp.asarray(1e-4, jnp.float32))
    assert torch.isnan(td["X"]).all() and np.isnan(np.asarray(jd["X"])).any()

    real_build = tschur.build_normal_system
    monkeypatch.setattr(tschur, "build_normal_system",
                        lambda *a, **k: (lambda s: s._replace(Hcc=-s.Hcc))(real_build(*a, **k)))
    res = tschur.lm_optimize_schur(p["tv"], p["tw"], p["tmk"], p["tc"], LMConfig(max_iterations=2),
                                   p["tw"].X_init[0])
    assert res.iterations == 2
    assert float(res.error) == float(res.initial_error)
    assert float(res.lam) == pytest.approx(1e-3, rel=1e-6)   # 1e-5 x 10 x 10
    assert torch.equal(res.values["X"].t, p["tv"]["X"].t)


def _f64(tree):
    if isinstance(tree, torch.Tensor):
        return tree.double() if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: _f64(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_f64(x) for x in tree))
    return tree


def test_schur_step_equals_dense_solve_float64():
    """Port-only: in float64 the Woodbury Schur step equals
    `solver.dense_normal_solve` of the same damped normal equations to
    3e-6 (the problem of `tests/f64_check.py`: softened ternary sigma, 8
    frames), the cross-check `tests/test_schur.py:63` makes in JAX."""
    scfg = ScenarioConfig(n_frames=8, n_static=30, n_objects=2, pts_per_object=10, ns=40, nd=32, no=4,
                          point_noise=0.02)
    _, tw, _, tc, _, _ = _window(scfg, dict(motion_ternary_factor_noise_sigma=0.05))
    tw = _f64(tw)
    tmk = tfm.build_masks(tw, tc)
    vals = _f64(tfm.init_values(tw, tmk, tc))
    anchor = tw.X_init[0]
    specs = tfm.world_motion_families(tc).robust
    resid = lambda v: tfm.world_motion_residuals(v, tw, tmk, tc, anchor)  # noqa: E731
    lam = 1e-3
    res0 = resid(vals)
    sys = tschur.build_normal_system(vals, tschur.sqrt_weights(res0, specs), tw, tmk, tc, anchor, res0)
    step = tschur.schur_step(sys, torch.tensor(lam, dtype=torch.float64), 1e-6)
    got = retract_tree(vals, {"X": step["X"], "H": step["P"], "sp": step["sp"], "dp": step["dp"]})
    want, _ = dense_normal_solve(resid, specs, vals, lam)
    assert got["X"].t.dtype == torch.float64
    for a, b in ((got["X"].t, want["X"].t), (got["X"].R, want["X"].R), (got["H"].t, want["H"].t),
                 (got["sp"], want["sp"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=3e-6)
    ok = tmk.dyn_obs[..., None].numpy()
    # dp comes from the chain back-substitution on top of the reduced
    # solve, as in `tests/f64_check.py` (atol 1e-5 there)
    np.testing.assert_allclose(got["dp"].numpy() * ok, want["dp"].numpy() * ok, rtol=0, atol=1e-5)


def assert_moved_dp_equals_jnp(jv0, jmk, got):
    """`moved(jv0, jmk, ...)["dp"]` (`got`) has the bits of the `jnp` sum
    it replaces, `jv0["dp"] + jnp.asarray(draw, dtype)`."""
    rng = np.random.default_rng(3)
    W, O = jmk.motion_active.shape
    rng.normal(0, 0.01, (W, 6)), rng.normal(0, 0.05, (W, O, 6))
    dtype = jv0["dp"].dtype
    want = jv0["dp"] + jnp.asarray(rng.normal(0, 0.02, jv0["dp"].shape), dtype)
    assert got.dtype == want.dtype == dtype
    assert np.array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("formulation", ["motion", "pose"])
def test_moved_dp_in_numpy_equals_jnp(formulation):
    """`moved` adds its dp offset in numpy: on the values the fixtures move
    (WorldMotion's and WorldPose's initial values of the window-10
    scenario), the sum has the bits of the `jnp` sum it replaces
    (`test_torch_world_pose.py::test_schur_step_pose_float64_matches_jax`
    checks WorldPose's float64 values too)."""
    jw, _, jc, _, jmk, _ = _window(ScenarioConfig(n_frames=10))
    jv0 = (jfm.init_values if formulation == "motion" else jfm.init_values_world_pose)(jw, jmk, jc)
    assert_moved_dp_equals_jnp(jv0, jmk, moved(jv0, jmk, "H" if formulation == "motion" else "L")["dp"])

