"""The port's variable-projection solve (`dynosam_tpu_torch/backend/varpro.py`,
experimental and off by default) against the JAX package, after
`tests/test_varpro.py`: the closed-form landmark eliminations on the
8-frame, 2-object scenario, the reduced LM with the Hutchinson probes JAX
draws, and `use_varpro` through the online backend.

Tolerances (float32): static points within 1e-6 m of JAX's and 1e-3 m of
the truth without noise; dynamic points within 1e-4 m of JAX's (3x3
solves in another order along a chain of 8 frames) and 5e-3 m of the
truth; the reduced LM, one iteration with JAX's probes: final error and
camera translations within twice the measured float32 floor, as in
`tests/test_torch_solver.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu.backend import formulation as jfm
from dynosam_tpu.backend import solver as jsolver
from dynosam_tpu.backend import varpro as jvarpro
from dynosam_tpu.core.lie import SE3 as JSE3
from dynosam_tpu.testing.simulator import ScenarioConfig
from dynosam_tpu.utils import config as jcfg
from dynosam_tpu_torch import pipeline as tpipe
from dynosam_tpu_torch.backend import formulation as tfm
from dynosam_tpu_torch.backend import solver as tsolver
from dynosam_tpu_torch.backend import varpro as tvarpro
from dynosam_tpu_torch.backend.backend import lm_config
from dynosam_tpu_torch.utils import config as tcfg

from test_torch_schur import _window, port_packets, scenario, to_port
from test_torch_solver import jax_probes

torch.set_num_threads(2)


def make_problem(point_noise=0.0):
    """The 8-frame, 2-object scenario: its ground truth, config, both
    windows and both masks (`test_torch_schur._window`, built once per
    process)."""
    scfg = ScenarioConfig(n_frames=8, n_static=30, n_objects=2, pts_per_object=10, ns=40, nd=32, no=4,
                          point_noise=point_noise, odom_rot_noise=0.0, odom_trans_noise=0.0)
    jw, tw, _, _, jmk, tmk = _window(scfg)
    return scenario(scfg)[0], scfg, jw, tw, jmk, tmk


def gt_values(sc, scfg):
    """True camera poses and constant object motions, padded to 4 slots
    (stacked and tiled in numpy: no arithmetic, so JAX's bits)."""
    R = np.stack([np.asarray(sc.H_gt[j][1].R) for j in range(scfg.n_objects)])
    t = np.stack([np.asarray(sc.H_gt[j][1].t) for j in range(scfg.n_objects)])
    F = scfg.n_frames
    eye = np.tile(np.eye(3, dtype=np.float32), (F, 2, 1, 1))
    H = JSE3(jnp.asarray(np.concatenate([np.tile(R[None], (F, 1, 1, 1)), eye], 1)),
             jnp.asarray(np.concatenate([np.tile(t[None], (F, 1, 1)), np.zeros((F, 2, 3), np.float32)], 1)))
    return sc.X_gt, H


def test_gt_values_in_numpy_equal_jnp():
    """`gt_values` stacks in numpy what `jnp` stacked: the same dtypes and
    bits on the scenario the tests use."""
    sc, scfg = make_problem(0.02)[:2]
    R = jnp.stack([sc.H_gt[j][1].R for j in range(scfg.n_objects)])
    t = jnp.stack([sc.H_gt[j][1].t for j in range(scfg.n_objects)])
    F = scfg.n_frames
    eye = jnp.tile(jnp.eye(3, dtype=jnp.float32), (F, 2, 1, 1))
    want = JSE3(jnp.concatenate([jnp.tile(R[None], (F, 1, 1, 1)), eye], 1),
                jnp.concatenate([jnp.tile(t[None], (F, 1, 1)), jnp.zeros((F, 2, 3), jnp.float32)], 1))
    got = gt_values(sc, scfg)[1]
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("noise", [0.0, 0.02])
def test_optimal_points_match_jax(noise):
    sc, scfg, jw, tw, jmk, tmk = make_problem(noise)
    X, H = gt_values(sc, scfg)
    tX, tH = to_port(X), to_port(H)
    jsp = jvarpro.optimal_static_points(X, jw, jmk)
    tsp = tvarpro.optimal_static_points(tX, tw, tmk)
    np.testing.assert_allclose(tsp.numpy(), np.asarray(jsp), rtol=0, atol=1e-6)
    idx = jnp.clip(jw.dyn_obj, 0, 3)
    H_all = JSE3(jnp.take_along_axis(H.R, idx[..., None, None], axis=1),
                 jnp.take_along_axis(H.t, idx[..., None], axis=1))
    jdp = jvarpro.optimal_dynamic_points(X, H_all, jw, jmk, jcfg.BackendConfig())
    full = tvarpro.recover_points(tX, tH, tw, tmk, tcfg.BackendConfig())
    assert torch.equal(full["sp"], tsp)
    np.testing.assert_allclose(full["dp"].numpy(), np.asarray(jdp), rtol=0, atol=1e-4)
    if noise == 0.0:
        np.testing.assert_allclose(tsp[:scfg.n_static].numpy(), np.asarray(sc.static_w), atol=1e-3)
        P = scfg.pts_per_object
        for j in range(scfg.n_objects):
            sl = slice(j * P, (j + 1) * P)
            err = np.linalg.norm(full["dp"][:, sl].numpy() - np.asarray(sc.obj_points_w[j]), axis=-1)
            assert err[tmk.dyn_obs[:, sl].numpy()].max() < 5e-3


def test_varpro_lm_matches_jax_with_its_probes():
    """The reduced {X, H} LM (`world_motion_varpro_residuals`, J^T W J by
    `torch.func.jvp`/`vjp`, Hutchinson diagonal from JAX's probes), one
    iteration from the initial values with 20 CG iterations."""
    from test_torch_world_pose_solve import _floor_and_diff

    sc, scfg, jw, tw, jmk, tmk = make_problem(0.02)
    jc, tc = jcfg.BackendConfig(cg_max_iterations=20), tcfg.BackendConfig(cg_max_iterations=20)
    specs = jfm.world_motion_families(jc).robust
    lm = jsolver.LMConfig(max_iterations=1, cg_max_iterations=20, cg_tol=jc.cg_tol)
    t0 = tfm.init_values(tw, tmk, tc)          # the probes take the tangent's shapes only
    template = {k: jnp.zeros(v.shape, jnp.float32) for k, v in tsolver.zero_delta({"X": t0["X"], "H": t0["H"]}).items()}

    @jax.jit
    def jax_solve(w):
        v = jfm.init_values(w, jmk, jc)
        return jsolver.lm_optimize(lambda x: jvarpro.world_motion_varpro_residuals(x, w, jmk, jc, w.X_init[0]),
                                   specs, {"X": v["X"], "H": v["H"]}, lm, gn_diag_fn=None)

    def port_solve(w):
        v = tfm.init_values(w, tmk, tc)
        resid = lambda x: tvarpro.world_motion_varpro_residuals(x, w, tmk, tc, w.X_init[0])  # noqa: E731
        return tsolver.lm_optimize(resid, tfm.world_motion_families(tc).robust, {"X": v["X"], "H": v["H"]},
                                   lm_config(tc)._replace(max_iterations=1),
                                   normal_fn=tvarpro.linearized_normal_product(resid),
                                   probes=lambda it: jax_probes(template, it))

    (je, jt), (te, tt), (de, dt), (jres, tres) = _floor_and_diff(jax_solve, port_solve, jw, tw)
    # the eliminated points carry the chain solve's float32 rounding into
    # residuals whitened by sigma 1e-5: the initial errors agree to 1e-4
    assert float(tres.initial_error) == pytest.approx(float(jres.initial_error), rel=1e-4)
    assert float(tres.lam) == float(jres.lam)
    assert de <= 2 * (je + te), (de, je, te)
    assert dt <= 2 * (jt + tt), (dt, jt, tt)


def test_use_varpro_runs_through_the_online_backend():
    """`use_varpro=True` through `run_from_packets` (the full batch of 8
    frames, 3 LM iterations, probes from the backend's generator): the
    error drops, and every frame and point written back is finite."""
    scfg = ScenarioConfig(n_frames=8, n_static=30, n_objects=2, pts_per_object=10, ns=40, nd=32, no=4)
    kw = dict(use_varpro=True, use_full_batch_opt=True, lm_max_iterations=3, cg_max_iterations=20)

    cfg = tcfg.DynoConfig(backend=tcfg.BackendConfig(**kw), capacity=tcfg.CapacityConfig(
        max_static_tracks=40, max_dynamic_tracks=32, max_objects=4, max_frames=8))
    tb = tpipe.run_from_packets(port_packets(scfg), cfg, device="cpu")
    (start, window, r, _), = tb.solves
    assert (start, window) == (0, 8)
    assert float(r.error) < float(r.initial_error)
    assert torch.isfinite(tb.est.X.t).all() and torch.isfinite(tb.est.dyn_points).all()
    assert set(r.values) == {"X", "H", "sp", "dp"}
    assert tb.est.X_valid.all() and tb.est.dyn_valid.any()


def test_varpro_gn_diag_matches_jax():
    """The reduced problem's Jacobi diagonal (the full problem's analytic
    one at the eliminated points) at the true poses and motions, both
    packages given JAX's IRLS weights of the varpro residuals (Huber k
    1e-4 turns float32 rounding of near-zero residuals into different
    weights): each leaf within 1e-4 of its max-abs (the eliminated points
    carry the chain solve's float32 rounding, as in
    `test_optimal_points_match_jax`)."""
    sc, scfg, jw, tw, jmk, tmk = make_problem(0.02)
    X, H = gt_values(sc, scfg)
    jc, tc = jcfg.BackendConfig(), tcfg.BackendConfig()
    jv, tv = {"X": X, "H": H}, {"X": to_port(X), "H": to_port(H)}
    from dynosam_tpu.ops.robust import robust_sqrt_weights

    @jax.jit
    def jax_side(v):
        res = jvarpro.world_motion_varpro_residuals(v, jw, jmk, jc, jw.X_init[0])
        sw = [robust_sqrt_weights(r, s.k, s.kind) if s.kind != "none" else jnp.ones(r.shape[:-1])
              for r, s in zip(res, jfm.world_motion_families(jc).robust)]
        return sw, jvarpro.varpro_gn_diag(v, sw, jw, jmk, jc)

    jsw, jd = jax_side(jv)
    td = tvarpro.varpro_gn_diag(tv, [to_port(x) for x in jsw], tw, tmk, tc)
    assert set(td) == {"X", "H"}
    for k in ("X", "H"):
        a = np.asarray(jd[k])
        assert float(np.abs(a - td[k].numpy()).max()) <= 1e-4 * float(np.abs(a).max()), k
