"""The port's fixed-lag smoothing (`dynosam_tpu_torch/backend/fixed_lag.py`
and `anchor_prior_L` in the window solve) against the JAX package, after
`tests/test_fixed_lag.py:33-157`.

Tolerances:

* `anchor_prior_L` = I / sigma reproduces the isotropic anchor: residuals
  and normal system within 1 float32 ulp (relative 2.4e-7), both
  formulations;
* `boundary_prior` on the same map and estimates as JAX's, both
  updaters: the marginal information L L^T within twice JAX's own float32
  error, measured here against JAX's float64 marginal (plus 1e-6 of its
  scale);
* float64, port only: the marginal equals the same Schur complement
  taken on the dense Gauss-Newton Hessian (`torch.func.jacfwd`) to 5e-4
  of its scale, as JAX's test holds JAX's;
* end to end (14 frames, windows 6/2): the fixed-lag run converges, and
  its camera ATE stays below max(2 x, + 0.02 m) the fresh-rebuild run's,
  JAX's criterion, for both updaters.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from dynosam_tpu.backend import fixed_lag as jfl
from dynosam_tpu.backend import formulation as jfm
from dynosam_tpu.testing.simulator import ScenarioConfig
from dynosam_tpu.utils import config as jcfg
from dynosam_tpu_torch import pipeline as tpipe
from dynosam_tpu_torch.backend import fixed_lag as tfl
from dynosam_tpu_torch.backend import formulation as tfm
from dynosam_tpu_torch.backend import map as tmap
from dynosam_tpu_torch.backend import schur as tschur
from dynosam_tpu_torch.backend.solver import retract_tree, sqrt_weights, zero_delta
from dynosam_tpu_torch.utils import config as tcfg

from test_torch_schur import port_map, port_packets, scenario, to_jax, to_port

torch.set_num_threads(2)


def _maps(scfg):
    """(the JAX scenario, the JAX map, the port's map) of `scfg`: the map
    built once per process through the port (`test_torch_schur.port_map`),
    the JAX map its arrays."""
    tm = port_map(scfg)
    return scenario(scfg)[0], to_jax(tm), tm


SMALL = ScenarioConfig(n_frames=6, n_static=30, n_objects=1, pts_per_object=10, ns=40, nd=16, no=2)


@pytest.mark.parametrize("updater", [0, 1])
def test_anchor_prior_L_isotropic_equivalence(updater):
    """L = I / sigma whitens the anchor as the isotropic prior does, so the
    fixed-lag machinery degrades to the default on the first window."""
    _, _, tm = _maps(SMALL)
    cfg = tcfg.BackendConfig()
    w = tmap.slice_window(tm, 0, 6)
    masks = tfm.build_masks(w, cfg)
    if updater == 0:
        vals, residuals, build = tfm.init_values(w, masks, cfg), tfm.world_motion_residuals, tschur.build_normal_system
        specs = tfm.world_motion_families(cfg).robust
    else:
        vals = tfm.init_values_world_pose(w, masks, cfg)
        residuals, build = tfm.world_pose_residuals, tschur.build_normal_system_pose
        specs = tfm.world_pose_families(cfg).robust
    iso = torch.eye(6) / cfg.initial_pose_prior_sigma
    anchor = w.X_init[0]
    r_plain, r_L = residuals(vals, w, masks, cfg, anchor), residuals(vals, w, masks, cfg, anchor, iso)
    for a, b in zip(r_plain, r_L):
        torch.testing.assert_close(b, a, rtol=2.4e-7, atol=0)
    s_plain = build(vals, sqrt_weights(r_plain, specs), w, masks, cfg, anchor, r_plain)
    s_L = build(vals, sqrt_weights(r_L, specs), w, masks, cfg, anchor, r_L, iso)
    for f in s_plain._fields:
        torch.testing.assert_close(getattr(s_L, f), getattr(s_plain, f), rtol=2.4e-7, atol=0)


def _est_values(w, masks, cfg, updater, init):
    v = init(w, masks, cfg)
    return {"X": v["X"], "HL"[updater]: v["HL"[updater]], "sp": v["sp"], "dp": v["dp"]}


@pytest.mark.parametrize("updater", [0, 1])
def test_boundary_prior_matches_jax(updater):
    """The 7-frame sub-window [0, 6] of a 14-frame run (windows 6/2 slide by
    4 plus the boundary), compacted to caps 48/32/3, estimates at the
    initial values moved off by 1e-2 in the camera tangents, the previous
    prior a random full factor: L L^T against JAX's float32 and float64
    marginals."""
    scfg = ScenarioConfig(n_frames=14, n_static=60, n_objects=2, pts_per_object=14, ns=80, nd=48, no=4,
                          point_noise=0.02)
    _, jm, tm = _maps(scfg)
    kw = dict(window_max_static=48, window_max_dynamic=32, window_max_objects=3, backend_updater_enum=updater)
    jc, tc = jcfg.BackendConfig(**kw), tcfg.BackendConfig(**kw)
    n_sub = 7
    tw = tmap.slice_window(tm, 0, n_sub)
    jw = to_jax(tw)
    init = jfm.init_values if updater == 0 else jfm.init_values_world_pose
    jv = _est_values(jw, to_jax(tfm.build_masks(tw, tc)), jc, updater, init)
    rng = np.random.default_rng(5)
    from dynosam_tpu.core import lie as jlie

    jv["X"] = jlie.se3_retract(jv["X"], jnp.asarray(rng.normal(0, 1e-2, (n_sub, 6)), jnp.float32))
    Q = rng.normal(size=(6, 6))
    prev_L = np.linalg.cholesky((Q @ Q.T / 6 + np.eye(6)) / 1e-6)

    def jax_lam(dtype):
        cast = lambda t: jax.tree.map(  # noqa: E731
            lambda a: a.astype(dtype) if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating) else a, t)
        L, xbar = jax.jit(jfl.boundary_prior, static_argnames=("n_sub", "cfg", "updater"))(
            cast(jm), 0, n_sub=n_sub, cfg=jc, est_values=cast(jv), updater=updater, anchor=cast(jw.X_init[0]),
            prev_prior_L=jnp.asarray(prev_L, dtype))
        L = np.asarray(L, np.float64)
        return L @ L.T, np.asarray(xbar.t)

    j32, jx = jax_lam(jnp.float32)
    jax.config.update("jax_enable_x64", True)
    try:
        j64, _ = jax_lam(jnp.float64)
    finally:
        jax.config.update("jax_enable_x64", False)
    L, xbar = tfl.boundary_prior(tm, 0, n_sub, tc, to_port(jv), updater, to_port(jw.X_init[0]),
                                 torch.as_tensor(prev_L, dtype=torch.float32))
    t32 = L.double().numpy() @ L.double().numpy().T
    assert np.isfinite(t32).all()
    np.testing.assert_array_equal(xbar.t.numpy(), jx)
    scale = np.abs(j64).max()
    jax_err = np.abs(j32 - j64).max()
    port_err = np.abs(t32 - j64).max()
    assert port_err <= 2 * jax_err + 1e-6 * scale, (port_err, jax_err, scale)


def _f64(tree):
    if isinstance(tree, torch.Tensor):
        return tree.double() if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: _f64(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_f64(x) for x in tree))
    return tree


def test_boundary_marginal_matches_dense_float64():
    """The Schur-complement boundary marginal equals the same complement
    taken on the dense Gauss-Newton Hessian of the identical masked
    residuals (float64, the port's own `tests/test_fixed_lag.py` check)."""
    scfg = ScenarioConfig(n_frames=5, n_static=24, n_objects=1, pts_per_object=8, ns=30, nd=12, no=2,
                          point_noise=0.01)
    _, _, tm = _maps(scfg)
    m = _f64(tm)
    cfg = tcfg.BackendConfig(window_max_static=0, window_max_dynamic=0, window_max_objects=0)
    n_sub = 5
    w = tmap.slice_window(m, 0, n_sub)
    masks = tfm.build_masks(w, cfg)
    last = torch.arange(n_sub) == n_sub - 1
    masks = masks._replace(static_obs=masks.static_obs & ~last[:, None], dyn_obs=masks.dyn_obs & ~last[:, None])
    vals = tfm.init_values(w, masks, cfg)
    anchor = w.X_init[0]
    L, _ = tfl.boundary_prior(m, 0, n_sub, cfg, vals, 0, anchor)
    Lam = (L @ L.T).numpy()
    assert L.dtype == torch.float64

    specs = tfm.world_motion_families(cfg).robust
    res0 = tfm.world_motion_residuals(vals, w, masks, cfg, anchor)
    sw = sqrt_weights(res0, specs)
    template = zero_delta(vals)
    keys = list(template)
    sizes = [template[k].numel() for k in keys]

    def rows(d):
        delta = {k: c.reshape(template[k].shape) for k, c in zip(keys, torch.split(d, sizes))}
        rs = tfm.world_motion_residuals(retract_tree(vals, delta), w, masks, cfg, anchor)
        return torch.cat([(s[..., None] * r).reshape(-1) for s, r in zip(sw, rs)])

    J = jacfwd(rows)(torch.zeros(sum(sizes), dtype=torch.float64))
    Hd = (J.T @ J).numpy()
    b0 = 6 * (n_sub - 1)                      # X leads the tangent layout
    keep = np.arange(b0, b0 + 6)
    drop = np.concatenate([np.arange(b0), np.arange(b0 + 6, Hd.shape[0])])
    Hmm = Hd[np.ix_(drop, drop)] + 1e-10 * np.eye(len(drop))
    want = Hd[np.ix_(keep, keep)] - Hd[np.ix_(keep, drop)] @ np.linalg.solve(Hmm, Hd[np.ix_(keep, drop)].T)
    scale = max(np.abs(want).max(), 1.0)
    assert np.abs(Lam - want).max() / scale < 5e-4, np.abs(Lam - want).max() / scale


def _ate(X, sc, n):
    return float(np.sqrt(np.mean([np.sum((X.t[k].numpy() - np.asarray(sc.X_gt[k].t)) ** 2) for k in range(n)])))


@pytest.mark.parametrize("updater", [0, 1])
def test_fixed_lag_e2e_accuracy(updater):
    """Sliding windows with the fixed-lag prior through the port's
    `run_from_packets`: every frame valid, each window solved with a
    finite error, and the camera ATE below max(2 a0, a0 + 0.02 m) of the
    fresh-rebuild run's a0."""
    scfg = ScenarioConfig(n_frames=14, n_static=60, n_objects=2, pts_per_object=14, ns=80, nd=48, no=4,
                          point_noise=0.02)
    sc = scenario(scfg)[0]
    packets = port_packets(scfg)
    cfg = tcfg.DynoConfig(backend=tcfg.BackendConfig(opt_window_size=6, opt_window_overlap=2,
                                                     backend_updater_enum=updater),
                          capacity=tcfg.CapacityConfig(max_static_tracks=80, max_dynamic_tracks=48, max_objects=4,
                                                       max_frames=14))
    b0 = tpipe.run_from_packets(packets, cfg, device="cpu")
    b1 = tpipe.run_from_packets(packets, dataclasses.replace(
        cfg, backend=dataclasses.replace(cfg.backend, use_fixed_lag_prior=True)), device="cpu")
    assert b1.est.X_valid.all() and b0.est.X_valid.all()
    assert [(s, w) for s, w, _, _ in b1.solves] == [(0, 6), (4, 6), (8, 6), (12, 2)]
    assert b1._prior_L is not None and torch.isfinite(b1._prior_L).all()
    assert all(np.isfinite(float(r.error)) for _, _, r, _ in b1.solves)
    a0, a1 = _ate(b0.est.X, sc, 14), _ate(b1.est.X, sc, 14)
    assert np.isfinite(a1) and a1 < max(2.0 * a0, a0 + 0.02), (a0, a1)
