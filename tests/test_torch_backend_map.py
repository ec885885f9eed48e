"""The port's measurement map, window compaction, masks, initial values and
WorldMotion residuals (`dynosam_tpu_torch/backend/{map,formulation}.py`)
against the JAX package on the same simulator packets.

Map updates, slices, compaction indices and masks are bit-exact; initial
values match to 1e-6 and each residual family to 1e-5 of its max-abs."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu.backend import formulation as jfm
from dynosam_tpu.backend import map as jmap
from dynosam_tpu.core import lie as jlie
from dynosam_tpu.ops import factors as jfactors
from dynosam_tpu.testing.simulator import Scenario, ScenarioConfig
from dynosam_tpu.utils.config import BackendConfig as JBackendConfig
from dynosam_tpu_torch import convert
from dynosam_tpu_torch.backend import formulation as tfm
from dynosam_tpu_torch.backend import map as tmap
from dynosam_tpu_torch.core.lie import SE3
from dynosam_tpu_torch.ops import factors as tfactors
from dynosam_tpu_torch.testing import simulator as tsim
from dynosam_tpu_torch.utils.config import BackendConfig

from test_torch_schur import _window, port_map, scenario_packets, to_jax

torch.set_num_threads(2)

N_FRAMES = 10
SCENARIO = dict(n_frames=N_FRAMES, n_objects=3, no=4)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def t2np(tree):
    return convert.frontend_output_to_numpy(tree)


def assert_tuple_equal(jax_tuple, port_tuple):
    """Every field of a JAX NamedTuple equals the port's bit for bit."""
    for f in port_tuple._fields:
        a, b = getattr(jax_tuple, f), getattr(port_tuple, f)
        if isinstance(b, int):
            assert int(np.asarray(a)) == b, f
            continue
        for x, y in zip(jax.tree.leaves(np_tree(a)), jax.tree.leaves(t2np(b))):
            assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.fixture(scope="module")
def maps():
    """The simulator's packets in a JAX map and, through `convert`, in the
    port's map."""
    packets = Scenario(ScenarioConfig(**SCENARIO)).frontend_outputs()
    scfg = ScenarioConfig(**SCENARIO)
    jm = jmap.MeasurementMap.create(N_FRAMES, scfg.ns, scfg.nd, scfg.no)
    tm = tmap.MeasurementMap.create(N_FRAMES, scfg.ns, scfg.nd, scfg.no, device="cpu")
    for k, p in enumerate(packets):
        jm = jmap.update_map(jm, p, k)
        tmap.update_map(tm, convert.frontend_output_from_numpy(np_tree(p), device="cpu"), k)
    return jm, tm, packets


def test_port_scenario_matches_jax_packets(maps):
    """`dynosam_tpu_torch.testing.simulator.Scenario` draws in the JAX
    scenario's order: every packet leaf has the same dtype and shape and
    agrees to 4e-6 (two float32 ulps at the scene's 30 m scale)."""
    port = tsim.Scenario(tsim.ScenarioConfig(**SCENARIO)).frontend_outputs()
    jax_packets = maps[2]
    assert len(port) == len(jax_packets)
    for pj, pt in zip(jax_packets, port):
        for a, b in zip(jax.tree.leaves(np_tree(pj)), jax.tree.leaves(t2np(pt))):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_allclose(b, a, rtol=0, atol=4e-6)


def test_update_map_is_bit_exact(maps):
    jm, tm, _ = maps
    assert_tuple_equal(jm, tm)
    assert convert.measurement_map_from_numpy(np_tree(jm), device="cpu").capacity == tm.capacity


@pytest.mark.parametrize("start,window", [(0, N_FRAMES), (2, 6)])
def test_slice_window_is_bit_exact(maps, start, window):
    jm, tm, _ = maps
    assert_tuple_equal(jmap.slice_window(jm, start, window), tmap.slice_window(tm, start, window))


def test_slice_window_outside_the_map_raises(maps):
    """JAX's dynamic_slice would clamp the start; the port refuses."""
    _, tm, _ = maps
    with pytest.raises(ValueError, match="outside the map"):
        tmap.slice_window(tm, N_FRAMES - 3, 4)


def _random_window(seed, W=6, NS=40, ND=48, O=6):
    """A window with many tied observation counts: valid masks drawn with
    few distinct counts, object labels over O slots with -1 gaps."""
    rng = np.random.default_rng(seed)
    s_valid = rng.random((W, NS)) < np.where(rng.random(NS) < 0.5, 1.0, 0.3)
    d_valid = rng.random((W, ND)) < np.where(rng.random(ND) < 0.5, 1.0, 0.4)
    d_obj = np.where(rng.random((W, ND)) < 0.9, rng.integers(0, O - 1, (W, ND)), -1).astype(np.int32)
    m_valid = rng.random((W, O)) < 0.3
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (W, O, 3, 3)).copy()
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return jmap.WindowData(
        static_xyz=jnp.asarray(f32(W, NS, 3)), static_valid=jnp.asarray(s_valid),
        dyn_xyz=jnp.asarray(f32(W, ND, 3)), dyn_obj=jnp.asarray(d_obj), dyn_valid=jnp.asarray(d_valid),
        X_init=jlie.SE3(jnp.asarray(R[:, 0]), jnp.asarray(f32(W, 3))),
        motion_init=jlie.SE3(jnp.asarray(R), jnp.asarray(f32(W, O, 3))), motion_valid=jnp.asarray(m_valid),
        obj_pose_init=jlie.SE3(jnp.asarray(R), jnp.asarray(f32(W, O, 3))),
        frame_valid=jnp.ones((W,), bool), start=jnp.asarray(0, jnp.int32),
    )


@pytest.mark.parametrize("case", ["scenario", "random ties 0", "random ties 1"])
def test_compact_window_matches_jax(maps, case):
    """Same slot and object indices as JAX's top_k (ties to the lower
    slot) with every pool capped, objects dropped by the cap included, and
    the same compacted window (dropped objects' observations -> -1)."""
    if case == "scenario":
        jm, tm, _ = maps
        jw, tw = jmap.slice_window(jm, 0, N_FRAMES), tmap.slice_window(tm, 0, N_FRAMES)
        caps = (100, 90, 2)               # 120 static / 120 dynamic valid tracks, 3 objects
    else:
        jw = _random_window(int(case[-1]))
        tw = convert.window_data_from_numpy(np_tree(jw), device="cpu")
        caps = (25, 30, 3)
    j_out = jax.jit(jmap.compact_window, static_argnums=(1, 2, 3))(jw, *caps)
    t_out = tmap.compact_window(tw, *caps)
    for a, b in zip(j_out[1:], t_out[1:]):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert_tuple_equal(j_out[0], t_out[0])
    dropped = (tw.dyn_obj[:, t_out[2]] >= 0) & (t_out[0].dyn_obj < 0)
    assert bool(dropped.any())            # the object cap dropped observations


@pytest.fixture(scope="module")
def window(maps):
    jm, tm, _ = maps
    jw, tw = jmap.slice_window(jm, 0, N_FRAMES), tmap.slice_window(tm, 0, N_FRAMES)
    jc, tc = JBackendConfig(), BackendConfig()
    return jw, tw, jc, tc, jfm.build_masks(jw, jc), tfm.build_masks(tw, tc)


@pytest.mark.parametrize("smoothing,vo", [(True, True), (False, False)])
def test_build_masks_is_bit_exact(window, smoothing, vo):
    jw, tw, _, _, _, _ = window
    jc = JBackendConfig(use_smoothing_factor=smoothing, use_vo_factor=vo)
    tc = BackendConfig(use_smoothing_factor=smoothing, use_vo_factor=vo)
    jmk, tmk = jfm.build_masks(jw, jc), tfm.build_masks(tw, tc)
    assert_tuple_equal(jmk, tmk)
    assert bool(tmk.ternary.any()) and bool(tmk.static_obs.any())


def _assert_values_close(jv, tv, tol):
    for k in jv:
        for a, b in zip(jax.tree.leaves(np_tree(jv[k])), jax.tree.leaves(t2np(tv[k]))):
            np.testing.assert_allclose(b, a, rtol=0, atol=tol, err_msg=k)


@pytest.mark.parametrize("warm", [False, True])
def test_init_values_match(window, warm):
    """init_values with and without the previous estimates (prev/prev_mask
    merge) agree to 1e-6."""
    jw, tw, jc, tc, jmk, tmk = window
    prev = prev_mask = None
    tprev = tprev_mask = None
    if warm:
        rng = np.random.default_rng(5)
        W, NS = jmk.static_obs.shape
        ND, O = jmk.dyn_obs.shape[1], jmk.motion_active.shape[1]
        xi = lambda *s: jnp.asarray(rng.normal(0, 0.1, (*s, 6)), jnp.float32)  # noqa: E731
        prev = {"X": jlie.se3_exp(xi(W)), "H": jlie.se3_exp(xi(W, O)),
                "sp": jnp.asarray(rng.normal(size=(NS, 3)), jnp.float32),
                "dp": jnp.asarray(rng.normal(size=(W, ND, 3)), jnp.float32)}
        prev_mask = {"X": jnp.asarray(rng.random(W) < 0.5), "H": jnp.asarray(rng.random((W, O)) < 0.5),
                     "sp": jnp.asarray(rng.random(NS) < 0.5), "dp": jnp.asarray(rng.random((W, ND)) < 0.5)}
        tprev = {k: SE3(torch.as_tensor(np.array(v.R)), torch.as_tensor(np.array(v.t)))
                 if isinstance(v, jlie.SE3) else torch.as_tensor(np.array(v)) for k, v in prev.items()}
        tprev_mask = {k: torch.as_tensor(np.array(v)) for k, v in prev_mask.items()}
    jv = jfm.init_values(jw, jmk, jc, prev=prev, prev_mask=prev_mask)
    tv = tfm.init_values(tw, tmk, tc, prev=tprev, prev_mask=tprev_mask)
    _assert_values_close(jv, tv, 1e-6)


def test_world_motion_residuals_match(window):
    """Each family to 1e-5 of its max-abs, at the initial values and at
    values moved off them (so every family is non-zero)."""
    jw, tw, jc, tc, jmk, tmk = window
    jv = jfm.init_values(jw, jmk, jc)
    rng = np.random.default_rng(6)
    W, O = jmk.motion_active.shape
    jv["X"] = jlie.se3_retract(jv["X"], jnp.asarray(rng.normal(0, 0.01, (W, 6)), jnp.float32))
    jv["H"] = jlie.se3_exp(jnp.asarray(rng.normal(0, 0.05, (W, O, 6)), jnp.float32))
    tv = {k: SE3(torch.as_tensor(np.array(v.R)), torch.as_tensor(np.array(v.t)))
          if isinstance(v, jlie.SE3) else torch.as_tensor(np.array(v)) for k, v in jv.items()}
    names = tfm.world_motion_families(tc).names
    assert names == jfm.world_motion_families(jc).names
    jr = jax.jit(jfm.world_motion_residuals, static_argnums=(3,))(jv, jw, jmk, jc, jw.X_init[0])
    tr = tfm.world_motion_residuals(tv, tw, tmk, tc, tw.X_init[0])
    for name, a, b in zip(names, jr, tr):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape), name
        scale = max(np.abs(a).max(), 1e-30)
        assert np.abs(a).max() > 0, name
        assert np.abs(a - b.numpy()).max() <= 1e-5 * scale, name


def test_backend_factor_residuals_match():
    """pose_to_point, between, prior and motion_smoothing residuals on
    random poses, to 1e-5 of their max-abs."""
    rng = np.random.default_rng(7)
    xi = lambda: rng.normal(0, 0.4, (64, 6)).astype(np.float32)  # noqa: E731
    ja, jb, jz = (jlie.se3_exp(jnp.asarray(xi())) for _ in range(3))
    ta, tb, tz = (SE3(torch.as_tensor(np.array(p.R)), torch.as_tensor(np.array(p.t))) for p in (ja, jb, jz))
    pts = rng.normal(0, 5, (64, 3)).astype(np.float32)
    z = rng.normal(0, 5, (64, 3)).astype(np.float32)
    cases = [
        (jax.jit(jfactors.pose_to_point_residual)(ja, jnp.asarray(pts), jnp.asarray(z)),
         tfactors.pose_to_point_residual(ta, torch.as_tensor(pts), torch.as_tensor(z))),
        (jax.jit(jfactors.between_residual)(ja, jb, jz), tfactors.between_residual(ta, tb, tz)),
        (jax.jit(jfactors.prior_residual)(ja, jb), tfactors.prior_residual(ta, tb)),
        (jax.jit(jfactors.motion_smoothing_residual)(ja, jb), tfactors.motion_smoothing_residual(ta, tb)),
    ]
    for a, b in cases:
        a = np.asarray(a)
        assert np.abs(a - b.numpy()).max() <= 1e-5 * np.abs(a).max()


# Every scenario whose map, window and masks the port's test fixtures build
# through the port (`test_torch_schur._window`, `port_map`) in place of the
# JAX package: (scenario, backend config fields, window start, frames).
_F8 = dict(n_frames=8, n_static=30, n_objects=2, pts_per_object=10, ns=40, nd=32, no=4)
PORT_BUILT = {
    "window10": (dict(n_frames=10), {}, 0, 10),
    "window10_kinematic": (dict(n_frames=10), dict(use_object_kinematic_factor=True), 0, 10),
    "full_batch8": (dict(n_frames=8), dict(use_full_batch_opt=True, use_schur=False, lm_max_iterations=30), 0, 8),
    "varpro8": (dict(_F8, point_noise=0.0, odom_rot_noise=0.0, odom_trans_noise=0.0), {}, 0, 8),
    "varpro8_noise": (dict(_F8, point_noise=0.02, odom_rot_noise=0.0, odom_trans_noise=0.0), {}, 0, 8),
    "f64_check8": (dict(_F8, point_noise=0.02), dict(motion_ternary_factor_noise_sigma=0.05), 0, 8),
    "fixed_lag14_sub7": (dict(n_frames=14, n_static=60, n_objects=2, pts_per_object=14, ns=80, nd=48, no=4,
                              point_noise=0.02),
                         dict(window_max_static=48, window_max_dynamic=32, window_max_objects=3), 0, 7),
    "fixed_lag6": (dict(n_frames=6, n_static=30, n_objects=1, pts_per_object=10, ns=40, nd=16, no=2), {}, 0, 6),
    "fixed_lag5": (dict(n_frames=5, n_static=24, n_objects=1, pts_per_object=8, ns=30, nd=12, no=2,
                        point_noise=0.01), {}, 0, 5),
    "graph6": (dict(n_frames=6, n_static=30, n_objects=1, pts_per_object=10, ns=40, nd=32, no=4), {}, 0, 6),
    "dist8": (dict(n_frames=8, n_static=40, n_objects=2, pts_per_object=12, ns=64, nd=32, no=4), {}, 0, 8),
    "seq16": (dict(n_frames=16), {}, 0, 16),
    "seq20": (dict(n_frames=20), {}, 0, 20),
    "graph4": (dict(n_frames=4, n_static=10, n_objects=1, pts_per_object=5, ns=16, nd=16, no=2), {}, 0, 4),
}


@functools.partial(jax.jit, static_argnames=("capacity", "start", "window", "cfg"))
def _jax_built(packets, capacity, start, window, cfg):
    """JAX's map of the packets (stacked on a leading frame axis), its
    window and the window's masks, as the fixtures built them before
    (`update_map` per packet, `slice_window`, `build_masks`); scatters,
    slices and boolean logic, so one jitted call gives the eager calls'
    bits."""
    n = jax.tree.leaves(packets)[0].shape[0]
    m, _ = jax.lax.scan(lambda m, kp: (jmap.update_map(m, kp[1], kp[0]), None),
                        jmap.MeasurementMap.create(*capacity), (jnp.arange(n, dtype=jnp.int32), packets))
    w = jmap.slice_window(m, start, window)
    return m, w, jfm.build_masks(w, cfg)


def _assert_same_jax_tree(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape and a.weak_type == b.weak_type
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("case", sorted(PORT_BUILT))
def test_port_built_windows_equal_jax_bits(case):
    """The map, window and masks the fixtures now build through the port
    from the JAX simulator's packets, handed to the JAX side as
    `jnp.asarray` of the port's arrays, equal JAX's own bit for bit: same
    NamedTuples, dtypes, shapes and weak types."""
    sc_kw, cfg_kw, start, window = PORT_BUILT[case]
    scfg = ScenarioConfig(**sc_kw)
    jc, tc = JBackendConfig(**cfg_kw), BackendConfig(**cfg_kw)
    packets = jax.tree.map(lambda *x: np.stack(x), *scenario_packets(scfg))
    jm, jw, jmk = _jax_built(packets, (scfg.n_frames, scfg.ns, scfg.nd, scfg.no), start, window, jc)
    tm = port_map(scfg)
    _assert_same_jax_tree(to_jax(tm), jm)
    empty = (scfg.n_frames, scfg.ns, scfg.nd, scfg.no)     # the rows no packet has reached yet
    _assert_same_jax_tree(to_jax(tmap.MeasurementMap.create(*empty, device="cpu")),
                          jax.jit(jmap.MeasurementMap.create, static_argnums=(0, 1, 2, 3))(*empty))
    tw = tmap.slice_window(tm, start, window)
    _assert_same_jax_tree(to_jax(tw), jw)
    _assert_same_jax_tree(to_jax(tfm.build_masks(tw, tc)), jmk)
    if start == 0 and window == scfg.n_frames:
        got = _window(scfg, cfg_kw)
        _assert_same_jax_tree(got[0], jw)
        _assert_same_jax_tree(got[4], jmk)
        assert_tuple_equal(got[0], got[1])
        assert_tuple_equal(got[4], got[5])

