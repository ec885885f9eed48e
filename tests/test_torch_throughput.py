"""The port's offline pipeline (`dynosam_tpu_torch/throughput.py`): the
segment loop against the JAX package's `update_map` + `_solve_window`
sequence (updater 0 and 1), the LM-PCG windows, the backend options of
the runner (fixed-lag prior, varpro, grouped dispatches), and the options
that raise (the whole pipeline on the golden scene is
`tests/test_torch_offline_golden.py`, grouped dispatches against JAX are
`tests/test_torch_batch_windows.py`).

* Segment loop: simulator packets, 16 frames, window 10, overlap 4 (two
  window solves, the second warm-started from the first's write-back),
  every pool compacted (caps 128/96/3), 7 LM iterations.  After each solve
  the estimate store's masks equal JAX's and its camera translations agree
  to 1e-3 m after the first window and 2e-3 m after the second.  Float32
  rounding alone moves them that far (`tests/f32_spread.py`, item 3 and
  its port twin): when the static measurements move by one part in 1e7,
  JAX's by up to 1.4e-4 and 6.5e-4 m, the port's by up to 2.1e-4 and
  1.2e-3 m (both at once: up to 1.8e-3 m after the second window); the
  second window, warm-started from the first and stopped after 7
  iterations of an IRLS with Huber k 1e-4, drifts along its frames by
  that much.
* Updater 1: masks equal after each window, camera translations after
  the second within twice the float32 floor measured in the test.
* LM-PCG windows: `use_schur=False` (window 10, compacted) and a window of
  20 frames (above `schur_max_window`, the whole pool) run and lower their
  error; the 20-frame window, 15 LM iterations, agrees with JAX's runner
  to 5e-4 m in the camera translations, masks equal: it is the solve of
  `test_torch_backend_online.py`'s full batch, whose float32 floor
  `tests/f32_spread.py` item 6 measures (3.5e-4 m for JAX, 2.8e-4 m for
  the port under a 1e-7 relative perturbation).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu import throughput as jtp
from dynosam_tpu.backend import formulation as jfm
from dynosam_tpu.backend import map as jmap
from dynosam_tpu.testing.simulator import ScenarioConfig
from dynosam_tpu.utils import config as jcfg
from dynosam_tpu_torch import convert
from dynosam_tpu_torch import throughput as ttp
from dynosam_tpu_torch.backend import backend as tbe
from dynosam_tpu_torch.backend import map as tmap
from dynosam_tpu_torch.utils import config as tcfg

from test_torch_schur import port_map, port_packets, scenario_packets, to_jax

torch.set_num_threads(2)


# JAX's window solve, one jit for the module (its static configs key the
# compiles)
_solve_window = jax.jit(jtp._solve_window, static_argnames=("window", "cfg", "lm_cfg", "pose_key", "updater"))


class _JaxMap:
    """The map JAX's `update_map` builds from numpy packets, built through
    the port's `update_map` (JAX's bits, `tests/test_torch_backend_map.py`)
    and read as JAX arrays where a JAX solve takes it."""

    def __init__(self, scfg):
        self.tm = tmap.MeasurementMap.create(scfg.n_frames, scfg.ns, scfg.nd, scfg.no, device="cpu")

    def update(self, pkt, k):
        tmap.update_map(self.tm, convert.frontend_output_from_numpy(pkt, device="cpu"), k)

    def jax(self):
        return to_jax(self.tm)


def _loop_cfg(mod, scfg):
    return mod.DynoConfig(
        backend=mod.BackendConfig(window_max_static=128, window_max_dynamic=96, window_max_objects=3,
                                  lm_max_iterations=7),
        capacity=mod.CapacityConfig(max_static_tracks=scfg.ns, max_dynamic_tracks=scfg.nd,
                                    max_objects=scfg.no, max_frames=scfg.n_frames),
    )


def test_segment_loop_matches_jax_after_each_window():
    scfg = ScenarioConfig(n_frames=16)
    packets = scenario_packets(scfg)
    jc, tc = _loop_cfg(jcfg, scfg), _loop_cfg(tcfg, scfg)
    lm_cfg = jtp._lm_cfg(jc.backend)
    m = _JaxMap(scfg)
    est = jtp.EstStore.create(16, scfg.ns, scfg.nd, scfg.no)
    runner = ttp.make_offline_runner(None, tc, 16, device="cpu")
    starts = []
    for k, pkt in enumerate(packets):
        m.update(pkt, k)
        runner.add_packet(convert.frontend_output_from_numpy(pkt, device="cpu"))
        start = runner.window_due()
        if start is None:
            continue
        starts.append(start)
        est, jres = _solve_window(est, m.jax(), jnp.int32(start), window=10, cfg=jc, lm_cfg=lm_cfg, pose_key="H",
                                  updater=0)
        win = runner.solve(start)
        assert win.solve_ms() is None                   # no CUDA events on the CPU
        assert float(win.result.error) < float(win.result.initial_error)
        assert abs(win.result.iterations - int(jres.iterations)) <= 1
        a = jax.tree.map(np.asarray, est)
        b = convert.est_store_from_numpy(a, device="cpu")   # round trip of the JAX store
        t = convert.frontend_output_to_numpy(runner.est)
        for f in ("static_valid", "dyn_valid", "X_valid", "motion_valid"):
            assert np.array_equal(getattr(a, f), getattr(t, f)), f
            assert np.array_equal(getattr(b, f).numpy(), getattr(t, f)), f
        np.testing.assert_allclose(t.X.t, a.X.t, rtol=0, atol=(1e-3, 2e-3)[len(starts) - 1])
        solved = convert.lm_result_to_numpy(win.result)     # the write-back holds the solve's poses
        assert np.array_equal(solved.values["X"].t, t.X.t[start:start + 10])
    assert starts == [0, 6]
    assert runner.est.X_valid[:16].all()


def golden_config(n_frames, **backend_kw):
    """The golden config (`test_accuracy_regression._make_cfg`) with
    sliding windows."""
    return tcfg.DynoConfig(
        frontend=tcfg.FrontendConfig(
            tracker=tcfg.TrackerConfig(max_features_per_frame=300, klt_window=13, klt_levels=2),
            min_dynamic_features_per_object=20),
        backend=tcfg.BackendConfig(use_full_batch_opt=False, lm_max_iterations=15, **backend_kw),
        capacity=tcfg.CapacityConfig(max_static_tracks=400, max_dynamic_tracks=1024, max_objects=8,
                                     max_frames=n_frames),
        pipeline=tcfg.PipelineConfig(use_backend=True),
    )


@pytest.mark.parametrize("option", ["full_batch", "sequence_length"])
def test_options_outside_the_slice_raise(option):
    """Full batch (the JAX runner asserts it away: `run_from_packets` runs
    it) and a length the plan cannot split raise ValueError before any
    work runs (the camera is never read)."""
    cfg = golden_config(28)
    if option == "sequence_length":
        with pytest.raises(ValueError, match="must equal overlap 4 \\+ n_segments \\* stride 6"):
            ttp.make_offline_runner(None, cfg, 27, device="cpu")
    else:
        cfg = dataclasses.replace(cfg, backend=dataclasses.replace(cfg.backend, use_full_batch_opt=True))
        with pytest.raises(ValueError, match="run_from_packets for full-batch"):
            ttp.make_offline_runner(None, cfg, 28, device="cpu")


def _jiggled(packets, rng, module=np):
    """The packets with their static and dynamic measurements scaled by
    (1 + 1e-7 N(0, 1)): numpy packets in numpy float32 (the default), JAX
    packets with `module=jnp` (the form
    `test_jiggled_packets_in_numpy_equal_jnp` holds the numpy one to)."""
    def j(x):
        if module is np:
            return x * (np.float32(1) + np.float32(1e-7) * rng.standard_normal(x.shape).astype(np.float32))
        return x * (1 + 1e-7 * jnp.asarray(rng.standard_normal(x.shape), jnp.float32))

    return [p._replace(static_obs=p.static_obs._replace(xyz=j(p.static_obs.xyz)),
                       dynamic_obs=p.dynamic_obs._replace(xyz=j(p.dynamic_obs.xyz))) for p in packets]


def test_jiggled_packets_in_numpy_equal_jnp():
    """`_jiggled`'s numpy float32 product has the bits of the `jnp` form it
    replaces on the 16-frame scenario's packets, over the 2 draws the
    floor takes."""
    packets = scenario_packets(ScenarioConfig(n_frames=16))
    rng, ref = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(2):
        got = _jiggled(packets, rng)
        want = _jiggled([jax.tree.map(jnp.asarray, p) for p in packets], ref, jnp)
        for a, b in zip(got, want):
            for x, y in ((a.static_obs.xyz, b.static_obs.xyz), (a.dynamic_obs.xyz, b.dynamic_obs.xyz)):
                assert x.dtype == y.dtype == np.float32
                assert np.array_equal(x, np.asarray(y))


def test_segment_loop_world_pose_matches_jax():
    """Updater 1 (WorldPose) through the segment loop of
    `test_segment_loop_matches_jax_after_each_window`: after each window the
    store's masks equal JAX's (its L written under the L key), and after
    the second window the camera translations are within twice the float32
    floor measured here (the spread of JAX's loop and of the port's when
    the static and dynamic measurements move by one part in 1e7, 2
    draws)."""
    scfg = ScenarioConfig(n_frames=16)
    packets = scenario_packets(scfg)
    jc, tc = _loop_cfg(jcfg, scfg), _loop_cfg(tcfg, scfg)
    jc = dataclasses.replace(jc, backend=dataclasses.replace(jc.backend, backend_updater_enum=1))
    tc = dataclasses.replace(tc, backend=dataclasses.replace(tc.backend, backend_updater_enum=1))
    lm_cfg = jtp._lm_cfg(jc.backend)

    def jax_loop(pk, check=None):
        m = _JaxMap(scfg)
        est = jtp.EstStore.create(16, scfg.ns, scfg.nd, scfg.no)
        for k, p in enumerate(pk):
            m.update(p, k)
            if k >= 9 and (k - 9) % 6 == 0:
                est, _ = _solve_window(est, m.jax(), jnp.int32(k - 9), window=10, cfg=jc, lm_cfg=lm_cfg,
                                       pose_key="L", updater=1)
                if check is not None:
                    check.append(jax.tree.map(np.asarray, est))
        return np.asarray(est.X.t)

    def port_loop(pk, check=None):
        runner = ttp.make_offline_runner(None, tc, 16, device="cpu")
        for p in pk:
            runner.add_packet(convert.frontend_output_from_numpy(p, device="cpu"))
            for s in runner.windows_due():
                runner.solve(s)
                if check is not None:
                    check.append(jax.tree.map(np.array, convert.frontend_output_to_numpy(runner.est)))
        return runner.est.X.t.numpy()

    jsnaps, tsnaps = [], []
    jt0, tt0 = jax_loop(packets, jsnaps), port_loop(packets, tsnaps)
    assert len(jsnaps) == len(tsnaps) == 2
    for a, t in zip(jsnaps, tsnaps):
        b = convert.est_store_from_numpy(a, device="cpu", updater=1)
        for f in ("static_valid", "dyn_valid", "X_valid", "motion_valid"):
            assert np.array_equal(getattr(a, f), getattr(t, f)), f
        assert torch.equal(b.L.t, torch.as_tensor(np.array(a.P.t))) and not b.H.t.any()
    assert not tsnaps[-1].H.t.any() and tsnaps[-1].L.t.any()
    rng = np.random.default_rng(0)
    draws = [_jiggled(packets, rng) for _ in range(2)]
    j_floor = max(np.abs(jax_loop(d) - jt0).max() for d in draws)
    t_floor = max(np.abs(port_loop(d) - tt0).max() for d in draws)
    assert np.abs(tt0 - jt0).max() <= 2 * (j_floor + t_floor), (np.abs(tt0 - jt0).max(), j_floor, t_floor)


def test_offline_runner_does_not_apply_the_fixed_lag_prior():
    """`use_fixed_lag_prior` is accepted and, as in the JAX package's runner
    (its `_solve_window` passes no `anchor_prior_L`), leaves the offline
    solves unchanged: the store equals the run without the option."""
    scfg = ScenarioConfig(n_frames=16)
    packets = port_packets(scfg)
    cfg = _loop_cfg(tcfg, scfg)
    runs = []
    for flag in (False, True):
        c = dataclasses.replace(cfg, backend=dataclasses.replace(cfg.backend, use_fixed_lag_prior=flag))
        runner = ttp.make_offline_runner(None, c, 16, device="cpu")
        for p in packets:
            runner.add_packet(p)
            for s in runner.windows_due():
                runner.solve(s)
        runs.append(runner.est)
    assert torch.equal(runs[0].X.t, runs[1].X.t) and torch.equal(runs[0].dyn_points, runs[1].dyn_points)


def test_offline_runner_varpro_windows():
    """`use_varpro` in the offline runner: windows solve by variable
    projection on the whole pool (2 LM iterations of 10 CG iterations
    here); each lowers its error and writes finite estimates, and the
    store's masks equal JAX's runner's on the same packets (the masks do
    not depend on the Hutchinson probes, which differ)."""
    scfg = ScenarioConfig(n_frames=16)
    packets = port_packets(scfg)
    kw = dict(use_varpro=True, lm_max_iterations=2, cg_max_iterations=10)
    jc, tc = _loop_cfg(jcfg, scfg), _loop_cfg(tcfg, scfg)
    tc = dataclasses.replace(tc, backend=dataclasses.replace(tc.backend, **kw))
    runner = ttp.make_offline_runner(None, tc, 16, device="cpu")
    for p in packets:
        runner.add_packet(p)
        for s in runner.windows_due():
            r = runner.solve(s).result
            assert float(r.error) < float(r.initial_error)
    assert [w.start for w in runner.windows] == [0, 6]
    assert torch.isfinite(runner.est.X.t).all() and runner.est.X_valid[:16].all()
    # JAX's masks of the second window, on JAX's map of the packets (built
    # through the port, `test_torch_schur.port_map`); slices and boolean
    # logic, so one jitted call gives the eager calls' bits
    masks = jax.jit(lambda m: jfm.build_masks(jmap.slice_window(m, 6, 10), jc.backend))(to_jax(port_map(scfg)))
    t = convert.frontend_output_to_numpy(runner.est)
    assert np.array_equal(np.asarray(masks.dyn_obs), t.dyn_valid[6:16])
    assert np.array_equal(np.asarray(masks.motion_active), t.motion_valid[6:16])


def test_offline_runner_solves_grouped_windows():
    """`opt_windows_per_dispatch=2` over 16 frames: one dispatch of both
    windows (`solve_group`), the same solve as `backend.solve_windows` from
    an empty store, every frame covered."""
    scfg = ScenarioConfig(n_frames=16)
    packets = port_packets(scfg)
    cfg = _loop_cfg(tcfg, scfg)
    cfg = dataclasses.replace(cfg, backend=dataclasses.replace(cfg.backend, opt_windows_per_dispatch=2))
    out = ttp.make_offline_runner(None, cfg, 16, device="cpu")
    dispatches = []
    for p in packets:
        out.add_packet(p)
        due = out.windows_due()
        if due:
            dispatches.append(due)
            out.solve_group(due)
    assert dispatches == [[0, 6]]
    est = tbe.EstimateStore.create(16, scfg.ns, scfg.nd, scfg.no, device="cpu")
    tbe.solve_windows(est, out.map, [0, 6], 10, cfg.backend, tbe.lm_config(cfg.backend))
    assert torch.equal(est.X.t, out.est.X.t) and out.est.X_valid[:16].all()


@pytest.mark.parametrize("option", ["no_schur", "long_window"])
def test_lm_pcg_windows_run(option):
    """The options LM-PCG serves: `use_schur=False` (two compacted windows of
    10, the second warm-started) and a window of 20 frames, above
    `schur_max_window` (one window over the whole pool, held against
    JAX's runner)."""
    if option == "no_schur":
        scfg, kw, window = ScenarioConfig(n_frames=16), dict(use_schur=False), 10
    else:
        scfg, kw, window = ScenarioConfig(n_frames=20), dict(opt_window_size=20, lm_max_iterations=15), 20
    jc, tc = _loop_cfg(jcfg, scfg), _loop_cfg(tcfg, scfg)
    jc = dataclasses.replace(jc, backend=dataclasses.replace(jc.backend, **kw))
    tc = dataclasses.replace(tc, backend=dataclasses.replace(tc.backend, **kw))
    runner = ttp.make_offline_runner(None, tc, scfg.n_frames, device="cpu")
    for pkt in port_packets(scfg):
        runner.add_packet(pkt)
        start = runner.window_due()
        if start is not None:
            r = runner.solve(start).result
            assert float(r.error) < float(r.initial_error), (start, float(r.initial_error), float(r.error))
            assert len(r.cg_iterations) == r.iterations and min(r.cg_iterations) > 0
    assert [w.start for w in runner.windows] == ([0, 6] if option == "no_schur" else [0])
    assert runner.est.X_valid[:scfg.n_frames].all()
    if option == "long_window":
        est, _ = _solve_window(jtp.EstStore.create(20, scfg.ns, scfg.nd, scfg.no), to_jax(port_map(scfg)),
                               jnp.int32(0), window=window, cfg=jc, lm_cfg=jtp._lm_cfg(jc.backend), pose_key="H",
                               updater=0)
        a, t = jax.tree.map(np.asarray, est), convert.frontend_output_to_numpy(runner.est)
        for f in ("static_valid", "dyn_valid", "X_valid", "motion_valid"):
            assert np.array_equal(getattr(a, f), getattr(t, f)), f
        np.testing.assert_allclose(t.X.t, a.X.t, rtol=0, atol=5e-4)


def test_run_offline_raises_without_a_card(monkeypatch):
    """Without `device="cpu"` the offline runner asks for CUDA and raises
    when no card is present."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttp.run_offline([None] * 28, None, golden_config(28))
