"""The port's offline pipeline (`dynosam_tpu_torch/throughput.py`): the
segment loop against the JAX package's `update_map` + `_solve_window`
sequence, the LM-PCG windows, and the options outside the ported path
(the whole pipeline on the golden scene is `tests/test_torch_offline_golden.py`).

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
from dynosam_tpu.backend import map as jmap
from dynosam_tpu.testing.simulator import Scenario, ScenarioConfig
from dynosam_tpu.utils import config as jcfg
from dynosam_tpu_torch import convert
from dynosam_tpu_torch import throughput as ttp
from dynosam_tpu_torch.utils import config as tcfg

torch.set_num_threads(2)


def _loop_cfg(mod, scfg):
    return mod.DynoConfig(
        backend=mod.BackendConfig(window_max_static=128, window_max_dynamic=96, window_max_objects=3,
                                  lm_max_iterations=7),
        capacity=mod.CapacityConfig(max_static_tracks=scfg.ns, max_dynamic_tracks=scfg.nd,
                                    max_objects=scfg.no, max_frames=scfg.n_frames),
    )


def test_segment_loop_matches_jax_after_each_window():
    scfg = ScenarioConfig(n_frames=16)
    packets = Scenario(scfg).frontend_outputs()
    jc, tc = _loop_cfg(jcfg, scfg), _loop_cfg(tcfg, scfg)
    solve = jax.jit(jtp._solve_window, static_argnames=("window", "cfg", "lm_cfg", "pose_key", "updater"))
    lm_cfg = jtp._lm_cfg(jc.backend)
    m = jmap.MeasurementMap.create(16, scfg.ns, scfg.nd, scfg.no)
    est = jtp.EstStore.create(16, scfg.ns, scfg.nd, scfg.no)
    runner = ttp.make_offline_runner(None, tc, 16, device="cpu")
    starts = []
    for k, pkt in enumerate(packets):
        m = jmap.update_map(m, pkt, k)
        runner.add_packet(convert.frontend_output_from_numpy(jax.tree.map(np.asarray, pkt), device="cpu"))
        start = runner.window_due()
        if start is None:
            continue
        starts.append(start)
        est, jres = solve(est, m, jnp.int32(start), window=10, cfg=jc, lm_cfg=lm_cfg, pose_key="H", updater=0)
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


@pytest.mark.parametrize("option", [
    "updater_1", "fixed_lag", "full_batch", "varpro", "batched_windows", "sequence_length",
])
def test_options_outside_the_slice_raise(option):
    """Each option outside the ported path raises NotImplementedError that
    names its ROADMAP.md item; full batch (the JAX runner asserts it away:
    `run_from_packets` runs it) and a length the plan cannot split raise
    ValueError; all before any work runs (the camera is never read)."""
    kw = {
        "updater_1": dict(backend_updater_enum=1), "fixed_lag": dict(use_fixed_lag_prior=True),
        "full_batch": dict(use_full_batch_opt=True), "varpro": dict(use_varpro=True),
        "batched_windows": dict(opt_windows_per_dispatch=2), "sequence_length": {},
    }[option]
    cfg = golden_config(28)
    cfg = dataclasses.replace(cfg, backend=dataclasses.replace(cfg.backend, **kw))
    if option == "sequence_length":
        with pytest.raises(ValueError, match="must equal overlap 4 \\+ n_segments \\* stride 6"):
            ttp.make_offline_runner(None, cfg, 27, device="cpu")
    elif option == "full_batch":
        with pytest.raises(ValueError, match="run_from_packets for full-batch"):
            ttp.make_offline_runner(None, cfg, 28, device="cpu")
    else:
        with pytest.raises(NotImplementedError, match=r"ROADMAP\.md item 1[12]"):
            ttp.make_offline_runner(None, cfg, 28, device="cpu")


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
    packets = Scenario(scfg).frontend_outputs()
    runner = ttp.make_offline_runner(None, tc, scfg.n_frames, device="cpu")
    for pkt in packets:
        runner.add_packet(convert.frontend_output_from_numpy(jax.tree.map(np.asarray, pkt), device="cpu"))
        start = runner.window_due()
        if start is not None:
            r = runner.solve(start).result
            assert float(r.error) < float(r.initial_error), (start, float(r.initial_error), float(r.error))
            assert len(r.cg_iterations) == r.iterations and min(r.cg_iterations) > 0
    assert [w.start for w in runner.windows] == ([0, 6] if option == "no_schur" else [0])
    assert runner.est.X_valid[:scfg.n_frames].all()
    if option == "long_window":
        m = jmap.MeasurementMap.create(20, scfg.ns, scfg.nd, scfg.no)
        for k, pkt in enumerate(packets):
            m = jmap.update_map(m, pkt, k)
        est, _ = jax.jit(jtp._solve_window, static_argnames=("window", "cfg", "lm_cfg", "pose_key", "updater"))(
            jtp.EstStore.create(20, scfg.ns, scfg.nd, scfg.no), m, jnp.int32(0), window=window, cfg=jc,
            lm_cfg=jtp._lm_cfg(jc.backend), pose_key="H", updater=0)
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
